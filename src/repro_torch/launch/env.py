"""torch-free process-environment helpers: where the ranks of the per-rank
gossip engine meet.  Safe to import before torch, as the JAX package's
``launch/env.py`` is safe to import before jax.

Two ways to start the ranks, one gossip node each:

* spawned by the launcher (``--simulate-devices N``, the counterpart of
  the JAX launcher's simulated host devices): the ranks meet in a
  ``FileStore`` file that the launcher names (:func:`file_rendezvous`);
* started by ``torchrun --nproc-per-node N``: the ranks read ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
  and ``MASTER_PORT`` from the environment (:func:`torchrun_rendezvous`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """How one rank joins its process group."""
    rank: int
    world_size: int
    #: this rank's index among the ranks of its host, and their count
    local_rank: int
    local_world_size: int
    #: ``torch.distributed.init_process_group``'s ``init_method``
    init_method: str


def file_rendezvous(path: str, rank: int, world_size: int) -> Rendezvous:
    """Ranks spawned on one host that meet in the ``FileStore`` file
    ``path`` (which must not hold an earlier group's store)."""
    return Rendezvous(rank=rank, world_size=world_size, local_rank=rank,
                      local_world_size=world_size,
                      init_method="file://" + os.path.abspath(path))


def torchrun_rendezvous(environ: Optional[Mapping[str, str]] = None
                        ) -> Optional[Rendezvous]:
    """The rendezvous ``torchrun`` sets up, or None outside ``torchrun``
    (no ``RANK`` and ``WORLD_SIZE`` in the environment)."""
    env = os.environ if environ is None else environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    return Rendezvous(rank=rank, world_size=world,
                      local_rank=int(env.get("LOCAL_RANK", rank)),
                      local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)),
                      init_method="env://")
