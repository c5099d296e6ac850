"""Elastic restore policy: map the leading node dimension when the node
count changes, as the JAX package does (``src/repro/checkpoint/elastic.py``).

* **grow** (``n_new % n_old == 0``): cyclic tile, ``new[j] =
  old[j % n_old]``; copies of one old node land ``n_old`` ids apart, so
  neighbours on a ring hold different models.
* **shrink** (``n_old % n_new == 0``): strided mean, ``new[j] =
  mean(old[j::n_new])``, computed in float32 and cast back.
* anything else raises :class:`ElasticRestoreError`.

The error-feedback states x_hat and s are not mapped: they were built
under the old mixing matrix, so the restore zeroes them and the trainer
rebuilds them with a consensus warmup of :func:`consensus_warmup_rounds`
CHOCO-GOSSIP rounds (Algorithm 1).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from repro_torch.checkpoint.manifest import ElasticRestoreError

#: the consensus error the warmup leaves, as a share of what the remap made
WARMUP_TARGET = 0.25
#: the most warmup rounds, for graphs whose spectral gap is near 0
WARMUP_CAP = 64


def elastic_ratio(n_old: int, n_new: int) -> Tuple[str, int]:
    """("grow" | "shrink" | "same", ratio), or ElasticRestoreError."""
    if n_old == n_new:
        return "same", 1
    if n_old <= 0 or n_new <= 0:
        raise ElasticRestoreError(f"invalid node counts {n_old} -> {n_new}")
    if n_new % n_old == 0:
        return "grow", n_new // n_old
    if n_old % n_new == 0:
        return "shrink", n_old // n_new
    raise ElasticRestoreError(
        f"cannot elastically restore n_nodes={n_old} -> {n_new}: the policy "
        f"needs one count to divide the other (cyclic tile on grow, strided "
        f"mean on shrink); resize to a multiple or re-initialise")


def source_rows(new_row: int, n_old: int, n_new: int) -> Tuple[int, ...]:
    """The old node rows that new node ``new_row`` is made from."""
    kind, _ = elastic_ratio(n_old, n_new)
    if kind in ("same", "grow"):
        return (new_row % n_old,)
    return tuple(range(new_row, n_old, n_new))          # the strided mean


def mean_rows(rows) -> np.ndarray:
    """The shrink's strided mean of same-shaped float rows, in float32 as
    the JAX restore computes it (``np.mean`` of the f32 rows)."""
    return np.mean([r.astype(np.float32) for r in rows], axis=0)


def consensus_warmup_rounds(delta: float) -> int:
    """Rounds k of CHOCO-GOSSIP warmup after an elastic restore: exact
    gossip contracts the consensus error by (1 - delta) a round on the new
    graph, so k = ceil(log(WARMUP_TARGET) / log(1 - delta)) rounds bring
    the disagreement the remap made to WARMUP_TARGET of itself;
    WARMUP_CAP bounds graphs whose gap is near 0."""
    if not 0.0 < delta <= 1.0:
        raise ElasticRestoreError(f"spectral gap delta={delta} outside (0, 1]")
    if delta == 1.0:                                    # fully connected
        return 1
    k = math.ceil(math.log(WARMUP_TARGET) / math.log(1.0 - delta))
    return max(1, min(WARMUP_CAP, k))
