"""Process groups of the per-rank gossip engine: one process per gossip
node, the counterpart of the JAX package's ``make_local_mesh`` /
``gossip_axis_for`` (``src/repro/launch/mesh.py``).  There each node is a
device of a mesh and its index is ``axis_index``; here each node is a
rank of a ``torch.distributed`` group and its index is the rank.

The transport rule (:func:`transport_for`):

* every rank has a card of its own -> NCCL, payloads sent from device
  memory;
* the ranks share a card, or run on the CPU -> gloo.  On a card, each
  payload is staged through pinned host buffers: device -> pinned host
  -> gloo (loopback TCP) -> pinned host -> device.  gloo's point-to-point
  takes CPU tensors only, so no device pointer is ever handed to it.

:meth:`NodeGroup.sendrecv` is the transport every gossip payload and the
collective-layer probe go through, :meth:`NodeGroup.all_reduce` the
all-reduce mode's; both count the bytes this rank sent and the host time
spent staging.
"""
from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.env import Rendezvous

#: default process-group timeout: a rank blocked on a peer that died
#: raises after this long
DEFAULT_TIMEOUT_S = 600.0


def transport_for(device_type: str, cards: int,
                  local_ranks: int) -> Tuple[str, bool]:
    """(backend, staged) for ranks on ``device_type`` with ``local_ranks``
    ranks on this host and ``cards`` CUDA devices: NCCL when every rank has
    a card of its own, else gloo, staged through pinned host buffers on a
    card."""
    if device_type == "cuda":
        return ("nccl", False) if cards >= local_ranks else ("gloo", True)
    return "gloo", False


@dataclasses.dataclass(eq=False)
class NodeGroup:
    """This process's gossip node in a group of ``size`` ranks, one node
    each: its node index is its rank."""
    rank: int
    size: int
    device: torch.device
    backend: str
    staged: bool
    timeout_s: float
    #: a gloo group for the host-side metric reductions (the default group
    #: itself when the backend is gloo)
    host_group: object = None
    #: payload bytes this rank has handed to ``sendrecv`` to send, and host
    #: seconds spent copying payloads between the device and pinned host
    #: buffers
    bytes_sent: int = 0
    staging_s: float = 0.0
    #: bytes a ring all-reduce would send per rank for the tensors given
    #: to ``all_reduce``: a model, not a count (the transport picks its own
    #: algorithm, and no hook reports what it sent)
    bytes_modelled: int = 0

    def sendrecv(self, send: torch.Tensor, dst, src):
        """Send the 1-D uint8 tensor ``send`` to rank ``dst`` and receive
        as many bytes from rank ``src``, in one ``batch_isend_irecv``.
        ``dst`` or ``src`` None: no send, or no receive (a partial schedule
        round).  Returns the received bytes on this rank's device, or None
        without a receive."""
        if send.dtype != torch.uint8 or send.dim() != 1:
            raise ValueError("sendrecv moves 1-D uint8 tensors")
        nbytes = send.numel()
        out = inbox = None
        t0 = time.perf_counter()
        if dst is not None:
            out = send
            if self.staged:
                out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                out.copy_(send)                # waits for the kernels
        if src is not None:
            inbox = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     if self.staged else torch.empty_like(send))
        if self.staged:
            self.staging_s += time.perf_counter() - t0
        ops = ([dist.P2POp(dist.isend, out, dst)] if dst is not None else []) \
            + ([dist.P2POp(dist.irecv, inbox, src)] if src is not None else [])
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if dst is not None:
            self.bytes_sent += nbytes
        if inbox is None or not self.staged:
            return inbox
        t0 = time.perf_counter()
        got = inbox.to(self.device)
        self.staging_s += time.perf_counter() - t0
        return got

    def all_reduce(self, tensor: torch.Tensor) -> None:
        """Sum ``tensor`` over the group, in place (on the card it is
        staged through a pinned host buffer when the group is).  Adds to
        ``bytes_modelled`` what a ring all-reduce sends per rank,
        ``2 (n - 1) / n`` of the tensor's bytes (a reduce-scatter, then an
        all-gather); gloo and NCCL may take another algorithm."""
        nbytes = tensor.numel() * tensor.element_size()
        buf = tensor
        if self.staged:
            t0 = time.perf_counter()
            buf = torch.empty(tensor.shape, dtype=tensor.dtype,
                              pin_memory=True)
            buf.copy_(tensor)                  # waits for the kernels
            self.staging_s += time.perf_counter() - t0
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        self.bytes_modelled += 2 * (self.size - 1) * nbytes // self.size
        if self.staged:
            t0 = time.perf_counter()
            tensor.copy_(buf)
            self.staging_s += time.perf_counter() - t0

    def all_reduce_host(self, values: Sequence[float], op) -> List[float]:
        """All-reduce a few host floats (float64) over the group."""
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.all_reduce(t, op=op, group=self.host_group)
        return t.tolist()

    def describe(self) -> str:
        where = ("pinned host buffers" if self.staged else
                 "device memory" if self.device.type == "cuda" else
                 "host memory")
        return (f"backend={self.backend} ranks={self.size} "
                f"device={self.device} payloads through {where}")


def make_node_group(n_nodes: int, device, rendezvous: Rendezvous, *,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> NodeGroup:
    """Join the process group of ``n_nodes`` ranks as ``rendezvous.rank``,
    on ``device`` ("cuda" or "cpu"), by the transport rule.  The rank is
    the gossip node index."""
    if rendezvous.world_size != n_nodes:
        raise ValueError(f"{rendezvous.world_size} ranks for {n_nodes} gossip "
                         f"nodes: the per-rank engine runs one node per rank")
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and cards == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    backend, staged = transport_for(dev.type, cards,
                                    rendezvous.local_world_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", rendezvous.local_rank
                           if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=rendezvous.init_method,
                            rank=rendezvous.rank, world_size=n_nodes,
                            timeout=timeout)
    host_group = (dist.new_group(backend="gloo", timeout=timeout)
                  if backend == "nccl" else None)
    return NodeGroup(rank=rendezvous.rank, size=n_nodes, device=dev,
                     backend=backend, staged=staged, timeout_s=timeout_s,
                     host_group=host_group)


def close_node_group() -> None:
    """Leave the process group (each rank, once its work is done)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, args: tuple = (), *,
                deadline_s: float) -> None:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes and wait for all
    of them.  A rank that raises or dies stops the others, and this raises
    with its error; past ``deadline_s`` seconds every rank is killed and
    this raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline_s
    while True:
        left = end - time.monotonic()
        if left <= 0:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{n} ranks did not finish within "
                               f"{deadline_s:.0f} s; every rank was killed")
        if ctx.join(timeout=min(left, 2.0)):
            return
