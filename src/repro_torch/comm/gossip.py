"""Gossip exchanges on bucket buffers, in two engines.

The port of the JAX package's packed static CHOCO engine on its fused
bucket-space path (``src/repro/comm/gossip.py:510-548``), and of its two
exact baselines: plain neighbour averaging (``make_plain_schedule_fn``)
and the all-reduce average (``make_allreduce_fn``).

The EF state x_hat and s is f32 or bf16, x always f32, and the bucket
spec is built from the EF-state leaves, so its buckets have the state's
dtype and the x buffers the same layout in f32.  With bf16 state the
JAX engine takes its leaf path (``:550-568``; ``_fused_update_ok``
fails), whose algebra is elementwise, so it runs here in bucket space
too: the delta is rounded to bf16 (``lh.astype(bf16) - lhat``), every
payload carries bf16 values (QSGD and sign quantize its f32 upcast), the
received dense payloads are summed in bf16 in round order, and the EF
update is the bf16-state kernel, which rounds where the JAX engine does
(``kernels/ref.py:ef_update_bf16_ref``).  bf16 state takes schedules with
one uniform receive weight (every registry graph).

* :func:`make_choco_exchange`, the stacked engine: the n gossip nodes
  are stacked on a leading ``(n, ...)`` dimension on one device, so a
  schedule round, a ``ppermute`` in the JAX engine, is an index gather
  over that dimension.
* :func:`make_dist_choco_exchange`, the per-rank engine: one process per
  node, as the JAX engine runs one device per node; a schedule round is
  one send and one receive of the payload's wire bytes per rank.

Per ``gossip_steps`` round t and per bucket:

    q      = Q(x - x_hat)            compress -> wire payload
    q_j    = dense(payload_j)        decode: the dequantize kernel for
                                     QSGD / sign codes, a scatter for
                                     sparse payloads
    x_hat += q
    s     += w_self q + w_nbr sum_j q_j        (schedule rounds)
    x      = x + gamma_b (s - x_hat)           fused EF-update kernel

The stacked engine decodes each payload once: every receiver of node j's
payload would decode the same bits, so the one decode serves node j's own
update and every neighbour's gather.  The per-rank engine decodes its own
payload and each received one where it lands, as the JAX engine does.

Every compressor of the JAX package runs here, and exact buckets ship
uncompressed.  Every symmetric schedule runs, time-varying sequences
included: per-node self and receive weights (star, chain) reach the EF
update as ``(rows,)`` vectors, and a node that a partial round skips adds
a zero row, as ``ppermute`` hands it zeros.

The exact modes ship the f32 iterate itself and launch no kernel, as in
the JAX package, whose fused kernels serve the choco mode only:

* plain (exact D-SGD, Algorithm 3): per gossip round,
  ``x = w_self x + w_nbr sum_j x_j`` over the same weight groups and
  partial rounds as the choco exchange (:func:`make_plain_exchange`,
  :func:`make_dist_plain_exchange`);
* all-reduce (the centralized baseline): ``x = sum_i x_i / n``
  (:func:`make_allreduce_exchange`, :func:`make_dist_allreduce_exchange`).

Both choco exchanges also run the JAX package's two other static
engines.  The per-leaf engine (``packed=False``, JAX ``local_fn``) ships
one payload per leaf: each leaf's slot of its bucket is compressed on its
own with the operator's unpacked form (``QSGD.compress``, a leaf above
``packing.BLOCK_COMPRESS_SIZE`` as zero-padded rows of that width, each a
vector of its own; Identity for a leaf of an exact bucket) and updated in
place by one EF launch, the kernels taking the slot's row stride.  Its
QSGD and sign payloads decode to f32 with bf16 state too, and JAX sums
and weights them in f32 (f32 weights; the bf16-state EF kernel's f32
payload form).  The pipelined engine (``pipelined=True``, JAX
``comm/pipelined.py``) ships the same payloads and updates x from the
pre-round pair, ``x = x + gamma (s - x_hat)``, in the EF kernels'
pipelined order; the trainer runs it on the pre-gradient iterate
(``train/trainer.py``).

Under a stochastic topology process (``comm/stochastic.py``) the choco
exchange is the replica engine (:func:`make_process_exchange`,
:func:`make_dist_process_exchange`; JAX ``make_process_choco_fn``): the
paper's Algorithm-2 form with per-round references and source replicas,
x_hat and s lists of bucket lists, one replica-update launch per bucket
(or leaf) per gossip round; the plain mode averages with the sampled
matrix (:func:`make_plain_exchange` with ``process=``).  Bounded
staleness (JAX ``comm/async_gossip.py:make_async_choco_fn``) is the
replica engine's third form, with depth-tau rings of increments.  The
push-sum mode's engine, on directed graphs, is ``comm/pushsum.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm.packing import (Bucket, BucketSpec, bucket_dense,
                                      bucket_omegas, bucket_wire_nbytes,
                                      compress_bufs, compress_rows, fold_seed,
                                      from_wire, leaf_draw, leaf_rows,
                                      leaf_wire_nbytes, to_wire)
from repro_torch.comm.schedule import GossipSchedule
from repro_torch.core.choco_gossip import GammaSpec
from repro_torch.core.compression import (BlockTopK, Identity, QSGD, RandK,
                                          RandomizedGossip, SignNorm, TopK)
from repro_torch.kernels import dispatch

_PORTED = (Identity, RandK, TopK, BlockTopK, QSGD, SignNorm, RandomizedGossip)


def _pack_align(compressor) -> int:
    """Segment alignment of the packed buckets: the compressor's block
    width for blockwise operators (so bucket compression commutes with
    packing), the 128-lane unit otherwise."""
    return getattr(compressor, "block", None) or 128


def _resolve_bucket_gammas(gamma, spec: BucketSpec, compressor) -> List[float]:
    """Per-bucket consensus stepsizes, in bucket order: a float broadcasts;
    a GammaSpec evaluates Theorem 2 at each bucket's own omega."""
    if not isinstance(gamma, GammaSpec):
        return [float(gamma)] * spec.n_buckets
    return [gamma.value(w) for w in bucket_omegas(spec, compressor)]


def _weight_groups(schedule: GossipSchedule):
    """Consecutive rounds sharing one receive weight merge into a group:
    their dense payloads accumulate unweighted and the weight applies once
    (a uniform ring's +1/-1 shifts are one group).  A group's weight is a
    float, or the per-node tuple of a round with per-node receive weights.
    Returns ``[(weight, rounds), ...]``."""
    groups = []
    for rnd in schedule.rounds:
        wkey = rnd.weight if rnd.weight is not None else rnd.weights
        if groups and groups[-1][0] == wkey:
            groups[-1][1].append(rnd)
        else:
            groups.append([wkey, [rnd]])
    return [(w, tuple(rnds)) for w, rnds in groups]


def _node_weights(w, nodes: Sequence[int]) -> torch.Tensor:
    """A schedule weight for the buffers' rows, ``(len(nodes),)`` f32 on
    the CPU: a float fills it, a per-node tuple gives the rows' nodes'
    entries (the same f32 values the JAX engine gathers by node index)."""
    vals = [w] * len(nodes) if isinstance(w, float) else [w[i] for i in nodes]
    return torch.tensor(vals, dtype=torch.float32)


def _accumulate_rounds(rounds, receive) -> torch.Tensor:
    """sum_r receive(r): the dense payload each node receives in round r
    (a zero row where the round gives it none), added in round order."""
    acc = None
    for rnd in rounds:
        got = receive(rnd)
        acc = got if acc is None else acc.add_(got)
    return acc


def _neighbor_sum(groups, receive) -> torch.Tensor:
    """Neighbour aggregate of the rounds, the JAX engine's ``_neighbor_sum``:
    a single weight group is returned unweighted (its weight goes to the
    EF update as w_nbr); several groups are weighted here (w_nbr = 1).
    ``groups`` hold each weight as a float or the rows' ``(rows, 1)`` f32
    column."""
    if len(groups) == 1:
        return _accumulate_rounds(groups[0][1], receive)
    total = None
    for w, rounds in groups:
        contrib = w * _accumulate_rounds(rounds, receive)
        total = contrib if total is None else total.add_(contrib)
    return total


def _check_f32(spec: BucketSpec) -> None:
    """The exact modes run on f32 bucket buffers (the iterate itself)."""
    for b in spec.buckets:
        if b.dtype != torch.float32:
            raise ValueError("the exact modes exchange the f32 iterate; "
                             "build their spec from f32 leaves")


def _state_dtype(spec: BucketSpec) -> torch.dtype:
    """The choco exchange's EF-state dtype: its buckets' one dtype, f32 or
    bf16 (the x buffers stay f32, in the same layout)."""
    dtypes = {b.dtype for b in spec.buckets}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"EF state of dtypes {sorted(map(str, dtypes))}: "
                         f"the exchange takes f32 or bf16 buckets, one dtype")
    return dtypes.pop()


def _check_bf16_schedules(schedules: Sequence[GossipSchedule]) -> None:
    """bf16 EF state takes schedules whose rounds share one uniform receive
    weight (every registry graph): the JAX engine's bf16 rounding with
    several weight groups, or per-node receive weights, is not ported."""
    for sch in schedules:
        groups = _weight_groups(sch)
        if len(groups) > 1 or (groups and not isinstance(groups[0][0],
                                                         float)):
            raise ValueError("bf16 EF state needs schedules with one uniform "
                             "receive weight; this one has per-node or "
                             "several receive weights")


def _check_exchange(spec: BucketSpec, schedules: Sequence[GossipSchedule],
                    compressor, gossip_steps: int) -> int:
    """What every gossip exchange refuses (the plain mode passes no
    ``compressor``); returns n."""
    if gossip_steps < 1:
        raise ValueError("gossip_steps must be >= 1")
    if compressor is None:
        _check_f32(spec)
    else:
        if type(compressor) not in _PORTED:
            raise ValueError(f"compressor {compressor.name!r} is not ported "
                             f"to the exchange")
        if _state_dtype(spec) == torch.bfloat16:
            _check_bf16_schedules(schedules)
    n = schedules[0].n
    if any(sch.n != n for sch in schedules):
        raise ValueError("time-varying schedules must share n")
    return n


def _compile(schedules: Sequence[GossipSchedule], nodes: Sequence[int],
             round_data: Callable, state_dtype=torch.float32) -> list:
    """Per schedule: (weight groups, w_self, w_nbr, mix_in_bf16) for the
    buffers' rows, the nodes ``nodes``.  A group holds its weight as a
    float or a ``(rows, 1)`` f32 column and ``round_data(round)`` per
    round; ``w_self`` and ``w_nbr`` are the EF update's ``(rows,)`` f32
    vectors (w_nbr the single group's weight, else 1, or 0 without
    neighbours).  With bf16 EF state the uniform weights are rounded to
    bf16, as JAX rounds a Python float weight multiplying a bf16 array;
    ``mix_in_bf16`` says that the self weight is uniform too, so that the
    EF update's weighted sum runs in bf16 (per-node self weights are f32
    arrays in JAX and promote it to f32)."""
    bf16 = state_dtype == torch.bfloat16
    compiled = []
    for sch in schedules:
        groups = _weight_groups(sch)
        resolved = [(w if isinstance(w, float)
                     else _node_weights(w, nodes)[:, None],
                     tuple(round_data(r) for r in rounds))
                    for w, rounds in groups]
        w_nbr = (groups[0][0] if len(groups) == 1
                 else 1.0 if groups else 0.0)
        # a uniform diagonal, or per node (star, chain)
        uniform = sch.self_weight is not None
        w_self = _node_weights(sch.self_weight if uniform
                               else sch.self_weights, nodes)
        w_nbr = _node_weights(w_nbr, nodes)
        if bf16:
            w_nbr = w_nbr.to(state_dtype).to(torch.float32)
            if uniform:
                w_self = w_self.to(state_dtype).to(torch.float32)
        compiled.append((resolved, w_self, w_nbr, bf16 and uniform))
    return compiled


def _sends(schedules: Sequence[GossipSchedule], gossip_steps: int,
           rank: int) -> int:
    """The payloads of each bucket node ``rank`` sends per exchange call."""
    return sum(sum(rnd.peers(rank)[0] is not None
                   for rnd in schedules[t % len(schedules)].rounds)
               for t in range(gossip_steps))


def _to_device(obj, dev):
    """``obj`` with every tensor in it (through tuples and lists) on
    ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_device(o, dev) for o in obj)
    return obj


@dataclasses.dataclass(frozen=True)
class _Unit:
    """What the exchange compresses as one payload per node: a bucket (the
    packed engine) or a leaf, a slot of its bucket (the per-leaf engine).
    ``rows`` x ``width`` are the compressed rows per node: 1 x the bucket,
    or a leaf's R rows of C (``packing.leaf_rows``)."""
    index: int                 # bucket index, or leaf index (the draws' key)
    bucket: Bucket
    offset: int
    size: int                  # state elements per node row
    rows: int
    width: int
    packed: bool

    def views(self, bufs):
        """The unit's (n, size) view of each node-stacked bucket buffer."""
        buf = bufs[self.bucket.index]
        return buf if self.packed else buf[:, self.offset:self.offset
                                           + self.size]

    def dense(self, payload, n: int) -> torch.Tensor:
        """A payload's dense rows, (n, rows * width): a bucket's in its
        dtype; a leaf's in the payload's own (f32 for QSGD and sign)."""
        if self.packed:
            return bucket_dense(payload, self.bucket)
        return payload.dense().view(n, self.rows * self.width)


def _units(spec: BucketSpec, packed: bool) -> List[_Unit]:
    if packed:
        return [_Unit(b.index, b, 0, b.size, 1, b.size, True)
                for b in spec.buckets]
    return [_Unit(sl.leaf, spec.buckets[sl.bucket], sl.offset, sl.size,
                  *leaf_rows(sl.size), False)
            for sl in sorted(spec.slots, key=lambda sl: sl.leaf)]


def _compress_leaf(compressor, unit: _Unit, xv, hv, seed: int, draws, nodes):
    """The per-leaf engine's send half for one leaf (JAX
    ``_per_leaf_self_half`` / ``_compress_leaf``): the delta in the EF
    state's dtype, zero-padded to R rows of C above BLOCK_COMPRESS_SIZE,
    compressed row by row (a leaf of an exact bucket ships as it is).
    Returns (payload, q): q the dense rows, (n, R * C)."""
    n = xv.shape[0]
    wide = unit.rows * unit.width
    if wide == unit.size:
        delta = xv.to(hv.dtype) - hv
    else:
        delta = torch.zeros((n, wide), dtype=hv.dtype, device=hv.device)
        torch.sub(xv.to(hv.dtype), hv, out=delta[:, :unit.size])
    rows = delta.view(n * unit.rows, unit.width)
    comp = Identity() if unit.bucket.exact else compressor
    rand = None
    if comp.stochastic:
        rand = (draws(unit.index) if draws is not None else
                leaf_draw(comp, rows, unit.rows, fold_seed(seed, unit.index),
                          nodes))
    payload = compress_rows(comp, rows, rand)
    return payload, unit.dense(payload, n)


def _exchange(spec: BucketSpec, compressor, gammas, gossip_steps: int,
              compiled, nodes, receiver, *, packed: bool = True,
              pipelined: bool = False, compiled_f32q=None) -> Callable:
    """The exchange loop both engines share.  ``compiled[t]`` is round t's
    entry of :func:`_compile`; ``nodes`` are the gossip nodes of the
    buffers' rows (None: all of them); ``receiver(payload, q, unit)``
    returns ``receive(round) -> the dense payload this row receives``,
    ``round`` being the round's entry in ``compiled``, its tensors on the
    buffers' device.  ``compiled`` moves to a device once, at the first
    call with buffers there.

    ``packed``: one payload per bucket; else one per leaf (the per-leaf
    engine), whose QSGD and sign payloads decode to f32 and take the
    weights of ``compiled_f32q`` (unrounded f32 weights) with bf16 state.
    ``pipelined``: the EF update in the pipelined order.  ``gammas`` has
    one entry per unit (bucket or leaf)."""
    on_device = {}
    units = _units(spec, packed)

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat: List[torch.Tensor],
                 s: List[torch.Tensor], *, seed: int = 0,
                 draws: Optional[Callable[[int, int], torch.Tensor]] = None):
        dev = x[0].device
        if dev not in on_device:
            on_device[dev] = [_to_device(c, dev) if c is not None else None
                              for c in (compiled, compiled_f32q)]
        on_dev, on_dev_f32q = on_device[dev]
        for t in range(gossip_steps):
            tseed = seed if t == 0 else fold_seed(seed, t)
            tdraws = None if draws is None else (lambda i, t=t: draws(t, i))
            for unit, gamma in zip(units, gammas):
                xv, hv, sv = (unit.views(bufs) for bufs in (x, x_hat, s))
                if packed:
                    # in the EF state's dtype, as the JAX engine's
                    # ``lh.astype(lhat.dtype) - lhat``
                    delta = xv.to(hv.dtype) - hv
                    (payload,), (q,) = compress_bufs(
                        compressor, spec, (unit.bucket,), (delta,),
                        seed=tseed, draws=tdraws, nodes=nodes)
                    del delta
                else:
                    payload, q = _compress_leaf(compressor, unit, xv, hv,
                                                tseed, tdraws, nodes)
                f32q = q.dtype == torch.float32 and hv.dtype != q.dtype
                groups, w_self, w_nbr, mix_in_bf16 = (
                    on_dev_f32q if f32q else on_dev)[t % len(on_dev)]
                receive = receiver(payload, q, unit)
                del payload
                if groups:
                    nbr = _neighbor_sum(groups, receive)
                else:                               # n == 1: no neighbours
                    nbr = q * 0.0
                del receive
                w = unit.size
                dispatch.ef_bucket_update(xv, hv, sv, q[:, :w], nbr[:, :w],
                                          w_self, w_nbr, gamma, mix_in_bf16,
                                          pipelined)
                del q, nbr

    exchange.gammas = gammas
    if packed:
        exchange.bucket_gammas = gammas
    return exchange


def _gather_index(n: int):
    """``round -> (sources, rows that receive nothing or None)`` of the
    stacked engine, -1 sources standing in as 0."""
    def index(rnd):
        src = torch.tensor(rnd.sources(n))
        missing = torch.nonzero(src < 0).flatten()
        return src.clamp(min=0), (missing if missing.numel() else None)
    return index


def _gather_rows(q: torch.Tensor):
    """``receive(index)`` of the stacked engine: node i receives row
    src[i] of ``q``, or a zero row (written over the rows that receive
    nothing, and only those)."""
    def receive(index):
        src, missing = index
        got = q.index_select(0, src)
        if missing is not None:
            got.index_fill_(0, missing, 0.0)
        return got
    return receive


def _unit_gammas(gamma, spec: BucketSpec, compressor, packed: bool
                 ) -> List[float]:
    """One consensus stepsize per unit: per bucket (a float broadcasts, a
    GammaSpec takes each bucket's omega), or the one scalar for every leaf
    of the per-leaf engine, which refuses a GammaSpec as JAX's does."""
    if packed:
        return _resolve_bucket_gammas(gamma, spec, compressor)
    if isinstance(gamma, GammaSpec):
        raise ValueError(
            "per-bucket gamma (GammaSpec) requires the packed engine: the "
            "legacy per-leaf exchange has no bucket spec to derive omegas "
            "from; pass a float gamma, or packed=True")
    return [float(gamma)] * len(spec.slots)


def _choco(spec, schedules, compressor, gamma, gossip_steps, nodes,
           round_data, receiver, packed, pipelined, per_rank) -> Callable:
    """The choco exchange of either engine: the rounds compiled for the
    buffers' rows, the nodes ``nodes`` (and, per leaf with bf16 state,
    again with f32 weights for the f32 payloads of QSGD and sign), then
    :func:`_exchange`."""
    state_dtype = _state_dtype(spec)
    compiled = _compile(schedules, nodes, round_data, state_dtype)
    compiled_f32q = (_compile(schedules, nodes, round_data)
                     if not packed and state_dtype != torch.float32 else None)
    return _exchange(spec, compressor,
                     _unit_gammas(gamma, spec, compressor, packed),
                     gossip_steps, compiled,
                     tuple(nodes) if per_rank else None, receiver,
                     packed=packed, pipelined=pipelined,
                     compiled_f32q=compiled_f32q)


def _check_pipelined(schedules, pipelined: bool) -> None:
    """The pipelined engine runs one static schedule (JAX
    ``make_gossip_exchange``)."""
    if pipelined and len(schedules) > 1:
        raise ValueError(
            "pipelined gossip supports a single static schedule: the tau=1 "
            "gamma is derived from one delay-averaged mixing matrix, which "
            "a time-varying sequence does not have")


def make_choco_exchange(*, spec: BucketSpec,
                        schedules: Sequence[GossipSchedule], compressor,
                        gamma, gossip_steps: int = 1, packed: bool = True,
                        pipelined: bool = False) -> Callable:
    """Returns ``exchange(x, x_hat, s, *, seed=0, draws=None)``.

    ``x``, ``x_hat``, ``s`` are lists of node-stacked bucket buffers:
    ``x`` f32 (it holds the optimizer half-step x^{t+1/2}), ``x_hat`` and
    ``s`` in the spec's buckets' dtype, f32 or bf16.  The exchange runs
    ``gossip_steps`` rounds (schedule ``t % len(schedules)`` in round t)
    and updates the buffers in place, bucket by bucket.

    ``packed=False`` is the per-leaf engine (JAX ``local_fn``,
    ``src/repro/comm/gossip.py:573-596``): each leaf, a slot of its
    bucket, is compressed on its own with the operator's unpacked form
    (``packing.compress_rows``; a leaf above BLOCK_COMPRESS_SIZE as rows
    of that width; a leaf of an exact bucket uncompressed) and ships as
    one payload per round, and its slot is updated in place by one EF
    launch.  It takes a float gamma.  ``pipelined=True`` is the pipelined
    engine (JAX ``make_pipelined_choco_fn``): the same payloads, x
    updated from the pre-round ``s - x_hat`` (one static schedule).

    ``seed`` salts the stochastic compressors' draws (QSGD's dither,
    RandK's positions, RandomizedGossip's keep bits): round t uses
    ``fold_seed(seed, t)`` (t > 0), bucket (or leaf) u
    ``fold_seed(round_seed, u)`` and node i ``fold_seed(unit_seed, i)``.
    ``draws(t, u)``, when given, supplies the draw of round t, bucket (or
    leaf) u instead (the parity tests inject the JAX package's draws this
    way; a leaf's as (n, ...) or as its (n * R, ...) rows).
    """
    n = _check_exchange(spec, schedules, compressor, gossip_steps)
    _check_pipelined(schedules, pipelined)

    def receiver(payload, q, unit):
        return _gather_rows(q)

    return _choco(spec, schedules, compressor, gamma, gossip_steps,
                  range(n), _gather_index(n), receiver, packed, pipelined,
                  False)


def make_dist_choco_exchange(*, spec: BucketSpec,
                             schedules: Sequence[GossipSchedule], compressor,
                             gamma, gossip_steps: int = 1,
                             group, packed: bool = True,
                             pipelined: bool = False) -> Callable:
    """The per-rank exchange: the port of the JAX engine's
    ``packed_local_fn`` (``src/repro/comm/gossip.py:491-548``), or with
    ``packed=False`` of its per-leaf ``local_fn``, one process per gossip
    node.  ``group`` (``launch/mesh.py:NodeGroup``) is this node's rank;
    its buffers are ``(1, bucket.size)``, node ``group.rank``'s row of the
    stacked engine's.

    Returns ``exchange(x, x_hat, s, *, seed=0, draws=None)`` with the
    stacked exchange's contract, ``draws(t, u)`` giving this node's row.
    Per round t and bucket (or leaf), the node compresses its own row (its
    draws are the stacked engine's row, see ``packing.draw`` and
    ``packing.leaf_draw``), then for each schedule round sends its
    payload's wire bytes to the round's destination and receives the
    source's in one ``batch_isend_irecv`` (``group.sendrecv``; where a
    partial round skips the rank, it sends or receives nothing and adds a
    zero row), decodes each received payload where it lands (the
    dequantize kernel for QSGD / sign codes, a scatter for sparse
    payloads), sums them in the stacked engine's round order, applies the
    weight groups and finishes with the EF-update kernel (in the pipelined
    order with ``pipelined``): bit for bit the stacked exchange's row.

    The collective-layer probe (``dispatch.probe_collectives``) runs once
    per process, here, before any payload moves.  ``exchange.payload_bytes``
    lists the spec's bytes of one payload per bucket
    (``packing.bucket_wire_nbytes``) or per leaf
    (``packing.leaf_wire_nbytes``), ``exchange.sends`` how many payloads
    of each this rank sends per call (on star, node 0 sends n - 1 per
    gossip round, a leaf one); ``group.bytes_sent`` counts what this rank
    sent."""
    n = _check_exchange(spec, schedules, compressor, gossip_steps)
    _check_pipelined(schedules, pipelined)
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")
    probe = dispatch.probe_collectives(group)

    def receiver(payload, q, unit):
        wire = to_wire(payload)

        def receive(peers):
            dst, src = peers
            got = group.sendrecv(wire, dst, src)
            if src is None:                   # the round gives this node none
                return torch.zeros_like(q)
            return unit.dense(from_wire(got, payload), 1)
        return receive

    exchange = _choco(spec, schedules, compressor, gamma, gossip_steps,
                      (group.rank,), lambda rnd: rnd.peers(group.rank),
                      receiver, packed, pipelined, True)
    exchange.probe = probe
    exchange.payload_bytes = (bucket_wire_nbytes(spec, compressor) if packed
                              else leaf_wire_nbytes(spec, compressor))
    exchange.sends = _sends(schedules, gossip_steps, group.rank)
    return exchange


# ---------------------------------------------------------------------------
# the topology-process engine (replicas, the paper's Algorithm-2 form)
# ---------------------------------------------------------------------------

def _check_process(spec: BucketSpec, process, gamma, gossip_steps: int,
                   compressor=None) -> None:
    """What a process exchange refuses (the plain mode passes no
    ``compressor``): a process the port has not, no gossip round,
    staleness in the plain mode (JAX's reason), and
    what the static exchanges refuse of the spec and the compressor,
    every schedule taken with bf16 state (the replica update weighs in
    f32); under choco, the port's own rules, a per-bucket GammaSpec (the
    JAX trainer passes the scalar under a process) and exact buckets (the
    JAX process engine packs without them).  The trainer refuses the
    combinations JAX's trainer does."""
    kind = getattr(process, "kind", None)
    if kind not in ("matching", "linkfail", "staleness"):
        raise ValueError(f"topology process {kind!r} is not ported "
                         f"(matching, linkfail and staleness are)")
    if gossip_steps < 1:
        raise ValueError("gossip_steps must be >= 1")
    if compressor is None:
        if kind == "staleness":
            raise ValueError(
                "bounded staleness runs on the compressed choco engine "
                "only: the stale snapshots are reconstructed from rings of "
                "compressed increments, and the plain engine ships fresh "
                "iterates with no increment stream to ring-buffer")
        _check_f32(spec)
        return
    if type(compressor) not in _PORTED:
        raise ValueError(f"compressor {compressor.name!r} is not ported "
                         f"to the exchange")
    _state_dtype(spec)
    if isinstance(gamma, GammaSpec):
        raise ValueError("under a topology process gamma is the scalar "
                         "Theorem-2 value at the expected (delta, beta); "
                         "a per-bucket GammaSpec is not taken")
    if any(b.exact for b in spec.buckets):
        raise ValueError("the process engine packs without exact buckets, "
                         "as the JAX engine does: build the spec without "
                         "exact_small_leaves")


def _matching_tables(process, nodes, gamma: float):
    """Per round r of a matching process, the rows' ``(send_r, f32(gamma)
    * v_r)`` (``(rows,)`` f32 each), on the CPU, for the nodes
    ``nodes``."""
    f32 = torch.float32
    idx = list(nodes)
    g = torch.tensor(gamma, dtype=f32)
    return [(torch.tensor(process.round_send[r], dtype=f32)[idx],
             torch.tensor(process.branch_recv[r], dtype=f32)[idx] * g)
            for r in range(process.n_rounds)]


def _round_rows(vectors, nodes, dev) -> torch.Tensor:
    """The ``(R, rows)`` stack of per-round ``(n,)`` host vectors (the
    link-failure weights ``round_recv[r] * mask``, the stale delays) at
    the nodes ``nodes``, on ``dev``: on the card copied through pinned
    memory without a host sync."""
    t = torch.from_numpy(np.stack(vectors))[:, list(nodes)]
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _rotate(slots: list, lo: int, tau: int) -> None:
    """Rotate the ring ``slots[lo:lo + tau]`` one place in place: the
    oldest slot becomes slot 0, which the update then overwrites, and
    every other moves one round back.  No tensor is copied."""
    if tau:
        slots[lo:lo + tau] = [slots[lo + tau - 1]] + slots[lo:lo + tau - 1]


def _process_exchange(spec: BucketSpec, process, compressor, gamma: float,
                      gossip_steps: int, nodes, round_data, receiver, *,
                      packed: bool, per_rank: bool) -> Callable:
    """The replica exchange loop both engines share (JAX
    ``make_process_choco_fn``).  ``round_data(round)`` and
    ``receiver(payload, q, unit)`` as in :func:`_exchange`; ``receive``
    returns None where the round gives the row nothing and leaves it to
    this loop to add a zero row."""
    units = _units(spec, packed)
    nodes = tuple(nodes)
    rounds = process.schedule.rounds
    R = len(rounds)
    data = [round_data(r) for r in rounds]
    matching = process.kind == "matching"
    stale = process.kind == "staleness"
    tau = process.max_staleness if stale else 0
    tables = _matching_tables(process, nodes, gamma) if matching else []
    on_device = {}

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat, s, *, seed: int = 0,
                 draws: Optional[Callable[[int, int], torch.Tensor]] = None,
                 samples: Optional[Callable[[int], object]] = None):
        dev = x[0].device
        if dev not in on_device:
            on_device[dev] = (_to_device(tables, dev), _to_device(data, dev))
        tab, on_data = on_device[dev]

        def receive_dense(receive, r, q):
            got = receive(on_data[r])
            return torch.zeros_like(q) if got is None else got
        exchange.last_samples = []
        for t in range(gossip_steps):
            sample = (samples(t) if samples is not None
                      else process.sample(seed, t))
            exchange.last_samples.append(sample)
            tseed = seed if t == 0 else fold_seed(seed, t)
            tdraws = None if draws is None else (lambda i, t=t: draws(t, i))
            if matching:
                r = int(sample)
                # the sampled branch's draws: JAX fold_in(tkey, r)
                cseed, hats, reps = fold_seed(tseed, r), x_hat[r], s[r]
                send, gv = tab[r]
            else:
                if stale:
                    # the rings turn before the update, whose slot 0 takes
                    # this round's increments
                    _rotate(x_hat, 1, tau)
                    for r in range(R):
                        _rotate(s, R + r * tau, tau)
                # link failures are the ring form at tau = 0: no ring is
                # kept, and the sampled edge mask is in the rounds' weights
                cseed = tseed
                hats, own = (x_hat[0], x_hat[1:]) if stale else (x_hat, [])
                w_rounds = _round_rows(process.round_weights(sample), nodes,
                                       dev)
                d_rounds = (_round_rows(process.round_delays(sample), nodes,
                                        dev) if stale else None)
            for unit in units:
                xv, hv = unit.views(x), unit.views(hats)
                if packed:
                    delta = xv.to(hv.dtype) - hv
                    (payload,), (q,) = compress_bufs(
                        compressor, spec, (unit.bucket,), (delta,),
                        seed=cseed, draws=tdraws,
                        nodes=nodes if per_rank else None)
                    del delta
                else:
                    payload, q = _compress_leaf(compressor, unit, xv, hv,
                                                cseed, tdraws,
                                                nodes if per_rank else None)
                receive = receiver(payload, q, unit)
                del payload
                w = unit.size
                if matching:
                    nbr = receive_dense(receive, r, q)
                    dispatch.replica_matching(xv, hv, unit.views(reps),
                                              q[:, :w], nbr[:, :w], send, gv)
                else:
                    nbrs = [receive_dense(receive, r, q) for r in range(R)]
                    dispatch.replica_stale(
                        xv, hv, q[:, :w], [unit.views(sr) for sr in s[:R]],
                        [nb[:, :w] for nb in nbrs],
                        [unit.views(o) for o in own],
                        [[unit.views(o) for o in s[R + r * tau:
                                                   R + (r + 1) * tau]]
                         for r in range(R)], w_rounds, d_rounds, gamma)
                    del nbrs
                del receive, q

    exchange.gammas = [float(gamma)] * len(units)
    exchange.last_samples = []
    return exchange


def make_process_exchange(*, spec: BucketSpec, process, compressor,
                          gamma: float, gossip_steps: int = 1,
                          packed: bool = True) -> Callable:
    """The stacked choco exchange under a topology process
    (``comm/stochastic.py``), the port of JAX ``make_process_choco_fn``
    (``src/repro/comm/gossip.py:667-816``) with the paper's Algorithm-2
    replicas.  Returns ``exchange(x, x_hat, s, *, seed=0, draws=None,
    samples=None)``, updating the buffers in place:

    * matching: ``x_hat`` and ``s`` are lists of R bucket-buffer lists,
      the own references H_r and the source replicas S_r.  Per gossip
      round one round r is sampled; each node compresses q = Q(x - H_r)
      (the compressor's draws salted with ``fold_seed(round_seed, r)``, as
      JAX folds r into its key), ships it along round r only, and
      ``H_r += send_r q``, ``S_r += q_received`` (nothing where the round
      skips the node), ``x += gamma v_r (S_r - H_r)``: one replica-update
      launch per bucket (or leaf).
    * linkfail: ``x_hat`` is one bucket-buffer list, ``s`` a list of R.
      One compression against x_hat, every round ships, every replica
      takes in what it received, and the sampled edge mask gates only the
      mixing weight: ``x += gamma sum_r recv_r mask_r (S_r - x_hat)``, all
      R replicas in one launch per bucket (or leaf).
    * staleness (JAX ``make_async_choco_fn``): ``x_hat`` is a list of
      1 + tau bucket-buffer lists (the public copy, then the own ring of
      increments, slot j of j rounds back), ``s`` a list of R (1 + tau)
      (the R replicas, then ring r's slot j at ``s[R + r tau + j]``).
      One compression against x_hat, every round ships, every replica
      takes in what it received; the rings turn (a rotation of the lists:
      the oldest slot becomes slot 0, which the update overwrites with
      this round's increments, no tensor copied), and the sampled delay d
      of each row's round-r edge selects which ring prefix the update
      subtracts: ``x += gamma sum_r recv_r ((S_r - x_hat) - sum_{j<d}
      (ring_r[j] - own[j]))``, one launch per bucket (or leaf).  tau = 0
      is link failures at p = 0.

    ``seed`` is the exchange seed: the sample of gossip round t is
    ``process.sample(seed, t)``, the same on every node and engine, unless
    ``samples(t)`` gives it (a round index, an edge mask, or the edge
    delays: the parity tests hand over JAX's).  ``draws(t, u)`` injects the compressor's draw
    of round t, unit u (for matching, the sampled branch's).
    ``exchange.last_samples`` keeps the last call's samples.  ``packed``
    as in :func:`make_choco_exchange`; gamma is one float."""
    _check_process(spec, process, gamma, gossip_steps, compressor)
    n = process.n

    def receiver(payload, q, unit):
        return _gather_rows(q)

    return _process_exchange(spec, process, compressor, float(gamma),
                             gossip_steps, range(n), _gather_index(n),
                             receiver, packed=packed, per_rank=False)


def make_dist_process_exchange(*, spec: BucketSpec, process, compressor,
                               gamma: float, gossip_steps: int = 1, group,
                               packed: bool = True) -> Callable:
    """The per-rank exchange under a topology process: rank
    ``group.rank``'s row of :func:`make_process_exchange`, bit for bit.
    Matching ships only the sampled round (a rank the round skips makes
    no ``sendrecv`` call); link failures and staleness ship every round,
    a dropped or late link still carrying its payload.  The probe runs once per process.
    ``exchange.payload_bytes`` as in :func:`make_dist_choco_exchange`;
    ``exchange.sent_rounds(samples)`` counts the payloads of each unit
    this rank sent under the samples of one call."""
    _check_process(spec, process, gamma, gossip_steps, compressor)
    n = process.n
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")
    probe = dispatch.probe_collectives(group)
    rank = group.rank

    def receiver(payload, q, unit):
        wire = to_wire(payload)

        def receive(peers):
            dst, src = peers
            if dst is None and src is None:
                return None
            got = group.sendrecv(wire, dst, src)
            return None if src is None else unit.dense(
                from_wire(got, payload), 1)
        return receive

    exchange = _process_exchange(spec, process, compressor, float(gamma),
                                 gossip_steps, (rank,),
                                 lambda rnd: rnd.peers(rank), receiver,
                                 packed=packed, per_rank=True)
    exchange.probe = probe
    exchange.payload_bytes = (bucket_wire_nbytes(spec, compressor) if packed
                              else leaf_wire_nbytes(spec, compressor))
    rounds = process.schedule.rounds

    def sent_rounds(samples) -> int:
        if process.kind == "matching":
            return sum(rounds[int(r)].peers(rank)[0] is not None
                       for r in samples)
        return len(samples) * sum(rnd.peers(rank)[0] is not None
                                  for rnd in rounds)
    exchange.sent_rounds = sent_rounds
    return exchange


# ---------------------------------------------------------------------------
# exact baselines
# ---------------------------------------------------------------------------

def _plain(gossip_steps: int, mixing, receiver) -> Callable:
    """The plain exchange loop all its engines share, in place: per gossip
    round t, ``mixing(t, device, seed, samples)`` gives (the round's
    sample, None on a static schedule; ``neighbours(receive)``, the rows'
    weighted neighbour sum of what ``receiver(buf)``'s ``receive`` returns
    per schedule round; the rows' self weights as host floats), or None
    where the schedule has no rounds (x stays as it is).  Per bucket and
    row, ``x = fma(w_self, x, neighbours)``: ``torch.add`` with ``alpha``
    fuses into one multiply-add on the CPU and on the card, as XLA
    compiles the JAX engines' sum, and the result lands in x without a
    copy.  ``exchange.last_samples`` keeps the last call's samples."""

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat=None, s=None, *, seed: int = 0,
                 draws=None, samples=None):
        exchange.last_samples = []
        for t in range(gossip_steps):
            step = mixing(t, x[0].device, seed, samples)
            if step is None:
                continue
            sample, neighbours, ws_rows = step
            if sample is not None:
                exchange.last_samples.append(sample)
            for buf in x:
                nbr = neighbours(receiver(buf))
                for i, ws in enumerate(ws_rows):
                    torch.add(nbr[i], buf[i], alpha=ws, out=buf[i])
                del nbr

    exchange.last_samples = []
    return exchange


def _schedule_mixing(compiled) -> Callable:
    """:func:`_plain`'s mixing over static schedules (``compiled`` as in
    :func:`_exchange`), schedule ``t % len``: the JAX engine's
    ``w_nbr nbr`` with ``nbr = _neighbor_sum``, rounded before the FMA."""
    rows = [(w_self.tolist(), w_nbr.tolist())
            for _, w_self, w_nbr, _ in compiled]
    on_device = {}

    def mixing(t, dev, seed, samples):
        if dev not in on_device:
            on_device[dev] = _to_device(compiled, dev)
        k = t % len(compiled)
        groups = on_device[dev][k][0]
        if not groups:
            return None
        ws, wn = rows[k]

        def neighbours(receive):
            nbr = _neighbor_sum(groups, receive)
            for i, w in enumerate(wn):
                nbr[i].mul_(w)
            return nbr
        return None, neighbours, ws
    return mixing


def _process_mixing(process, nodes, round_data) -> Callable:
    """:func:`_plain`'s mixing under a topology process (JAX
    ``_process_neighbor_sum``), for the nodes ``nodes``: the sample of
    gossip round t is ``samples(t)`` if given, else ``process.sample(seed,
    t)``.  Matching: the sampled round's payload weighted by the
    1/p_r-scaled receive weight, the self weight its complement.  Link
    failures: every round's payload weighted by its receive weight times
    the edge mask, summed as XLA contracts the round loop
    (:func:`_contracted_sum`), the self weight 1 minus the summed
    weights."""
    f32 = torch.float32
    idx = list(nodes)
    data = [round_data(r) for r in process.schedule.rounds]
    on_device = {}

    def mixing(t, dev, seed, samples):
        if dev not in on_device:
            on_device[dev] = _to_device(data, dev)
        on_dev = on_device[dev]
        sample = (samples(t) if samples is not None
                  else process.sample(seed, t))
        if process.kind == "matching":
            r = int(sample)
            live = [(r, torch.tensor(process.branch_recv[r], dtype=f32)[idx])]
            w_self = torch.tensor(process.branch_self[r], dtype=f32)[idx]
        else:
            live = [(r, torch.from_numpy(wv)[idx]) for r, wv in
                    enumerate(process.round_weights(sample))]
            recv_w = torch.zeros((), dtype=f32)
            for _, wv in live:
                recv_w = recv_w + wv
            w_self = 1.0 - recv_w

        def neighbours(receive):
            return _contracted_sum([(wv.tolist(), receive(on_dev[r]))
                                    for r, wv in live])
        return sample, neighbours, w_self.tolist()
    return mixing


def _contracted_sum(terms):
    """sum_r w_r b_r over ``[(w_r, b_r)]`` (w_r one host float per row,
    b_r the rows' received buffers), as XLA contracts the JAX engine's
    round loop on the CPU (the replica kernel's order,
    ``ref.replica_stale_ref``): w_0 b_0 alone; fma(w_0, b_0, w_1 b_1);
    then fma(w_r, b_r, acc).  Each FMA is ``torch.add(acc, b, alpha=w)``
    per row, as in :func:`_plain`.  Returns a new buffer."""
    (w0, b0), rest = terms[0], terms[1:]
    if not rest:
        return b0 * torch.tensor(w0, dtype=b0.dtype, device=b0.device)[:, None]
    w1, b1 = rest[0]
    acc = b1 * torch.tensor(w1, dtype=b1.dtype, device=b1.device)[:, None]
    for w, b in [(w0, b0)] + rest[1:]:
        for i, wi in enumerate(w):
            torch.add(acc[i], b[i], alpha=wi, out=acc[i])
    return acc


def _wire_receiver(group) -> Callable:
    """``receiver(buf)`` of the per-rank plain exchanges: this rank's
    ``(1, size)`` f32 bucket goes, as its bytes, to the round's
    destination through ``group.sendrecv``, and the source's arrives (a
    zero row where the round gives this rank none; no call where it skips
    the rank)."""
    def receiver(buf):
        wire = buf.reshape(-1).view(torch.uint8)

        def receive(peers):
            dst, src = peers
            got = (None if dst is None and src is None
                   else group.sendrecv(wire, dst, src))
            if got is None:
                return torch.zeros_like(buf)
            return got.view(buf.dtype).view(buf.shape)
        return receive
    return receiver


def make_plain_exchange(*, spec: BucketSpec,
                        schedules: Sequence[GossipSchedule] = (),
                        gossip_steps: int = 1, process=None) -> Callable:
    """Exact neighbour averaging (D-SGD, Algorithm 3), the port of
    ``make_plain_schedule_fn`` (``src/repro/comm/gossip.py:823-858``):
    returns ``exchange(x, x_hat=None, s=None, *, seed=0, draws=None,
    samples=None)``, the choco exchange's call, which averages the
    node-stacked f32 bucket buffers ``x`` in place, ``gossip_steps``
    rounds of schedule ``t % len(schedules)``, or, under a topology
    ``process`` (whose schedule then stands in for ``schedules``), exact
    sampled averaging with no replicas: the sample of round t
    ``process.sample(seed, t)`` unless ``samples(t)`` gives it.  ``x_hat``,
    ``s`` and ``draws`` are not read: the payload is the iterate
    itself."""
    if process is not None:
        _check_process(spec, process, 1.0, gossip_steps)
        n = process.n
        mixing = _process_mixing(process, range(n), _gather_index(n))
    else:
        n = _check_exchange(spec, schedules, None, gossip_steps)
        mixing = _schedule_mixing(_compile(schedules, range(n),
                                           _gather_index(n)))
    return _plain(gossip_steps, mixing, _gather_rows)


def make_allreduce_exchange(*, spec: BucketSpec, n: int) -> Callable:
    """The centralized baseline, the port of ``make_allreduce_fn``
    (``src/repro/comm/gossip.py:860-869``): every node's x becomes the
    average ``(x_0 + x_1 + ... + x_{n-1}) / n``, summed in node order and
    divided as ``pmean`` does.  The call is the choco exchange's; only
    ``x`` is read."""
    _check_f32(spec)

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat=None, s=None, *, seed: int = 0,
                 draws=None):
        for buf in x:
            if buf.shape[0] != n:
                raise ValueError(f"{buf.shape[0]} node rows, expected {n}")
            total = buf[0].clone()
            for i in range(1, n):
                total.add_(buf[i])
            buf.copy_(total.div_(n).expand_as(buf))
            del total

    return exchange


def make_dist_plain_exchange(*, spec: BucketSpec,
                             schedules: Sequence[GossipSchedule] = (),
                             gossip_steps: int = 1, process=None,
                             group) -> Callable:
    """The per-rank plain exchange: this rank's row of
    :func:`make_plain_exchange` bit for bit, its bucket sent as its bytes
    (:func:`_wire_receiver`; under matching only the sampled round ships).
    No probe runs (the JAX package probes only on its kernel path).
    ``exchange.payload_bytes`` lists each bucket's bytes (4 per padded
    element); on a static schedule ``exchange.sends`` the payloads of each
    bucket this rank sends per call."""
    rank = group.rank
    if process is not None:
        _check_process(spec, process, 1.0, gossip_steps)
        n = process.n
        mixing = _process_mixing(process, (rank,), lambda rnd: rnd.peers(rank))
    else:
        n = _check_exchange(spec, schedules, None, gossip_steps)
        mixing = _schedule_mixing(_compile(schedules, (rank,),
                                           lambda rnd: rnd.peers(rank)))
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")
    exchange = _plain(gossip_steps, mixing, _wire_receiver(group))
    exchange.payload_bytes = [4 * b.size for b in spec.buckets]
    if process is None:
        exchange.sends = _sends(schedules, gossip_steps, rank)
    return exchange


def make_dist_allreduce_exchange(*, spec: BucketSpec, n: int,
                                 group) -> Callable:
    """The per-rank all-reduce average: each bucket summed over the ranks
    by ``group.all_reduce`` (the transport's own reduction order, which
    may differ from the stacked node order by an ulp) and divided by n.
    No probe runs.  ``exchange.payload_bytes`` lists each bucket's bytes
    (4 per padded element); ``group.bytes_modelled`` (not ``bytes_sent``)
    takes what a ring all-reduce of them would send."""
    _check_f32(spec)
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat=None, s=None, *, seed: int = 0,
                 draws=None):
        for buf in x:
            group.all_reduce(buf)
            buf.div_(group.size)

    exchange.payload_bytes = [4 * b.size for b in spec.buckets]
    return exchange
