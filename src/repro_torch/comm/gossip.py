"""Gossip exchanges on bucket buffers, in two engines.

The port of the JAX package's packed static CHOCO engine on its fused
bucket-space path (``src/repro/comm/gossip.py:510-548``), and of its two
exact baselines: plain neighbour averaging (``make_plain_schedule_fn``)
and the all-reduce average (``make_allreduce_fn``).

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

Not ported: the per-leaf engine, the push-sum mode, stochastic topology
processes and the pipelined engine.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.comm.packing import (BucketSpec, bucket_dense,
                                      bucket_omegas, bucket_wire_nbytes,
                                      compress_bufs, fold_seed, from_wire,
                                      to_wire)
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
    """Every exchange runs on f32 bucket buffers."""
    for b in spec.buckets:
        if b.dtype != torch.float32:
            raise ValueError("the fused bucket-space path needs f32 state; "
                             "bf16 EF state is not ported")


def _check_exchange(spec: BucketSpec, schedules: Sequence[GossipSchedule],
                    compressor, gossip_steps: int) -> int:
    """What every gossip exchange refuses (the plain mode passes no
    ``compressor``); returns n."""
    if gossip_steps < 1:
        raise ValueError("gossip_steps must be >= 1")
    if compressor is not None and type(compressor) not in _PORTED:
        raise ValueError(f"compressor {compressor.name!r} is not ported to "
                         f"the exchange")
    _check_f32(spec)
    n = schedules[0].n
    if any(sch.n != n for sch in schedules):
        raise ValueError("time-varying schedules must share n")
    return n


def _compile(schedules: Sequence[GossipSchedule], nodes: Sequence[int],
             round_data: Callable) -> list:
    """Per schedule: (weight groups, w_self, w_nbr) for the buffers' rows,
    the nodes ``nodes``.  A group holds its weight as a float or a
    ``(rows, 1)`` f32 column and ``round_data(round)`` per round;
    ``w_self`` and ``w_nbr`` are the EF update's ``(rows,)`` f32 vectors
    (w_nbr the single group's weight, else 1, or 0 without neighbours)."""
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
        w_self = (sch.self_weight if sch.self_weight is not None
                  else sch.self_weights)
        compiled.append((resolved, _node_weights(w_self, nodes),
                         _node_weights(w_nbr, nodes)))
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


def _exchange(spec: BucketSpec, compressor, gammas, gossip_steps: int,
              compiled, nodes, receiver) -> Callable:
    """The exchange loop both engines share.  ``compiled[t]`` is round t's
    entry of :func:`_compile`; ``nodes`` are the gossip nodes of the
    buffers' rows (None: all of them); ``receiver(payload, q, bucket)``
    returns ``receive(round) -> the dense payload this row receives``,
    ``round`` being the round's entry in ``compiled``, its tensors on the
    buffers' device.  ``compiled`` moves to a device once, at the first
    call with buffers there."""
    on_device = {}

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat: List[torch.Tensor],
                 s: List[torch.Tensor], *, seed: int = 0,
                 draws: Optional[Callable[[int, int], torch.Tensor]] = None):
        dev = x[0].device
        if dev not in on_device:
            on_device[dev] = _to_device(compiled, dev)
        on_dev = on_device[dev]
        for t in range(gossip_steps):
            groups, w_self, w_nbr = on_dev[t % len(on_dev)]
            tseed = seed if t == 0 else fold_seed(seed, t)
            for bucket in spec.buckets:
                b = bucket.index
                delta = x[b] - x_hat[b]
                (payload,), (q,) = compress_bufs(
                    compressor, spec, (bucket,), (delta,), seed=tseed,
                    draws=None if draws is None
                    else (lambda i, t=t: draws(t, i)), nodes=nodes)
                receive = receiver(payload, q, bucket)
                del delta, payload
                if groups:
                    nbr = _neighbor_sum(groups, receive)
                else:                               # n == 1: no neighbours
                    nbr = q * 0.0
                del receive
                dispatch.ef_bucket_update(x[b], x_hat[b], s[b], q, nbr,
                                          w_self, w_nbr, gammas[b])
                del q, nbr

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


def make_choco_exchange(*, spec: BucketSpec,
                        schedules: Sequence[GossipSchedule], compressor,
                        gamma, gossip_steps: int = 1) -> Callable:
    """Returns ``exchange(x, x_hat, s, *, seed=0, draws=None)``.

    ``x``, ``x_hat``, ``s`` are lists of node-stacked f32 bucket buffers
    (``x`` holds the optimizer half-step x^{t+1/2}).  The exchange runs
    ``gossip_steps`` rounds (schedule ``t % len(schedules)`` in round t)
    and updates the buffers in place, bucket by bucket.

    ``seed`` salts the stochastic compressors' draws (QSGD's dither,
    RandK's positions, RandomizedGossip's keep bits): round t uses
    ``fold_seed(seed, t)`` (t > 0), bucket b ``fold_seed(round_seed, b)``
    and node i ``fold_seed(bucket_seed, i)``.  ``draws(t, b)``, when
    given, supplies the draw instead (the parity tests inject the JAX
    package's draws this way).
    """
    n = _check_exchange(spec, schedules, compressor, gossip_steps)
    compiled = _compile(schedules, range(n), _gather_index(n))

    def receiver(payload, q, bucket):
        return _gather_rows(q)

    return _exchange(spec, compressor,
                     _resolve_bucket_gammas(gamma, spec, compressor),
                     gossip_steps, compiled, None, receiver)


def make_dist_choco_exchange(*, spec: BucketSpec,
                             schedules: Sequence[GossipSchedule], compressor,
                             gamma, gossip_steps: int = 1,
                             group) -> Callable:
    """The per-rank exchange: the port of the JAX engine's
    ``packed_local_fn`` (``src/repro/comm/gossip.py:491-548``), one process
    per gossip node.  ``group`` (``launch/mesh.py:NodeGroup``) is this
    node's rank; its buffers are ``(1, bucket.size)``, node ``group.rank``'s
    row of the stacked engine's.

    Returns ``exchange(x, x_hat, s, *, seed=0, draws=None)`` with the
    stacked exchange's contract, ``draws(t, b)`` giving this node's row.
    Per round t and bucket, the node compresses its own row (its draws
    are the stacked engine's row, see ``packing.draw``), then for each
    schedule round sends its payload's wire bytes to the round's
    destination and receives the source's in one ``batch_isend_irecv``
    (``group.sendrecv``; where a partial round skips the rank, it sends
    or receives nothing and adds a zero row), decodes each received
    payload where it lands (the dequantize kernel for QSGD / sign codes, a
    scatter for sparse payloads), sums them in the stacked engine's round order, applies the
    weight groups and finishes with the EF-update kernel: bit for bit the
    stacked exchange's row.

    The collective-layer probe (``dispatch.probe_collectives``) runs once
    per process, here, before any payload moves.  ``exchange.payload_bytes``
    lists the spec's bytes of one payload per bucket
    (``packing.bucket_wire_nbytes``), ``exchange.sends`` how many payloads
    of each bucket this rank sends per call (on star, node 0 sends n - 1
    per gossip round, a leaf one); ``group.bytes_sent`` counts what this
    rank sent."""
    n = _check_exchange(spec, schedules, compressor, gossip_steps)
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")
    probe = dispatch.probe_collectives(group)
    compiled = _compile(schedules, (group.rank,),
                        lambda rnd: rnd.peers(group.rank))

    def receiver(payload, q, bucket):
        wire = to_wire(payload)

        def receive(peers):
            dst, src = peers
            got = group.sendrecv(wire, dst, src)
            if src is None:                   # the round gives this node none
                return torch.zeros_like(q)
            return bucket_dense(from_wire(got, payload), bucket)
        return receive

    exchange = _exchange(spec, compressor,
                         _resolve_bucket_gammas(gamma, spec, compressor),
                         gossip_steps, compiled, (group.rank,), receiver)
    exchange.probe = probe
    exchange.payload_bytes = bucket_wire_nbytes(spec, compressor)
    exchange.sends = _sends(schedules, gossip_steps, group.rank)
    return exchange


# ---------------------------------------------------------------------------
# exact baselines
# ---------------------------------------------------------------------------

def _plain(gossip_steps: int, compiled, receiver) -> Callable:
    """The plain exchange loop both engines share: per round t and bucket,
    ``x = w_self x + w_nbr nbr`` with ``nbr = _neighbor_sum`` of what
    ``receiver(buf)`` returns per round (``compiled`` as in
    :func:`_exchange`), in place; a schedule without rounds leaves x as
    it is.  The arithmetic is the JAX engine's as XLA compiles it: the
    sum contracts into one fused multiply-add,
    ``fma(w_self, x, round(w_nbr nbr))`` (``torch.add`` with ``alpha``
    fuses the same way on the CPU and on the card).  Each row takes its
    weights as host floats, so every pass is a vectorized one over a row
    and the result lands in x without a copy."""
    on_device = {}
    rows = [(w_self.tolist(), w_nbr.tolist()) for _, w_self, w_nbr in compiled]

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat=None, s=None, *, seed: int = 0,
                 draws=None):
        dev = x[0].device
        if dev not in on_device:
            on_device[dev] = _to_device(compiled, dev)
        on_dev = on_device[dev]
        for t in range(gossip_steps):
            groups = on_dev[t % len(on_dev)][0]
            if not groups:
                continue
            for buf in x:
                nbr = _neighbor_sum(groups, receiver(buf))
                for i, (ws, wn) in enumerate(zip(*rows[t % len(on_dev)])):
                    torch.add(nbr[i].mul_(wn), buf[i], alpha=ws, out=buf[i])
                del nbr

    return exchange


def make_plain_exchange(*, spec: BucketSpec,
                        schedules: Sequence[GossipSchedule],
                        gossip_steps: int = 1) -> Callable:
    """Exact neighbour averaging (D-SGD, Algorithm 3), the port of
    ``make_plain_schedule_fn`` (``src/repro/comm/gossip.py:823-857``):
    returns ``exchange(x, x_hat=None, s=None, *, seed=0, draws=None)``,
    the choco exchange's call, which averages the node-stacked f32 bucket
    buffers ``x`` in place, ``gossip_steps`` rounds of schedule
    ``t % len(schedules)``.  ``x_hat``, ``s``, ``seed`` and ``draws`` are
    not read: the payload is the iterate itself."""
    n = _check_exchange(spec, schedules, None, gossip_steps)
    return _plain(gossip_steps,
                  _compile(schedules, range(n), _gather_index(n)),
                  _gather_rows)


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
                             schedules: Sequence[GossipSchedule],
                             gossip_steps: int = 1, group) -> Callable:
    """The per-rank plain exchange: this rank's ``(1, size)`` f32 bucket
    goes, as its bytes, to each schedule round's destination through
    ``group.sendrecv``, and the source's arrives (a zero row where a
    partial round gives this node none); the weighting is the stacked
    form's, so each rank computes its row of :func:`make_plain_exchange`
    bit for bit.  No probe runs (the JAX package probes only on its
    kernel path).  ``exchange.payload_bytes`` lists each bucket's bytes
    (4 per padded element) and ``exchange.sends`` the payloads of each
    bucket this rank sends per call."""
    n = _check_exchange(spec, schedules, None, gossip_steps)
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")
    compiled = _compile(schedules, (group.rank,),
                        lambda rnd: rnd.peers(group.rank))

    def receiver(buf):
        wire = buf.reshape(-1).view(torch.uint8)

        def receive(peers):
            dst, src = peers
            got = group.sendrecv(wire, dst, src)
            if src is None:
                return torch.zeros_like(buf)
            return got.view(buf.dtype).view(buf.shape)
        return receive

    exchange = _plain(gossip_steps, compiled, receiver)
    exchange.payload_bytes = [4 * b.size for b in spec.buckets]
    exchange.sends = _sends(schedules, gossip_steps, group.rank)
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
