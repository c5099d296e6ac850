"""CHOCO gossip exchange on node-stacked bucket buffers, on one device.

The port of the JAX package's packed static CHOCO engine on its fused
bucket-space path (``src/repro/comm/gossip.py:510-548``).  The n gossip
nodes are stacked on a leading ``(n, ...)`` dimension, so a schedule
round, a ``ppermute`` in the JAX engine, is an index gather over that
dimension.  Per ``gossip_steps`` round t and per bucket:

    q      = Q(x - x_hat)            compress -> wire payload
    q_j    = dense(payload_j)        one decode for all n payloads: the
                                     dequantize kernel for QSGD / sign
                                     codes, a scatter for sparse payloads
    x_hat += q
    s     += w_self q + w_nbr sum_j q_j        (schedule rounds, gathered)
    x      = x + gamma_b (s - x_hat)           fused EF-update kernel

Each payload is decoded once: every receiver of node j's payload would
decode the same bits, so the one decode serves node j's own update and
every neighbour's gather.

Every compressor of the JAX package runs here, and exact buckets ship
uncompressed.  Not ported: the per-leaf engine, the plain / all-reduce /
push-sum modes, stochastic topology processes, the pipelined engine, and
schedules with per-node weights (the ring has uniform ones).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.packing import (BucketSpec, bucket_omegas,
                                      compress_bufs, fold_seed)
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
    (a uniform ring's +1/-1 shifts are one group)."""
    groups = []
    for rnd in schedule.rounds:
        if rnd.weight is None:
            raise ValueError("schedules with per-node receive weights are "
                             "not ported")
        if groups and groups[-1][0] == rnd.weight:
            groups[-1][1].append(rnd)
        else:
            groups.append([rnd.weight, [rnd]])
    return [(w, tuple(torch.tensor(r.sources(schedule.n)) for r in rnds))
            for w, rnds in groups]


def _self_weight(schedule: GossipSchedule) -> float:
    if schedule.self_weight is None:
        raise ValueError("schedules with per-node self weights are not ported")
    return schedule.self_weight


def _accumulate_rounds(q: torch.Tensor, sources) -> torch.Tensor:
    """sum_r q[src_r]: node i receives row src_r[i] in round r."""
    acc = None
    for src in sources:
        got = q.index_select(0, src.to(q.device))
        acc = got if acc is None else acc.add_(got)
    return acc


def _neighbor_sum(q: torch.Tensor, groups) -> Tuple[torch.Tensor, float]:
    """Weighted neighbour aggregate  sum_j w_ij q_j  (j != i).  A single
    weight group defers its scalar to the EF update; several groups are
    weighted here and the caller applies w_nbr = 1."""
    if len(groups) == 1:
        w, sources = groups[0]
        return _accumulate_rounds(q, sources), w
    total = None
    for w, sources in groups:
        contrib = w * _accumulate_rounds(q, sources)
        total = contrib if total is None else total.add_(contrib)
    return total, 1.0


def make_choco_exchange(*, spec: BucketSpec,
                        schedules: Sequence[GossipSchedule], compressor,
                        gamma, gossip_steps: int = 1) -> Callable:
    """Returns ``exchange(x, x_hat, s, *, seed=0, draws=None)``.

    ``x``, ``x_hat``, ``s`` are lists of node-stacked f32 bucket buffers
    (``x`` holds the optimizer half-step x^{t+1/2}).  The exchange runs
    ``gossip_steps`` rounds (schedule ``t % len(schedules)`` in round t)
    and replaces the lists' entries with the new buffers bucket by
    bucket, so each old buffer is freed as soon as its update lands.

    ``seed`` salts the stochastic compressors' draws (QSGD's dither,
    RandK's positions, RandomizedGossip's keep bits): round t uses
    ``fold_seed(seed, t)`` (t > 0) and bucket b ``fold_seed(round_seed,
    b)``.  ``draws(t, b)``, when given, supplies the draw instead (the
    parity tests inject the JAX package's draws this way).
    """
    if gossip_steps < 1:
        raise ValueError("gossip_steps must be >= 1")
    if type(compressor) not in _PORTED:
        raise ValueError(f"compressor {compressor.name!r} is not ported to "
                         f"the exchange")
    for b in spec.buckets:
        if b.dtype != torch.float32:
            raise ValueError("the fused bucket-space path needs f32 state; "
                             "bf16 EF state is not ported")
    n = schedules[0].n
    if any(sch.n != n for sch in schedules):
        raise ValueError("time-varying schedules must share n")
    compiled = [(_weight_groups(sch), _self_weight(sch))
                for sch in schedules]
    gammas = _resolve_bucket_gammas(gamma, spec, compressor)

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat: List[torch.Tensor],
                 s: List[torch.Tensor], *, seed: int = 0,
                 draws: Optional[Callable[[int, int], torch.Tensor]] = None):
        for t in range(gossip_steps):
            groups, w_self = compiled[t % len(compiled)]
            tseed = seed if t == 0 else fold_seed(seed, t)
            for bucket in spec.buckets:
                b = bucket.index
                delta = x[b] - x_hat[b]
                payloads, (q,) = compress_bufs(
                    compressor, spec, (bucket,), (delta,), seed=tseed,
                    draws=None if draws is None
                    else (lambda i, t=t: draws(t, i)))
                del delta, payloads
                if groups:
                    nbr, w_nbr = _neighbor_sum(q, groups)
                else:                               # n == 1: no neighbours
                    nbr, w_nbr = q * 0.0, 0.0
                x[b], x_hat[b], s[b] = dispatch.ef_bucket_update(
                    x[b], x_hat[b], s[b], q, nbr, w_self, w_nbr, gammas[b])
                del q, nbr

    exchange.bucket_gammas = gammas
    return exchange
