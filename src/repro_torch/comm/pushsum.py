"""Directed push-sum gossip with compressed payloads (column-stochastic A):
the port of the JAX package's push-sum engine (``src/repro/comm/pushsum.py``).

On a directed graph the mixing matrix A is only column-stochastic (every
node splits its unit mass over its out-neighbours, 1^T A = 1^T), so plain
neighbour averaging converges to a Perron-weighted point, not the
average.  Push-sum runs the same recursion on a scalar weight w (init 1)
and de-biases with z = x / w.  Per node i and gossip round, with CHOCO's
error feedback:

    q_i      = Q(x_i - x_hat_i)              compressed delta (packed bucket)
    x_hat_i += q_i
    s_i     += a_ii q_i + sum_j a_ij q_j     over the schedule's rounds
    x_i     += gamma (s_i - x_hat_i)
    w_i     += gamma (a_ii w_i + sum_j a_ij w_j - w_i)   exact, one scalar

Both 1^T x and 1^T w are conserved.  The schedule comes from
``schedule.compile_directed_schedule`` (a symmetric schedule works too: a
symmetric doubly stochastic W is column-stochastic).  Its rounds are not
weight-grouped: a directed round's receive weight belongs to the
destination, so each round r adds ``a_r[i] * dense(payload of src_r(i))``
in round order, in f32 (JAX multiplies by an f32 array).

The engine is packed only, as JAX's.  Per bucket it runs the kernels of
the static engine: the codes kernel (QSGD, sign) in the send half, the
dequantize kernel where a payload is decoded, and one EF-update launch,
with ``w_self`` each node's a_jj and, as the neighbour term, the
round-weighted sum ``nb`` (f32, in JAX's contracted order, rounded to the
state's dtype as JAX unpacks it) with weight 1.  The kernel rounds
``a_jj q`` before it adds nb, where XLA contracts the two into one FMA:
the results agree bit for bit where that product is exact (the directed
ring's 1/2) or runs in bf16 (bf16 state, a uniform self weight), and
differ by the product's rounding elsewhere (``tests/test_torch_pushsum.py``
states the measured gaps).  The w recursion and :func:`debias` are plain
PyTorch, as in JAX.

* :func:`make_pushsum_exchange`: the stacked engine (nodes on a leading
  ``(n, ...)`` dimension; a round is an index gather).
* :func:`make_dist_pushsum_exchange`: one process per node; node i's
  weight w_i rides in the same send as its first bucket's payload, 4
  bytes per neighbour per round, never an exchange of its own.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.comm.gossip import (_PORTED, _contracted_sum, _gather_index,
                                     _gather_rows, _node_weights,
                                     _state_dtype, _to_device)
from repro_torch.comm.packing import (BucketSpec, bucket_dense,
                                      bucket_wire_nbytes, compress_bufs,
                                      fold_seed, from_wire, to_wire)
from repro_torch.comm.schedule import GossipSchedule, round_recv_vec
from repro_torch.core.choco_gossip import GammaSpec
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import fma_f32

#: bytes of the weight scalar a node appends to its first payload
W_BYTES = 4


def _check(spec: BucketSpec, schedule: GossipSchedule, compressor, gamma,
           gossip_steps: int) -> int:
    """What the push-sum exchange refuses; returns n."""
    if gossip_steps < 1:
        raise ValueError("gossip_steps must be >= 1")
    if type(compressor) not in _PORTED:
        raise ValueError(f"compressor {compressor.name!r} is not ported "
                         f"to the exchange")
    if isinstance(gamma, GammaSpec):
        raise ValueError("push-sum takes the scalar Theorem-2 gamma (the "
                         "JAX trainer passes no GammaSpec to it)")
    if any(b.exact for b in spec.buckets):
        raise ValueError("the push-sum engine packs without exact buckets, "
                         "as the JAX engine does: build the spec without "
                         "exact_small_leaves")
    _state_dtype(spec)
    return schedule.n


def _tables(schedule: GossipSchedule, nodes):
    """The rows' self weights and per-round receive weights, ``(rows,)``
    f32 each, on the CPU (JAX's f32 ``round_recv_vec`` rows)."""
    a_self = _node_weights(schedule.self_weights, nodes)
    recv = [_node_weights(tuple(round_recv_vec(rnd, schedule.n)), nodes)
            for rnd in schedule.rounds]
    return a_self, recv


def _weight_update(w: torch.Tensor, received, a_self, recv, gamma: float):
    """w += gamma (a_self w + sum_r a_r w_src(r) - w), in place, with the
    JAX engine's f32 arithmetic as XLA compiles it on the CPU."""
    nbr = a_self[:, None] * w
    for a, got in zip(recv, received):
        nbr = fma_f32(a[:, None], got, nbr)
    d = nbr - w
    w.copy_(fma_f32(torch.full_like(d, gamma), d, w))


def _pushsum(spec: BucketSpec, schedule: GossipSchedule, compressor,
             gamma: float, gossip_steps: int, nodes, receiver) -> Callable:
    """The exchange loop both engines share, for the buffers' rows, the
    nodes ``nodes``.  ``receiver(payload, q, bucket, w)`` returns
    ``receive(r) -> (the dense payload this row receives in round r, a
    zero row where the round gives it none; the sender's w where ``w`` is
    given, else None)``."""
    gamma = float(gamma)
    nodes = tuple(nodes)
    a_self, recv = _tables(schedule, nodes)
    R = len(recv)
    # with bf16 state a uniform self weight is a Python float in JAX: it
    # takes q's dtype and a_self q + nb runs in bf16
    mix_in_bf16 = (spec.buckets[0].dtype == torch.bfloat16
                   and schedule.self_weight is not None)
    w_self = (a_self.to(torch.bfloat16).to(torch.float32) if mix_in_bf16
              else a_self)
    on_device = {}

    @torch.no_grad()
    def exchange(x: List[torch.Tensor], x_hat: List[torch.Tensor],
                 s: List[torch.Tensor], w: torch.Tensor, *, seed: int = 0,
                 draws: Optional[Callable[[int, int], torch.Tensor]] = None):
        dev = x[0].device
        if dev not in on_device:
            on_device[dev] = _to_device((a_self, w_self, recv), dev)
        a_dev, w_self_dev, recv_dev = on_device[dev]
        ones = torch.ones_like(a_dev)
        for t in range(gossip_steps):
            tseed = seed if t == 0 else fold_seed(seed, t)
            tdraws = None if draws is None else (lambda i, t=t: draws(t, i))
            w_got = []
            for b, (xv, hv, sv) in enumerate(zip(x, x_hat, s)):
                bucket = spec.buckets[b]
                delta = xv.to(hv.dtype) - hv
                (payload,), (q,) = compress_bufs(
                    compressor, spec, (bucket,), (delta,), seed=tseed,
                    draws=tdraws, nodes=nodes)
                del delta
                receive = receiver(payload, q, bucket, w if b == 0 else None)
                del payload
                got = []
                for r in range(R):
                    dense, wr = receive(r)
                    got.append(dense.to(torch.float32))
                    if b == 0:
                        w_got.append(wr)
                # nb: the rounds' f32 sum in JAX's contracted order, in the
                # state's dtype as JAX unpacks it; the kernel weighs it by 1
                nb = (_contracted_sum([(a.tolist(), g) for a, g in
                                       zip(recv, got)]).to(q.dtype)
                      if R else torch.zeros_like(q))
                del got
                dispatch.ef_bucket_update(xv, hv, sv, q, nb, w_self_dev, ones,
                                          gamma, mix_in_bf16, False)
                del q, nb
            _weight_update(w, w_got, a_dev, recv_dev, gamma)
        return x, x_hat, s, w

    exchange.gammas = [gamma] * spec.n_buckets
    return exchange


def make_pushsum_exchange(*, spec: BucketSpec, schedule: GossipSchedule,
                          compressor, gamma: float,
                          gossip_steps: int = 1) -> Callable:
    """Returns ``exchange(x, x_hat, s, w, *, seed=0, draws=None)``, the
    stacked push-sum exchange (JAX ``make_pushsum_schedule_fn``).

    ``x``, ``x_hat``, ``s`` are lists of node-stacked bucket buffers (x
    f32, holding the half-step; x_hat and s in the spec's buckets' dtype,
    f32 or bf16), ``w`` the ``(n, 1)`` f32 weight column.  It runs
    ``gossip_steps`` rounds of the module docstring's recursion in place
    and returns ``(x, x_hat, s, w)``.  ``seed`` and ``draws(t, b)`` as in
    ``gossip.make_choco_exchange``."""
    n = _check(spec, schedule, compressor, gamma, gossip_steps)
    index = _gather_index(n)
    srcs = [index(rnd) for rnd in schedule.rounds]
    on_device = {}

    def receiver(payload, q, bucket, w):
        dev = q.device
        if dev not in on_device:
            on_device[dev] = _to_device(srcs, dev)
        gather, wgather = _gather_rows(q), None
        if w is not None:
            wgather = _gather_rows(w)

        def receive(r):
            idx = on_device[dev][r]
            return gather(idx), (None if wgather is None else wgather(idx))
        return receive

    return _pushsum(spec, schedule, compressor, gamma, gossip_steps,
                    range(n), receiver)


def make_dist_pushsum_exchange(*, spec: BucketSpec, schedule: GossipSchedule,
                               compressor, gamma: float,
                               gossip_steps: int = 1, group) -> Callable:
    """The per-rank push-sum exchange, one process per node: ``group``
    (``launch/mesh.py:NodeGroup``) is this node's rank, its buffers ``(1,
    bucket.size)`` and its w ``(1, 1)``, node ``group.rank``'s rows of the
    stacked engine's.  Per gossip round and bucket the node compresses its
    row, then for each schedule round sends its payload's wire bytes to
    the round's destination and receives the source's in one
    ``group.sendrecv``; the first bucket's send carries the node's w as 4
    more bytes.  A received payload is decoded where it lands (the
    dequantize kernel for QSGD and sign codes): bit for bit the stacked
    exchange's row.

    The collective-layer probe runs once per process, here.
    ``exchange.payload_bytes`` lists the bytes of one payload per bucket,
    ``exchange.sends`` the payloads of each bucket this rank sends per
    call, and ``exchange.w_bytes`` the weight's bytes per call;
    ``group.bytes_sent`` counts what the rank sent, w included."""
    n = _check(spec, schedule, compressor, gamma, gossip_steps)
    if group.size != n:
        raise ValueError(f"a group of {group.size} ranks for {n} nodes")
    probe = dispatch.probe_collectives(group)
    peers = [rnd.peers(group.rank) for rnd in schedule.rounds]

    def receiver(payload, q, bucket, w):
        wire = to_wire(payload)
        if w is not None:
            wire = torch.cat([wire, w.reshape(-1).view(torch.uint8)])

        def receive(r):
            dst, src = peers[r]
            got = (None if dst is None and src is None
                   else group.sendrecv(wire, dst, src))
            if got is None:
                return torch.zeros_like(q), (None if w is None
                                             else torch.zeros_like(w))
            w_src = None
            if w is not None:
                w_src = got[-W_BYTES:].clone().view(torch.float32).view(1, 1)
                got = got[:-W_BYTES]
            return bucket_dense(from_wire(got, payload), bucket), w_src
        return receive

    exchange = _pushsum(spec, schedule, compressor, gamma, gossip_steps,
                        (group.rank,), receiver)
    exchange.probe = probe
    exchange.payload_bytes = bucket_wire_nbytes(spec, compressor)
    sends = sum(dst is not None for dst, _ in peers) * gossip_steps
    exchange.sends = [sends] * spec.n_buckets
    exchange.w_bytes = W_BYTES * sends
    return exchange


def debias(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Push-sum's de-biased estimate z = x / w of node-stacked rows: ``x``
    ``(n, ...)``, ``w`` the ``(n, 1)`` weight column (one true division
    per element)."""
    return x / w.reshape((w.shape[0],) + (1,) * (x.dim() - 1)).to(x.dtype)
