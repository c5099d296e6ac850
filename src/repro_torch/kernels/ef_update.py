"""CUDA wrappers for the fused CHOCO error-feedback update kernels.

:func:`ef_update` replaces the Pallas kernel
``src/repro/kernels/ef_update.py:ef_gossip_update`` (:52): five full-size
reads and three writes in one pass,

    x_hat' = x_hat + q_self
    s'     = s + (w_self q_self + w_nbr q_nbr)
    x'     = x_half + gamma (s' - x_hat')

with the s' association kept (it is part of the contract).  The buffers
are node-stacked ``(n, L)``; ``w_self`` and ``w_nbr`` are ``(n,)``, node
i's weights (the JAX engine gathers node i's scalar by its index inside
``shard_map``): a uniform schedule passes filled vectors, one rank of the
per-rank engine a vector of length 1.  The outputs are written over
``x_half``, ``x_hat`` and ``s``, which saves three bucket-sized buffers
at the exchange's peak.  The kernels are in ``csrc/gossip_kernels.cu``.

Each row of the five buffers must be contiguous, and the rows may lie
apart: ``x_half``, ``x_hat`` and ``s`` share one row stride and
``q_self`` and ``q_nbr`` another, so the per-leaf engine updates a leaf,
a slot ``buf[:, off:off + L]`` of its bucket, in place.

:func:`ef_update_bf16` is the same update on bf16 EF state (x stays
f32, x_hat and s are bf16; the payloads bf16, or f32 where the per-leaf
engine decodes QSGD and sign payloads), rounded to bf16 where the JAX
engines round it (``ref.ef_update_bf16_ref`` says where).  It has no
Pallas counterpart: JAX runs that update as fused jnp
(``src/repro/comm/gossip.py:_choco_leaf_updates``), and the port runs no
plain version on the card.

:func:`ef_update_pipelined` and :func:`ef_update_bf16_pipelined` are the
pipelined engine's order (``src/repro/comm/pipelined.py:
_pipelined_leaf_updates``, jnp in JAX): x reads the pre-round pair,
``x' = x_half + gamma (s - x_hat)``, then x_hat' and s' as above.

:func:`replica_matching` and :func:`replica_stale` are the two forms of
the topology-process engine's replica update (``src/repro/comm/gossip.py:
make_process_choco_fn`` and ``src/repro/comm/async_gossip.py:
make_async_choco_fn``, jnp in JAX), one kernel, ``replica_update``, with
the form, the state dtype and the payload dtype as template parameters
(``ref.replica_matching_ref`` and ``ref.replica_stale_ref`` say what they
compute).  The matching form moves the EF update's bytes.  The ring form
updates x, x_hat and all R replicas of a bucket in one launch, with
depth-tau rings of increments under bounded staleness; link failures are
its tau = 0 case, the sampled edge mask folded into the rounds' weights.
The replicas', payloads' and ring slots' pointers, the weights and the
rows' delays are passed in device memory (so neither the rounds, tau nor
the node rows are capped), each row reads only the ring slots its delay
reaches, and a thread takes 4 elements where the row length, the strides
and every buffer's alignment allow it.
"""
from __future__ import annotations

import torch

from . import build


def _check(kernel, state_dtype, q_dtypes, x_half, x_hat, s, q_self, q_nbr,
           w_self, w_nbr):
    """The arguments' checks every entry shares: five (n, L) CUDA tensors
    with contiguous rows, x_half f32, x_hat and s ``state_dtype``, the
    payloads one dtype of ``q_dtypes``; x_half, x_hat and s one row
    stride, q_self and q_nbr another; no two the same memory; (n,) f32
    weights on their device.  Returns (q dtype, ld_x, ld_q)."""
    shape = x_half.shape
    if x_half.dim() != 2:
        raise ValueError(f"{kernel}: expected (n, L) buffers, got "
                         f"{tuple(shape)}")
    q_dtype = q_self.dtype
    if q_dtype not in q_dtypes:
        raise ValueError(f"{kernel}: payloads of {q_dtype}, expected one of "
                         f"{', '.join(map(str, q_dtypes))}")
    ptrs = [t.data_ptr() for t in (x_half, x_hat, s, q_self, q_nbr)]
    if len(set(ptrs)) < len(ptrs):
        raise ValueError(f"{kernel}: x_half, x_hat, s, q_self and q_nbr "
                         f"must be five distinct buffers")
    lds = {}
    for name, t, dtype in (("x_half", x_half, torch.float32),
                           ("x_hat", x_hat, state_dtype),
                           ("s", s, state_dtype),
                           ("q_self", q_self, q_dtype),
                           ("q_nbr", q_nbr, q_dtype)):
        lds[name] = build.require_rows(t, name, dtype, shape)
    if not lds["x_half"] == lds["x_hat"] == lds["s"]:
        raise ValueError(f"{kernel}: x_half, x_hat and s must share one row "
                         f"stride, got {lds}")
    if lds["q_self"] != lds["q_nbr"]:
        raise ValueError(f"{kernel}: q_self and q_nbr must share one row "
                         f"stride, got {lds}")
    for name, t in (("w_self", w_self), ("w_nbr", w_nbr)):
        build.require(t, name, torch.float32, shape[:1])
        if t.device != x_half.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the "
                             f"buffers on {x_half.device}")
    return q_dtype, lds["x_half"], lds["q_self"]


def _f32(kernel, pipelined, x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
         gamma):
    lib = build.load_library("gossip")
    _, ld_x, ld_q = _check(kernel, torch.float32, (torch.float32,), x_half,
                           x_hat, s, q_self, q_nbr, w_self, w_nbr)
    n, L = x_half.shape
    code = lib.ef_update(x_half.data_ptr(), x_hat.data_ptr(), s.data_ptr(),
                         q_self.data_ptr(), q_nbr.data_ptr(), w_self.data_ptr(),
                         w_nbr.data_ptr(), float(gamma), int(pipelined), n, L,
                         ld_x, ld_q, build.stream_of(x_half))
    build.check_launch(lib, code, kernel)
    return x_half, x_hat, s


def _bf16(kernel, pipelined, x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
          gamma, mix_in_bf16):
    lib = build.load_library("gossip")
    q_dtype, ld_x, ld_q = _check(kernel, torch.bfloat16,
                                 (torch.bfloat16, torch.float32), x_half,
                                 x_hat, s, q_self, q_nbr, w_self, w_nbr)
    n, L = x_half.shape
    code = lib.ef_update_bf16(
        x_half.data_ptr(), x_hat.data_ptr(), s.data_ptr(), q_self.data_ptr(),
        q_nbr.data_ptr(), int(q_dtype == torch.float32), w_self.data_ptr(),
        w_nbr.data_ptr(), float(gamma), int(bool(mix_in_bf16)),
        int(pipelined), n, L, ld_x, ld_q, build.stream_of(x_half))
    build.check_launch(lib, code, kernel)
    return x_half, x_hat, s


def ef_update(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
              gamma: float):
    """Five ``(n, L)`` f32 CUDA tensors with contiguous rows (x_half,
    x_hat and s one row stride, q_self and q_nbr another), no two of
    them the same memory, two ``(n,)`` f32 weight vectors on the same
    device and the scalar gamma; updates ``x_half`` (to x'), ``x_hat``
    and ``s`` in place and returns them."""
    out = _f32("ef_update", False, x_half, x_hat, s, q_self, q_nbr, w_self,
               w_nbr, gamma)
    ef_update.launches += 1
    return out


def ef_update_pipelined(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                        gamma: float):
    """:func:`ef_update` in the pipelined order: x' reads the pre-round
    ``s - x_hat``."""
    out = _f32("ef_update_pipelined", True, x_half, x_hat, s, q_self, q_nbr,
               w_self, w_nbr, gamma)
    ef_update_pipelined.launches += 1
    return out


def ef_update_bf16(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                   gamma: float, mix_in_bf16: bool):
    """``x_half`` an ``(n, L)`` f32 CUDA tensor, ``x_hat`` and ``s`` bf16
    of its shape and row stride, ``q_self`` and ``q_nbr`` bf16 or f32 of
    its shape (one row stride of their own), no two of the five the same
    memory, two ``(n,)`` f32 weight vectors on the same device, the scalar
    gamma, and whether the weighted sum of bf16 payloads runs in bf16
    (uniform, bf16-valued weights) or in f32 (per-node self weights);
    updates ``x_half`` (to x'), ``x_hat`` and ``s`` in place and returns
    them."""
    out = _bf16("ef_update_bf16", False, x_half, x_hat, s, q_self, q_nbr,
                w_self, w_nbr, gamma, mix_in_bf16)
    ef_update_bf16.launches += 1
    return out


def ef_update_bf16_pipelined(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                             gamma: float, mix_in_bf16: bool):
    """:func:`ef_update_bf16` in the pipelined order: x' =
    fma(gamma, s - x_hat, x_half) over the pre-round pair."""
    out = _bf16("ef_update_bf16_pipelined", True, x_half, x_hat, s, q_self,
                q_nbr, w_self, w_nbr, gamma, mix_in_bf16)
    ef_update_bf16_pipelined.launches += 1
    return out


def _replica_check(kernel, x, h, q_self, states, payloads):
    """The replica update's argument checks: x (n, L) f32 and the EF state
    (x_hat / H_r and the replicas) f32 or bf16, one row stride; the
    payloads one dtype (f32, or bf16 with bf16 state) and one row stride
    of their own; no two buffers the same memory.  Returns (state bf16,
    q f32, ld_x, ld_q)."""
    shape = x.shape
    if x.dim() != 2:
        raise ValueError(f"{kernel}: expected (n, L) buffers, got "
                         f"{tuple(shape)}")
    sd, qd = h.dtype, q_self.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: EF state of {sd}, expected f32 or bf16")
    if qd not in ((torch.float32,) if sd == torch.float32
                  else (torch.float32, torch.bfloat16)):
        raise ValueError(f"{kernel}: payloads of {qd} on {sd} state")
    bufs = [x, h, q_self, *states, *payloads]
    ptrs = [t.data_ptr() for t in bufs]
    if len(set(ptrs)) < len(ptrs):
        raise ValueError(f"{kernel}: every buffer must be distinct memory")
    ld_x = {build.require_rows(t, name, dtype, shape) for name, t, dtype in
            [("x", x, torch.float32), ("x_hat", h, sd)]
            + [("s", t, sd) for t in states]}
    ld_q = {build.require_rows(t, "q", qd, shape)
            for t in (q_self, *payloads)}
    if len(ld_x) != 1 or len(ld_q) != 1:
        raise ValueError(f"{kernel}: x, x_hat and the replicas must share "
                         f"one row stride, the payloads another; got "
                         f"{sorted(ld_x)} and {sorted(ld_q)}")
    return sd == torch.bfloat16, qd == torch.float32, ld_x.pop(), ld_q.pop()


def _row_vector(t, name, rows, device):
    build.require(t, name, torch.float32, (rows,))
    if t.device != device:
        raise ValueError(f"replica_update: {name} is on {t.device}, the "
                         f"buffers on {device}")


def _on_device(values, dtype, device):
    """A small host list on ``device`` without a host sync: staged through
    pinned memory, copied on the current stream ahead of the launch."""
    return torch.tensor(values, dtype=dtype).pin_memory().to(
        device, non_blocking=True)


def replica_update(form: int, x, h, q_self, states, payloads, aux0, aux1,
                   gamma: float, slots=(), tau: int = 0):
    """Launch the replica-update kernel (form 0 matching, 1 the ring form
    with the ring ``slots``: the R tau receive-ring slots, then the tau
    own-ring slots, none at tau 0) on checked arguments; counts the
    launch."""
    lib = build.load_library("gossip")
    bf16, q_f32, ld_x, ld_q = _replica_check(
        "replica_update", x, h, q_self, [*states, *slots], payloads)
    n, L = x.shape
    R = len(states)
    if R < 1 or len(payloads) != R:
        raise ValueError(f"replica_update: {R} replicas and {len(payloads)} "
                         f"payloads, expected one or more of each")
    reps = None
    bufs = (*states, *payloads, *slots)
    if form == 1:
        reps = _on_device([t.data_ptr() for t in bufs], torch.int64,
                          x.device)
    # the ring form moves 4 elements a thread where every buffer allows it
    vec4 = form == 1 and L % 4 == 0 and ld_x % 4 == 0 and ld_q % 4 == 0 \
        and all(t.data_ptr() % (4 * t.element_size()) == 0
                for t in (x, h, q_self, *bufs))
    code = lib.replica_update(
        int(form), x.data_ptr(), h.data_ptr(), q_self.data_ptr(),
        states[0].data_ptr(), payloads[0].data_ptr(),
        0 if reps is None else reps.data_ptr(), R, int(tau), aux0.data_ptr(),
        0 if aux1 is None else aux1.data_ptr(), float(gamma), int(bf16),
        int(q_f32), int(vec4), n, L, ld_x, ld_q, build.stream_of(x))
    build.check_launch(lib, code, "replica_update")
    replica_update.launches += 1


def replica_matching(x, h, s, q_self, q_nbr, send, gv):
    """The matching form on CUDA tensors, in place: ``x`` (n, L) f32;
    ``h`` (H_r) and ``s`` (S_r) f32 or bf16, x's row stride; ``q_self``
    and ``q_nbr`` f32, or bf16 with bf16 state, a row stride of their own;
    ``send`` and ``gv`` (n,) f32 on the same device.  Returns (x, h, s)."""
    n = x.shape[0]
    for name, t in (("send", send), ("gv", gv)):
        _row_vector(t, name, n, x.device)
    replica_update(0, x, h, q_self, [s], [q_nbr], send, gv, 0.0)
    return x, h, s


def replica_stale(x, h, q_self, s_list, q_list, own_ring, rings, w, delays,
                  gamma: float):
    """The ring form on CUDA tensors, in place: ``x`` (n, L) f32, ``h``
    (x_hat) and the R replicas ``s_list`` f32 or bf16, one row stride;
    ``q_self`` and the R received payloads ``q_list`` one dtype and row
    stride; ``own_ring`` the tau own-ring slots and ``rings`` the R lists
    of tau receive-ring slots (state dtype, x's row stride; slot 0 of each
    is overwritten, slots 1.. read where a delay reaches them); ``w``
    (R, n) f32 on the device, the rounds' receive weights (under link
    failures times the sampled edge mask); ``delays`` (R, n) int32 each
    row's round-edge delay, None at tau 0.  Returns (x, h, s_list)."""
    R, n, tau = len(s_list), x.shape[0], len(own_ring)
    build.require(w, "w", torch.float32, (R, n))
    if len(rings) != R or any(len(rg) != tau for rg in rings):
        raise ValueError(f"replica_update: {len(rings)} receive rings for "
                         f"{R} rounds, each of {tau} slots expected")
    rows = [("w", w)]
    if tau:
        build.require(delays, "delays", torch.int32, (R, n))
        rows.append(("delays", delays))
    for name, t in rows:
        if t.device != x.device:
            raise ValueError(f"replica_update: {name} is on {t.device}, "
                             f"the buffers on {x.device}")
    replica_update(1, x, h, q_self, list(s_list), list(q_list), w,
                   delays if tau else None, gamma,
                   slots=[t for rg in rings for t in rg] + list(own_ring),
                   tau=tau)
    return x, h, s_list


ef_update.launches = 0
ef_update_pipelined.launches = 0
ef_update_bf16.launches = 0
ef_update_bf16_pipelined.launches = 0
replica_update.launches = 0
