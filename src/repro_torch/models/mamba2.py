"""The Mamba2 (SSD) mixer of the "hybrid" family (zamba2-1.2b), the JAX
package's ``src/repro/models/mamba2.py`` on node-stacked tensors.

Per head h with state N and head dim P:

    h_t = a_t h_{t-1} + b_t x_t^T        (h in R^{N x P}, a_t = exp(dt_t A))
    y_t = c_t^T h_t + D x_t

The full-sequence pass is JAX's chunked form (state-space duality): the
work inside a chunk of ``ssm.chunk`` tokens is matrix products (einsums in
f32), and only the recurrence across chunks is a loop, over S / chunk
chunks, in JAX's order (the state entering chunk c, then h * decay +
chunk c's summary).  No kernel: JAX computes all of this as jnp outside
any Pallas kernel.  The three-operand einsums of the JAX text run as two
products each (the pair that keeps the contracted index first), which
adds in another order than XLA: f32 differences of a few ulp.  The chunked
pass runs in a profiler range ``mamba.ssd``, by which ``chip_smoke.py``
splits a profiled prefill (it costs next to nothing when no profiler
runs).

Activations carry the node dimension first, ``(n, B, S, ...)``, and every
leaf ``(n, *shape)``, as in ``layers.py``.  The decode cache keeps JAX's
choices: the SSM state in the cache's (compute) dtype, rounded after each
step and after a prefill, and the conv tails as the last ``d_conv - 1``
pre-activation projections.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import layers as L


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, head dim P, state N) of the mixer."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return di, di // s.head_dim, s.head_dim, s.d_state


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """One mixer's leaves and shapes (the JAX ``init_mamba``)."""
    s, D = cfg.ssm, cfg.d_model
    di, H, _, N = dims(cfg)
    return {"w_x": (D, di), "w_z": (D, di), "w_B": (D, N), "w_C": (D, N),
            "w_dt": (D, H), "conv_x": (s.d_conv, di),
            "conv_B": (s.d_conv, N), "conv_C": (s.d_conv, N), "A_log": (H,),
            "D": (H,), "dt_bias": (H,), "norm": (di,), "w_out": (di, D)}


def init_leaf(name: str, shape, gen, device) -> torch.Tensor:
    """One leaf drawn by the JAX ``init_mamba``'s rule (from a torch
    Generator, so not its values), in f32; ``shape`` may carry leading
    repeat dims.  A_log = log(linspace(1, 16, H)), D ones, dt_bias and
    norm zeros, the convs normal x 0.1, the projections fan-in-scaled
    normal."""
    if name == "A_log":
        h = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return h.expand(shape).clone()
    if name == "D":
        return torch.ones(shape, device=device)
    if name in ("dt_bias", "norm"):
        return torch.zeros(shape, device=device)
    x = torch.randn(shape, generator=gen, device=device)
    if name.startswith("conv_"):
        return x * 0.1
    return x / math.sqrt(shape[-2])


def init_mamba(gen, cfg, device) -> Dict[str, torch.Tensor]:
    """One mixer's f32 leaves (no node dimension), by :func:`init_leaf`."""
    return {name: init_leaf(name, shape, gen, device)
            for name, shape in sorted(param_shapes(cfg).items())}


def _segsum(a):
    """a: (..., Q) log-decays -> (..., Q, Q) lower-triangular cumulative
    sums L[i, j] = sum_{k=j+1..i} a_k (i >= j), -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return seg.masked_fill_(~mask, -math.inf)


def _causal_conv(x, w, d_conv: int):
    """Depthwise causal conv.  x: (n, B, S, C), w: (n, d_conv, C)."""
    S = x.shape[2]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    return sum(pad[:, :, i:i + S] * w[:, None, None, i] for i in range(d_conv))


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD over a flat batch (the port's n * B sequences).
    x: (Z, S, H, P); dt: (Z, S, H) f32; A: (Z, H) or (H,) f32 negative
    decay rates; Bm, Cm: (Z, S, N) f32 (shared across heads).  Returns
    y (Z, S, H, P) f32 and the final state (Z, H, N, P) f32."""
    Z, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} % chunk {Q} != 0")
    nc = S // Q
    xc = x.reshape(Z, nc, Q, H, P)
    dtc = dt.reshape(Z, nc, Q, H)
    Bc = Bm.reshape(Z, nc, Q, N)
    Cc = Cm.reshape(Z, nc, Q, N)

    a = dtc * A.expand(Z, H)[:, None, None, :]        # (Z, nc, Q, H)
    a_cum = torch.cumsum(a, dim=2)

    # 1. intra-chunk: y = (C B^T * decay * causal) @ (dt x)
    Lmat = _segsum(a.transpose(2, 3)).exp_()          # (Z, nc, H, Q, Q)
    CB = torch.einsum("zcqn,zckn->zcqk", Cc, Bc)       # (Z, nc, Q, Q)
    xdt = xc * dtc[..., None]                         # (Z, nc, Q, H, P)
    Lmat.mul_(CB[:, :, None])
    y = torch.einsum("zchqk,zckhp->zcqhp", Lmat, xdt)
    del Lmat

    # 2. chunk summary states: sum_t decay_to_end B_t (dt x)_t
    decay_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)           # (Z,nc,Q,H)
    states = torch.einsum("zcqn,zcqhp->zchnp", Bc,
                          decay_end[..., None] * xdt)             # (Z,nc,H,N,P)

    # 3. inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(a_cum[:, :, -1, :])[..., None, None]  # (Z,nc,H,1,1)
    h = torch.zeros((Z, H, N, P), dtype=torch.float32, device=x.device)
    h_in = torch.empty((Z, nc, H, N, P), dtype=torch.float32, device=x.device)
    for c in range(nc):
        h_in[:, c] = h                               # the state entering c
        h = torch.addcmul(states[:, c], h, chunk_decay[:, c])

    # 4. inter-chunk contribution: y += C_t decay_from_start h_in
    y += torch.einsum("zcqn,zchnp->zcqhp", Cc, h_in) * torch.exp(a_cum)[..., None]
    return y.reshape(Z, S, H, P), h


def _heads(t, n, B):
    """(n, H) per-node head values -> (n B, 1, H, 1), against (Z, S, H, P)."""
    return t[:, None, None, :, None].expand(n, B, 1, t.shape[-1], 1).reshape(
        n * B, 1, t.shape[-1], 1)


def mamba_forward(p, x, cfg, want_cache: bool = False):
    """Full-sequence mixer.  x: (n, B, S, D) -> (n, B, S, D), or (out,
    cache) with ``want_cache`` (a prefill): the cache's leaves "ssm" (n,
    B, H, N, P) in x's dtype and "conv_x", "conv_B", "conv_C", the last
    ``d_conv - 1`` pre-activation projections (n, B, d_conv - 1, C)."""
    s = cfg.ssm
    n, B, S, D = x.shape
    di, H, P, N = dims(cfg)
    xz_raw = L.matmul(x, p["w_x"])                    # (n, B, S, di)
    z = L.matmul(x, p["w_z"])
    B_raw = L.matmul(x, p["w_B"])                     # (n, B, S, N)
    C_raw = L.matmul(x, p["w_C"])
    dt = L.matmul(x, p["w_dt"])                       # (n, B, S, H)

    xz = L.silu(_causal_conv(xz_raw, p["conv_x"], s.d_conv))
    Bm = L.silu(_causal_conv(B_raw, p["conv_B"], s.d_conv))
    Cm = L.silu(_causal_conv(C_raw, p["conv_C"], s.d_conv))

    dt = F.softplus(dt.float() + L.per_node(p["dt_bias"], 4))
    A = -torch.exp(p["A_log"].float())                # (n, H)
    xh = xz.reshape(n * B, S, H, P)
    with record_function("mamba.ssd"):
        y, final = _ssd_chunked(
            xh, dt.reshape(n * B, S, H),
            A[:, None].expand(n, B, H).reshape(n * B, H),
            Bm.float().reshape(n * B, S, N), Cm.float().reshape(n * B, S, N),
            s.chunk)
    y = y + xh * _heads(p["D"], n, B)
    y = (y.reshape(n, B, S, di) * L.silu(z)).to(x.dtype)
    y = L.rms_norm(y, L.per_node(p["norm"], 4), cfg.norm_eps)
    out = L.matmul(y, p["w_out"]).to(x.dtype)
    if not want_cache:
        return out
    tail = slice(-(s.d_conv - 1), None)
    cache = {"ssm": final.reshape(n, B, H, N, P).to(x.dtype),
             "conv_x": xz_raw[:, :, tail], "conv_B": B_raw[:, :, tail],
             "conv_C": C_raw[:, :, tail]}
    return out, cache


def cache_shapes(cfg, batch: int) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One mixer's decode cache leaves (the JAX ``init_mamba_cache``): name
    -> (per-node shape, whether the leaf is f32: none is, all take the
    compute dtype)."""
    s = cfg.ssm
    di, H, P, N = dims(cfg)
    return {"ssm": ((batch, H, N, P), False),
            "conv_x": ((batch, s.d_conv - 1, di), False),
            "conv_B": ((batch, s.d_conv - 1, N), False),
            "conv_C": ((batch, s.d_conv - 1, N), False)}


def init_mamba_cache(cfg, batch: int, dtype, device, n_nodes: int = 1):
    """Zeroed decode cache of one mixer, (n, *shape) leaves."""
    return {k: torch.zeros((n_nodes,) + shape, dtype=dtype, device=device)
            for k, (shape, _) in cache_shapes(cfg, batch).items()}


def mamba_decode_step(p, x, cache, cfg):
    """One-token recurrent step.  x: (n, B, 1, D); cache as
    :func:`init_mamba_cache`.  Returns (out (n, B, 1, D), the new cache:
    the state rounded to the cache's dtype, the conv windows moved on)."""
    n, B, _, D = x.shape
    di, H, P, N = dims(cfg)
    x0 = x[:, :, 0]
    xz_new = L.matmul(x0, p["w_x"])                   # (n, B, di)
    z = L.matmul(x0, p["w_z"])
    B_new = L.matmul(x0, p["w_B"])
    C_new = L.matmul(x0, p["w_C"])
    dt = L.matmul(x0, p["w_dt"])

    def conv_step(cache_w, new, w):
        window = torch.cat([cache_w, new[:, :, None]], dim=2)   # (n,B,dc,C)
        out = torch.einsum("nbtc,ntc->nbc", window, w)
        return L.silu(out), window[:, :, 1:]

    xz, cx = conv_step(cache["conv_x"], xz_new, p["conv_x"])
    Bm, cB = conv_step(cache["conv_B"], B_new, p["conv_B"])
    Cm, cC = conv_step(cache["conv_C"], C_new, p["conv_C"])

    dt = F.softplus(dt.float() + p["dt_bias"][:, None])         # (n, B, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A[:, None])
    xh = xz.reshape(n, B, H, P).float()
    h = cache["ssm"].float() * a[..., None, None] + (
        Bm.float()[:, :, None, :, None] * (dt[..., None] * xh)[:, :, :, None])
    y = torch.einsum("nbm,nbhmp->nbhp", Cm.float(), h) \
        + xh * p["D"][:, None, :, None]
    y = (y.reshape(n, B, di) * L.silu(z.float())).to(x.dtype)
    y = L.rms_norm(y, L.per_node(p["norm"], 3), cfg.norm_eps)
    out = L.matmul(y, p["w_out"])[:, :, None].to(x.dtype)
    return out, {"ssm": h.to(cache["ssm"].dtype), "conv_x": cx,
                 "conv_B": cB, "conv_C": cC}
