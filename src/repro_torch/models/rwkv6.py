"""The RWKV-6 "Finch" block of the "ssm" family (rwkv6-3b), the JAX
package's ``src/repro/models/rwkv6.py`` on node-stacked tensors:
attention-free, a time-mix (the WKV recurrence) and a channel-mix.

Per head (k, v in R^P), with the f32 state S in R^{P x P}:

    out_t = r_t^T (diag(u) k_t v_t^T + S_t)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T          (w_t data-dependent)

The recurrence runs in one launch of the hand-written WKV6 kernel
(``kernels/wkv6.py``, through ``dispatch.wkv6``; its plain version,
``ref.wkv6_ref``, on the CPU), where JAX runs a ``lax.scan`` over the
tokens.  Both mixes shift the token stream by one: the first token's
predecessor is the carried-in tail (a decode step's cache), or zeros.
The tails a block hands on are the last token of each mix's input, which
is the block's *normed* stream (``rms_norm(x, ln1)``, ``rms_norm(x,
ln2)``), in the compute dtype; the WKV state stays f32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import dispatch

from . import layers as L

LORA_R = 32     # low-rank size of the data-dependent mixes and decay


def heads(cfg) -> Tuple[int, int]:
    """(H, P): the WKV heads and their size."""
    H = cfg.n_heads if cfg.n_heads > 0 else cfg.d_model // 64
    return H, cfg.d_model // H


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """One block's time-mix ("tm/...") and channel-mix ("cm/...") leaves and
    shapes (the JAX ``init_rwkv_timemix`` and ``init_rwkv_channelmix``)."""
    D, F = cfg.d_model, cfg.d_ff
    tm = {"mu_x": (D,), "mu": (5, D), "lora_A": (D, 5 * LORA_R),
          "lora_B": (5, LORA_R, D), "w_r": (D, D), "w_k": (D, D),
          "w_v": (D, D), "w_g": (D, D), "w_o": (D, D), "decay_base": (D,),
          "decay_A": (D, LORA_R), "decay_B": (LORA_R, D), "bonus_u": (D,),
          "ln_out": (D,)}
    cm = {"mu_k": (D,), "mu_r": (D,), "w_k": (D, F), "w_v": (F, D),
          "w_r": (D, D)}
    return {**{f"tm/{k}": v for k, v in tm.items()},
            **{f"cm/{k}": v for k, v in cm.items()}}


def init_leaf(name: str, shape, gen, device) -> torch.Tensor:
    """One leaf drawn by the JAX inits' rules (from a torch Generator, so
    not its values), in f32; ``shape`` may carry leading repeat dims: the
    mixes uniform x 0.1, the LoRA B factors normal x 0.01, decay_base
    linspace(-6, -1, D), bonus_u normal x 0.1, ln_out zeros, the
    projections fan-in-scaled normal."""
    if name in ("mu_x", "mu", "mu_k", "mu_r"):
        return torch.rand(shape, generator=gen, device=device) * 0.1
    if name == "decay_base":
        d = torch.linspace(-6.0, -1.0, shape[-1], device=device)
        return d.expand(shape).clone()
    if name == "ln_out":
        return torch.zeros(shape, device=device)
    x = torch.randn(shape, generator=gen, device=device)
    if name in ("lora_B", "decay_B"):
        return x * 0.01
    if name == "bonus_u":
        return x * 0.1
    return x / math.sqrt(shape[-2])


def init_rwkv_timemix(gen, cfg, device) -> Dict[str, torch.Tensor]:
    """One time-mix's f32 leaves (no node dimension), by :func:`init_leaf`."""
    return {k[3:]: init_leaf(k[3:], s, gen, device)
            for k, s in sorted(param_shapes(cfg).items()) if k[:3] == "tm/"}


def init_rwkv_channelmix(gen, cfg, device) -> Dict[str, torch.Tensor]:
    """One channel-mix's f32 leaves (no node dimension), by
    :func:`init_leaf`."""
    return {k[3:]: init_leaf(k[3:], s, gen, device)
            for k, s in sorted(param_shapes(cfg).items()) if k[:3] == "cm/"}


def _shifted(x, x_prev_last):
    """The token stream shifted by one: (n, B, S, D), its first row the
    carried-in tail (n, B, D), or zeros."""
    first = (torch.zeros_like(x[:, :, :1]) if x_prev_last is None
             else x_prev_last[:, :, None])
    return torch.cat([first, x[:, :, :-1]], dim=2)


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift interpolation: five mixed streams (r, k,
    v, g, w), each (n, B, S, D)."""
    n, B, S, _ = x.shape
    xx = x_prev - x
    base = x + xx * L.per_node(p["mu_x"], 4)
    a = torch.tanh(L.matmul(base, p["lora_A"])).reshape(n, B, S, 5, LORA_R)
    dyn = torch.einsum("nbsir,nird->nbsid", a, p["lora_B"])     # (n,B,S,5,D)
    mixes = p["mu"][:, None, None] + dyn
    return [x + xx * mixes[:, :, :, i] for i in range(5)]


def timemix_forward(p, x, cfg, x_prev_last=None, state=None):
    """x: (n, B, S, D), the normed stream; ``x_prev_last`` (n, B, D) and
    ``state`` (n, B, H, P, P) f32 carried in (a decode step), or None.
    Returns (out (n, B, S, D), (the last token of x, the final state))."""
    n, B, S, D = x.shape
    H, P = heads(cfg)
    xr, xk, xv, xg, xw = _ddlerp(p, x, _shifted(x, x_prev_last))
    r = L.matmul(xr, p["w_r"]).reshape(n * B, S, H, P)
    k = L.matmul(xk, p["w_k"]).reshape(n * B, S, H, P)
    v = L.matmul(xv, p["w_v"]).reshape(n * B, S, H, P)
    g = L.silu(L.matmul(xg, p["w_g"]))
    dec = L.per_node(p["decay_base"], 4) + L.matmul(
        torch.tanh(L.matmul(xw, p["decay_A"])), p["decay_B"])
    w = torch.exp(-torch.exp(dec.float())).reshape(n * B, S, H, P)
    u = p["bonus_u"].float().reshape(n, 1, H, P).expand(
        n, B, H, P).contiguous().view(n * B, H, P)
    if state is not None:
        state = state.reshape(n * B, H, P, P).contiguous()
    out, final = dispatch.wkv6(r, k, v, w, u, state)
    out = out.reshape(n, B, S, D).to(x.dtype)
    out = L.rms_norm(out, L.per_node(p["ln_out"], 4), cfg.norm_eps) * g
    return L.matmul(out, p["w_o"]), (x[:, :, -1], final.reshape(n, B, H, P, P))


def channelmix_forward(p, x, x_prev_last=None):
    """The channel mix over a sequence (n, B, S, D); returns (out, the last
    token of x)."""
    xx = _shifted(x, x_prev_last) - x
    xk = x + xx * L.per_node(p["mu_k"], 4)
    xr = x + xx * L.per_node(p["mu_r"], 4)
    k = torch.square(torch.relu(L.matmul(xk, p["w_k"])))
    return (torch.sigmoid(L.matmul(xr, p["w_r"])) * L.matmul(k, p["w_v"]),
            x[:, :, -1])


def cache_shapes(cfg, batch: int) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One block's decode cache leaves: name -> (per-node shape, whether
    the leaf is f32; the others take the compute dtype)."""
    H, P = heads(cfg)
    D = cfg.d_model
    return {"wkv": ((batch, H, P, P), True), "shift_tm": ((batch, D), False),
            "shift_cm": ((batch, D), False)}


def init_rwkv_cache(cfg, batch: int, dtype, device, n_nodes: int = 1):
    """Zeroed decode cache of one block (the JAX ``init_rwkv_cache``): the
    f32 WKV state and the two shift tails, (n, *shape) leaves."""
    return {k: torch.zeros((n_nodes,) + shape, device=device,
                           dtype=torch.float32 if f32 else dtype)
            for k, (shape, f32) in cache_shapes(cfg, batch).items()}
