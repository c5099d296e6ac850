"""Plain PyTorch versions of every kernel of the port.

The gossip kernels' and the top-k mask kernel's versions compute exactly
what their CUDA kernels compute, one PyTorch operation per arithmetic step (so no two steps fuse
into an FMA), on node-stacked buffers: row i of an ``(n, L)`` tensor is
gossip node i's bucket buffer, and per-node scalars are ``(n,)`` tensors.
:func:`flash_attention_ref` repeats the flash kernel's online softmax
tile by tile; it is held to the kernel within a tolerance.

``dispatch.py`` routes CPU tensors here; on the card these are the
versions ``chip_smoke.py`` holds the kernels against.
"""
from __future__ import annotations

import math

import torch

#: the flash kernel's tile (query rows and key columns) and masked logit,
#: those of the Pallas kernel (block_q = block_k = 128, NEG_INF = -1e30)
FLASH_BLOCK = 128
NEG_INF = -1e30


def code_dtype(s: int) -> torch.dtype:
    """Wire code dtype for s quantization levels: int8 up to 127, int16 above."""
    return torch.int8 if s <= 127 else torch.int16


def qsgd_codes_ref(x, xi, inv_norm, s: int):
    """QSGD wire codes  sign(x) * floor(|x| * inv_norm * s + xi).

    x, xi: (n, L) f32; inv_norm: (n,) f32 (0 for a zero row).  Returns
    int8 codes for s <= 127, int16 above."""
    level = torch.floor(x.abs() * inv_norm[:, None] * float(s) + xi)
    return (torch.sign(x) * level).to(code_dtype(s))


def sign_codes_ref(x):
    """SignNorm wire codes: int8 sign(x)."""
    return torch.sign(x).to(torch.int8)


def dequantize_ref(codes, scale):
    """codes (n, L) int8/int16, scale (n,) f32 -> codes * scale in f32."""
    return codes.to(torch.float32) * scale[:, None]


def block_topk_mask_ref(x, k: int, n_iter: int = 24):
    """Per-row top-k selection mask by threshold bisection, line by line
    the JAX package's oracle.  x: (R, C) f32.  Returns (mask (R, C) f32,
    thresholds (R,) f32); a row keeps between k and k + ties elements."""
    mag = x.abs()
    lo = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    hi = mag.amax(dim=1) + torch.tensor(1e-12, dtype=torch.float32)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        cnt = (mag >= mid[:, None]).sum(dim=1)
        ge = cnt >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return (mag >= lo[:, None]).to(torch.float32), lo


def probe_scale_ref(x):
    """The collective-layer probe's body: x * 2 in f32 (the JAX probe's
    ``o = x * 2.0``)."""
    return x * 2.0


def ef_update_ref(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                  gamma: float):
    """CHOCO error-feedback update (Algorithm 6 lines 8-10), per node row:

        x_hat' = x_hat + q_self
        s'     = s + (w_self * q_self + w_nbr * q_nbr)
        x'     = x_half + gamma * (s' - x_hat')

    Buffers (n, L) f32; ``w_self``, ``w_nbr``: (n,) f32, node i's weights.
    The s' association is part of the contract.  Returns (x', x_hat', s')."""
    x_hat_n = x_hat + q_self
    s_n = s + (w_self[:, None] * q_self + w_nbr[:, None] * q_nbr)
    x_n = x_half + gamma * (s_n - x_hat_n)
    return x_n, x_hat_n, s_n


def flash_attention_ref(q, k, v, *, causal: bool = True, softcap=None):
    """Online-softmax attention, step for step as the flash kernel.

    q: (N, S, H, Dh); k, v: (N, S, KV, Dh), H a multiple of KV: head h
    reads KV head h // (H // KV).  Computed in f32 over 128-wide key
    blocks: the scaled query ``q * (1/sqrt(Dh))``, optional
    ``softcap * tanh(l / softcap)``, the causal mask by index (-1e30), a
    running max, denominator and accumulator, and
    ``acc / max(l, 1e-30)``.  A causal query tile stops at the diagonal
    key block, so key block j updates only the query rows from ``j * 128``
    on.  Any S: the last block is ragged.  Returns (N, S, H, Dh) in q's
    dtype."""
    N, S, H, Dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    f32 = torch.float32
    # (N, KV, rep, S, Dh): the rep query heads that share one KV head
    qf = (q.to(f32) * (1.0 / math.sqrt(Dh))).reshape(
        N, S, KV, rep, Dh).permute(0, 2, 3, 1, 4)
    kf = k.to(f32).permute(0, 2, 1, 3)[:, :, None]          # (N, KV, 1, S, Dh)
    vf = v.to(f32).permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((N, KV, rep, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((N, KV, rep, S), dtype=f32, device=q.device)
    acc = torch.zeros((N, KV, rep, S, Dh), dtype=f32, device=q.device)
    for k0 in range(0, S, FLASH_BLOCK):
        k1 = min(k0 + FLASH_BLOCK, S)
        r0 = k0 if causal else 0
        logits = qf[..., r0:, :] @ kf[..., k0:k1, :].transpose(-1, -2)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        if causal:
            qpos = torch.arange(r0, S, device=q.device)[:, None]
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            logits = torch.where(kpos <= qpos, logits, NEG_INF)
        m_old = m[..., r0:]
        m_new = torch.maximum(m_old, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l_new = l[..., r0:] * alpha + p.sum(dim=-1)
        acc_new = acc[..., r0:, :] * alpha[..., None] + p @ vf[..., k0:k1, :]
        # rows before r0 (earlier query tiles) keep their state
        m = torch.cat([m[..., :r0], m_new], dim=-1)
        l = torch.cat([l[..., :r0], l_new], dim=-1)
        acc = torch.cat([acc[..., :r0, :], acc_new], dim=-2)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(N, S, H, Dh).to(q.dtype)
