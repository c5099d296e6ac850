"""Plain PyTorch versions of every kernel of the gossip hot path.

Each function computes exactly what its CUDA kernel computes, one
PyTorch operation per arithmetic step (so no two steps fuse into an FMA),
on node-stacked buffers: row i of an ``(n, L)`` tensor is gossip node
i's bucket buffer, and per-node scalars are ``(n,)`` tensors.

``dispatch.py`` routes CPU tensors here; on the card these are the
versions ``chip_smoke.py`` holds the kernels against.
"""
from __future__ import annotations

import torch


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


def ef_update_ref(x_half, x_hat, s, q_self, q_nbr, w_self: float,
                  w_nbr: float, gamma: float):
    """CHOCO error-feedback update (Algorithm 6 lines 8-10):

        x_hat' = x_hat + q_self
        s'     = s + (w_self * q_self + w_nbr * q_nbr)
        x'     = x_half + gamma * (s' - x_hat')

    The s' association is part of the contract.  Returns (x', x_hat', s')."""
    x_hat_n = x_hat + q_self
    s_n = s + (w_self * q_self + w_nbr * q_nbr)
    x_n = x_half + gamma * (s_n - x_hat_n)
    return x_n, x_hat_n, s_n
