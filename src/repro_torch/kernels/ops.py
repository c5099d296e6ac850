"""Flat-vector wrappers around the wire-code kernels.

Each takes node-stacked flat buffers ``(n, L)`` and adds the reductions
the kernels leave to the caller: the per-node norm and the payload scale.
The reductions run on the whole row (padding is zero, so it adds
nothing); the elementwise pass goes through ``kernels/dispatch.py``.
"""
from __future__ import annotations

import torch

from . import dispatch


def qsgd_compress(x, xi, s: int, tau: float):
    """x, xi: (n, L) f32 -> (codes (n, L) int8/int16, scale (n,) f32),
    scale = ||x_i|| / (s * tau)."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=1))
    inv_norm = torch.where(norm == 0, torch.zeros_like(norm), 1.0 / norm)
    return dispatch.qsgd_codes(x, xi, inv_norm, s), norm / (s * tau)


def sign_compress(x, logical: int):
    """x: (n, L) f32 -> (int8 sign codes, scale = ||x_i||_1 / logical)."""
    scale = torch.sum(torch.abs(x), dim=1) / logical
    return dispatch.sign_codes(x), scale
