"""CUDA wrapper for the flash-attention forward kernel.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py``:
``flash_attention_single`` (:77, body ``_flash_kernel``) and its GQA
wrapper ``flash_attention`` (:93).  The kernel
(``csrc/flash_attention.cu``) reads q ``(N, S, H, Dh)`` and k, v
``(N, S, KV, Dh)`` in place, with no transpose and no repeated KV copy,
computes in f32 and writes the output in q's dtype.  Any S; Dh 64 or 128;
bf16 or f32.  It has no backward: the wrapper refuses inputs that need a
gradient.
"""
from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q, k, v, *, causal: bool = True, softcap=None):
    """q: (N, S, H, Dh); k, v: (N, S, KV, Dh) -> (N, S, H, Dh), launched
    on the current stream."""
    lib = build.load_library("flash")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (N, S, H, Dh) and k, v (N, S, KV, Dh), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    N, S, H, Dh = q.shape
    KV = k.shape[2]
    if q.dtype not in _ENTRY:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    build.require(q, "q", q.dtype)
    build.require(k, "k", q.dtype, (N, S, KV, Dh))
    build.require(v, "v", q.dtype, (N, S, KV, Dh))
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh}: the kernel takes {HEAD_DIMS}")
    if S < 1 or N * H > 65535:
        raise ValueError(f"S={S}, N*H={N * H}: need S >= 1 and N*H <= 65535 "
                         f"(the kernel grid's y dimension)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward")
    out = torch.empty_like(q)
    code = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N, S, H, KV,
        Dh, int(bool(causal)), float(softcap or 0.0), 1.0 / math.sqrt(Dh),
        build.stream_of(q))
    build.check_launch(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
