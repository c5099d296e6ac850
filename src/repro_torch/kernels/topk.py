"""CUDA wrapper for the per-row top-k selection-mask kernel.

Replaces the Pallas kernel ``src/repro/kernels/topk.py:block_topk_mask``
(:50, body ``_block_topk_kernel``): per row of an ``(R, C)`` f32 tile,
24 bisection steps on ``count(|x| >= mid) >= k`` give a threshold, and
the mask keeps every ``|x|`` at or above it (k elements, plus ties).  The
kernel, one warp per row with the row in registers, is in
``csrc/block_topk.cu``.
"""
from __future__ import annotations

import torch

from . import build

LANES = 128
#: the widest row the kernel keeps in registers (32 values per lane)
MAX_COLS = 1024


def block_topk_mask(x, k: int):
    """x: (R, C) contiguous f32, C a multiple of 128 up to 1024 ->
    (mask (R, C) f32 in {0, 1}, thresholds (R,) f32)."""
    lib = build.load_library("topk")
    if x.dim() != 2:
        raise ValueError(f"x: expected (R, C), got {tuple(x.shape)}")
    rows, cols = x.shape
    if cols % LANES or not LANES <= cols <= MAX_COLS:
        raise ValueError(f"C={cols}: the kernel takes a multiple of {LANES} "
                         f"up to {MAX_COLS}")
    build.require(x, "x", torch.float32)
    if x.data_ptr() % 16:
        raise ValueError("x: expected a 16-byte aligned tensor")
    if not -2 ** 31 <= k < 2 ** 31:
        raise ValueError(f"k={k} outside the int32 range")
    mask = torch.empty_like(x)
    thresh = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if rows:
        build.check_launch(lib, lib.block_topk_mask(
            x.data_ptr(), int(k), mask.data_ptr(), thresh.data_ptr(), rows,
            cols, build.stream_of(x)), "block_topk_mask")
        block_topk_mask.launches += 1
    return mask, thresh


block_topk_mask.launches = 0
