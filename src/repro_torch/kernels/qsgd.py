"""CUDA wrappers for the QSGD / SignNorm wire-code kernels.

Replace the Pallas kernels of ``src/repro/kernels/qsgd.py``:
``qsgd_quantize_codes`` (:64), ``signnorm_codes`` (:86) and
``qsgd_dequantize`` (:118); ``qsgd_leaf_codes`` has no Pallas
counterpart: it is the per-leaf engine's ``QSGD.compress``
(``src/repro/core/compression.py:336``), which JAX runs as jnp.  Each
wrapper checks its tensors, allocates
the output with ``torch.empty``, launches on the current stream, checks
the launch error and adds one to its ``launches`` count.  The kernels
themselves are in ``csrc/gossip_kernels.cu``.
"""
from __future__ import annotations

import torch

from . import build, ref


def qsgd_codes(x, xi, inv_norm, s: int):
    """x, xi: (n, L) f32; inv_norm: (n,) f32 -> (n, L) int8 (s <= 127)
    or int16 codes  sign(x) * floor(|x| * inv_norm * s + xi)."""
    lib = build.load_library("gossip")
    if x.dim() != 2:
        raise ValueError(f"x: expected (n, L), got {tuple(x.shape)}")
    n, length = x.shape
    build.require(x, "x", torch.float32)
    build.require(xi, "xi", torch.float32, x.shape)
    build.require(inv_norm, "inv_norm", torch.float32, (n,))
    if n > 65535:
        raise ValueError(f"{n} nodes exceed the kernel grid's 65535 rows")
    if not 1 <= s <= 32767:
        raise ValueError(f"qsgd levels s={s} outside the int16 code range")
    out = torch.empty((n, length), dtype=ref.code_dtype(s), device=x.device)
    fn = lib.qsgd_codes_i8 if out.dtype == torch.int8 else lib.qsgd_codes_i16
    build.check_launch(lib, fn(x.data_ptr(), xi.data_ptr(), inv_norm.data_ptr(),
                               float(s), out.data_ptr(), n, length,
                               build.stream_of(x)), "qsgd_codes")
    qsgd_codes.launches += 1
    return out


def qsgd_leaf_codes(x, xi, norm, s: int):
    """x: (n, L) f32 or bf16; xi: (n, L) f32; norm: (n,) f32 (a zero norm
    given as 1) -> (n, L) int8 (s <= 127) or int16 codes
    sign(x) * floor(s |x| / norm + xi), s |x| rounded to bf16 first on
    bf16 input."""
    lib = build.load_library("gossip")
    if x.dim() != 2:
        raise ValueError(f"x: expected (n, L), got {tuple(x.shape)}")
    n, length = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    build.require(x, "x", x.dtype)
    build.require(xi, "xi", torch.float32, x.shape)
    build.require(norm, "norm", torch.float32, (n,))
    if n > 65535:
        raise ValueError(f"{n} rows exceed the kernel grid's 65535")
    if not 1 <= s <= 32767:
        raise ValueError(f"qsgd levels s={s} outside the int16 code range")
    out = torch.empty((n, length), dtype=ref.code_dtype(s), device=x.device)
    build.check_launch(lib, lib.qsgd_leaf_codes(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xi.data_ptr(),
        norm.data_ptr(), float(s), out.data_ptr(),
        int(out.dtype == torch.int16), n, length, build.stream_of(x)),
        "qsgd_leaf_codes")
    qsgd_leaf_codes.launches += 1
    return out


def sign_codes(x):
    """x: (n, L) f32 or bf16 -> (n, L) int8 sign(x)."""
    lib = build.load_library("gossip")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    build.require(x, "x", x.dtype)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    build.check_launch(lib, lib.sign_codes(
        x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
        x.numel(), build.stream_of(x)), "sign_codes")
    sign_codes.launches += 1
    return out


def dequantize(codes, scale):
    """codes: (n, L) int8/int16; scale: (n,) f32 -> (n, L) f32 codes * scale."""
    lib = build.load_library("gossip")
    if codes.dim() != 2:
        raise ValueError(f"codes: expected (n, L), got {tuple(codes.shape)}")
    n, length = codes.shape
    if codes.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"codes: expected int8 or int16, got {codes.dtype}")
    if n > 65535:
        raise ValueError(f"{n} nodes exceed the kernel grid's 65535 rows")
    build.require(codes, "codes", codes.dtype)
    build.require(scale, "scale", torch.float32, (n,))
    out = torch.empty((n, length), dtype=torch.float32, device=codes.device)
    fn = lib.dequantize_i8 if codes.dtype == torch.int8 else lib.dequantize_i16
    build.check_launch(lib, fn(codes.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), n, length,
                               build.stream_of(codes)), "dequantize")
    dequantize.launches += 1
    return out


qsgd_codes.launches = 0
qsgd_leaf_codes.launches = 0
sign_codes.launches = 0
dequantize.launches = 0
