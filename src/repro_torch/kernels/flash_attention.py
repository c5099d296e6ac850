"""CUDA wrappers for the flash-attention forward kernels.

Replace the Pallas kernel ``src/repro/kernels/flash_attention.py``:
``flash_attention_single`` (:77, body ``_flash_kernel``) and its GQA
wrapper ``flash_attention`` (:93).  Both kernels read q ``(N, S, H, Dh)``
and k, v ``(N, S, KV, Dh)`` in place, with no transpose and no repeated
KV copy, and write the output in q's dtype.  Any S; the head dims of
:data:`HEAD_DIMS` (f32 64, 80 or 128, bf16 64, 80, 128 or 256); causal or not,
with an optional softcap and an optional sliding ``window`` (a key is
kept iff k_pos > q_pos - window, the JAX ``_chunked_attention``'s local
mask; a query tile skips the key blocks wholly before its first row's
window, as a causal tile stops at its diagonal).  Each (Dh, window or
not) pair is a template instance of its own, so ``window=None`` runs
the code it ran before windows were added.  The entry follows the
dtype, and nothing else:

* float32: ``csrc/flash_attention.cu`` (library ``flash``), on the
  tensor cores in 3xTF32 (each operand split into two TF32 parts, three
  wgmma products per product; the softmax in f32 on the CUDA cores),
  within 1e-5 of max|out| of the plain version, which runs full-f32
  matmuls.  It is bound by operations at a third of the TF32 rate (26.7
  ms for a causal 32768-token qwen3-1.7b layer at an H100 SXM's 495
  TFLOP/s, its 700 W rate; 64.8 ms measured on an NVIDIA H100 80GB HBM3
  at 700.00 W, ``chip_smoke.py``); one
  consumer and one producer warpgroup per 64 query rows, 193 KB of
  shared memory and up to 255 registers a thread at Dh 128 (the budget
  is in the source's note); at Dh 80 (hubert-xlarge) Q's and K's rows take
  three 32-column boxes and P V runs at n80;
* bfloat16: ``csrc/flash_attention_sm90.cu`` (library ``flash_tc``), on
  the tensor cores (wgmma, TMA loads), with P rounded to bf16 before P V,
  held to the plain version (``ref.flash_attention_ref``, which rounds at
  the same points) by :data:`FLASH_BF16_RTOL` and
  :data:`FLASH_BF16_ULP_SHARE` through :func:`bf16_gap`.  At Dh 64 and
  128: 3 K/V stages, 225 KB of shared memory at Dh 128, the block's P V
  apart from the output (240 registers a consumer thread).  At Dh 256 a
  128-row Q tile is 64 KB and one K or V block 64 KB: Q, one K slot and
  one V slot, each with its own barriers (192 KB), so K(j+1) loads while
  V(j) is read; the output (128 registers) is rescaled by alpha before
  P V accumulates into it, with no separate P V.  At Dh 80 a row takes
  the Dh 128 layout (two 64-column boxes; TMA fills columns 80..127 with
  zeros): Q K^T reads the 80 columns, P V runs at n128 and drops the
  padded columns, so at most 77% of the operations bound.

Neither has a backward: the wrapper refuses inputs that need a gradient.
"""
from __future__ import annotations

import collections
import math

import torch

from . import build

#: dtype -> the head dims its kernel takes
HEAD_DIMS = {torch.float32: (64, 80, 128), torch.bfloat16: (64, 80, 128, 256)}
#: dtype -> (library, entry)
_ENTRY = {torch.float32: ("flash", "flash_attention_f32"),
          torch.bfloat16: ("flash_tc", "flash_attention_bf16_tc")}
#: both kernels load 16 bytes at a time (the bf16 one by TMA), so every
#: base address is 16-byte aligned
LOAD_ALIGN = 16

#: Contract (a), bf16: the kernel against its plain version on the same
#: inputs, max|d| / max|want| and the share of elements more than one bf16
#: ulp apart.  On an H100 the sound kernel read at most 2.6e-3 and 2.0e-3
#: (``chip_smoke.py``'s bf16 cases, S up to 32768); kernels with one
#: deliberate fault (``chip_flash_faults.py``) read 0.17 or more (the alpha
#: rescale skipped on one block; the last K/V block read one stage stale)
#: and a share of 0.22 or more (P truncated, not rounded).
FLASH_BF16_RTOL = 8e-3
FLASH_BF16_ULP_SHARE = 1e-2
#: Contract (b), bf16: the plain version (P rounded to bf16) against the
#: f32-P result on the same inputs, a loose sanity bound on max|d| /
#: max|want|: it read 1.9e-3 to 6.0e-3 (on the card and in the CPU tests),
#: and 0.35 or more with the alpha rescale skipped on one block.
FLASH_BF16_F32P_RTOL = 2e-2


def bf16_gap(got, want):
    """How far a bf16 attention output is from another: ``(max|got - want|
    / max|want|, share of elements more than one bf16 ulp apart)``, the ulp
    (2^(e - 7) for magnitudes in [2^e, 2^(e+1))) taken at the larger
    magnitude of the two."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    rel = float(d.max()) / max(float(w.abs().max()), 1e-30)
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return rel, float((d > ulp).float().mean())


def _check(q, k, v, window=None) -> None:
    """Everything the kernels assume that a tensor's metadata shows; raises
    before any library is loaded."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (N, S, H, Dh) and k, v (N, S, KV, Dh), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    N, S, H, Dh = q.shape
    KV = k.shape[2]
    if q.dtype not in _ENTRY:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: expected {q.dtype}, got {t.dtype}")
        if name != "q" and tuple(t.shape) != (N, S, KV, Dh):
            raise ValueError(f"{name}: expected shape {(N, S, KV, Dh)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.data_ptr() % LOAD_ALIGN:
            raise ValueError(f"{name}: the kernels' loads need a "
                             f"{LOAD_ALIGN}-byte aligned base address")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    if Dh not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim {Dh}: the {str(q.dtype)[6:]} kernel "
                         f"takes {HEAD_DIMS[q.dtype]}")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: expected None or >= 1")
    if S < 1 or N * H > 65535:
        raise ValueError(f"S={S}, N*H={N * H}: need S >= 1 and N*H <= 65535 "
                         f"(the kernel grid's y dimension)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash-attention kernel has no backward")


def variant(dtype, head_dim: int, window) -> str:
    """The name a launch is counted under in ``flash_attention.variants``:
    "bf16_dh80", "bf16_dh256", "f32_dh64_window", ..."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    return f"{name}_dh{head_dim}" + ("" if window is None else "_window")


def flash_attention(q, k, v, *, causal: bool = True, softcap=None,
                    window=None):
    """q: (N, S, H, Dh); k, v: (N, S, KV, Dh) -> (N, S, H, Dh), launched
    on the current stream.  ``window`` (None or >= 1) keeps a key iff
    k_pos > q_pos - window.  Each launch adds one to ``launches`` and to
    its :func:`variant`'s count in ``variants``."""
    _check(q, k, v, window)
    library, entry = _ENTRY[q.dtype]
    lib = build.load_library(library)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: expected a CUDA tensor on q's device, "
                             f"got {t.device}")
    N, S, H, Dh = q.shape
    out = torch.empty_like(q)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N, S, H,
        k.shape[2], Dh, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), 1.0 / math.sqrt(Dh), build.stream_of(q))
    build.check_launch(lib, code, "flash_attention")
    flash_attention.launches += 1
    flash_attention.variants[variant(q.dtype, Dh, window)] += 1
    return out


flash_attention.launches = 0
flash_attention.variants = collections.Counter()
