"""CUDA wrapper for RWKV-6's WKV recurrence kernel (``csrc/wkv6.cu``,
library ``wkv6``).

It replaces no Pallas kernel: the JAX package runs the recurrence as a
jnp ``lax.scan`` over the tokens (``src/repro/models/rwkv6.py:_wkv_scan``,
:72), which eager PyTorch would run as a Python loop of a few launches a
token.  The kernel computes the scan's function in one launch: one block
per (batch, head), 64 threads, thread q holding column q of the f32 state
in registers, r, k and w staged through shared memory a token at a time.
It is held to its plain version, ``ref.wkv6_ref``, within 1e-5 of
max|out| (FMA contraction on).  The recurrence is serial in the tokens,
so a call costs about S times one step's dependent chain, far above its
bytes bound; ``chip_smoke.py`` prints both and the ms per token.

No backward: the wrapper refuses inputs that need a gradient.
"""
from __future__ import annotations

import collections

import torch

from . import build

#: the head size the kernel takes
HEAD_SIZE = 64
#: compute dtype of r, k, v -> entry
_ENTRY = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}


def wkv6(r, k, v, w, u, state=None):
    """r, k, v: (N, S, H, 64) CUDA tensors in f32 or bf16; w: (N, S, H, 64)
    f32; u: (N, H, 64) f32; state: (N, H, 64, 64) f32 or None (zeros).
    Returns (out (N, S, H, 64) f32, final state (N, H, 64, 64) f32), launched
    on the current stream.  Each launch adds one to ``launches`` and to
    its input dtype's count in ``variants`` ("bf16" or "f32")."""
    if r.dim() != 4:
        raise ValueError(f"r: expected (N, S, H, P), got {tuple(r.shape)}")
    N, S, H, P = r.shape
    if P != HEAD_SIZE:
        raise ValueError(f"head size {P}: the kernel takes {HEAD_SIZE}")
    if r.dtype not in _ENTRY:
        raise ValueError(f"r: expected float32 or bfloat16, got {r.dtype}")
    if S < 1 or N * H > 2 ** 31 - 1:
        raise ValueError(f"S={S}, N*H={N * H}: need S >= 1 and N*H < 2^31")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        raise RuntimeError("the WKV6 kernel has no backward")
    for t, name in ((k, "k"), (v, "v")):
        build.require(t, name, r.dtype, (N, S, H, P))
    build.require(r, "r", r.dtype)
    build.require(w, "w", torch.float32, (N, S, H, P))
    build.require(u, "u", torch.float32, (N, H, P))
    if state is not None:
        build.require(state, "state", torch.float32, (N, H, P, P))
    lib = build.load_library("wkv6")
    out = torch.empty((N, S, H, P), dtype=torch.float32, device=r.device)
    final = torch.empty((N, H, P, P), dtype=torch.float32, device=r.device)
    code = getattr(lib, _ENTRY[r.dtype])(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), out.data_ptr(),
        final.data_ptr(), N, S, H, build.stream_of(r))
    build.check_launch(lib, code, "wkv6")
    wkv6.launches += 1
    wkv6.variants[_ENTRY[r.dtype][len("wkv6_"):]] += 1
    return out, final


wkv6.launches = 0
wkv6.variants = collections.Counter()
