"""CUDA wrapper for the collective-layer probe kernel.

Replaces the Pallas kernel of the JAX toolchain probe,
``src/repro/kernels/dispatch.py:_probe_shard_map_check_rep`` (body
``kern``, ``pallas_call`` at :133): ``o = x * 2.0`` on an ``(8, 128)`` f32
block.  ``dispatch.probe_collectives`` launches it and sends its output
through the per-rank gossip engine's transport.  The kernel is in
``csrc/probe.cu``.
"""
from __future__ import annotations

import torch

from . import build

#: the block the JAX probe traces
PROBE_SHAPE = (8, 128)


def probe_scale(x):
    """x: contiguous f32 CUDA tensor -> x * 2, allocated here."""
    lib = build.load_library("probe")
    build.require(x, "x", torch.float32)
    out = torch.empty_like(x)
    build.check_launch(lib, lib.probe_scale(x.data_ptr(), out.data_ptr(),
                                            x.numel(), build.stream_of(x)),
                       "probe_scale")
    probe_scale.launches += 1
    return out


probe_scale.launches = 0
