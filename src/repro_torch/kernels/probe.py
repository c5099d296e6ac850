"""CUDA wrapper for the collective-layer probe kernel.

Replaces the Pallas kernel of the JAX toolchain probe,
``src/repro/kernels/dispatch.py:_probe_shard_map_check_rep`` (body
``kern``, ``pallas_call`` at :133): ``o = x * 2.0`` on an ``(8, 128)`` f32
block.  ``dispatch.probe_collectives`` launches it and sends its output
through the per-rank gossip engine's transport.  The kernel is in
``csrc/probe.cu``.

What bounds a call is the host, not the card: the kernel moves 8 KiB, and
back-to-back calls run as fast as the host issues them.  The host path is
this function's five steps (library, checks, output, launch, its error
check); ``chip_smoke.py`` prints their split beside ``torch.mul(x, 2)``
(``[kernel] probe_scale host path``).  Its largest step was the stream
lookup, which built a ``torch.cuda.Stream`` per call: ``build.stream_of``
now reads the raw stream, ``dispatch``'s device check reads
``Tensor.is_cpu`` (``.device`` built a device object per call), and
``build.require`` reads each attribute once.  The ctypes function is
resolved once, at its first call (``ctypes.CDLL`` keeps it).
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
