"""CUDA wrapper for the fused CHOCO error-feedback update kernel.

Replaces the Pallas kernel ``src/repro/kernels/ef_update.py:ef_gossip_update``
(:52): five full-size reads and three writes in one pass,

    x_hat' = x_hat + q_self
    s'     = s + (w_self q_self + w_nbr q_nbr)
    x'     = x_half + gamma (s' - x_hat')

with the s' association kept (it is part of the contract).  The kernel is
in ``csrc/gossip_kernels.cu``.
"""
from __future__ import annotations

import torch

from . import build


def ef_update(x_half, x_hat, s, q_self, q_nbr, w_self: float, w_nbr: float,
              gamma: float):
    """Five same-shape contiguous f32 CUDA tensors and three scalars ->
    new (x, x_hat, s), each allocated here."""
    lib = build.load_library()
    shape = x_half.shape
    for name, t in (("x_half", x_half), ("x_hat", x_hat), ("s", s),
                    ("q_self", q_self), ("q_nbr", q_nbr)):
        build.require(t, name, torch.float32, shape)
    outs = [torch.empty(shape, dtype=torch.float32, device=x_half.device)
            for _ in range(3)]
    code = lib.ef_update(x_half.data_ptr(), x_hat.data_ptr(), s.data_ptr(),
                         q_self.data_ptr(), q_nbr.data_ptr(), float(w_self),
                         float(w_nbr), float(gamma), outs[0].data_ptr(),
                         outs[1].data_ptr(), outs[2].data_ptr(),
                         x_half.numel(), build.stream_of(x_half))
    build.check_launch(lib, code, "ef_update")
    ef_update.launches += 1
    return tuple(outs)


ef_update.launches = 0
