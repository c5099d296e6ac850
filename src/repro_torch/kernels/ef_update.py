"""CUDA wrapper for the fused CHOCO error-feedback update kernel.

Replaces the Pallas kernel ``src/repro/kernels/ef_update.py:ef_gossip_update``
(:52): five full-size reads and three writes in one pass,

    x_hat' = x_hat + q_self
    s'     = s + (w_self q_self + w_nbr q_nbr)
    x'     = x_half + gamma (s' - x_hat')

with the s' association kept (it is part of the contract).  The outputs
are written over ``x_half``, ``x_hat`` and ``s``, which saves three
bucket-sized buffers at the exchange's peak.  The kernel is in
``csrc/gossip_kernels.cu``.
"""
from __future__ import annotations

import torch

from . import build


def ef_update(x_half, x_hat, s, q_self, q_nbr, w_self: float, w_nbr: float,
              gamma: float):
    """Five same-shape contiguous f32 CUDA tensors, no two of them the same
    memory, and three scalars; updates ``x_half`` (to x'), ``x_hat`` and
    ``s`` in place and returns them."""
    lib = build.load_library("gossip")
    shape = x_half.shape
    ins = (("x_half", x_half), ("x_hat", x_hat), ("s", s),
           ("q_self", q_self), ("q_nbr", q_nbr))
    for name, t in ins:
        build.require(t, name, torch.float32, shape)
    if len({t.data_ptr() for _, t in ins}) < len(ins):
        raise ValueError("ef_update: x_half, x_hat, s, q_self and q_nbr must "
                         "be five distinct buffers")
    code = lib.ef_update(x_half.data_ptr(), x_hat.data_ptr(), s.data_ptr(),
                         q_self.data_ptr(), q_nbr.data_ptr(), float(w_self),
                         float(w_nbr), float(gamma), x_half.numel(),
                         build.stream_of(x_half))
    build.check_launch(lib, code, "ef_update")
    ef_update.launches += 1
    return x_half, x_hat, s


ef_update.launches = 0
