"""CUDA wrapper for the fused CHOCO error-feedback update kernel.

Replaces the Pallas kernel ``src/repro/kernels/ef_update.py:ef_gossip_update``
(:52): five full-size reads and three writes in one pass,

    x_hat' = x_hat + q_self
    s'     = s + (w_self q_self + w_nbr q_nbr)
    x'     = x_half + gamma (s' - x_hat')

with the s' association kept (it is part of the contract).  The buffers
are node-stacked ``(n, L)``; ``w_self`` and ``w_nbr`` are ``(n,)``, node
i's weights (the JAX engine gathers node i's scalar by its index inside
``shard_map``): a uniform schedule passes filled vectors, one rank of the
per-rank engine a vector of length 1.  The outputs are written over
``x_half``, ``x_hat`` and ``s``, which saves three bucket-sized buffers
at the exchange's peak.  The kernel is in ``csrc/gossip_kernels.cu``.
"""
from __future__ import annotations

import torch

from . import build


def ef_update(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
              gamma: float):
    """Five ``(n, L)`` contiguous f32 CUDA tensors, no two of them the same
    memory, two ``(n,)`` f32 weight vectors on the same device and the
    scalar gamma; updates ``x_half`` (to x'), ``x_hat`` and ``s`` in place
    and returns them."""
    lib = build.load_library("gossip")
    shape = x_half.shape
    if x_half.dim() != 2:
        raise ValueError(f"ef_update: expected (n, L) buffers, got "
                         f"{tuple(shape)}")
    ins = (("x_half", x_half), ("x_hat", x_hat), ("s", s),
           ("q_self", q_self), ("q_nbr", q_nbr))
    for name, t in ins:
        build.require(t, name, torch.float32, shape)
    for name, t in (("w_self", w_self), ("w_nbr", w_nbr)):
        build.require(t, name, torch.float32, shape[:1])
        if t.device != x_half.device:
            raise ValueError(f"ef_update: {name} is on {t.device}, the "
                             f"buffers on {x_half.device}")
    if len({t.data_ptr() for _, t in ins}) < len(ins):
        raise ValueError("ef_update: x_half, x_hat, s, q_self and q_nbr must "
                         "be five distinct buffers")
    code = lib.ef_update(x_half.data_ptr(), x_hat.data_ptr(), s.data_ptr(),
                         q_self.data_ptr(), q_nbr.data_ptr(), w_self.data_ptr(),
                         w_nbr.data_ptr(), float(gamma), shape[0], shape[1],
                         build.stream_of(x_half))
    build.check_launch(lib, code, "ef_update")
    ef_update.launches += 1
    return x_half, x_hat, s


ef_update.launches = 0
