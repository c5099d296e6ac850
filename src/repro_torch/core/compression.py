"""Compression operators Q (paper §3.3-§3.5, Assumption 1).

Every operator satisfies  E_Q ||Q(x) - x||^2 <= (1 - omega) ||x||^2  with a
known ``omega in (0, 1]``.  The port keeps Identity, QSGD and SignNorm,
each with its ``omega`` and ``wire_bits``.  The per-bucket wire payloads
of QSGD and SignNorm are made by ``comm/packing.py``; the exchange takes
only those two (Identity's uncompressed payload is not ported).

Payloads are node-stacked: ``codes`` is ``(n, dim)`` and ``scale`` is
``(n,)``, one row per gossip node.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import code_dtype  # noqa: F401 (re-exported)


@dataclasses.dataclass
class PackedQuantPayload:
    """Per-coordinate integer codes + one f32 scale per node for a packed
    bucket.  ``codes`` keep the full padded layout (padding quantizes to
    code 0 in place); ``logical`` is what wire accounting charges for."""
    codes: torch.Tensor        # (n, dim) int8 / int16
    scale: torch.Tensor        # (n,) f32
    bits_per_coord: int
    dim: int                   # padded buffer length (= codes.shape[-1])
    logical: int               # unpadded coordinate count

    def dense(self) -> torch.Tensor:
        """codes * scale in f32, through the dequantize kernel on the card."""
        return dispatch.dequantize(self.codes, self.scale)

    def wire_bits(self) -> int:
        return int(self.logical) * self.bits_per_coord + 32


class Compressor:
    """Base class: ``omega`` (Assumption 1) and ``wire_bits`` per vector."""

    name: str = "base"
    #: True if the operator uses randomness (needs a dither / generator)
    stochastic: bool = True

    def omega(self, d: int) -> float:
        raise NotImplementedError

    def wire_bits(self, d: int) -> int:
        raise NotImplementedError


class Identity(Compressor):
    """No-op compressor: Q(x) = x (omega = 1, exact gossip baseline)."""

    name = "identity"
    stochastic = False

    def omega(self, d):
        return 1.0

    def wire_bits(self, d):
        return 32 * d


def code_bits(s: int) -> int:
    """Bits per QSGD coordinate: ceil(log2(2s+1)) magnitude + 1 sign."""
    return int(math.ceil(math.log2(2 * s + 1))) + 1


class QSGD(Compressor):
    """qsgd_s random quantization, rescaled by 1/tau so that (7) holds with
    omega = 1/tau, tau = 1 + min(d/s^2, sqrt(d)/s) (the unrescaled variant
    is not ported).

        qsgd_s(x) = sign(x) * ||x|| / (s*tau) * floor(s |x| / ||x|| + xi)
    """
    name = "qsgd"

    def __init__(self, s: int):
        self.s = int(s)

    def _tau(self, d):
        s = self.s
        return 1.0 + min(d / (s * s), math.sqrt(d) / s)

    def omega(self, d):
        return 1.0 / self._tau(d)

    def wire_bits(self, d):
        return d * code_bits(self.s) + 32


class SignNorm(Compressor):
    """Scaled sign: Q(x) = ||x||_1 / d * sign(x).  Biased; omega >= 1/d."""
    name = "sign"
    stochastic = False

    def omega(self, d):
        return 1.0 / d

    def wire_bits(self, d):
        return d + 32


_REGISTRY = {
    "identity": lambda **kw: Identity(),
    "qsgd": lambda **kw: QSGD(**kw),
    "sign": lambda **kw: SignNorm(),
}


def make_compressor(name: str, **kwargs) -> Compressor:
    """Factory: make_compressor('qsgd', s=16).  Only identity, qsgd and
    sign are ported."""
    if name not in _REGISTRY:
        raise ValueError(f"compressor {name!r} is not ported; the port has "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
