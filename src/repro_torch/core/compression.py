"""Compression operators Q (paper §3.3-§3.5, Assumption 1).

Every operator satisfies  E_Q ||Q(x) - x||^2 <= (1 - omega) ||x||^2  with a
known ``omega in (0, 1]``.  The port has every operator of the JAX
package: Identity, RandK, TopK, BlockTopK, QSGD, SignNorm and
RandomizedGossip, each with its ``omega``, ``wire_bits`` and ``stochastic``
flag.  The sparsifiers, Identity and RandomizedGossip also have their
``compress``; the per-bucket wire payloads of QSGD and SignNorm are made
by ``comm/packing.py``.

Payloads are node-stacked: row i of every tensor belongs to gossip node
i, so a payload covers all n nodes' copies of one flat vector.  Indices
are int32 on the wire, as in the JAX package; ``dense()`` widens them to
int64 only for its ``scatter_``.

Random draws are injected, not drawn here: ``RandK.compress`` takes the
sampled positions and ``RandomizedGossip.compress`` the per-node keep
bits (``comm/packing.py`` draws them, or a test hands in the JAX
package's).

``apply(X, rand)`` is the matrix simulators' view (the JAX package's
``_rowwise_compress``): Q applied to each row of an ``(n, d)`` matrix,
dense.  A stochastic operator takes its draw for the whole matrix as
``rand`` (``draw(X, generator)`` makes one from an explicit
``torch.Generator``).  QSGD's and SignNorm's rows go through the port's
codes and dequantize kernels on the card (``kernels/dispatch.py``); top_k
selects through ``ops.topk_rows``, which keeps ``lax.top_k``'s tie rule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import code_dtype  # noqa: F401 (re-exported)


# ---------------------------------------------------------------------------
# Wire payloads (node-stacked)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DensePayload:
    """The vector itself, uncompressed: ``x`` is ``(n, d)``."""
    x: torch.Tensor

    def dense(self) -> torch.Tensor:
        return self.x

    def wire_bits(self) -> int:
        return int(self.x.shape[-1]) * self.x.element_size() * 8


@dataclasses.dataclass
class SparsePayload:
    """k values + k int32 indices per node of a d-dim vector."""
    values: torch.Tensor       # (n, k)
    indices: torch.Tensor      # (n, k) int32
    dim: int

    def dense(self) -> torch.Tensor:
        out = torch.zeros((self.values.shape[0], self.dim),
                          dtype=self.values.dtype, device=self.values.device)
        return out.scatter_(1, self.indices.long(), self.values)

    def wire_bits(self) -> int:
        k = self.values.shape[-1]
        return int(k) * (self.values.element_size() * 8 + 32)


@dataclasses.dataclass
class PackedSparsePayload:
    """Blockwise top-k wire format of a flat buffer: the k largest
    magnitudes of every ``block``-wide row, per node.  The tail row is
    zero-padded, so an index may point past ``dim`` (with value 0)."""
    values: torch.Tensor       # (n, R, k)
    indices: torch.Tensor      # (n, R, k) int32, position within the block
    dim: int                   # flat length reconstructed by dense()
    block: int                 # row width, a multiple of 128

    def dense(self) -> torch.Tensor:
        """(n, dim), contiguous: the full blocks scatter in place, the
        padded tail block through a (n, block) row of its own."""
        n, R, _ = self.values.shape
        full, tail = divmod(self.dim, self.block)
        out = torch.zeros((n, self.dim), dtype=self.values.dtype,
                          device=self.values.device)
        idx = self.indices.long()
        if full:
            out[:, :full * self.block].view(n, full, self.block).scatter_(
                2, idx[:, :full], self.values[:, :full])
        if tail:
            last = torch.zeros((n, self.block), dtype=out.dtype,
                               device=out.device)
            last.scatter_(1, idx[:, full], self.values[:, full])
            out[:, full * self.block:] = last[:, :tail]
        return out

    def wire_bits(self) -> int:
        R, k = self.values.shape[-2:]
        return int(R) * int(k) * (self.values.element_size() * 8 + 32)


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


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

class Compressor:
    """Base class: ``omega`` (Assumption 1) and ``wire_bits`` per vector,
    and the row-wise dense ``apply`` of the matrix simulators."""

    name: str = "base"
    #: True if the operator uses randomness (needs an injected draw)
    stochastic: bool = True

    def draw(self, X: torch.Tensor, generator: torch.Generator):
        """The draw ``apply`` needs for the (n, d) matrix ``X``, made by
        ``generator`` on the generator's device."""
        raise NotImplementedError

    def apply(self, X: torch.Tensor, rand=None) -> torch.Tensor:
        """Q applied to each row of ``X`` (n, d), dense.  ``rand`` is the
        draw of a stochastic operator (:meth:`draw`), moved to X's
        device."""
        if self.stochastic and rand is None:
            raise ValueError(f"{self.name}: a stochastic compressor needs "
                             f"its draw (see draw())")
        return self._apply(X, None if rand is None else rand.to(X.device))

    def _apply(self, X, rand):
        raise NotImplementedError

    def omega(self, d: int) -> float:
        raise NotImplementedError

    def wire_bits(self, d: int) -> int:
        raise NotImplementedError


class Identity(Compressor):
    """No-op compressor: Q(x) = x (omega = 1, exact gossip baseline)."""

    name = "identity"
    stochastic = False

    @staticmethod
    def compress(x):
        return DensePayload(x)

    def _apply(self, X, rand):
        return X

    def omega(self, d):
        return 1.0

    def wire_bits(self, d):
        return 32 * d


def _resolve_k(d: int, k: Optional[int], fraction: Optional[float]) -> int:
    if k is not None:
        return max(1, min(int(k), d))
    return max(1, min(d, int(math.ceil(fraction * d))))


def _one_budget(k, fraction):
    if (k is None) == (fraction is None):
        raise ValueError("give exactly one of k and fraction")


class RandK(Compressor):
    """rand_k sparsification: keep k uniformly random coordinates.  omega = k/d."""
    name = "rand_k"

    def __init__(self, k: Optional[int] = None, fraction: Optional[float] = None,
                 rescale: bool = False):
        _one_budget(k, fraction)
        self.k, self.fraction, self.rescale = k, fraction, rescale

    def compress(self, x, positions, k: Optional[int] = None,
                 logical: Optional[torch.Tensor] = None):
        """x: (n, D); positions: (n, >= k) sampled coordinates per node (the
        first k of a uniform permutation of range(d)).  ``logical`` maps
        them into x (a packed bucket's unpadded coordinates, d of them;
        default range(D)); ``k`` overrides the budget resolved from d."""
        d = x.shape[-1] if logical is None else logical.numel()
        k = _resolve_k(d, self.k, self.fraction) if k is None else k
        idx = positions[:, :k].to(x.device).long()
        if logical is not None:
            idx = logical[idx]
        vals = x.gather(1, idx)
        if self.rescale:
            vals = vals * (d / k)
        return SparsePayload(vals, idx.to(torch.int32), x.shape[-1])

    def draw(self, X, generator):
        """Per row the first k of a uniform permutation of range(d)."""
        n, d = X.shape
        k = _resolve_k(d, self.k, self.fraction)
        return torch.stack([torch.randperm(d, generator=generator,
                                           device=generator.device)[:k]
                            for _ in range(n)])

    def _apply(self, X, rand):
        return self.compress(X, rand).dense()

    def omega(self, d):
        return _resolve_k(d, self.k, self.fraction) / d

    def wire_bits(self, d):
        return _resolve_k(d, self.k, self.fraction) * 64


class TopK(Compressor):
    """top_k sparsification: keep the k largest-magnitude coords.  omega = k/d.
    Deterministic and biased: the class CHOCO supports and DCD/ECD do not."""
    name = "top_k"
    stochastic = False

    def __init__(self, k: Optional[int] = None, fraction: Optional[float] = None):
        _one_budget(k, fraction)
        self.k, self.fraction = k, fraction

    def compress(self, x, k: Optional[int] = None):
        """x: (n, d) -> the k largest |x| per node, in ``lax.top_k``'s
        order (magnitude descending, the lower index first among ties);
        ``k`` overrides the budget resolved from d."""
        from repro_torch.kernels.ops import topk_rows
        d = x.shape[-1]
        idx = topk_rows(x, _resolve_k(d, self.k, self.fraction) if k is None else k)
        return SparsePayload(x.gather(1, idx), idx.to(torch.int32), d)

    def _apply(self, X, rand):
        return self.compress(X).dense()

    def omega(self, d):
        return _resolve_k(d, self.k, self.fraction) / d

    def wire_bits(self, d):
        return _resolve_k(d, self.k, self.fraction) * 64


class BlockTopK(Compressor):
    """Blockwise top-k: keep the k_b largest magnitudes of every
    ``block``-wide row; omega = k_b/block (Assumption 1 per block).
    Blockwise selection commutes with block-aligned concatenation, so
    compressing a packed bucket once equals compressing each leaf."""
    name = "block_top_k"
    stochastic = False

    def __init__(self, k_per_block: Optional[int] = None,
                 fraction: Optional[float] = None, block: int = 128):
        _one_budget(k_per_block, fraction)
        if block % 128:
            raise ValueError("block must be a multiple of the 128-lane unit")
        self.k_per_block, self.fraction, self.block = k_per_block, fraction, block

    def _kb(self) -> int:
        if self.k_per_block is not None:
            return max(1, min(int(self.k_per_block), self.block))
        return max(1, min(self.block, int(math.ceil(self.fraction * self.block))))

    def compress(self, x):
        """x: (n, d) -> PackedSparsePayload of (n, ceil(d/block), k_b)."""
        from repro_torch.kernels.ops import block_topk_select
        vals, idx = block_topk_select(x, self._kb(), block=self.block)
        return PackedSparsePayload(vals, idx, x.shape[-1], self.block)

    def _apply(self, X, rand):
        return self.compress(X).dense()

    def omega(self, d):
        return min(1.0, self._kb() / self.block)

    def wire_bits(self, d):
        n_blocks = -(-d // self.block)
        return n_blocks * self._kb() * 64


def code_bits(s: int) -> int:
    """Bits per QSGD coordinate: ceil(log2(2s+1)) magnitude + 1 sign."""
    return int(math.ceil(math.log2(2 * s + 1))) + 1


class QSGD(Compressor):
    """qsgd_s random quantization (Alistarh et al. 2017), by default
    rescaled by 1/tau so that (7) holds with omega = 1/tau,
    tau = 1 + min(d/s^2, sqrt(d)/s); ``rescale=False`` is the unbiased
    operator of the Q1 and Q2 baselines (tau = 1 in the scale).

        qsgd_s(x) = sign(x) * ||x|| / (s*tau) * floor(s |x| / ||x|| + xi)
    """
    name = "qsgd"

    def __init__(self, s: int, rescale: bool = True):
        self.s = int(s)
        self.rescale = rescale

    def _tau(self, d):
        s = self.s
        return 1.0 + min(d / (s * s), math.sqrt(d) / s)

    def draw(self, X, generator):
        """The uniform dither xi, (n, d) f32."""
        return torch.rand(X.shape, generator=generator,
                          device=generator.device)

    def _apply(self, X, rand):
        from repro_torch.kernels import ops
        d = X.shape[-1]
        codes, scale = ops.qsgd_compress(
            X.to(torch.float32), rand, self.s,
            self._tau(d) if self.rescale else 1.0)
        return dispatch.dequantize(codes, scale)

    def omega(self, d):
        return 1.0 / self._tau(d)

    def wire_bits(self, d):
        return d * code_bits(self.s) + 32


class SignNorm(Compressor):
    """Scaled sign: Q(x) = ||x||_1 / d * sign(x).  Biased; omega >= 1/d."""
    name = "sign"
    stochastic = False

    def _apply(self, X, rand):
        from repro_torch.kernels import ops
        codes, scale = ops.sign_compress(X.to(torch.float32), X.shape[-1])
        return dispatch.dequantize(codes, scale)

    def omega(self, d):
        return 1.0 / d

    def wire_bits(self, d):
        return d + 32


class RandomizedGossip(Compressor):
    """Q(x) = x with probability p, else 0.  omega = p  (paper §3.5)."""
    name = "randomized_gossip"

    def __init__(self, p: float):
        self.p = float(p)

    def compress(self, x, keep):
        """x: (n, d); keep: (n,) bool, one coin per node."""
        keep = keep.to(x.device)[:, None]
        return DensePayload(torch.where(keep, x, torch.zeros_like(x)))

    def draw(self, X, generator):
        """One keep coin per row, (n,) bool."""
        return torch.rand((X.shape[0],), generator=generator,
                          device=generator.device) < self.p

    def _apply(self, X, rand):
        return self.compress(X, rand).dense()

    def omega(self, d):
        return self.p

    def wire_bits(self, d):
        return int(32 * d * self.p)


_REGISTRY = {
    "identity": lambda **kw: Identity(),
    "rand_k": lambda **kw: RandK(**kw),
    "top_k": lambda **kw: TopK(**kw),
    "block_top_k": lambda **kw: BlockTopK(**kw),
    "qsgd": lambda **kw: QSGD(**kw),
    "sign": lambda **kw: SignNorm(),
    "randomized_gossip": lambda **kw: RandomizedGossip(**kw),
}


def make_compressor(name: str, **kwargs) -> Compressor:
    """Factory: make_compressor('top_k', fraction=0.01)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
