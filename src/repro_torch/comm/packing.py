"""Bucketed flat-buffer packing for the CHOCO gossip exchange.

The parameter leaves are packed into a few dtype-homogeneous flat
*buckets*; each bucket is compressed once and ships as one payload per
neighbour.  Leaf segments inside compressed buckets start at
``align``-element boundaries (a multiple of 128), and the padding is
zero.  The spec depends only on the leaves' per-node shapes and dtypes,
so it is computed once per trainer.

Buffers are node-stacked: a bucket buffer is ``(n, bucket.size)``, row i
being gossip node i's buffer.

Layout rules (those of the JAX package, so both build the same buckets):
buckets are keyed by (dtype, route) and split when they would
exceed ``max_bucket_elems``; a single leaf larger than the cap gets a
dedicated bucket.  ``route`` is a leaf's sharding over the model axis
(:func:`leaf_route`): the JAX engine never mixes model-sharded and
model-replicated leaves in one bucket, even at model extent 1.

Only the QSGD and SignNorm payloads are ported; the exact small-leaf
bucket and the uncompressed (Identity) payload are not.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.compression import (PackedQuantPayload, QSGD,
                                          SignNorm, code_bits)
from repro_torch.kernels import ops

LANES = 128
#: default cap on bucket size (the JAX package's MAX_BUCKET_ELEMS)
MAX_BUCKET_ELEMS = 1 << 22
_MASK64 = (1 << 64) - 1

#: leaf names the JAX sharding rules split over the model axis
#: (``launch/sharding.py``: column, row and vocab-sharded weights)
_MODEL_SHARDED = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "unembed",
                            "wo", "w_down", "tok"})


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside the packed buffers."""
    leaf: int                  # index in leaf order
    bucket: int
    offset: int                # start offset inside the bucket buffer
    size: int                  # logical element count (per node)
    shape: Tuple[int, ...]     # per-node shape
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int
    dtype: torch.dtype
    size: int                  # padded buffer length
    logical: int               # sum of leaf sizes (excludes padding)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    slots: Tuple[LeafSlot, ...]
    buckets: Tuple[Bucket, ...]
    align: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def leaf_route(path: str) -> Tuple[str, ...]:
    """Routing key of a dense-decoder leaf ("embed/tok", "stack/p0/attn/wq",
    ...): ``("model",)`` for model-sharded weights, ``()`` otherwise."""
    return ("model",) if path.rsplit("/", 1)[-1] in _MODEL_SHARDED else ()


def _round_up(n: int, unit: int) -> int:
    return -(-n // unit) * unit


def make_bucket_spec(leaves, *, align: int = LANES,
                     max_bucket_elems: int = MAX_BUCKET_ELEMS,
                     routes: Optional[Sequence] = None) -> BucketSpec:
    """Build the packing spec from per-node leaves (anything with
    ``.shape`` and ``.dtype``, e.g. meta tensors), in leaf order."""
    if align % LANES:
        raise ValueError("segment alignment must be a lane multiple")
    if routes is not None and len(routes) != len(leaves):
        raise ValueError(f"{len(routes)} routes for {len(leaves)} leaves")
    open_buckets = {}
    slots: List[LeafSlot] = []
    buckets: List[List] = []   # [dtype, cursor (= padded size), logical]
    for i, leaf in enumerate(leaves):
        size = 1
        for dim in leaf.shape:
            size *= int(dim)
        seg = _round_up(size, align)
        key = (leaf.dtype, None if routes is None else routes[i])
        b = open_buckets.get(key)
        if b is None or (buckets[b][1] + seg > max_bucket_elems
                         and buckets[b][1] > 0):
            b = len(buckets)
            buckets.append([leaf.dtype, 0, 0])
            open_buckets[key] = b
        slots.append(LeafSlot(leaf=i, bucket=b, offset=buckets[b][1],
                              size=size, shape=tuple(int(d) for d in leaf.shape),
                              dtype=leaf.dtype))
        buckets[b][1] += seg
        buckets[b][2] += size
    return BucketSpec(
        slots=tuple(slots),
        buckets=tuple(Bucket(index=i, dtype=d, size=c, logical=lg)
                      for i, (d, c, lg) in enumerate(buckets)),
        align=align)


# ---------------------------------------------------------------------------
# pack / unpack (node-stacked)
# ---------------------------------------------------------------------------

def pack_leaves(spec: BucketSpec, leaves: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Node-stacked leaves ``(n, *shape)`` -> one ``(n, bucket.size)``
    buffer per bucket, zero between and after the segments."""
    n = leaves[0].shape[0]
    device = leaves[0].device
    bufs = [torch.zeros((n, b.size), dtype=b.dtype, device=device)
            for b in spec.buckets]
    for slot in spec.slots:
        bufs[slot.bucket][:, slot.offset:slot.offset + slot.size] = \
            leaves[slot.leaf].reshape(n, slot.size)
    return bufs


def unpack_leaves(spec: BucketSpec, bufs: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Bucket buffers -> node-stacked leaf VIEWS ``(n, *shape)`` in leaf
    order (writes through, and autograd flows back into the buffers)."""
    out: List[Optional[torch.Tensor]] = [None] * len(spec.slots)
    for slot in spec.slots:
        buf = bufs[slot.bucket]
        seg = buf[:, slot.offset:slot.offset + slot.size]
        out[slot.leaf] = seg.view(buf.shape[0], *slot.shape)
    return out


# ---------------------------------------------------------------------------
# per-bucket compression
# ---------------------------------------------------------------------------

def fold_seed(seed: int, data: int) -> int:
    """Derive a 63-bit seed from (seed, data): the port's counterpart of
    ``jax.random.fold_in`` (a splitmix64 finaliser over both values)."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def draw_dither(buf: torch.Tensor, seed: int) -> torch.Tensor:
    """QSGD's uniform dither on the buffer's device, from a generator
    seeded with ``seed``."""
    gen = torch.Generator(device=buf.device).manual_seed(seed)
    return torch.rand(buf.shape, generator=gen, dtype=torch.float32,
                      device=buf.device)


def compress_bucket(compressor, buf: torch.Tensor, bucket: Bucket,
                    xi: Optional[torch.Tensor] = None):
    """Compress one node-stacked bucket buffer into its wire payload.

    * QSGD -> int8/int16 codes (quantize kernel) + a per-node scale using
      the *logical* dimension's tau; ``xi`` is the uniform dither
    * SignNorm -> int8 sign codes (sign kernel) + logical-mean scale
    """
    x32 = buf.to(torch.float32)
    if isinstance(compressor, QSGD):
        if xi is None:
            raise ValueError("QSGD needs its dither xi")
        codes, scale = ops.qsgd_compress(x32, xi, compressor.s,
                                         compressor._tau(bucket.logical))
        return PackedQuantPayload(codes, scale, code_bits(compressor.s),
                                  dim=bucket.size, logical=bucket.logical)
    if isinstance(compressor, SignNorm):
        codes, scale = ops.sign_compress(x32, bucket.logical)
        return PackedQuantPayload(codes, scale, 1, dim=bucket.size,
                                  logical=bucket.logical)
    raise ValueError(f"compressor {compressor.name!r} is not ported")


def bucket_dense(payload, bucket: Bucket) -> torch.Tensor:
    """Dense q for one bucket, in the bucket's dtype."""
    return payload.dense().to(bucket.dtype)


def bucket_dither(compressor, bucket: Bucket, buf: torch.Tensor, seed: int,
                  dither: Optional[Callable[[int], torch.Tensor]] = None):
    """The dither one bucket's compression needs: None for deterministic
    compressors, else ``dither(bucket.index)`` when injected, else a draw
    salted per bucket (``fold_seed(seed, index)``)."""
    if not compressor.stochastic:
        return None
    if dither is not None:
        return dither(bucket.index)
    return draw_dither(buf, fold_seed(seed, bucket.index))


def compress_bufs(compressor, buckets: Sequence[Bucket],
                  bufs: Sequence[torch.Tensor], *, seed: int = 0,
                  dither: Optional[Callable[[int], torch.Tensor]] = None):
    """Compress already-packed bucket buffers (``spec.buckets`` or any
    subset, with their buffers).  Returns (payloads, q_bufs): one wire
    payload per bucket plus its dense q.  The exchange calls it one bucket
    at a time."""
    payloads = [compress_bucket(compressor, buf, bucket,
                                bucket_dither(compressor, bucket, buf, seed,
                                              dither))
                for bucket, buf in zip(buckets, bufs)]
    q_bufs = [bucket_dense(p, b) for p, b in zip(payloads, buckets)]
    return payloads, q_bufs


def bucket_omegas(spec: BucketSpec, compressor) -> List[float]:
    """Per-bucket Assumption-1 omega, in bucket order."""
    return [compressor.omega(b.logical) for b in spec.buckets]


def bucket_omega_worst(spec: BucketSpec, compressor) -> float:
    """Smallest omega over the buckets."""
    return min(bucket_omegas(spec, compressor))


def bucket_wire_bits(spec: BucketSpec, compressor) -> List[int]:
    """Analytic bits on the wire per bucket, in bucket order."""
    return [int(compressor.wire_bits(b.logical)) for b in spec.buckets]
