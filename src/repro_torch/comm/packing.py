"""Bucketed flat-buffer packing for the CHOCO gossip exchange.

The parameter leaves are packed into a few dtype-homogeneous flat
*buckets*; each bucket is compressed once and ships as one payload per
neighbour.  Leaf segments inside compressed buckets start at
``align``-element boundaries (a multiple of 128, the compressor's block
width for blockwise top-k), and the padding is zero.  Tiny leaves can be
routed to an *exact* bucket (``exact_small_leaves``): their segments are
not aligned and the bucket ships uncompressed.  The spec depends only on
the leaves' per-node shapes and dtypes, so it is computed once per trainer.

Buffers are node-stacked: a bucket buffer is ``(n, bucket.size)``, row i
being gossip node i's buffer.

Layout rules (those of the JAX package, so both build the same buckets):
buckets are keyed by (dtype, exact, route) and split when they would
exceed ``max_bucket_elems``; a single leaf larger than the cap gets a
dedicated bucket, and top-k on such a bucket falls back to row-blockwise
selection.  ``route`` is a leaf's sharding over the model axis
(:func:`leaf_route`): the JAX engine never mixes model-sharded and
model-replicated leaves in one bucket, even at model extent 1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.compression import (BlockTopK, Identity,
                                          PackedQuantPayload,
                                          PackedSparsePayload, QSGD, RandK,
                                          RandomizedGossip, SignNorm, TopK,
                                          _resolve_k, code_bits, code_dtype)
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
    exact: bool                # ships uncompressed (DensePayload)
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

    def bucket_slots(self, b: int) -> List[LeafSlot]:
        return [s for s in self.slots if s.bucket == b]


def leaf_route(path: str) -> Tuple[str, ...]:
    """Routing key of a dense-decoder leaf ("embed/tok", "stack/p0/attn/wq",
    ...): ``("model",)`` for model-sharded weights, ``()`` otherwise."""
    return ("model",) if path.rsplit("/", 1)[-1] in _MODEL_SHARDED else ()


def _round_up(n: int, unit: int) -> int:
    return -(-n // unit) * unit


def make_bucket_spec(leaves, *, align: int = LANES,
                     exact_small_leaves: bool = False,
                     small_leaf_threshold: int = 8_192,
                     max_bucket_elems: int = MAX_BUCKET_ELEMS,
                     routes: Optional[Sequence] = None) -> BucketSpec:
    """Build the packing spec from per-node leaves (anything with
    ``.shape`` and ``.dtype``, e.g. meta tensors), in leaf order.  With
    ``exact_small_leaves``, leaves of at most ``small_leaf_threshold``
    elements go to exact buckets."""
    if align % LANES:
        raise ValueError("segment alignment must be a lane multiple")
    if routes is not None and len(routes) != len(leaves):
        raise ValueError(f"{len(routes)} routes for {len(leaves)} leaves")
    open_buckets = {}
    slots: List[LeafSlot] = []
    buckets: List[List] = []   # [dtype, exact, cursor (= padded size), logical]
    for i, leaf in enumerate(leaves):
        size = 1
        for dim in leaf.shape:
            size *= int(dim)
        exact = bool(exact_small_leaves and size <= small_leaf_threshold)
        seg = size if exact else _round_up(size, align)
        key = (leaf.dtype, exact, None if routes is None else routes[i])
        b = open_buckets.get(key)
        if b is None or (buckets[b][2] + seg > max_bucket_elems
                         and buckets[b][2] > 0):
            b = len(buckets)
            buckets.append([leaf.dtype, exact, 0, 0])
            open_buckets[key] = b
        slots.append(LeafSlot(leaf=i, bucket=b, offset=buckets[b][2],
                              size=size, shape=tuple(int(d) for d in leaf.shape),
                              dtype=leaf.dtype))
        buckets[b][2] += seg
        buckets[b][3] += size
    return BucketSpec(
        slots=tuple(slots),
        buckets=tuple(Bucket(index=i, dtype=d, exact=e, size=c, logical=lg)
                      for i, (d, e, c, lg) in enumerate(buckets)),
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


def _slot_budget(compressor, slots, bucket: Bucket) -> int:
    """Sparse coordinate budget, resolved per slot and summed (an absolute
    k means k per leaf; fractions sum to the same total)."""
    if slots:
        k = sum(_resolve_k(s.size, compressor.k, compressor.fraction)
                for s in slots)
    else:
        k = _resolve_k(bucket.logical, compressor.k, compressor.fraction)
    return min(k, bucket.logical)


def _logical_positions(slots, bucket: Bucket, device) -> torch.Tensor:
    """Padded-buffer indices of the bucket's logical coordinates."""
    if not slots:
        return torch.arange(bucket.logical, device=device)
    return torch.cat([s.offset + torch.arange(s.size, device=device)
                      for s in slots])


def draw(compressor, bucket: Bucket, slots, buf: torch.Tensor, seed: int,
         nodes: Optional[Sequence[int]] = None):
    """The random draw one bucket's compression needs, on the buffer's
    device.  Row r belongs to gossip node ``nodes[r]`` (default: row r is
    node r) and is drawn from its own generator, seeded with
    ``fold_seed(seed, node)``, as the JAX engine folds each node's
    ``axis_index`` into its key: so a node's row is the same whether it is
    drawn with every other node's (the stacked engine) or alone (the
    per-rank engine).

    * QSGD: the uniform dither xi, ``(n, bucket.size)`` f32;
    * RandK: per node the first k of a uniform permutation of the
      bucket's logical coordinates, ``(n, k)`` int64;
    * RandomizedGossip: one keep bit per node, ``(n,)`` bool."""
    nodes = range(buf.shape[0]) if nodes is None else nodes
    gens = [torch.Generator(device=buf.device).manual_seed(fold_seed(seed, i))
            for i in nodes]
    if isinstance(compressor, QSGD):
        xi = torch.empty(buf.shape, dtype=torch.float32, device=buf.device)
        for row, gen in zip(xi, gens):
            row.uniform_(generator=gen)
        return xi
    if isinstance(compressor, RandK):
        k = _slot_budget(compressor, slots, bucket)
        return torch.stack([torch.randperm(bucket.logical, generator=gen,
                                           device=buf.device)[:k]
                            for gen in gens])
    if isinstance(compressor, RandomizedGossip):
        return torch.cat([torch.rand((1,), generator=gen, device=buf.device)
                          for gen in gens]) < compressor.p
    raise ValueError(f"compressor {compressor.name!r} draws nothing")


def compress_bucket(compressor, buf: torch.Tensor, bucket: Bucket,
                    slots: Optional[Sequence[LeafSlot]] = None, rand=None):
    """Compress one node-stacked bucket buffer into its wire payload.

    ``slots`` (the bucket's leaves) give the sparse budgets per leaf and
    the logical positions RandK samples from; ``rand`` is the bucket's
    draw (:func:`draw`) for a stochastic compressor.

    * exact buckets and Identity -> the buffer itself (DensePayload)
    * BlockTopK -> its own blockwise payload (PackedSparsePayload)
    * RandK -> k per slot, sampled over logical positions only
    * TopK -> the bucket's k largest |x| (k from the slot budget); a
      bucket over MAX_BUCKET_ELEMS is selected row-blockwise instead,
      ceil(k / rows) per row of MAX_BUCKET_ELEMS
    * QSGD -> int8/int16 codes (quantize kernel) + a per-node scale using
      the *logical* dimension's tau; ``rand`` is the uniform dither
    * SignNorm -> int8 sign codes (sign kernel) + logical-mean scale
    * RandomizedGossip -> the buffer or zeros per node, by ``rand``
    """
    if bucket.exact or isinstance(compressor, Identity):
        return Identity.compress(buf)
    if isinstance(compressor, BlockTopK):
        return compressor.compress(buf)
    if isinstance(compressor, RandK):
        return compressor.compress(
            buf, rand, k=_slot_budget(compressor, slots, bucket),
            logical=_logical_positions(slots, bucket, buf.device))
    if isinstance(compressor, TopK):
        k = _slot_budget(compressor, slots, bucket)
        size = buf.shape[1]
        if size > MAX_BUCKET_ELEMS:
            n_blocks = -(-size // MAX_BUCKET_ELEMS)
            kb = max(1, -(-k // n_blocks))
            vals, idx = ops.block_topk_select(buf, kb, block=MAX_BUCKET_ELEMS)
            return PackedSparsePayload(vals, idx, size, MAX_BUCKET_ELEMS)
        return compressor.compress(buf, k)
    x32 = buf.to(torch.float32)
    if isinstance(compressor, QSGD):
        if rand is None:
            raise ValueError("QSGD needs its dither xi")
        tau = compressor._tau(bucket.logical) if compressor.rescale else 1.0
        codes, scale = ops.qsgd_compress(x32, rand.to(buf.device),
                                         compressor.s, tau)
        return PackedQuantPayload(codes, scale, code_bits(compressor.s),
                                  dim=bucket.size, logical=bucket.logical)
    if isinstance(compressor, SignNorm):
        codes, scale = ops.sign_compress(x32, bucket.logical)
        return PackedQuantPayload(codes, scale, 1, dim=bucket.size,
                                  logical=bucket.logical)
    if isinstance(compressor, RandomizedGossip):
        return compressor.compress(buf, rand)
    raise ValueError(f"compressor {compressor.name!r} is not ported")


def bucket_dense(payload, bucket: Bucket) -> torch.Tensor:
    """Dense q for one bucket, ``(n, bucket.size)`` in the bucket's dtype."""
    q = payload.dense()
    if q.shape[1] < bucket.size:
        q = torch.nn.functional.pad(q, (0, bucket.size - q.shape[1]))
    return q[:, : bucket.size].to(bucket.dtype)


def bucket_rand(compressor, bucket: Bucket, slots, buf: torch.Tensor,
                seed: int, draws: Optional[Callable[[int], torch.Tensor]] = None,
                nodes: Optional[Sequence[int]] = None):
    """The draw one bucket's compression needs: None for deterministic
    compressors and exact buckets, else ``draws(bucket.index)`` when
    injected, else a draw salted per bucket (``fold_seed(seed, index)``)
    for the nodes ``nodes`` of the buffer's rows."""
    if not compressor.stochastic or bucket.exact:
        return None
    if draws is not None:
        return draws(bucket.index)
    return draw(compressor, bucket, slots, buf, fold_seed(seed, bucket.index),
                nodes)


def compress_bufs(compressor, spec: BucketSpec, buckets: Sequence[Bucket],
                  bufs: Sequence[torch.Tensor], *, seed: int = 0,
                  draws: Optional[Callable[[int], torch.Tensor]] = None,
                  nodes: Optional[Sequence[int]] = None):
    """Compress already-packed bucket buffers (``spec.buckets`` or any
    subset, with their buffers).  Returns (payloads, q_bufs): one wire
    payload per bucket plus its dense q.  Row r of each buffer is gossip
    node ``nodes[r]`` (default r), whose draws it takes.  The exchanges
    call it one bucket at a time."""
    payloads = []
    for bucket, buf in zip(buckets, bufs):
        slots = spec.bucket_slots(bucket.index)
        payloads.append(compress_bucket(
            compressor, buf, bucket, slots,
            bucket_rand(compressor, bucket, slots, buf, seed, draws, nodes)))
    q_bufs = [bucket_dense(p, b) for p, b in zip(payloads, buckets)]
    return payloads, q_bufs


# ---------------------------------------------------------------------------
# wire form of a payload (the per-rank engine's transport)
# ---------------------------------------------------------------------------

def _wire_fields(payload) -> List[str]:
    """The payload's tensors, in field order: codes and scale; values and
    indices; or the dense buffer.  The other fields are static."""
    return [f.name for f in dataclasses.fields(payload)
            if torch.is_tensor(getattr(payload, f.name))]


def to_wire(payload) -> torch.Tensor:
    """One payload's tensors flattened into one 1-D uint8 tensor, on the
    payload's device, in :func:`_wire_fields` order."""
    return torch.cat([getattr(payload, name).contiguous().reshape(-1)
                      .view(torch.uint8) for name in _wire_fields(payload)])


def from_wire(raw: torch.Tensor, like):
    """The payload whose wire form is ``raw``, with the tensor shapes and
    dtypes and the static fields of ``like``: a payload of the same bucket
    made by this rank.  Every rank builds the same shapes from the same
    ``BucketSpec`` and compressor, so no size travels with the bytes."""
    fields, off = {}, 0
    for name in _wire_fields(like):
        t = getattr(like, name)
        nbytes = t.numel() * t.element_size()
        piece = raw[off:off + nbytes]
        if off % t.element_size():
            piece = piece.clone()              # realign for the dtype view
        fields[name] = piece.view(t.dtype).view(t.shape)
        off += nbytes
    if off != raw.numel():
        raise ValueError(f"{raw.numel()} wire bytes for a payload of {off}")
    return dataclasses.replace(like, **fields)


def bucket_wire_nbytes(spec: BucketSpec, compressor) -> List[int]:
    """Bytes of one node's payload on the wire per bucket, in bucket order,
    from the spec alone: what :func:`to_wire` makes of
    :func:`compress_bucket`'s payload (padding and all; sparse values in
    the bucket's dtype, indices int32)."""
    out = []
    for b in spec.buckets:
        item = b.dtype.itemsize
        if b.exact or isinstance(compressor, (Identity, RandomizedGossip)):
            out.append(b.size * item)
        elif isinstance(compressor, BlockTopK):
            out.append(-(-b.size // compressor.block) * compressor._kb()
                       * (item + 4))
        elif isinstance(compressor, (TopK, RandK)):
            k = _slot_budget(compressor, spec.bucket_slots(b.index), b)
            if isinstance(compressor, TopK) and b.size > MAX_BUCKET_ELEMS:
                n_blocks = -(-b.size // MAX_BUCKET_ELEMS)
                k = n_blocks * max(1, -(-k // n_blocks))
            out.append(k * (item + 4))
        elif isinstance(compressor, QSGD):
            out.append(b.size * code_dtype(compressor.s).itemsize + 4)
        elif isinstance(compressor, SignNorm):
            out.append(b.size + 4)
        else:
            raise ValueError(f"compressor {compressor.name!r} is not ported")
    return out


def bucket_omegas(spec: BucketSpec, compressor) -> List[float]:
    """Per-bucket Assumption-1 omega, in bucket order.  Exact buckets ship
    uncompressed (omega = 1); sparse budgets resolve per slot, as
    :func:`compress_bucket` does."""
    omegas = []
    for b in spec.buckets:
        if b.exact or isinstance(compressor, Identity):
            omegas.append(1.0)
        elif isinstance(compressor, (TopK, RandK)):
            k = _slot_budget(compressor, spec.bucket_slots(b.index), b)
            omegas.append(k / b.logical)
        else:
            omegas.append(compressor.omega(b.logical))
    return omegas


def bucket_omega_worst(spec: BucketSpec, compressor) -> float:
    """Smallest omega over the compressed buckets; exact buckets never
    bind, and a spec of exact buckets only has omega exactly 1."""
    omegas = [w for b, w in zip(spec.buckets, bucket_omegas(spec, compressor))
              if not (b.exact or isinstance(compressor, Identity))]
    return min(omegas) if omegas else 1.0


def bucket_wire_bits(spec: BucketSpec, compressor) -> List[int]:
    """Analytic bits on the wire per bucket, in bucket order."""
    bits = []
    for b in spec.buckets:
        if b.exact:
            bits.append(b.logical * b.dtype.itemsize * 8)
        elif isinstance(compressor, (TopK, RandK)):
            bits.append(sum(compressor.wire_bits(s.size)
                            for s in spec.bucket_slots(b.index)))
        elif isinstance(compressor, (BlockTopK, QSGD, SignNorm)):
            bits.append(compressor.wire_bits(b.logical))
        else:
            bits.append(compressor.wire_bits(b.size))
    return [int(x) for x in bits]
