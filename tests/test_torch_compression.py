"""The port's sparsifying compressors and their bucket payloads held
against the JAX package on the CPU.

Inputs are made with numpy from a seed; many hold planted ties (small
integers, runs of equal magnitudes, zero padding), where ``torch.topk``
and ``lax.top_k`` would pick different coordinates.  Tolerances:

* TopK and BlockTopK payloads: values, indices and their order
  bit-equal, and the dense q bit-equal (both select, neither computes);
* RandK and RandomizedGossip: bit-equal given the JAX package's draws
  (its permutation prefix, its keep bit), injected;
* Identity and exact buckets: the buffer itself, bit-equal;
* omega, wire bits and gamma: equal as Python numbers (the same formulas
  on the same integers);
* the oversized TopK bucket (one leaf of 5,000,000 elements, over
  MAX_BUCKET_ELEMS): its dense q bit-equal to the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import packing as jpacking
from repro.comm.gossip import _pack_align as jalign
from repro.core import compression as jcomp
from repro_torch.comm import gossip, packing
from repro_torch.core import compression

N = 4

#: (name, kwargs) of every compressor the port shares with the JAX package
COMPRESSORS = [("identity", {}), ("rand_k", {"fraction": 0.05}),
               ("rand_k", {"k": 7}), ("top_k", {"fraction": 0.05}),
               ("top_k", {"k": 7}), ("block_top_k", {"fraction": 0.05}),
               ("block_top_k", {"k_per_block": 13, "block": 256}),
               ("qsgd", {"s": 16}), ("sign", {}),
               ("randomized_gossip", {"p": 0.5})]
_IDS = [f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
        for n, kw in COMPRESSORS]


def _vectors(seed, d, ties):
    """(N, d) f32: Gaussian, or with ``ties`` small integers (every
    magnitude repeats) with a run of zeros."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-3, 4, (N, d)).astype(np.float32)
        x[:, d // 3: d // 2] = 0.0
        return x
    return rng.standard_normal((N, d)).astype(np.float32)


def _keys(seed):
    return [jax.random.fold_in(jax.random.PRNGKey(seed), i) for i in range(N)]


def _assert_same(got, want):
    """Port payload (node row i) against the JAX payload of node i."""
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("d", [1, 128, 1000, 4097])
@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=_IDS)
def test_factors_match_jax(name, kw, d):
    got, want = compression.make_compressor(name, **kw), jcomp.make_compressor(name, **kw)
    assert got.omega(d) == want.omega(d)
    assert got.wire_bits(d) == want.wire_bits(d)
    assert got.stochastic == want.stochastic


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d", [128, 1000, 4097])
@pytest.mark.parametrize("name,kw", [c for c in COMPRESSORS
                                     if c[0] not in ("qsgd", "sign")],
                         ids=[i for i, c in zip(_IDS, COMPRESSORS)
                              if c[0] not in ("qsgd", "sign")])
def test_payload_matches_jax(name, kw, d, ties):
    """Each compressor's ``compress`` on flat vectors, node by node."""
    x = _vectors(d + 7 * ties, d, ties)
    tc, jc = compression.make_compressor(name, **kw), jcomp.make_compressor(name, **kw)
    keys = _keys(d)
    want = [jc.compress(keys[i] if jc.stochastic else None, jnp.asarray(x[i]))
            for i in range(N)]
    xt = torch.from_numpy(x)
    if name == "rand_k":
        k = compression._resolve_k(d, kw.get("k"), kw.get("fraction"))
        perm = np.stack([np.asarray(jax.random.permutation(keys[i], d)[:k])
                         for i in range(N)])
        got = tc.compress(xt, torch.from_numpy(perm))
    elif name == "randomized_gossip":
        keep = np.array([bool(jax.random.bernoulli(keys[i], kw["p"]))
                         for i in range(N)])
        got = tc.compress(xt, torch.from_numpy(keep))
    else:
        got = tc.compress(xt)
    assert type(got).__name__ == type(want[0]).__name__
    dense = got.dense()
    assert dense.shape == (N, d)
    for i, w in enumerate(want):
        if hasattr(w, "indices"):
            assert got.indices.dtype == torch.int32
            _assert_same(got.indices[i].numpy(), w.indices)
            _assert_same(got.values[i].numpy(), w.values)
        _assert_same(dense[i].numpy(), w.dense())
        assert got.wire_bits() == w.wire_bits()


@pytest.mark.parametrize("k", [1, 2, 13, 16, 17, 64])
def test_topk_order_and_ties_match_lax(k):
    """Magnitude descending and, among ties, the lower index first, on
    both sides of the argmax / threshold switch (k = 16): three rows of
    planted ties."""
    from repro_torch.kernels import ops
    rows = [np.array([1, 3, 3, 2, 3, 0, 3] + [0] * 121, np.float32),
            np.zeros(128, np.float32), np.ones(128, np.float32)]
    rows[1][[5, 40, 90]] = 1.0
    rows[2][::3] = -1.0
    rows[2][7] = 2.0
    x = np.stack(rows)
    got = ops.topk_rows(torch.from_numpy(x), k).numpy()
    for r in range(len(rows)):
        _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x[r])), k)
        np.testing.assert_array_equal(got[r], np.asarray(want))


# -- bucket layout and per-bucket payloads --------------------------------------

def _leaves(sizes):
    return [torch.empty((s,), device="meta") for s in sizes]


def _jleaves(sizes):
    return [jax.ShapeDtypeStruct((s,), jnp.float32) for s in sizes]


#: a layout with small and large leaves, two routes and a cap that splits
SIZES = [64, 5000, 3, 130, 70_000, 64, 9000, 8192, 8193, 1]
ROUTES = [(), ("model",), (), (), ("model",), (), (), ("model",), (), ()]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=_IDS)
def test_spec_and_bucket_factors_match_jax(name, kw, exact):
    tc, jc = compression.make_compressor(name, **kw), jcomp.make_compressor(name, **kw)
    layout = dict(align=gossip._pack_align(tc), exact_small_leaves=exact,
                  max_bucket_elems=1 << 16, routes=ROUTES)
    assert layout["align"] == jalign(jc, None)
    got = packing.make_bucket_spec(_leaves(SIZES), **layout)
    want = jpacking.make_bucket_spec(_jleaves(SIZES), **layout)
    assert [(s.leaf, s.bucket, s.offset, s.size) for s in got.slots] \
        == [(s.leaf, s.bucket, s.offset, s.size) for s in want.slots]
    assert [(b.index, b.exact, b.size, b.logical) for b in got.buckets] \
        == [(b.index, b.exact, b.size, b.logical) for b in want.buckets]
    assert any(b.exact for b in got.buckets) == exact
    assert packing.bucket_omegas(got, tc) == jpacking.bucket_omegas(want, jc)
    assert packing.bucket_omega_worst(got, tc) == \
        jpacking.bucket_omega_worst(want, jc)
    assert packing.bucket_wire_bits(got, tc) == jpacking.bucket_wire_bits(want, jc)


def _jax_draws(name, kw, spec, keys):
    """The JAX package's per-bucket draw, node-stacked: the engine salts
    node i's key with the bucket index on non-exact buckets."""
    out = {}
    for b in spec.buckets:
        if b.exact:
            continue
        bkeys = [jax.random.fold_in(k, b.index) for k in keys]
        if name == "qsgd":
            rows = [jax.random.uniform(k, (b.size,)) for k in bkeys]
        elif name == "rand_k":
            kb = jpacking._slot_budget(jcomp.make_compressor(name, **kw),
                                       spec.bucket_slots(b.index), b)
            rows = [jax.random.permutation(k, b.logical)[:kb] for k in bkeys]
        elif name == "randomized_gossip":
            rows = [jax.random.bernoulli(k, kw["p"]) for k in bkeys]
        else:
            continue
        out[b.index] = torch.from_numpy(np.stack([np.asarray(r) for r in rows]))
    return out


def _compare_bucket_payloads(name, kw, sizes, routes, exact, seed, ties,
                             max_bucket_elems=1 << 16):
    tc, jc = compression.make_compressor(name, **kw), jcomp.make_compressor(name, **kw)
    layout = dict(align=gossip._pack_align(tc), exact_small_leaves=exact,
                  max_bucket_elems=max_bucket_elems, routes=routes)
    spec = packing.make_bucket_spec(_leaves(sizes), **layout)
    jspec = jpacking.make_bucket_spec(_jleaves(sizes), **layout)
    n = N
    leaves = [torch.from_numpy(_vectors(seed + i, s, ties)[:n])
              for i, s in enumerate(sizes)]
    bufs = packing.pack_leaves(spec, leaves)
    keys = _keys(seed)
    draws = _jax_draws(name, kw, jspec, keys)
    payloads, q_bufs = packing.compress_bufs(tc, spec, spec.buckets, bufs,
                                             draws=draws.__getitem__)
    for i in range(n):
        jbufs = [jnp.asarray(b[i].numpy()) for b in bufs]
        want_p, want_q = jpacking.compress_bufs(jc, keys[i], jspec, jbufs)
        for p, wp, q, wq in zip(payloads, want_p, q_bufs, want_q):
            assert type(p).__name__ == type(wp).__name__
            assert q.shape[1] == wq.size
            if name in ("qsgd", "sign") and type(p).__name__ == "PackedQuantPayload":
                # the norm / |x|-sum reductions run in another order
                _assert_same(p.codes[i].numpy(), wp.codes)
                np.testing.assert_allclose(q[i].numpy(), np.asarray(wq),
                                           rtol=1e-6, atol=0)
            else:
                if hasattr(wp, "indices"):
                    _assert_same(p.indices[i].numpy(), wp.indices)
                    _assert_same(p.values[i].numpy(), wp.values)
                _assert_same(q[i].numpy(), wq)
            assert p.wire_bits() == wp.wire_bits()
    return payloads


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name,kw", COMPRESSORS, ids=_IDS)
def test_compress_bucket_matches_jax(name, kw, exact, ties):
    _compare_bucket_payloads(name, kw, SIZES, ROUTES, exact, 11, ties)


@pytest.mark.parametrize("ties", [False, True])
def test_oversized_topk_bucket_matches_jax(ties):
    """One 5,000,000-element leaf: its bucket (5,000,064 with padding) is
    over MAX_BUCKET_ELEMS, so TopK selects ceil(k / 2) per 4M-wide row
    (PackedSparsePayload), padded tail included."""
    assert 5_000_000 > packing.MAX_BUCKET_ELEMS
    payloads = _compare_bucket_payloads(
        "top_k", {"fraction": 0.01}, [5_000_000], None, False, 3, ties,
        max_bucket_elems=packing.MAX_BUCKET_ELEMS)
    (p,) = payloads
    assert isinstance(p, compression.PackedSparsePayload)
    assert p.values.shape == (N, 2, 25_000) and p.block == packing.MAX_BUCKET_ELEMS


def test_packed_sparse_dense_drops_padded_positions():
    """dense() of a payload whose indices reach past dim: the padded
    positions land in the spare element, rows stay contiguous."""
    vals = torch.tensor([[[5.0, 0.0]], [[-1.0, 2.0]]])
    idx = torch.tensor([[[3, 200]], [[0, 129]]], dtype=torch.int32)
    q = compression.PackedSparsePayload(vals, idx, 130, 256).dense()
    assert q.shape == (2, 130) and q.is_contiguous()
    want = torch.zeros(2, 130)
    want[0, 3], want[1, 0], want[1, 129] = 5.0, -1.0, 2.0
    assert torch.equal(q, want)


def test_exchange_takes_every_compressor():
    from repro_torch.comm import schedule
    from repro_torch.core import topology
    spec = packing.make_bucket_spec(_leaves(SIZES), routes=ROUTES)
    for name, kw in COMPRESSORS:
        ex = gossip.make_choco_exchange(
            spec=spec, schedules=(schedule.compile_schedule(topology.ring(N)),),
            compressor=compression.make_compressor(name, **kw), gamma=0.5)
        assert ex.bucket_gammas == [0.5] * spec.n_buckets
