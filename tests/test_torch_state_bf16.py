"""bf16 error-feedback state (``ChocoConfig.state_dtype="bfloat16"``,
``--state-dtype bfloat16``) in the port, held against the JAX package's
packed engine on the CPU.

With bf16 state the JAX engine leaves its fused path (``_fused_update_ok``
fails) for the leaf update ``_choco_leaf_updates``; x stays f32, x_hat and
s are bf16, the bucket spec is built from the bf16 x_hat leaves, and the
sparse and dense payloads carry bf16 values.  The port runs the same
algebra in bucket space with the rounding points of
``ref.ef_update_bf16_ref``: every bf16 operation of the JAX text rounds,
except ``s' - x_hat'``, whose rounding XLA's default excess precision
drops before the upcast (measured: with
``--xla_allow_excess_precision=false`` the JAX engine rounds there too).

Tolerances (all measured on this CPU with the cases below):

* (a) the plain bf16 EF update against the jitted ``_choco_leaf_updates``
  (x_hat' from the engine's ``lhat + q``), uniform weights (Python
  floats) and per-node self weights (f32 scalars): x, x_hat and s bit-equal;
* (b) the stacked and the per-rank exchange against JAX's packed engine
  (``make_gossip_exchange``, 4 host devices, ``kernel_backend="jnp"``)
  with the JAX draws injected, for every case of ``EXCHANGE_CASES``
  (``test_torch_dist.py``) at gossip_steps 1 and 2 on the ring, and on
  star and chain (per-node self weights): every payload bit-equal to
  JAX's ``compress_bufs`` on the same bf16 delta (values, indices, codes
  and scales; the QSGD and sign scales, whose reductions run in another
  order, within 1e-6 relative, with the codes equal), x_hat and s
  bit-equal, x bit-equal; the per-rank engine bit-equal to the stacked
  one, and each rank's bytes sent equal to the bytes of JAX's payload
  arrays (bf16 values, int32 indices), which for sparse and dense
  payloads is JAX's ``payload.wire_bits() / 8`` (``bucket_wire_bits`` is
  an analytic count, 64 bits per sparse coordinate in any dtype);
* (c) three trainer steps against the JAX trainer with bf16 state
  (``test_torch_slice.py``'s reference run with a state-dtype argument and
  its tolerances: losses 1e-6 relative, x 1e-6 absolute, x_hat and s
  1e-6 + 1e-5 relative);
* (d) the launcher trains with ``--state-dtype bfloat16`` on the CPU,
  stacked and per rank, and refuses a dtype the port does not run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.comm import gossip, packing, schedule
from repro_torch.comm.packing import (bucket_wire_nbytes, make_bucket_spec,
                                      pack_leaves, to_wire, unpack_leaves)
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.kernels import dispatch, ref
from repro_torch.launch import mesh
from test_torch_dist import (EXCHANGE_CASES, GOSSIP_STEPS, LEAF_SHAPES, N,
                             THREADS, _join, _spawn)
from test_torch_slice import ROOT, Reference, make_reference
from test_torch_slice import one_thread, tmp_path  # noqa: F401  (fixtures)

BF16 = torch.bfloat16

#: (EXCHANGE_CASES index, gossip_steps, topology) of the exchange cases:
#: every compressor case on the ring at 1 and 2 rounds, and per-node self
#: weights on star and chain
CASES = ([(i, k, "ring") for i in range(len(EXCHANGE_CASES))
          for k in GOSSIP_STEPS]
         + [(2, 1, "star"), (5, 2, "star"), (0, 1, "chain"), (6, 2, "chain")])
SMALL_LEAF_THRESHOLD = 4224


def _tag(case):
    i, k, topo = case
    name, _, exact = EXCHANGE_CASES[i]
    return f"{name}{'-exact' if exact else ''}-{k}-{topo}"


_JAX_EXCHANGES = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.comm import packing as jpacking
    from repro.comm.gossip import make_gossip_exchange
    from repro.comm.schedule import compile_schedule
    from repro.core.compression import make_compressor
    from repro.core.topology import make_topology

    cases, shapes, threshold, out_dir = json.loads(sys.argv[1]), \\
        json.loads(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fold = jax.random.fold_in
    for c in cases:
        rng = np.random.default_rng(c["seed"])
        def draw(scale, dtype):
            return {f"l{i}": (scale * rng.standard_normal((4,) + tuple(s)))
                    .astype(np.float32).astype(dtype)
                    for i, s in enumerate(shapes)}
        x, x_hat, s = (draw(1.0, np.float32), draw(0.5, jnp.bfloat16),
                       draw(0.1, jnp.bfloat16))
        specs = {k: P("data", *([None] * (v.ndim - 1))) for k, v in x.items()}
        comp = make_compressor(c["name"], **c["kw"])
        ex = make_gossip_exchange(
            mode="choco", mesh=mesh, state_specs=specs, axis="data",
            compressor=comp, gamma=c["gamma"], exact_small_leaves=c["exact"],
            small_leaf_threshold=threshold,
            schedules=(compile_schedule(make_topology(c["topology"], 4)),),
            gossip_steps=c["k"], kernel_backend="jnp")
        key = jax.random.PRNGKey(c["seed"])
        tree = lambda t: jax.tree.map(jnp.asarray, t)
        out = jax.jit(ex)(key, tree(x), tree(x_hat), tree(s))
        res = {}
        for tag, t in (("in_x", x), ("in_x_hat", x_hat), ("in_s", s)) + tuple(
                zip(("out_x", "out_x_hat", "out_s"), out)):
            for k, v in t.items():
                v = np.asarray(v)
                res[f"{tag}:{k}"] = (v if v.dtype == np.float32
                                     else v.view(np.uint16))
        # the engine's draws: node i of round t, bucket b takes
        # fold_in(round_key, b), round_key = fold_in(key, i) (t = 0) or
        # fold_in(fold_in(key, i), t)
        spec = jpacking.make_bucket_spec(
            [jax.ShapeDtypeStruct(v.shape[1:], jnp.bfloat16)
             for v in x_hat.values()],
            align=128, exact_small_leaves=c["exact"],
            small_leaf_threshold=threshold)
        if comp.stochastic:
            for t in range(c["k"]):
                for b in spec.buckets:
                    if b.exact:
                        continue
                    rows = []
                    for i in range(4):
                        rk = fold(key, i) if t == 0 else fold(fold(key, i), t)
                        bk = fold(rk, b.index)
                        if c["name"] == "qsgd":
                            rows.append(jax.random.uniform(bk, (b.size,)))
                        elif c["name"] == "rand_k":
                            kb = jpacking._slot_budget(
                                comp, spec.bucket_slots(b.index), b)
                            rows.append(jax.random.permutation(
                                bk, b.logical)[:kb])
                        else:
                            rows.append(jax.random.bernoulli(bk, comp.p))
                    res[f"draw:{t}:{b.index}"] = np.stack(
                        [np.asarray(r) for r in rows])
        savez(os.path.join(out_dir, c["tag"] + ".npz"), **res)
""")


def _case_dict(case):
    i, k, topo = case
    name, kw, exact = EXCHANGE_CASES[i]
    return dict(tag=_tag(case), name=name, kw=kw, exact=exact, k=k,
                topology=topo, gamma=0.3, seed=100 + i)


def jax_exchanges(tmp_path_factory):
    """``tag -> path`` of the JAX engine's runs of every case, made once per
    pytest run in one subprocess (``make_reference``)."""
    out = make_reference(
        tmp_path_factory, "jax_bf16_exchanges", _JAX_EXCHANGES,
        lambda part: [json.dumps([_case_dict(c) for c in CASES]),
                      json.dumps(LEAF_SHAPES), SMALL_LEAF_THRESHOLD, part])
    return {_tag(c): str(out / (_tag(c) + ".npz")) for c in CASES}


def _tensor(a):
    """An npz array as a tensor: uint16 arrays hold bf16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(BF16) if a.dtype == np.uint16 else t


def _setup(case, path):
    """(compressor, spec, schedules, gamma, (x, x_hat, s) node-stacked
    bucket buffers, JAX outputs, draws(t, b)) of one case."""
    i, k, topo = case
    name, kw, exact = EXCHANGE_CASES[i]
    comp = make_compressor(name, **kw)
    spec = make_bucket_spec(
        [torch.empty(s, dtype=BF16, device="meta") for s in LEAF_SHAPES],
        align=gossip._pack_align(comp), exact_small_leaves=exact,
        small_leaf_threshold=SMALL_LEAF_THRESHOLD)
    res = Reference(path)
    leaves = lambda tag: [_tensor(res[f"{tag}:l{j}"])
                          for j in range(len(LEAF_SHAPES))]
    bufs = (pack_leaves(spec, leaves("in_x"), dtype=torch.float32),
            pack_leaves(spec, leaves("in_x_hat")),
            pack_leaves(spec, leaves("in_s")))
    want = [leaves(t) for t in ("out_x", "out_x_hat", "out_s")]
    sched = schedule.compile_schedule(topology.make_topology(topo, N))
    draws = (lambda t, b: torch.from_numpy(res[f"draw:{t}:{b}"])) \
        if comp.stochastic else None
    return comp, spec, (sched,), 0.3, bufs, want, draws


# -- (a) the plain bf16 EF update ---------------------------------------------

def _bf16(rng, shape, scale):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(BF16)


def _jnp(t):
    """A CPU tensor as a JAX array (bf16 through its bits)."""
    import jax.numpy as jnp
    if t.dtype == BF16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _torch(a):
    a = np.array(a)                      # writable, for from_numpy
    return (torch.from_numpy(a.view(np.int16)).view(BF16)
            if a.dtype.itemsize == 2 else torch.from_numpy(a))


@pytest.mark.parametrize("topo", ["ring", "star", "chain"])
def test_plain_bf16_update_matches_jitted_leaf_update(topo):
    """The ring's uniform weights (Python floats in JAX) and star's and
    chain's per-node self weights (f32 scalars, one jitted call per node),
    gamma 0.3: x', x_hat' and s' bit-equal to the JAX engine's
    ``lhat + q`` and ``_choco_leaf_updates`` jitted alone.  One exception,
    measured: with chain's self weights (2/3 and 1/3, whose products with
    bf16 values are not exact in f32) this jit contracts the weighted sum
    of s' into an FMA too, where the whole engine contracts it only in
    its recomputation for x (test_stacked_exchange_matches_jax_engine
    holds s' bit-equal there); so here s' may differ in a few elements
    (1-5 of 4096 per node), each by one bf16 step, and each equal to the
    FMA form."""
    import jax
    from repro.comm.gossip import _choco_leaf_updates
    sched = schedule.compile_schedule(topology.make_topology(topo, N))
    (w_nbr, _), = gossip._weight_groups(sched)
    rng = np.random.default_rng(7)
    L = 4096
    x = torch.from_numpy(rng.standard_normal((N, L)).astype(np.float32))
    x_hat, s, q = _bf16(rng, (N, L), 0.5), _bf16(rng, (N, L), 0.1), \
        _bf16(rng, (N, L), 0.3)
    nbr = (q.roll(1, 0) + q.roll(-1, 0))          # a bf16 sum, as received
    q[:, :64] = 0                                  # unselected coordinates
    gamma = 0.3
    uniform = sched.self_weight is not None
    w_self = [sched.self_weight] * N if uniform else list(sched.self_weights)
    new_hat = jax.jit(lambda a, b: a + b)(_jnp(x_hat), _jnp(q))
    want_x, want_s = [], []
    for i in range(N):
        ws = w_self[i] if uniform else np.float32(w_self[i])
        fn = jax.jit(lambda lh, ls, qd, nb, nh, ws_: _choco_leaf_updates(
            [lh], [ls], [qd], [nb], [nh],
            ws if uniform else ws_, w_nbr, gamma))
        (sn,), (xn,) = fn(_jnp(x[i]), _jnp(s[i]), _jnp(q[i]), _jnp(nbr[i]),
                          new_hat[i], np.float32(w_self[i]))
        want_x.append(_torch(xn))
        want_s.append(_torch(sn))
    # the weights as the exchange compiles them: uniform ones rounded to
    # bf16, per-node self weights f32
    ws = torch.tensor(w_self, dtype=torch.float32)
    wn = torch.full((N,), w_nbr, dtype=torch.float32).to(BF16).float()
    if uniform:
        ws = ws.to(BF16).float()
    got_x, got_hat, got_s = ref.ef_update_bf16_ref(
        x, x_hat, s, q, nbr, ws, wn, gamma, mix_in_bf16=uniform)
    assert torch.equal(got_hat.view(torch.int16),
                       _torch(new_hat).view(torch.int16))
    want_s = torch.stack(want_s)
    off = got_s != want_s
    if not uniform:
        assert int(off.sum()) <= 8 * N
        qs = q.float()
        fma_mix = ref.fma_f32(ws[:, None].expand_as(qs), qs,
                              wn[:, None] * nbr.float())
        fma_s = (s.float() + fma_mix.to(BF16).float()).to(BF16)
        assert torch.equal(fma_s[off], want_s[off])
        off[:] = False
    assert not off.any()
    assert torch.equal(got_x, torch.stack(want_x))
    # dispatch takes the bf16 entry on the CPU, in place
    buf = [x.clone(), x_hat.clone(), s.clone()]
    dispatch.ef_bucket_update(*buf, q, nbr, ws, wn, gamma, uniform)
    for a, b in zip(buf, (got_x, got_hat, got_s)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fma_f32_rounds_once():
    """``ref.fma_f32`` against exact rational arithmetic, on seeded values
    and on constructed cases whose f64 sum lands on an f32 midpoint while
    the exact value does not (where rounding twice goes wrong)."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = rng.standard_normal(2000).astype(np.float32)
    b = (rng.standard_normal(2000) * 1e-3).astype(np.float32)
    c = rng.standard_normal(2000).astype(np.float32)
    # a b = 2^-24 (1 + 2^-11) (1 - 2^-11 + 2^-22) = 2^-24 + 2^-57 and c = 1:
    # the exact sum lies above the midpoint 1 + 2^-24 of two f32 values,
    # its f64 rounding on it (and from there ties go to 1.0); and negated
    a = np.append(a, [np.float32(1 + 2 ** -11), np.float32(-(1 + 2 ** -11))])
    b = np.append(b, [np.float32(2 ** -24 * (1 - 2 ** -11 + 2 ** -22))] * 2)
    c = np.append(c, [np.float32(1.0), np.float32(-1.0)])
    got = ref.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()

    def nearest(v):
        lo = np.float32(float(v))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        err = [abs(Fraction(float(cnd)) - v) for cnd in cands]
        best = min(err)
        ties = [cnd for cnd, e in zip(cands, err) if e == best]
        return min(ties, key=lambda t: int(t.view(np.uint32)) & 1)
    want = np.array([nearest(Fraction(float(x)) * Fraction(float(y))
                             + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    # the constructed cases: the plain f64 rounding goes wrong there
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[-2:] != want[-2:]).all()


@pytest.mark.parametrize("k", [5, 17, 300])
def test_topk_rows_keeps_lax_top_k_order_on_bf16(k):
    """bf16 magnitudes repeat often (8 mantissa bits), so the k-th largest
    is tied in most rows: ``ops.topk_rows`` on bf16 against
    ``lax.top_k(|x|)`` on the same bf16 values, indices in the same order
    (magnitude descending, the lower index first)."""
    import jax
    from repro_torch.kernels import ops
    rng = np.random.default_rng(k)
    x = _bf16(rng, (6, 4099), 1.0)
    x[1] = x[1].round()                       # small integers: heavy ties
    x[2, :2000] = 0
    got = ops.topk_rows(x, k)
    _, want = jax.lax.top_k(jax.numpy.abs(_jnp(x)), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- (b) the exchange against JAX's packed engine -----------------------------

def _jax_payloads(comp_name, kw, spec_args, case_seed, t, bucket, delta):
    """JAX's payload of each node for one bucket's bf16 delta (n, size),
    with the engine's key of node i in round t."""
    import jax
    from repro.comm import packing as jpacking
    from repro.core import compression as jcomp
    jc = jcomp.make_compressor(comp_name, **kw)
    jspec = jpacking.make_bucket_spec(spec_args["leaves"], **{
        k: v for k, v in spec_args.items() if k != "leaves"})
    jb = jspec.buckets[bucket.index]
    out = []
    fold = jax.random.fold_in
    for i in range(delta.shape[0]):
        key = fold(jax.random.PRNGKey(case_seed), i)
        key = key if t == 0 else fold(key, t)
        bkey = (fold(key, jb.index) if jc.stochastic and not jb.exact
                else None)
        out.append(jpacking.compress_bucket(
            jc, bkey, _jnp(delta[i]), jb, jspec.bucket_slots(jb.index)))
    return out


def _row(payload, i):
    """Node row i of a node-stacked payload."""
    return dataclasses.replace(payload, **{
        f.name: getattr(payload, f.name)[i:i + 1]
        for f in dataclasses.fields(payload)
        if torch.is_tensor(getattr(payload, f.name))})


def _check_payload(got, want):
    """Port payload row against a JAX payload: every array bit-equal (the
    QSGD / sign scale within 1e-6 relative), and the wire bytes equal to
    the bytes of JAX's arrays."""
    import jax
    fields = [f.name for f in dataclasses.fields(got)
              if torch.is_tensor(getattr(got, f.name))]
    nbytes = 0
    for name in fields:
        g, w = getattr(got, name)[0], np.asarray(getattr(want, name))
        nbytes += w.nbytes
        assert g.element_size() == w.dtype.itemsize, name
        if name == "scale":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
        else:
            assert np.array_equal(g.reshape(w.shape).view(
                {1: torch.int8, 2: torch.int16, 4: torch.int32}[
                    g.element_size()]).numpy(),
                w.view({1: np.int8, 2: np.int16, 4: np.int32}[
                    w.dtype.itemsize])), name
    assert nbytes == sum(np.asarray(a).nbytes
                         for a in jax.tree_util.tree_leaves(want))
    assert to_wire(got).numel() == nbytes
    if type(want).__name__ != "PackedQuantPayload":
        # JAX's own accounting of sparse and dense payloads reads the value
        # dtype (QSGD's and sign's counts bits per code, not int8 words)
        assert 8 * nbytes == want.wire_bits()
    return nbytes


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_exchanges(tmp_path_factory)


def _assert_bit_equal(got, want, what):
    for g, w in zip(got, want):
        g = g.reshape(w.shape)
        if g.dtype == BF16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w), what


@pytest.mark.parametrize("case", CASES, ids=[_tag(c) for c in CASES])
def test_stacked_exchange_matches_jax_engine(case, jax_runs, monkeypatch):
    """x, x_hat and s after the exchange bit-equal to the JAX engine's;
    every payload of every round bit-equal to JAX's ``compress_bucket`` of
    the same bf16 delta, its bytes those of JAX's arrays and of
    ``bucket_wire_nbytes``."""
    comp, spec, scheds, gamma, bufs, want, draws = _setup(
        case, jax_runs[_tag(case)])
    assert all(b.dtype == BF16 for b in spec.buckets)
    calls = []
    compress = gossip.compress_bufs

    def record(*args, **kwargs):
        out = compress(*args, **kwargs)
        calls.append((args[2][0], args[3][0].clone(), out[0][0]))
        return out
    monkeypatch.setattr(gossip, "compress_bufs", record)
    x, x_hat, s = [[b.clone() for b in part] for part in bufs]
    gossip.make_choco_exchange(spec=spec, schedules=scheds, compressor=comp,
                               gamma=gamma, gossip_steps=case[1])(
        x, x_hat, s, draws=draws)
    assert [b.dtype for b in x] == [torch.float32] * spec.n_buckets
    assert [b.dtype for b in x_hat + s] == [BF16] * (2 * spec.n_buckets)
    for tag, bufs_, w in zip(("x", "x_hat", "s"), (x, x_hat, s), want):
        _assert_bit_equal(unpack_leaves(spec, bufs_), w, tag)

    name, kw, exact = EXCHANGE_CASES[case[0]]
    import jax
    import jax.numpy as jnp
    spec_args = dict(
        leaves=[jax.ShapeDtypeStruct(sh, jnp.bfloat16) for sh in LEAF_SHAPES],
        align=gossip._pack_align(comp), exact_small_leaves=exact,
        small_leaf_threshold=SMALL_LEAF_THRESHOLD)
    sizes = bucket_wire_nbytes(spec, comp)
    assert len(calls) == case[1] * spec.n_buckets
    for j, (bucket, delta, payload) in enumerate(calls):
        assert delta.dtype == BF16
        wants = _jax_payloads(name, kw, spec_args, 100 + case[0],
                              j // spec.n_buckets, bucket, delta)
        for i, wp in enumerate(wants):
            assert type(payload).__name__ == type(wp).__name__
            assert _check_payload(_row(payload, i), wp) == sizes[bucket.index]


def _dist_rank(rank, store, out_dir, paths):
    group = _join(rank, store)
    results = {}
    for case in CASES:
        comp, spec, scheds, gamma, bufs, _, draws = _setup(case,
                                                           paths[_tag(case)])
        ex = gossip.make_dist_choco_exchange(
            spec=spec, schedules=scheds, compressor=comp, gamma=gamma,
            gossip_steps=case[1], group=group)
        x, x_hat, s = [[b[rank:rank + 1].clone() for b in part]
                       for part in bufs]
        before = group.bytes_sent
        row = None if draws is None else (
            lambda t, b: draws(t, b)[rank:rank + 1])
        ex(x, x_hat, s, draws=row)
        results[_tag(case)] = (x, x_hat, s, group.bytes_sent - before,
                               ex.payload_bytes, ex.sends)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_dist_exchange_matches_stacked_and_jax(tmp_path, jax_runs):
    """4 gloo ranks run every case with JAX's draws: each rank's x, x_hat
    and s bit-equal to its row of the JAX engine's (so of the stacked
    exchange's), and its bytes sent equal to its sends times the payload
    bytes ``bucket_wire_nbytes`` gives (those of JAX's arrays, checked
    above)."""
    ranks = _spawn(_dist_rank, tmp_path, str(tmp_path), jax_runs)
    for case in CASES:
        comp, spec, _, _, _, want, _ = _setup(case, jax_runs[_tag(case)])
        sizes = bucket_wire_nbytes(spec, comp)
        for r, res in enumerate(ranks):
            x, x_hat, s, sent, payload, sends = res[_tag(case)]
            for tag, bufs_, w in zip(("x", "x_hat", "s"), (x, x_hat, s), want):
                _assert_bit_equal(unpack_leaves(spec, bufs_),
                                  [leaf[r:r + 1] for leaf in w],
                                  (_tag(case), r, tag))
            assert payload == sizes
            assert sent == sends * sum(sizes), (_tag(case), r)


def test_exchange_refuses_what_bf16_state_does_not_take():
    """Several receive-weight groups (a hand-built W) and mixed state
    dtypes are refused; the exact modes keep f32."""
    from test_torch_topology import _irregular
    topo = _irregular()
    spec = make_bucket_spec([torch.empty((700,), dtype=BF16, device="meta")])
    with pytest.raises(ValueError, match="one uniform receive weight"):
        gossip.make_choco_exchange(
            spec=spec, schedules=(schedule.compile_schedule(topo),),
            compressor=make_compressor("identity"), gamma=0.3)
    mixed = make_bucket_spec(
        [torch.empty((700,), dtype=BF16, device="meta"),
         torch.empty((700,), dtype=torch.float32, device="meta")])
    ring = (schedule.compile_schedule(topology.make_topology("ring", N)),)
    with pytest.raises(ValueError, match="one dtype"):
        gossip.make_choco_exchange(spec=mixed, schedules=ring,
                                   compressor=make_compressor("identity"),
                                   gamma=0.3)
    with pytest.raises(ValueError, match="f32 iterate"):
        gossip.make_plain_exchange(spec=spec, schedules=ring)


# -- (c) the trainer -------------------------------------------------------------

TRAINER_CASES = [
    pytest.param("qsgd", 16, 2, "ring", id="qsgd-16-2-ring"),
    pytest.param("top_k", 0.05, 1, "ring", id="top_k-0.05-1-ring"),
    pytest.param("top_k", 0.05, 1, "star", id="top_k-0.05-1-star"),
]


@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("comp,arg,k,topo", TRAINER_CASES)
def test_trainer_with_bf16_state_matches_jax(tmp_path_factory, comp, arg, k,
                                             topo):
    """3 steps with ``state_dtype="bfloat16"`` from the JAX trainer's
    initial parameters, with ``check_against_jax``'s tolerances; x_hat and
    s are bf16 buckets, x f32."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import make_lm_batch_fn
    from test_torch_slice import (BPN, SEQ, STEPS, _port_trainer, _tree,
                                  check_against_jax, jax_reference_path)
    ref_ = Reference(jax_reference_path(
        tmp_path_factory, comp, arg, k, False, topology=topo,
        state_dtype="bfloat16"))
    tr = _port_trainer(comp, arg, k, False, topology=topo,
                       state_dtype="bfloat16")
    assert [tr.gamma] + tr.exchange.bucket_gammas == list(ref_["gamma"])
    state = tr.state_from_params(params_from_jax(_tree(ref_, "x0")))
    assert {b.dtype for b in state.x} == {torch.float32}
    assert {b.dtype for b in state.x_hat + state.s} == {BF16}
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    mets = []
    for j in range(STEPS):
        draws = None
        if comp == "qsgd":
            draws = lambda t, b, j=j: torch.from_numpy(ref_[f"xi:{j}:{t}:{b}"])
        m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
        mets.append([m["loss"], m["lr"], m["grad_norm"]])
    check_against_jax(tr, state, mets, ref_, comp)


def test_trainer_refuses_a_state_dtype_it_does_not_run():
    from test_torch_slice import _port_trainer
    with pytest.raises(ValueError, match="state_dtype='float16'"):
        _port_trainer("top_k", 0.05, 1, False, state_dtype="float16")


# -- (d) the launcher --------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1", "--steps", "2",
          "--seq-len", "32", "--batch-per-node", "2", "--device", "cpu",
          "--state-dtype", "bfloat16"]


@pytest.mark.parametrize("extra", [
    ["--compressor", "top_k", "--fraction", "0.05"],
    ["--compressor", "qsgd", "--qsgd-s", "16", "--topology", "star"],
    ["--mode", "plain"],
])
def test_launcher_trains_with_bf16_state_on_cpu(extra, capsys):
    from repro_torch.launch import train as launcher
    assert launcher.main(_SMOKE + extra) == 0
    out = capsys.readouterr().out
    assert "engine=stacked state_dtype=bfloat16 " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launcher_per_rank_prints_the_state_dtype():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *_SMOKE, "--simulate-devices", "4",
                        "--compressor", "qsgd", "--qsgd-s", "16"],
                       env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    assert "engine=per-rank state_dtype=bfloat16 " in r.stdout
    assert "[train] engine per-rank state_dtype=bfloat16: one process" \
        in r.stdout
    steps = [line for line in r.stdout.splitlines()
             if line.startswith("[train] step")]
    assert len(steps) == 2 and all(" B sent by rank 0" in s for s in steps)
