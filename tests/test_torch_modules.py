"""Modules of the PyTorch port held against the JAX package on the CPU.

Topology, schedule, compression factors, stepsizes, bucket layout, wire
payloads, optimizer, schedule and data, each on the same inputs (made
with numpy from a seed) on both sides:

* W, delta, beta and the schedule's reconstruction of W: exact;
* bucket slots and offsets: identical, for the smoke tree and for the
  full-width tree the chip run trains;
* ``compress_bufs`` payloads with the JAX package's dither injected:
  codes identical, scales within 1e-6 relative (a few ulp: the norm and
  |x|-sum over a 1.4M-element bucket run in another order in XLA and in
  PyTorch, each accurate to O(log n) ulp);
* momentum update and token batches: identical; the cosine learning
  rate within 1 ulp (float32 cos differs between XLA and PyTorch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import packing as jpacking
from repro.comm import schedule as jschedule
from repro.comm.gossip import _leaf_routes, _resolve_bucket_gammas as jgammas
from repro.configs import qwen3_1_7b as jqwen
from repro.core import choco_gossip as jchoco
from repro.core import compression as jcomp
from repro.core import topology as jtopo
from repro.data.synthetic import make_lm_batch_fn as jbatches
from repro.launch.sharding import param_pspecs
from repro.models.transformer import Model as JModel
from repro.optim.sgd import OptState, cosine_schedule as jcosine, momentum_sgd
from repro_torch.comm import gossip, packing, schedule
from repro_torch.configs import qwen3_1_7b as tqwen
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import choco_gossip, compression, topology
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.models.transformer import param_shapes
from repro_torch.optim.sgd import OptState as TOptState, cosine_schedule
from repro_torch.optim.sgd import momentum_sgd as tmomentum

N = 4


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16])
def test_ring_matches_jax(n):
    got, want = topology.ring(n), jtopo.ring(n)
    np.testing.assert_array_equal(got.W, want.W)
    assert got.neighbors == want.neighbors
    assert (got.delta, got.beta, got.rho) == (want.delta, want.beta, want.rho)
    assert topology.spectral_gap(got.W) == jtopo.spectral_gap(want.W)
    assert topology.beta_norm(got.W) == jtopo.beta_norm(want.W)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16])
def test_ring_schedule_matches_jax(n):
    got = schedule.compile_schedule(topology.ring(n))
    want = jschedule.compile_schedule(jtopo.ring(n))
    assert got.n_rounds == want.n_rounds
    for a, b in zip(got.rounds, want.rounds):
        assert (a.perm, a.weight, a.weights) == (b.perm, b.weight, b.weights)
    assert (got.self_weights, got.self_weight) == (want.self_weights,
                                                   want.self_weight)
    np.testing.assert_array_equal(got.mixing_matrix(), want.mixing_matrix())
    np.testing.assert_array_equal(got.mixing_matrix(), topology.ring(n).W)


def test_unported_topologies_raise():
    with pytest.raises(ValueError, match="unknown topology"):
        topology.make_topology("directed_torus", 4)
    with pytest.raises(ValueError, match="unknown compressor"):
        compression.make_compressor("top_q", fraction=0.01)


@pytest.mark.parametrize("d", [1, 128, 1000, 1_441_792, 311_164_928])
@pytest.mark.parametrize("name,kw", [("qsgd", {"s": 1}), ("qsgd", {"s": 16}),
                                     ("qsgd", {"s": 127}), ("qsgd", {"s": 128}),
                                     ("qsgd", {"s": 255}), ("sign", {}),
                                     ("identity", {})])
def test_compressor_factors_match_jax(name, kw, d):
    got = compression.make_compressor(name, **kw)
    want = jcomp.make_compressor(name, **kw)
    assert got.omega(d) == want.omega(d)
    assert got.wire_bits(d) == want.wire_bits(d)
    assert got.stochastic == want.stochastic


@pytest.mark.parametrize("s", [1, 16, 127, 128, 255])
def test_qsgd_code_type(s):
    assert compression.code_dtype(s) == (torch.int8 if s <= 127 else torch.int16)
    assert compression.code_bits(s) == jcomp.QSGD(s).wire_bits(1) - 32


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("omega", [1.0, 0.4, 1e-6])
def test_stepsizes_match_jax(n, omega):
    t = topology.ring(n)
    assert (choco_gossip.theorem2_stepsize(t.delta, t.beta, omega)
            == jchoco.theorem2_stepsize(t.delta, t.beta, omega))
    assert (choco_gossip.GammaSpec(t.delta, t.beta, 0.5).value(omega)
            == jchoco.GammaSpec(t.delta, t.beta, 0.5).value(omega))
    assert (choco_gossip.auto_stepsize(t, compression.QSGD(16), 4096)
            == jchoco.auto_stepsize(jtopo.ring(n), jcomp.QSGD(16), 4096))


# -- bucket layout ------------------------------------------------------------

def _jax_tree_shapes(cfg):
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    return jax.eval_shape(jax.vmap(JModel(cfg).init), keys)


def _jax_spec(cfg, **kw):
    shapes = _jax_tree_shapes(cfg)
    specs = param_pspecs(shapes, cfg, node_axis="data", model_size=0)
    local = [jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
             for leaf in jax.tree.leaves(shapes)]
    return jpacking.make_bucket_spec(local, routes=_leaf_routes(specs, "data"),
                                     **kw)


def _port_spec(cfg, **kw):
    shapes = param_shapes(cfg)
    return packing.make_bucket_spec(
        [torch.empty(s, device="meta") for _, s in shapes],
        routes=[packing.leaf_route(p) for p, _ in shapes], **kw)


_CFGS = {
    "smoke": (jqwen.SMOKE_CONFIG, tqwen.SMOKE_CONFIG),
    "full_width_2_layers": (dataclasses.replace(jqwen.CONFIG, n_layers=2),
                            dataclasses.replace(tqwen.CONFIG, n_layers=2)),
}
_LAYOUTS = {"default": {}, "small_cap": {"max_bucket_elems": 1 << 16},
            "exact_small_leaves": {"exact_small_leaves": True}}
#: every compressor, at the launcher's settings (fraction 0.01)
_COMPRESSORS = [("qsgd", {"s": 16}), ("sign", {}), ("identity", {}),
                ("top_k", {"fraction": 0.01}), ("rand_k", {"fraction": 0.01}),
                ("block_top_k", {"fraction": 0.01}),
                ("randomized_gossip", {"p": 0.3})]


@pytest.mark.parametrize("cfg", sorted(_CFGS))
def test_leaf_order_and_shapes_match_jax(cfg):
    jcfg, tcfg = _CFGS[cfg]
    flat = jax.tree_util.tree_flatten_with_path(_jax_tree_shapes(jcfg))[0]
    want = [("/".join(k.key for k in path), tuple(leaf.shape[1:]))
            for path, leaf in flat]
    assert param_shapes(tcfg) == want


@pytest.mark.parametrize("name,kw", _COMPRESSORS)
@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("cfg", sorted(_CFGS))
def test_bucket_spec_matches_jax(cfg, layout, name, kw):
    jcfg, tcfg = _CFGS[cfg]
    got, want = _port_spec(tcfg, **_LAYOUTS[layout]), _jax_spec(jcfg, **_LAYOUTS[layout])
    assert [(s.leaf, s.bucket, s.offset, s.size, s.shape) for s in got.slots] \
        == [(s.leaf, s.bucket, s.offset, s.size, s.shape) for s in want.slots]
    assert [(b.index, b.exact, b.size, b.logical) for b in got.buckets] \
        == [(b.index, b.exact, b.size, b.logical) for b in want.buckets]
    assert any(b.exact for b in got.buckets) == (layout == "exact_small_leaves")
    tc, jc = compression.make_compressor(name, **kw), jcomp.make_compressor(name, **kw)
    assert packing.bucket_omegas(got, tc) == jpacking.bucket_omegas(want, jc)
    assert packing.bucket_omega_worst(got, tc) == jpacking.bucket_omega_worst(want, jc)
    assert packing.bucket_wire_bits(got, tc) == jpacking.bucket_wire_bits(want, jc)
    spec = jchoco.GammaSpec(0.5, 1.3)
    assert gossip._resolve_bucket_gammas(
        choco_gossip.GammaSpec(0.5, 1.3), got, tc) == jgammas(spec, want, jc)


def test_exchange_refuses_unported_compressors():
    class Halve(compression.Compressor):
        name = "halve"

    spec = _port_spec(tqwen.SMOKE_CONFIG)
    with pytest.raises(ValueError, match="not ported"):
        gossip.make_choco_exchange(
            spec=spec, schedules=(schedule.compile_schedule(topology.ring(N)),),
            compressor=Halve(), gamma=0.5)


@pytest.mark.parametrize("name,kw,exact", [
    pytest.param(name, kw, exact, id=f"{name}-kw{i}" + ("-exact" if exact else ""))
    for exact in (False, True) for i, (name, kw) in enumerate(_COMPRESSORS)])
@pytest.mark.parametrize("cfg", sorted(_CFGS))
def test_trainer_gamma_matches_jax_rule(cfg, name, kw, exact):
    """The port trainer's Theorem-2 gamma (scalar worst case and per
    bucket) equals the JAX trainer's rule on the same bucket layout: about
    2e-5 for QSGD(16) and 7e-11 for SignNorm at full width, 4 nodes."""
    from repro.comm.gossip import _pack_align as jalign
    from repro_torch.configs.base import ChocoConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train.trainer import DecentralizedTrainer
    jcfg, tcfg = _CFGS[cfg]
    tr = DecentralizedTrainer(
        model=Model(tcfg), choco=ChocoConfig(compressor=name,
                                             comp_kwargs=tuple(kw.items()),
                                             exact_small_leaves=exact),
        n_nodes=N, optimizer=tmomentum(), lr_fn=cosine_schedule(0.1, 1, 3),
        device="cpu")
    ring, jc = jtopo.ring(N), jcomp.make_compressor(name, **kw)
    spec = _jax_spec(jcfg, align=jalign(jc, None), exact_small_leaves=exact)
    assert tr.gamma == jchoco.theorem2_stepsize(
        ring.delta, ring.beta, jpacking.bucket_omega_worst(spec, jc))
    assert tr.exchange.bucket_gammas == jgammas(
        jchoco.GammaSpec(ring.delta, ring.beta), spec, jc)


def _node_leaves(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N,) + s).astype(np.float32)
            for _, s in param_shapes(cfg)]


def test_pack_unpack_match_jax():
    cfg = tqwen.SMOKE_CONFIG
    got_spec, want_spec = _port_spec(cfg), _jax_spec(jqwen.SMOKE_CONFIG)
    leaves = _node_leaves(cfg, 0)
    bufs = packing.pack_leaves(got_spec, [torch.from_numpy(a) for a in leaves])
    for i in range(N):
        want = jpacking.pack_leaves(want_spec, [jnp.asarray(a[i]) for a in leaves])
        for b, w in zip(bufs, want):
            np.testing.assert_array_equal(b[i].numpy(), np.asarray(w))
    for a, u in zip(leaves, packing.unpack_leaves(got_spec, bufs)):
        np.testing.assert_array_equal(u.numpy(), a)


@pytest.mark.parametrize("name,kw", [("qsgd", {"s": 1}), ("qsgd", {"s": 16}),
                                     ("qsgd", {"s": 127}), ("qsgd", {"s": 128}),
                                     ("qsgd", {"s": 255}), ("sign", {})])
def test_compress_bufs_payloads_match_jax(name, kw):
    cfg = tqwen.SMOKE_CONFIG
    got_spec, want_spec = _port_spec(cfg), _jax_spec(jqwen.SMOKE_CONFIG)
    leaves = _node_leaves(cfg, 1)
    bufs = packing.pack_leaves(got_spec, [torch.from_numpy(a) for a in leaves])
    jc = jcomp.make_compressor(name, **kw)
    keys = [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(N)]
    # the JAX dither of node i, bucket b: uniform(fold_in(key_i, b))
    xi = {b.index: torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
              jax.random.fold_in(k, b.index), (b.size,))) for k in keys]))
          for b in want_spec.buckets}
    payloads, q_bufs = packing.compress_bufs(
        compression.make_compressor(name, **kw), got_spec, got_spec.buckets,
        bufs, draws=xi.__getitem__)
    for i in range(N):
        jbufs = [jnp.asarray(b[i].numpy()) for b in bufs]
        want_p, want_q = jpacking.compress_bufs(jc, keys[i], want_spec, jbufs)
        for p, wp, q, wq in zip(payloads, want_p, q_bufs, want_q):
            np.testing.assert_array_equal(p.codes[i].numpy(), np.asarray(wp.codes))
            assert (p.bits_per_coord, p.dim, p.logical) == \
                (wp.bits_per_coord, wp.dim, wp.logical)
            assert p.wire_bits() == wp.wire_bits()
            np.testing.assert_allclose(p.scale[i].numpy(), np.asarray(wp.scale),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(q[i].numpy(), np.asarray(wq), rtol=1e-6,
                                       atol=0)


def test_momentum_update_matches_jax():
    rng = np.random.default_rng(3)
    p, g, m = (rng.standard_normal((N, 4096)).astype(np.float32) for _ in range(3))
    tp, tg, tm = (torch.from_numpy(a.copy()) for a in (p, g, m))
    lr = cosine_schedule(0.1, 1, 3)(2)
    got = tmomentum(beta=0.9).update(
        [tp], [tg], TOptState(mu=[tm], nu=None, count=0), lr)
    assert got.count == 1 and got.mu[0] is tm
    opt = momentum_sgd(0.9)
    jstate = OptState(mu=jnp.asarray(m), nu=None, count=jnp.zeros((), jnp.int32))
    want_p, want_state = opt.update(jnp.asarray(p), jnp.asarray(g), jstate,
                                    jnp.float32(lr))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(want_state.mu))


@pytest.mark.parametrize("warmup,total", [(1, 3), (2, 10), (100, 1000)])
def test_cosine_schedule_matches_jax(warmup, total):
    got = cosine_schedule(0.1, warmup, total)
    want = jcosine(0.1, warmup, total)
    for t in range(0, total, max(1, total // 25)):
        w = np.float32(want(jnp.int32(t)))
        # float32 cos differs by up to 1 ulp between XLA and PyTorch; the
        # lr carries it scaled by lr0 / 2 (plus the lr's own rounding)
        tol = 0.1 * 0.5 * np.spacing(np.float32(1.0)) + np.spacing(w)
        assert abs(np.float32(got(t)) - w) <= tol


@pytest.mark.parametrize("heterogeneity", [0.0, 1.0])
def test_token_batches_match_jax(heterogeneity):
    got = make_lm_batch_fn(tqwen.SMOKE_CONFIG, 128, 4, N, heterogeneity)
    want = jbatches(jqwen.SMOKE_CONFIG, 128, 4, N, heterogeneity)
    for _ in range(3):
        a, b = got(), want()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_params_round_trip_through_jax_layout():
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    tree = jax.tree.map(np.asarray, jax.vmap(JModel(jqwen.SMOKE_CONFIG).init)(keys))
    params = params_from_jax(tree)
    assert [(k, tuple(v.shape[1:])) for k, v in params.items()] \
        == param_shapes(tqwen.SMOKE_CONFIG)
    back = params_to_jax(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
