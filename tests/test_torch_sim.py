"""The paper's algorithms as matrix simulators, held against the JAX
package on the CPU: CHOCO-Gossip (Algorithms 1 and 5), the exact, Q1 and
Q2 gossip baselines, CHOCO-SGD (Algorithm 6), plain D-SGD, DCD, ECD and
centralized SGD on the logistic-regression problem, the averaging
schemes, the stepsize rules, and the row-wise compressors behind them.

JAX's random draws cannot be made by torch, so each test makes them with
``jax.random`` exactly as the JAX function does inside (its key splits,
and ``vmap`` over the node keys) and injects them: QSGD's dither, RandK's
positions and the logreg minibatch indices.  ``x0`` is JAX's normal draw.

Tolerances, and why:

* wire codes and selected indices are equal.  QSGD's level is
  ``floor(s |x| / ||x|| + xi)`` in JAX and ``floor(|x| (1/||x||) s + xi)``
  in the port's codes kernel (the Pallas kernel's form), with the norm
  summed in another order: where the value lies within float rounding of
  an integer the two may take adjacent levels, so those positions (a
  1e-5 band) are exempt and counted;
* f32 iterates agree at ulp level (matmul and reduction order): within
  1e-5 of the iterate's largest magnitude while no selection or level
  flips (a small coordinate is the difference of larger ones, so its own
  relative error can be larger); error curves and losses 1e-5 relative;
* over the quickstart's long horizons (300 QSGD rounds, 3000 top-k
  rounds) a flipped selection or level moves the curve a little: the
  error curves agree within 1e-4 relative, round by round (measured on
  these draws: at most 2.5e-5 for top 1%, 2.4e-5 for QSGD, 4.1e-7 exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import choco_gossip as jchoco
from repro.core import choco_sgd as jsgd
from repro.core import compression as jcomp
from repro.core import consensus as jcons
from repro.core import topology as jtopo
from repro.data import synthetic as jsyn
from repro_torch.core import baselines, choco_gossip, choco_sgd, consensus
from repro_torch.core import compression, topology
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from test_torch_slice import one_thread  # noqa: F401  (autouse)

RTOL = 1e-5


def _close(got, want):
    """f32 iterates within RTOL of the reference's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=RTOL * max(
        float(np.abs(want).max()), 1e-6))


def _np(a):
    return np.array(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _node_draws(comp, key, n, d):
    """What JAX's ``_rowwise_compress`` draws per node from ``key``: QSGD's
    dither (n, d), RandK's permutation prefix (n, k)."""
    keys = jax.random.split(key, n)
    if isinstance(comp, jcomp.QSGD):
        return jax.vmap(lambda k: jax.random.uniform(k, (d,)))(keys)
    if isinstance(comp, jcomp.RandK):
        k = jcomp._resolve_k(d, comp.k, comp.fraction)
        return jax.vmap(lambda kk: jax.random.permutation(kk, d)[:k])(keys)
    return None


def _round_draws(comp, key, steps, n, d):
    """Per round t of a JAX run with ``key``: the injected draw, or None."""
    if not comp.stochastic:
        return None
    keys = jax.random.split(key, steps)
    draws = [_np(_node_draws(comp, k, n, d)) for k in keys]
    return lambda t: torch.from_numpy(draws[t])


# -- the compressors, row by row ------------------------------------------------

@pytest.mark.parametrize("s,rescale", [(16, True), (127, True), (16, False),
                                       (255, False)])
def test_qsgd_rows_match_jax(s, rescale):
    n, d = 6, 3000
    x = np.random.default_rng(s).standard_normal((n, d)).astype(np.float32)
    x[2] = 0.0                                   # a zero row: codes 0
    key = jax.random.PRNGKey(7)
    xi = _np(_node_draws(jcomp.QSGD(s), key, n, d))
    jq = jcomp.QSGD(s, rescale=rescale)
    keys = jax.random.split(key, n)
    codes, scale = ops.qsgd_compress(
        torch.from_numpy(x), torch.from_numpy(xi), s,
        jq._tau(d) if rescale else 1.0)
    dense = compression.QSGD(s, rescale=rescale).apply(
        torch.from_numpy(x), torch.from_numpy(xi))
    exempt = 0
    for i in range(n):
        p = jq.compress(keys[i], jnp.asarray(x[i]))
        want = _np(p.codes)
        norm = np.linalg.norm(x[i].astype(np.float64))
        level = s * np.abs(x[i]) / (norm if norm else 1.0) + xi[i]
        edge = np.abs(level - np.round(level)) < 1e-5
        exempt += int(edge.sum())
        got = codes[i].numpy()
        assert np.all(got[~edge] == want[~edge])
        assert np.all(np.abs(got[edge].astype(int) - want[edge]) <= 1)
        np.testing.assert_allclose(scale[i].numpy(), _np(p.scale), rtol=1e-6)
        same = got == want
        np.testing.assert_allclose(dense[i].numpy()[same],
                                   _np(p.dense())[same], rtol=1e-6)
    assert exempt <= n * d // 1000


def test_sign_topk_randk_rows_match_jax():
    n, d = 5, 1000
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    x[1, :10] = 0.0
    X = torch.from_numpy(x)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, n)
    sign = compression.SignNorm().apply(X)
    topk = compression.TopK(fraction=0.03).apply(X)
    perms = _np(_node_draws(jcomp.RandK(fraction=0.05), key, n, d))
    randk = compression.RandK(fraction=0.05).apply(X, torch.from_numpy(perms))
    block = compression.BlockTopK(fraction=0.05).apply(X)
    for i in range(n):
        row = jnp.asarray(x[i])
        js = jcomp.SignNorm().compress(None, row)
        np.testing.assert_array_equal(np.sign(sign[i].numpy()),
                                      _np(js.codes).astype(np.float32))
        np.testing.assert_allclose(sign[i].numpy(), _np(js.dense()),
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            topk[i].numpy(), _np(jcomp.TopK(fraction=0.03).apply(None, row)))
        np.testing.assert_array_equal(
            randk[i].numpy(),
            _np(jcomp.RandK(fraction=0.05).apply(keys[i], row)))
        np.testing.assert_array_equal(
            block[i].numpy(),
            _np(jcomp.BlockTopK(fraction=0.05).apply(None, row)))


def test_stochastic_apply_takes_a_generator_or_refuses():
    X = torch.randn(3, 100, generator=torch.Generator().manual_seed(0))
    q = compression.QSGD(16)
    with pytest.raises(ValueError, match="needs its draw"):
        q.apply(X)
    a = q.apply(X, q.draw(X, torch.Generator().manual_seed(5)))
    b = q.apply(X, q.draw(X, torch.Generator().manual_seed(5)))
    assert torch.equal(a, b)
    keep = compression.RandomizedGossip(0.5)
    kept = keep.apply(X, torch.tensor([True, False, True]))
    assert torch.equal(kept[0], X[0]) and not kept[1].any()
    with pytest.raises(ValueError, match="Generator"):
        choco_gossip.run_choco_gossip(X, topology.ring(3).W, 0.5, q, 2)


# -- CHOCO-Gossip and the gossip baselines ------------------------------------

SMALL_N, SMALL_D, SMALL_STEPS = 8, 64, 20
GOSSIP_CASES = [("identity", {}, 1.0), ("top_k", {"fraction": 0.1}, 0.2),
                ("qsgd", {"s": 16}, 0.5), ("sign", {}, 0.1),
                ("rand_k", {"fraction": 0.25}, 0.3)]


def _small(seed=0):
    x0 = jax.random.normal(jax.random.PRNGKey(seed), (SMALL_N, SMALL_D))
    W = jtopo.ring(SMALL_N).W
    return x0, W


@pytest.mark.parametrize("name,kw,gamma", GOSSIP_CASES)
def test_choco_gossip_algorithms_1_and_5_match_jax(name, kw, gamma):
    x0, W = _small()
    jc = jcomp.make_compressor(name, **kw)
    tc = compression.make_compressor(name, **kw)
    key = jax.random.PRNGKey(11)
    draws = _round_draws(jc, key, SMALL_STEPS, SMALL_N, SMALL_D)
    (jx, jh), jerr = jchoco.run_choco_gossip(x0, jnp.asarray(W), gamma, jc,
                                             SMALL_STEPS, key=key)
    st1, err1 = choco_gossip.run_choco_gossip(_t(x0), W, gamma, tc,
                                              SMALL_STEPS, draws=draws)
    st5, err5 = choco_gossip.run_choco_gossip_efficient(
        _t(x0), W, gamma, tc, SMALL_STEPS, draws=draws)
    # Algorithms 1 and 5 agree with each other (the same math, another
    # association) and each with JAX
    for st, err in ((st1, err1), (st5, err5)):
        np.testing.assert_allclose(err.numpy(), _np(jerr), rtol=RTOL)
        _close(st.x.numpy(), _np(jx))
        _close(st.x_hat.numpy(), _np(jh))
    _close(st5.x.numpy(), st1.x.numpy())
    # the efficient form's aggregate is W x_hat
    _close(st5.s.numpy(), W.astype(np.float32) @ st5.x_hat.numpy())


@pytest.mark.parametrize("scheme", ["exact", "q1", "q2"])
def test_gossip_baselines_match_jax(scheme):
    x0, W = _small(1)
    jc = None if scheme == "exact" else jcomp.QSGD(16, rescale=False)
    tc = None if scheme == "exact" else compression.QSGD(16, rescale=False)
    key = jax.random.PRNGKey(5)
    draws = (None if jc is None
             else _round_draws(jc, key, SMALL_STEPS, SMALL_N, SMALL_D))
    jX, jerr = jbase.run_gossip_baseline(scheme, x0, jnp.asarray(W), jc,
                                         SMALL_STEPS, 0.5, key=key)
    X, err = baselines.run_gossip_baseline(scheme, _t(x0), W, tc, SMALL_STEPS,
                                           0.5, draws=draws)
    np.testing.assert_allclose(err.numpy(), _np(jerr), rtol=RTOL)
    _close(X.numpy(), _np(jX))
    with pytest.raises(ValueError):
        baselines.run_gossip_baseline("q3", _t(x0), W, tc, 1)


def test_averaging_schemes_match_jax():
    x0, W = _small(2)
    topo = jtopo.ring(SMALL_N)
    jW = jnp.asarray(W)
    tW = choco_gossip.mixing(W, _t(x0))
    je = jcons.exact_averaging(jW, topo.delta, 0.7)
    te = consensus.exact_averaging(tW, topo.delta, 0.7)
    assert te.p == je.p and te.name == je.name
    _close(te.h(_t(x0), _t(x0))[0].numpy(), _np(je.h(x0, x0)[0]))
    jc = jcons.choco_averaging(jW, topo.delta, topo.beta,
                               jcomp.TopK(fraction=0.1), SMALL_D)
    tc = consensus.choco_averaging(tW, topo.delta, topo.beta,
                                   compression.TopK(fraction=0.1), SMALL_D)
    assert tc.p == jc.p and tc.name == jc.name
    X, Y = x0, jnp.zeros_like(x0)
    tX, tY = _t(x0), torch.zeros(SMALL_N, SMALL_D)
    for _ in range(5):
        X, Y = jc.h(X, Y)
        tX, tY = tc.h(tX, tY)
    _close(tX.numpy(), _np(X))
    _close(tY.numpy(), _np(Y))


# -- the stepsize rules ---------------------------------------------------------

def test_stepsize_rules_match_jax():
    for delta, beta, omega in ((0.05, 1.3, 0.01), (1.0, 1.0, 1.0),
                               (0.2, 0.8, 0.5)):
        assert choco_gossip.theorem2_rate(delta, omega) == \
            jchoco.theorem2_rate(delta, omega)
        assert choco_sgd.auto_gamma(delta, beta, omega) == \
            jsgd.auto_gamma(delta, beta, omega)
        assert choco_sgd.theorem4_a(delta, omega, 30.0) == \
            jsgd.theorem4_a(delta, omega, 30.0)
    topo = topology.make_topology("star", 5)
    comp = compression.TopK(fraction=0.01)
    assert choco_gossip.auto_stepsize(topo, comp, 2000) == jchoco.auto_stepsize(
        jtopo.make_topology("star", 5), jcomp.TopK(fraction=0.01), 2000)
    pairs = ((choco_sgd.experiment_lr_schedule(9, 0.1, 300.0),
              jsgd.experiment_lr_schedule(9, 0.1, 300.0)),
             (choco_sgd.theorem4_lr_schedule(0.03, 4100.0),
              jsgd.theorem4_lr_schedule(0.03, 4100.0)))
    for mine, theirs in pairs:
        for t in (0, 1, 7, 299, 12345):
            assert mine(t) == float(theirs(jnp.int32(t)))


# -- logistic regression ----------------------------------------------------------

@pytest.mark.parametrize("name,sort", [("epsilon", True), ("epsilon", False),
                                       ("rcv1", False)])
def test_make_logreg_equals_jax_bit_for_bit(name, sort):
    kw = dict(sorted_assignment=sort, seed=3, m=400, d=120)
    got = synthetic.make_logreg(name, 4, device="cpu", **kw)
    want = jsyn.make_logreg(name, 4, **kw)
    np.testing.assert_array_equal(got.A.numpy(), _np(want.A))
    np.testing.assert_array_equal(got.b.numpy(), _np(want.b))
    np.testing.assert_array_equal(got.node_index.numpy(), _np(want.node_index))
    assert got.reg == want.reg and got.d == want.d
    x = np.random.default_rng(0).standard_normal(120).astype(np.float32)
    np.testing.assert_allclose(float(got.full_loss(torch.from_numpy(x))),
                               float(want.full_loss(jnp.asarray(x))),
                               rtol=RTOL)
    # the Dirichlet shards over the labels, bit for bit too
    kw = dict(kw, sorted_assignment=False, skew_alpha=0.5)
    got = synthetic.make_logreg(name, 4, device="cpu", **kw)
    want = jsyn.make_logreg(name, 4, **kw)
    np.testing.assert_array_equal(got.A.numpy(), _np(want.A))
    np.testing.assert_array_equal(got.node_index.numpy(), _np(want.node_index))
    with pytest.raises(ValueError, match="mutually exclusive"):
        synthetic.make_logreg(name, 4, device="cpu",
                              **dict(kw, sorted_assignment=True))


N_SGD, BS, SGD_STEPS = 4, 3, 8


def _logreg():
    kw = dict(sorted_assignment=True, seed=2, m=400, d=50)
    return (jsyn.make_logreg("epsilon", N_SGD, **kw),
            synthetic.make_logreg("epsilon", N_SGD, device="cpu", **kw))


def _batches(key, n, m_per):
    """JAX's minibatch indices for one step key: per node i,
    randint(split(key, n)[i], (BS,), 0, m_per)."""
    keys = jax.random.split(key, n)
    return torch.from_numpy(_np(jax.vmap(
        lambda k: jax.random.randint(k, (BS,), 0, m_per))(keys)).astype(
            np.int64))


def test_logreg_gradient_matches_jax():
    jp, tp = _logreg()
    X = np.random.default_rng(4).standard_normal(
        (N_SGD, 50)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jg = jax.vmap(jp.make_grad_fn(BS))(jnp.asarray(X), jnp.arange(N_SGD),
                                       jax.random.split(key, N_SGD))
    tg = tp.make_grad_fn(BS)
    batch = _batches(key, N_SGD, tp.node_index.shape[1])
    np.testing.assert_allclose(tg(torch.from_numpy(X), batch).numpy(),
                               _np(jg), rtol=RTOL, atol=1e-7)
    drawn = tg.draw(N_SGD, torch.Generator().manual_seed(0))
    assert drawn.shape == (N_SGD, BS) and int(drawn.max()) < 100


@pytest.mark.parametrize("name,kw,gamma", [
    ("qsgd", {"s": 16}, 0.3), ("top_k", {"fraction": 0.1}, 0.1),
    ("identity", {}, 1.0)])
def test_choco_sgd_matches_jax(name, kw, gamma):
    jp, tp = _logreg()
    jc = jcomp.make_compressor(name, **kw)
    tc = compression.make_compressor(name, **kw)
    W = jtopo.ring(N_SGD).W
    key = jax.random.PRNGKey(21)
    m_per = tp.node_index.shape[1]
    step_keys = jax.random.split(key, SGD_STEPS)
    injected = []
    for k in step_keys:
        gkey, ckey = jax.random.split(k)
        rand = _node_draws(jc, ckey, N_SGD, 50)
        injected.append((_batches(gkey, N_SGD, m_per),
                         None if rand is None else _t(rand)))
    lr = (choco_sgd.experiment_lr_schedule(N_SGD, 0.5, 10.0),
          jsgd.experiment_lr_schedule(N_SGD, 0.5, 10.0))
    x0 = np.zeros((N_SGD, 50), np.float32)
    jst, jtrace = jsgd.run_choco_sgd(
        jnp.asarray(x0), jnp.asarray(W), jp.make_grad_fn(BS), jc, lr[1],
        gamma, SGD_STEPS, key=key, eval_fn=jp.full_loss)
    st, trace = choco_sgd.run_choco_sgd(
        torch.from_numpy(x0), W, tp.make_grad_fn(BS), tc, lr[0], gamma,
        SGD_STEPS, draws=lambda t: injected[t], eval_fn=tp.full_loss)
    assert st.t == SGD_STEPS
    np.testing.assert_allclose(trace.numpy(), _np(jtrace), rtol=RTOL)
    for got, want in ((st.x, jst.x), (st.x_hat, jst.x_hat), (st.s, jst.s)):
        _close(got.numpy(), _np(want))


def test_dsgd_dcd_ecd_and_centralized_match_jax():
    """Plain D-SGD, DCD and ECD with QSGD(16), and centralized SGD, for
    SGD_STEPS steps each with the draws of the JAX loop (the step key
    ``fold_in(key, i)``, as ``benchmarks/bench_sgd.py`` runs them)."""
    jp, tp = _logreg()
    jg, tg = jp.make_grad_fn(BS), tp.make_grad_fn(BS)
    jW = jnp.asarray(jtopo.ring(N_SGD).W)
    tW = choco_gossip.mixing(jtopo.ring(N_SGD).W, torch.zeros(1))
    jc, tc = jcomp.QSGD(16), compression.QSGD(16)
    m_per = tp.node_index.shape[1]
    key = jax.random.PRNGKey(13)
    eta = 0.5
    jx = jnp.zeros((N_SGD, 50))
    jd = jbase.DCDState(x=jx)
    je = jbase.ECDState(x=jx, x_tilde=jx, t=jnp.zeros((), jnp.int32))
    jcen = jnp.zeros((50,))
    tx = torch.zeros(N_SGD, 50)
    td, te = baselines.DCDState(x=tx), baselines.ECDState(x=tx, x_tilde=tx, t=0)
    tcen = torch.zeros(50)
    for i in range(SGD_STEPS):
        k = jax.random.fold_in(key, i)
        gkey, ckey = jax.random.split(k)
        xi = _t(_node_draws(jc, ckey, N_SGD, 50))
        jx = jbase.plain_dsgd_step(jx, jW, jg, eta, k)
        tx = baselines.plain_dsgd_step(tx, tW, tg, eta,
                                       _batches(k, N_SGD, m_per))
        jd = jbase.dcd_sgd_step(jd, jW, jg, jc, eta, k)
        td = baselines.dcd_sgd_step(td, tW, tg, tc, eta,
                                    _batches(gkey, N_SGD, m_per), xi)
        je = jbase.ecd_sgd_step(je, jW, jg, jc, eta, k)
        te = baselines.ecd_sgd_step(te, tW, tg, tc, eta,
                                    _batches(gkey, N_SGD, m_per), xi)
        jcen = jbase.centralized_sgd_step(jcen, jg, N_SGD, eta, k)
        tcen = baselines.centralized_sgd_step(tcen, tg, N_SGD, eta,
                                              _batches(k, N_SGD, m_per))
    for got, want in ((tx, jx), (td.x, jd.x), (te.x, je.x),
                      (te.x_tilde, je.x_tilde), (tcen, jcen)):
        _close(got.numpy(), _np(want))
    assert te.t == SGD_STEPS


# -- the quickstart's sizes -------------------------------------------------------

def test_quickstart_error_curves_match_jax():
    """ring n = 25, d = 2000, as ``examples/quickstart.py`` runs it: exact
    gossip for 300 rounds, CHOCO with QSGD(127) for 300 and with top 1%
    for 3000; the error curves round by round within 1e-4 relative."""
    n, d = 25, 2000
    W = jtopo.ring(n).W
    x0 = jax.random.normal(jax.random.PRNGKey(0), (n, d))
    _, want = jbase.run_gossip_baseline("exact", x0, jnp.asarray(W), None, 300)
    _, got = baselines.run_gossip_baseline("exact", _t(x0), W, None, 300)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4)
    for comp, gamma, steps in ((jcomp.QSGD(127), 1.0, 300),
                               (jcomp.TopK(fraction=0.01), 0.046, 3000)):
        draws = _round_draws(comp, jax.random.PRNGKey(0), steps, n, d)
        _, want = jchoco.run_choco_gossip(x0, jnp.asarray(W), gamma, comp,
                                          steps)
        tcomp = (compression.QSGD(127) if isinstance(comp, jcomp.QSGD)
                 else compression.TopK(fraction=0.01))
        _, got = choco_gossip.run_choco_gossip(_t(x0), W, gamma, tcomp, steps,
                                               draws=draws)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4)
        assert float(got[-1]) < 1e-3 * float(got[0])


def test_quickstart_example_runs_on_the_cpu_when_asked():
    import os
    import subprocess
    import sys
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    # one torch thread, as in this module's fixture: the example's tensors
    # are small, and pytest-xdist's workers share the cores
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    script = os.path.join(root, "examples", "quickstart_torch.py")
    r = subprocess.run([sys.executable, script, "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[")]
    assert [ln.split("]")[0] for ln in lines] == ["[exact  ", "[qsgd   ",
                                                  "[top 1% "]
    for ln in lines:
        first, last = (float(v) for v in
                       ln.split("err: ")[1].split()[0:3:2])
        assert last < 1e-3 * first
