"""The port's local optimizers, schedules and Dirichlet data skew, held
against the JAX package on the CPU.

* The optimizers against ``repro.optim`` on the same inputs, op by op
  (JAX runs eagerly, one rounded operation at a time): plain SGD and
  momentum SGD (Nesterov and weight decay too) bit-equal over four
  steps.  AdamW takes fused passes (``lerp_``, ``addcmul_``,
  ``addcdiv_``) that round elsewhere than JAX's formula: over four steps
  at lr 0.1, x within ``ADAMW_OP_ATOL`` = 2e-6 (measured 7.2e-07, a few
  ulp of |x| <= 4), m within 1e-6 (measured 1.2e-07) and v within 1e-6
  relative (measured 2.3e-07); inside the trainer x within
  ``ADAMW_ATOL`` (below).  The schedules, computed in f32, bit-equal.
* ``data/partition.py`` and the skewed token stream and logreg shards:
  every output bit-equal (the same numpy draws in the same order).
* The trainer against the JAX ``DecentralizedTrainer`` (one reference
  subprocess per pytest run, ``test_torch_modes.jax_cases``): 3 steps each
  of choco top_k with plain SGD (the paper's Algorithm 2), choco QSGD with
  AdamW (lr 1e-3, the JAX dither injected) and choco top_k on
  Dirichlet(0.5) skewed data, to ``test_torch_slice.py``'s tolerances,
  except x under AdamW.

AdamW's bound.  AdamW divides the first moment by the root of the
second, so each coordinate moves by about lr whatever its gradient's
size: a gradient that differs from JAX's in its last bits (the matmuls
add in another order) moves x by lr times its relative difference, not
by lr times the difference itself, and where cancellation leaves a
gradient near zero that relative difference is large.  Measured on the
CPU against the JAX trainer (3 steps, lr 1e-3, QSGD s=16): x differs
by at most 1.315e-06 (x_hat and s by 7.5e-09, inside
``test_torch_slice.py``'s bounds), so x is held to ``ADAMW_ATOL`` =
1e-5, 7.6x that.  The faults it must catch read 1.088e-03 (no bias
correction) and 1.338e-03 (eps inside the square root), 100x above it;
``test_adamw_trainer_within_its_bound`` shows both failing it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.comm.packing import unpack_leaves
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import partition, synthetic
from test_torch_modes import jax_cases, run_port_case, trainer_case
from test_torch_slice import N, _tree, check_against_jax
from test_torch_slice import one_thread  # noqa: F401  (autouse)

ADAMW_ATOL = 1e-5
ADAMW_OP_ATOL = 2e-6

OPTIM_CASES = [
    trainer_case("choco_top_k_sgd", "choco", optimizer="sgd"),
    trainer_case("choco_qsgd_adamw", "choco", comp="qsgd", arg=16,
                 optimizer="adamw", lr=1e-3),
    trainer_case("choco_top_k_skew", "choco", skew=0.5)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return {tag: np.load(path) for tag, path in
            jax_cases(tmp_path_factory, "optim_data", OPTIM_CASES).items()}


def _max_dx(tr, state, ref):
    """max |x - x_JAX| over every leaf."""
    got = dict(zip(tr.paths, unpack_leaves(tr.spec, state.x)))
    want = params_from_jax(_tree(ref, "x"))
    return max(float((got[p] - want[p]).abs().max()) for p in tr.paths)


def _faulted_adamw(fault, b1=0.9, b2=0.95, eps=1e-8):
    """The port's AdamW with one fault: ``"no_bias_correction"`` (bc1 =
    bc2 = 1) or ``"eps_in_sqrt"`` (sqrt(v / bc2 + eps))."""
    @torch.no_grad()
    def update(params, grads, state, lr):
        count = state.count + 1
        c = torch.tensor(float(count))
        bc1, bc2 = 1 - torch.tensor(b1) ** c, 1 - torch.tensor(b2) ** c
        if fault == "no_bias_correction":
            bc1 = bc2 = torch.tensor(1.0)
        for i, (p, m, v) in enumerate(zip(params, state.mu, state.nu)):
            g, grads[i] = grads[i], None
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            m.mul_(b1).add_(g.mul_(1 - b1))
            den = (torch.sqrt(v / bc2 + eps) if fault == "eps_in_sqrt"
                   else torch.sqrt(v / bc2) + eps)
            p.sub_((m / bc1 / den).mul_(lr))
        return state._replace(count=count)
    return dataclasses.replace(topt.adamw(), update=update)


# -- the trainer ------------------------------------------------------------------

@pytest.mark.parametrize("case", OPTIM_CASES[::2], ids=lambda c: c["tag"])
def test_optimizer_and_skew_match_jax_trainer(refs, case):
    ref = refs[case["tag"]]
    tr, state, mets = run_port_case(case, ref)
    assert tr.optimizer.name == case["optimizer"]
    assert state.opt.count == 3
    assert (state.opt.mu is None) == (case["optimizer"] == "sgd")
    check_against_jax(tr, state, [m[:3] for m in mets], ref, case["comp"])
    batches = synthetic.make_lm_batch_fn(tr.model.cfg, 8, 1, N, 1.0,
                                         skew_alpha=case["skew"])
    assert batches.skew_tv == float(ref["skew_tv"])


def test_adamw_trainer_within_its_bound(refs):
    case = OPTIM_CASES[1]
    ref = refs[case["tag"]]
    tr, state, mets = run_port_case(case, ref)
    assert tr.optimizer.name == "adamw" and state.opt.count == 3
    check_against_jax(tr, state, [m[:3] for m in mets], ref, "qsgd",
                      x_atol=ADAMW_ATOL)
    for fault in ("no_bias_correction", "eps_in_sqrt"):
        tr, state, _ = run_port_case(case, ref,
                                     optimizer=_faulted_adamw(fault))
        assert _max_dx(tr, state, ref) > 100 * ADAMW_ATOL, fault


# -- the optimizers and schedules alone ---------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 0.01}),
    ("momentum", {}), ("momentum", {"nesterov": True, "weight_decay": 0.01}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1, "b2": 0.999}),
])
def test_optimizer_matches_jax(name, kw):
    """Four updates on two bucket buffers against the JAX optimizer on the
    same arrays: x and every moment bit for bit, AdamW's to the module's
    bounds."""
    rng = np.random.default_rng(7)
    shapes = ((N, 4096), (N, 1000))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt, jo = topt.make_optimizer(name, **kw), jopt.make_optimizer(name, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(tp)
    jp = [jnp.asarray(p) for p in params]
    jstate = jo.init(jp)
    lr = topt.cosine_schedule(0.1, 1, 10)
    for step in range(4):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        state = opt.update(tp, [torch.from_numpy(g.copy()) for g in grads], state,
                           lr(step + 1))
        jp, jstate = jo.update(jp, [jnp.asarray(g) for g in grads], jstate,
                               jnp.float32(lr(step + 1)))
        adam = name == "adamw"
        for tol, got_bufs, want_bufs in (
                (dict(atol=ADAMW_OP_ATOL), tp, jp),
                (dict(atol=1e-6), state.mu, jstate.mu),
                (dict(rtol=1e-6), state.nu, jstate.nu)):
            assert (got_bufs is None) == (want_bufs is None)
            for got, want in zip(got_bufs or (), want_bufs or ()):
                if adam:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               **{"rtol": 0, **tol})
                else:
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))
        assert state.count == int(jstate.count) == step + 1


def test_make_optimizer_names():
    assert [topt.make_optimizer(n).name for n in ("sgd", "momentum",
                                                  "adamw")] == \
        ["sgd", "momentum", "adamw"]
    with pytest.raises(ValueError, match="choose from sgd, momentum, adamw"):
        topt.make_optimizer("lamb")


@pytest.mark.parametrize("m,a,b", [(9, 0.1, 300.0), (1, 0.03, 4100.0),
                                   (4, 1.0, 1.0)])
def test_paper_decay_schedule_matches_jax(m, a, b):
    got, want = topt.paper_decay_schedule(m, a, b), \
        jopt.paper_decay_schedule(m, a, b)
    for t in (0, 1, 2, 7, 299, 1200, 12345):
        assert got(t) == float(want(jnp.int32(t)))


@pytest.mark.parametrize("lr0", [0.1, 1e-3, 0.3])
def test_constant_schedule_matches_jax(lr0):
    got, want = topt.constant_schedule(lr0), jopt.constant_schedule(lr0)
    for t in (0, 5, 999):
        assert got(t) == float(want(jnp.int32(t)))


# -- data/partition.py and the skewed data -------------------------------------

@pytest.mark.parametrize("alpha", [1e-3, 0.1, 0.5, 10.0, float("inf")])
def test_dirichlet_class_shares_match_jax(alpha):
    got = partition.dirichlet_class_shares(
        7, 5, alpha, np.random.default_rng(3))
    want = jpart.dirichlet_class_shares(7, 5, alpha, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total", [0, 1, 17, 1000])
def test_largest_remainder_counts_match_jax(total):
    share = np.random.default_rng(total).dirichlet(np.ones(6))
    got = partition._largest_remainder_counts(share, total)
    np.testing.assert_array_equal(
        got, jpart._largest_remainder_counts(share, total))
    assert got.sum() == total


@pytest.mark.parametrize("alpha,n", [(0.1, 4), (0.5, 4), (100.0, 3),
                                     (float("inf"), 8)])
def test_dirichlet_shards_and_skew_match_jax(alpha, n):
    labels = np.random.default_rng(1).integers(0, 10, 999)
    got = partition.dirichlet_shards(labels, n, alpha, seed=5)
    want = jpart.dirichlet_shards(labels, n, alpha, seed=5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        partition.node_label_distributions(labels, got),
        jpart.node_label_distributions(labels, want))
    assert partition.data_skew_tv(labels, got) == \
        jpart.data_skew_tv(labels, want)
    probs = partition.node_label_distributions(labels, got)
    assert partition.mean_tv_distance(probs) == jpart.mean_tv_distance(probs)


@pytest.mark.parametrize("alpha", [0.0, -1.0, float("nan")])
def test_partition_refuses_bad_alpha(alpha):
    with pytest.raises(ValueError, match="must be > 0"):
        partition.dirichlet_shards([0, 1, 0, 1], 2, alpha)


@pytest.mark.parametrize("alpha,het", [(0.1, 1.0), (0.5, 0.0), (5.0, 1.0),
                                       (None, 0.5)])
def test_skewed_token_stream_matches_jax(alpha, het):
    """Node distributions, skew_tv and three batches bit-equal; the
    Dirichlet draw takes precedence over ``heterogeneity``; each node's
    row of the per-rank stream is the stacked stream's."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    got = synthetic.TokenStream(cfg.vocab_size, 16, 2, N, het, 3, alpha)
    want = jsyn.TokenStream(cfg.vocab_size, 16, 2, N, het, 3, alpha)
    np.testing.assert_array_equal(got.node_probs(), want.node_probs())
    assert got.skew_tv() == want.skew_tv()
    if alpha is not None:
        other = synthetic.TokenStream(cfg.vocab_size, 16, 2, N, 0.0, 3, alpha)
        np.testing.assert_array_equal(other.node_probs(), got.node_probs())
    stacked = synthetic.make_lm_batch_fn(cfg, 16, 2, N, het, seed=3,
                                         skew_alpha=alpha)
    jax_batches = jsyn.make_lm_batch_fn(cfg, 16, 2, N, het, seed=3,
                                        skew_alpha=alpha)
    rows = [synthetic.make_lm_batch_fn(cfg, 16, 2, N, het, seed=3,
                                       skew_alpha=alpha, node=r)
            for r in range(N)]
    assert stacked.skew_tv == jax_batches.skew_tv == rows[0].skew_tv
    for _ in range(3):
        a, b, per_rank = stacked(), jax_batches(), [row() for row in rows]
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
            for r, got_row in enumerate(per_rank):
                np.testing.assert_array_equal(got_row[key], a[key][r:r + 1])
