"""Every symmetric topology of the JAX registry in the port, held against
the JAX package on the CPU.

* the graphs: W, neighbours, delta and beta equal to JAX's for every
  symmetric registry name at n = 1..16 (where JAX refuses, such as a torus
  on a prime n or a hypercube on n != 2^m, the port refuses too);
* the compiled schedules: rounds (``perm``, ``weight``, ``weights``), self
  weights and W rebuilt from them equal to JAX's; partial rounds give -1
  sources and None peers; mixed n is refused;
* the stacked exchange on a hand-built W whose rounds carry per-node
  receive weights, against W applied in float64 (no registry graph has
  such rounds: star's and chain's weights are per node on the diagonal
  only);
* 3 trainer steps against the JAX trainer (``test_torch_slice.py``'s
  reference script and tolerances) on torus (1 gossip round per step)
  and star (2), with top_k and QSGD (the JAX dither injected); the
  time-varying pair is in ``test_torch_time_varying.py``;
* the exchange moves its compiled weights to the buffers' device once.
"""
import numpy as np
import pytest
import torch

from repro.comm import schedule as jschedule
from repro.core import topology as jtopo
from repro_torch.comm import gossip, schedule
from repro_torch.comm.packing import make_bucket_spec, pack_leaves
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.convert import params_from_jax
from test_torch_slice import (BPN, N, SEQ, STEPS, _port_trainer, _tree,
                              check_against_jax, jax_reference_path)
from test_torch_slice import one_thread  # noqa: F401  (autouse)

SYMMETRIC = ("ring", "torus", "fully_connected", "chain", "star",
             "hypercube")
SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16)


def _both(name, n):
    """(JAX topology, port topology); both None when JAX refuses n, after
    checking that the port refuses it too."""
    try:
        want = jtopo.make_topology(name, n)
    except (ValueError, AssertionError):
        with pytest.raises(ValueError):
            topology.make_topology(name, n)
        return None, None
    return want, topology.make_topology(name, n)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", SYMMETRIC)
def test_topology_matches_jax(name, n):
    want, got = _both(name, n)
    if want is None:
        return
    assert got.name == want.name
    np.testing.assert_array_equal(got.W, want.W)
    assert got.neighbors == want.neighbors
    assert (got.delta, got.beta, got.rho) == (want.delta, want.beta, want.rho)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", SYMMETRIC)
def test_schedule_matches_jax(name, n):
    want_t, got_t = _both(name, n)
    if want_t is None:
        return
    got = schedule.compile_schedule(got_t)
    want = jschedule.compile_schedule(want_t)
    assert got.n_rounds == want.n_rounds
    for a, b in zip(got.rounds, want.rounds):
        assert (a.perm, a.weight, a.weights) == (b.perm, b.weight, b.weights)
    assert (got.self_weights, got.self_weight) == (want.self_weights,
                                                   want.self_weight)
    np.testing.assert_array_equal(got.mixing_matrix(), want.mixing_matrix())
    assert np.max(np.abs(got.mixing_matrix() - got_t.W)) <= 1e-9
    # a round's gather sources and each rank's peers describe the same
    # (partial) permutation
    for rnd in got.rounds:
        src = rnd.sources(n)
        for rank in range(n):
            dst, got_src = rnd.peers(rank)
            assert got_src == (None if src[rank] < 0 else src[rank])
            if dst is not None:
                assert src[dst] == rank


def test_star_and_chain_rounds_are_partial():
    star = schedule.compile_schedule(topology.make_topology("star", 4))
    assert star.self_weight is None
    assert star.self_weights == (0.25, 0.75, 0.75, 0.75)
    assert [r.weight for r in star.rounds] == [0.25] * 3
    assert star.rounds[0].sources(4) == (1, 0, -1, -1)
    assert star.rounds[0].peers(2) == (None, None)
    assert star.rounds[1].peers(0) == (2, 2)
    chain = schedule.compile_schedule(topology.make_topology("chain", 4))
    assert chain.rounds[1].sources(4) == (-1, 2, 1, -1)


def test_compile_schedules_refuses_mixed_n():
    topos = [topology.make_topology("ring", 4), topology.make_topology("star", 5)]
    with pytest.raises(ValueError, match="must share n"):
        schedule.compile_schedules(topos)
    with pytest.raises(ValueError, match="at least one"):
        schedule.compile_schedules([])
    pair = schedule.compile_schedules(
        [topology.make_topology(name, 4) for name in ("ring", "star")])
    want = jschedule.compile_schedules(
        [jtopo.make_topology(name, 4) for name in ("ring", "star")])
    assert [s.rounds for s in pair] == [
        tuple(schedule.GossipRound(r.perm, r.weight, r.weights)
              for r in w.rounds) for w in want]


def test_directed_topologies_are_refused():
    for name in ("directed_ring", "random_digraph"):
        with pytest.raises(ValueError, match="push-sum"):
            topology.make_topology(name, 4)
    W = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
    with pytest.raises(ValueError, match="symmetric"):
        schedule.compile_schedule(topology.Topology("directed", W, ()))


def _irregular():
    """A symmetric W with edge weights that differ by edge (Metropolis
    weights on an irregular graph): its edge-coloring rounds carry
    per-node receive weights, in groups of different weights."""
    n = 6
    adj = np.zeros((n, n), dtype=int)
    for i, j in ((0, 1), (1, 2), (2, 3), (2, 4), (2, 5)):
        adj[i, j] = adj[j, i] = 1
    return topology._from_adjacency("irregular", adj)


def test_exchange_with_per_node_receive_weights():
    """Identity gossip (q = x - x_hat) on the irregular graph, 2 rounds:
    the stacked exchange against s' = s + W q and x' = x + gamma (s' -
    x_hat') in float64, within f32 rounding (1e-6); the schedule equals
    JAX's."""
    topo = _irregular()
    sched = schedule.compile_schedule(topo)
    jsched = jschedule.compile_schedule(
        jtopo.Topology(topo.name, topo.W, topo.neighbors))
    assert [(r.perm, r.weight, r.weights) for r in sched.rounds] == \
        [(r.perm, r.weight, r.weights) for r in jsched.rounds]
    assert any(r.weights is not None for r in sched.rounds)
    assert len(gossip._weight_groups(sched)) > 1
    n, gamma = topo.n, 0.3
    spec = make_bucket_spec([torch.empty((n, 700), device="meta")[0]],
                            align=128)
    rng = np.random.default_rng(0)
    x, x_hat, s = (rng.standard_normal((n, 700)).astype(np.float32)
                   for _ in range(3))
    bufs = [pack_leaves(spec, [torch.from_numpy(a)]) for a in (x, x_hat, s)]
    ex = gossip.make_choco_exchange(
        spec=spec, schedules=(sched,), compressor=make_compressor("identity"),
        gamma=gamma, gossip_steps=2)
    ex(*bufs)
    W = topo.W
    x, x_hat, s = (a.astype(np.float64) for a in (x, x_hat, s))
    for _ in range(2):
        q = x - x_hat
        x_hat = x_hat + q
        s = s + W @ q
        x = x + gamma * (s - x_hat)
    for got, want in zip(bufs, (x, x_hat, s)):
        np.testing.assert_allclose(got[0][:, :700].numpy(), want, atol=1e-6)


# -- the trainer -------------------------------------------------------------

TRAINER_CASES = [
    pytest.param(topo, k, comp, arg, id=f"{topo}-{k}-{comp}")
    for topo, k in (("torus", 1), ("star", 2))
    for comp, arg in (("top_k", 0.05), ("qsgd", 16))]


@pytest.mark.parametrize("topo,k,comp,arg", TRAINER_CASES)
def test_trainer_matches_jax_on_topology(tmp_path_factory, topo, k, comp,
                                         arg):
    """3 steps on 4 nodes from the JAX trainer's initial parameters, with
    ``check_against_jax``'s tolerances (losses 1e-6 relative, x 1e-6,
    x_hat and s 1e-6 + 1e-5 relative); gamma per bucket equal."""
    run_against_jax(tmp_path_factory, topo, k, comp, arg)


def run_against_jax(tmp_path_factory, topo, k, comp, arg):
    ref = np.load(jax_reference_path(tmp_path_factory, comp, arg, k, False,
                                     topology=topo))
    tr = _port_trainer(comp, arg, k, False, topology=topo)
    assert [tr.gamma] + tr.exchange.bucket_gammas == list(ref["gamma"])
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0")))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    mets = []
    for j in range(STEPS):
        draws = None
        if comp == "qsgd":
            draws = lambda t, b, j=j: torch.from_numpy(ref[f"xi:{j}:{t}:{b}"])
        m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
        mets.append([m["loss"], m["lr"], m["grad_norm"]])
    check_against_jax(tr, state, mets, ref, comp)


def test_exchange_moves_its_weights_to_the_device_once(monkeypatch):
    """The compiled weights and gather indices reach the buffers' device
    at the first call only; later calls reuse them and give the same
    result from the same buffers."""
    moves = []
    to_device = gossip._to_device
    monkeypatch.setattr(gossip, "_to_device",
                        lambda obj, dev: moves.append(dev) or to_device(obj,
                                                                        dev))
    n = 4
    spec = make_bucket_spec([torch.empty((n, 300), device="meta")[0]],
                            align=128)
    ex = gossip.make_choco_exchange(
        spec=spec, schedules=schedule.compile_schedules(
            [topology.make_topology(name, n) for name in ("ring", "star")]),
        compressor=make_compressor("top_k", fraction=0.1), gamma=0.2,
        gossip_steps=2)
    rng = np.random.default_rng(0)
    start = [rng.standard_normal((n, 300)).astype(np.float32)
             for _ in range(3)]
    outs, moved = [], []
    for _ in range(3):
        bufs = [pack_leaves(spec, [torch.from_numpy(a)]) for a in start]
        ex(*bufs)
        outs.append(bufs)
        moved.append(len(moves))
    assert moved[0] > 0 and moved == moved[:1] * 3
    assert set(moves) == {torch.device("cpu")}
    for bufs in outs[1:]:
        for got, want in zip(bufs, outs[0]):
            assert torch.equal(got[0], want[0])
