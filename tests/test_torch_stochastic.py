"""The stochastic topology processes (``comm/stochastic.py``) and the
replica engine in the port, held against the JAX package on the CPU.

* the process objects on every symmetric registry graph: ``probs``, the
  branch vectors, the edge indexing, the expected matrix and its
  (delta, beta), and the infeasible-sampler error;
* the port's own sampler: a pure function of the exchange seed, the same
  on every engine and node, its round frequencies and edge drop rate
  within 4 sigma over 10^4 draws;
* the exchange against ``make_gossip_exchange(process=)`` on an
  ``AxisType.Auto`` mesh of 4 host devices (one JAX subprocess for every
  case, shared across xdist workers under a file lock): matching and
  link failures, packed and per leaf, f32 and bf16 state, QSGD s=16 and
  s=255, sign, top_k, rand_k and block_top_k, and the plain mode; JAX's
  samples (the round index, the edge mask) and draws injected;
* the simulator against ``run_choco_gossip_process`` and
  ``stochastic_choco_averaging`` against JAX's;
* the per-rank engine (4 gloo ranks on one torch thread) bit-equal to the
  stacked one, each rank's bytes its payload bytes times the rounds it
  shipped;
* the trainer against the JAX trainer (``check_against_jax``'s bounds on
  x and every element of the x_hat and s lists), checkpoints crossing
  with the JAX trainer bit for bit, the re-mix on a process change, and
  the launcher (its flags, its refusals, its CPU ranks on one thread).

Tolerances:

* the sampled rounds and masks, the wire payloads and x_hat (H_r under
  matching) bit for bit, and so the replicas S_r, which add the received
  payloads; the QSGD and sign scales within 1e-6 relative on f32 state
  (their norms are f32 sums in another order; where the scales differ,
  x_hat and S_r carry the difference, held within 1e-6 absolute plus
  1e-6 relative);
* x: bit for bit, f32 and bf16 state (the plain version takes XLA's
  FMAs, ``ref.replica_matching_ref`` and ``replica_stale_ref`` at tau 0), but
  with the f32 QSGD and sign scales' difference, within 1e-6 absolute
  plus 1e-6 relative;
* the plain mode bit for bit;
* the simulator: f32 iterates within 1e-5 of their largest magnitude.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.comm import gossip, schedule, stochastic
from repro_torch.comm.packing import make_bucket_spec, pack_leaves, unpack_leaves
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from test_torch_slice import ROOT, Reference, make_reference
from test_torch_slice import one_thread, tmp_path  # noqa: F401  (fixtures)

BF16 = torch.bfloat16
N = 4
GAMMA = 0.3
F32_ATOL = F32_RTOL = 1e-6
SCALE_RTOL = 1e-6
#: per-node leaf shapes of the exchange cases
SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000))

_KW = {"top_k": {"fraction": 0.05}, "block_top_k": {"fraction": 0.05},
       "rand_k": {"fraction": 0.05}, "qsgd": {"s": 16}, "qsgd255": {"s": 255},
       "sign": {}, "identity": {}}

#: (mode, process kind, topology, compressor key, state dtype, packed,
#: gossip_steps)
CASES = (
    ("choco", "matching", "ring", "qsgd", "float32", True, 2),
    ("choco", "matching", "ring", "top_k", "bfloat16", True, 1),
    ("choco", "matching", "chain", "sign", "float32", True, 2),
    ("choco", "matching", "ring", "rand_k", "bfloat16", False, 1),
    ("choco", "matching", "ring", "qsgd255", "bfloat16", False, 2),
    ("choco", "matching", "star", "block_top_k", "float32", False, 1),
    ("choco", "matching", "ring", "qsgd", "bfloat16", True, 1),
    ("choco", "linkfail", "ring", "qsgd", "bfloat16", True, 2),
    ("choco", "linkfail", "ring", "top_k", "float32", True, 1),
    ("choco", "linkfail", "chain", "rand_k", "float32", True, 1),
    ("choco", "linkfail", "ring", "sign", "bfloat16", False, 1),
    ("choco", "linkfail", "star", "qsgd255", "float32", False, 2),
    ("choco", "linkfail", "ring", "block_top_k", "bfloat16", False, 1),
    ("choco", "linkfail", "chain", "top_k", "bfloat16", True, 2),
    ("choco", "linkfail", "star", "qsgd", "bfloat16", True, 2),
    ("choco", "matching", "star", "top_k", "bfloat16", False, 2),
    ("plain", "matching", "ring", "identity", "float32", True, 2),
    ("plain", "linkfail", "chain", "identity", "float32", True, 2),
    ("plain", "linkfail", "ring", "identity", "float32", True, 2),
)
#: the edge drop probability of the link-failure cases (high, so that a
#: few gossip rounds drop and keep links both)
DROP = 0.4


def tag(case) -> str:
    mode, kind, topo, comp, sdt, packed, k = case
    return (f"{mode}-{kind}-{topo}-{comp}-{sdt}-"
            f"{'packed' if packed else 'leaf'}-{k}")


_JAX_EXCHANGES = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.comm import packing as jpacking
    from repro.comm.gossip import _compress_leaf, _pack_align, make_gossip_exchange
    from repro.comm.schedule import compile_schedule
    from repro.comm.stochastic import make_topology_process
    from repro.core.compression import make_compressor
    from repro.core.topology import make_topology

    cases, gamma, drop, out_dir = (json.loads(sys.argv[1]), float(sys.argv[2]),
                                   float(sys.argv[3]), sys.argv[4])
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fold = jax.random.fold_in
    bits = lambda v: v if v.dtype != jnp.bfloat16 else v.view(np.uint16)
    for c in cases:
        rng = np.random.default_rng(c["seed"])
        sdt = jnp.dtype(c["sdt"])
        shapes = [tuple(s) for s in c["shapes"]]
        proc = make_topology_process(
            c["kind"], compile_schedule(make_topology(c["topology"], 4)),
            edge_drop_prob=drop)
        R = proc.schedule.n_rounds
        def tree(scale, dtype):
            return {f"l{i}": (scale * rng.standard_normal((4,) + s))
                    .astype(np.float32).astype(dtype)
                    for i, s in enumerate(shapes)}
        x = tree(1.0, np.float32)
        plain = c["mode"] == "plain"
        matching = c["kind"] == "matching"
        if plain:
            x_hat, s = tree(0.0, sdt), tree(0.0, sdt)
        else:
            x_hat = ([tree(0.5, sdt) for _ in range(R)] if matching
                     else tree(0.5, sdt))
            s = [tree(0.5, sdt) for _ in range(R)]
        names = sorted(x)
        specs = {k: P("data", *([None] * (v.ndim - 1))) for k, v in x.items()}
        comp = make_compressor(c["name"], **c["kw"])
        ex = make_gossip_exchange(
            mode=c["mode"], mesh=mesh, state_specs=specs, axis="data",
            compressor=None if plain else comp, gamma=gamma,
            packed=c["packed"], process=proc, gossip_steps=c["k"])
        key = jax.random.PRNGKey(c["seed"])
        jt = lambda t: jax.tree.map(jnp.asarray, t)
        out = jax.jit(ex)(key, jt(x), jt(x_hat), jt(s))
        res = {}
        def save(tg, t):
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
                name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path)
                res[f"{tg}:{name}"] = bits(np.asarray(leaf))
        for tg, t in (("in_x", x), ("in_x_hat", x_hat), ("in_s", s)) + tuple(
                zip(("out_x", "out_x_hat", "out_s"), out)):
            save(tg, t)
        samples = []
        for t in range(c["k"]):
            if matching:
                samples.append(int(proc.round_index(key, t)))
            else:
                res[f"mask:{t}"] = np.asarray(proc.edge_mask(key, t))
        res["rounds"] = np.array(samples)
        if not plain and comp.stochastic:
            spec = jpacking.make_bucket_spec(
                [jax.ShapeDtypeStruct(s_[1:], sdt) for s_ in
                 (v.shape for v in x.values())],
                align=_pack_align(comp, None))
            for t in range(c["k"]):
                for i in range(4):
                    tk = fold(key, i)
                    tk = tk if t == 0 else fold(tk, t)
                    if matching:
                        tk = fold(tk, samples[t])
                    if c["packed"]:
                        units = [(b.index, fold(tk, b.index), b.size,
                                  b.logical, spec.bucket_slots(b.index), b)
                                 for b in spec.buckets]
                    else:
                        lk = jax.random.split(fold(tk, 0), len(names))
                        units = [(j, lk[j], x[nm][0].size, x[nm][0].size,
                                  None, None) for j, nm in enumerate(names)]
                    for u, uk, size, logical, slots, b in units:
                        if c["name"] == "qsgd":
                            d = jax.random.uniform(uk, (size,))
                        elif b is not None:
                            kb = jpacking._slot_budget(comp, slots, b)
                            d = jax.random.permutation(uk, logical)[:kb]
                        else:
                            kk = max(1, min(size, int(np.ceil(
                                c["kw"]["fraction"] * size))))
                            d = jax.random.permutation(uk, size)[:kk]
                        res[f"draw:{t}:{u}:{i}"] = np.asarray(d)
        savez(os.path.join(out_dir, c["tag"] + ".npz"), **res)
""")


def _case_dict(case, index):
    mode, kind, topo, comp, sdt, packed, k = case
    return dict(tag=tag(case), mode=mode, kind=kind, topology=topo,
                name=comp.rstrip("0123456789"), kw=_KW[comp], sdt=sdt,
                packed=packed, k=k, shapes=SHAPES, seed=700 + index)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """``tag -> npz path`` of the JAX engines' runs of CASES, made once
    per pytest run in one subprocess (``make_reference``)."""
    out = make_reference(
        tmp_path_factory, "jax_process_exchanges", _JAX_EXCHANGES,
        lambda part: [json.dumps([_case_dict(c, i)
                                  for i, c in enumerate(CASES)]),
                      GAMMA, DROP, part])
    return {tag(c): str(out / (tag(c) + ".npz")) for c in CASES}


def _tensor(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(BF16) if a.dtype == np.uint16 else t


def bits_equal(a, b) -> bool:
    if a.dtype == BF16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def make_process(case):
    mode, kind, topo, *_ = case
    return stochastic.make_topology_process(
        kind, schedule.compile_schedule(topology.make_topology(topo, N)),
        edge_drop_prob=DROP)


def setup_case(case, path):
    """(process, compressor, spec, (x, x_hat, s) bucket buffers in the
    engine's layout, the JAX outputs as leaf lists in the same layout,
    draws(t, u), samples(t), the npz)."""
    mode, kind, topo, comp_key, sdt, packed, k = case
    proc = make_process(case)
    R = proc.schedule.n_rounds
    comp = make_compressor(comp_key.rstrip("0123456789"), **_KW[comp_key])
    dtype = getattr(torch, sdt)
    spec = make_bucket_spec(
        [torch.empty(sh, dtype=dtype if mode == "choco" else torch.float32,
                     device="meta") for sh in SHAPES],
        align=gossip._pack_align(comp))
    res = Reference(path)
    L = len(SHAPES)

    def leaves(tg, idx=None):
        pre = f"{tg}:" if idx is None else f"{tg}:{idx}/"
        return [_tensor(res[f"{pre}l{j}"]) for j in range(L)]

    def state(tg, listed):
        return ([leaves(tg, r) for r in range(R)] if listed
                else leaves(tg))

    hat_list = mode == "choco" and kind == "matching"
    s_list = mode == "choco"
    pack = lambda lv, dt=None: pack_leaves(spec, lv, dtype=dt)
    x = pack(leaves("in_x"), torch.float32)
    ins = (x, [pack(t) for t in state("in_x_hat", True)] if hat_list
           else pack(state("in_x_hat", False)),
           [pack(t) for t in state("in_s", True)] if s_list
           else pack(state("in_s", False)))
    want = (leaves("out_x"), state("out_x_hat", hat_list),
            state("out_s", s_list))
    rounds = list(res["rounds"])
    samples = ((lambda t: int(rounds[t])) if kind == "matching"
               else (lambda t: res[f"mask:{t}"]))
    draws = None
    if mode == "choco" and comp.stochastic:
        draws = lambda t, u: torch.from_numpy(np.stack(
            [res[f"draw:{t}:{u}:{i}"] for i in range(N)]))
    return proc, comp, spec, ins, want, draws, samples, res


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    return [_clone(o) for o in obj]


def run_stacked(case, path, seed=0, inject=True):
    proc, comp, spec, ins, want, draws, samples, res = setup_case(case, path)
    x, x_hat, s = _clone(ins)
    if case[0] == "plain":
        ex = gossip.make_plain_exchange(spec=spec, process=proc,
                                        gossip_steps=case[6])
    else:
        ex = gossip.make_process_exchange(
            spec=spec, process=proc, compressor=comp, gamma=GAMMA,
            gossip_steps=case[6], packed=case[5])
    ex(x, x_hat, s, seed=seed, draws=draws if inject else None,
       samples=samples if inject else None)
    return proc, comp, spec, (x, x_hat, s), want, ex


def quantizing(comp) -> bool:
    return comp.name in ("qsgd", "sign")


def check_state(case, comp, spec, got, want):
    """x, x_hat and s against the JAX engine's leaves, with the
    tolerances of this module's docstring."""
    mode, kind, topo, comp_key, sdt, packed, k = case
    f32 = sdt == "float32"
    scale_gap = f32 and quantizing(comp)

    def flat(bufs, w):
        if isinstance(w[0], list):
            return [(g, ww) for b, wl in zip(bufs, w)
                    for g, ww in zip(unpack_leaves(spec, b), wl)]
        return list(zip(unpack_leaves(spec, bufs), w))

    for tg, bufs, w in zip(("x", "x_hat", "s"), got, want):
        if mode == "plain" and tg != "x":
            continue
        for j, (g, ww) in enumerate(flat(bufs, w)):
            g = g.reshape(ww.shape)
            exact = not scale_gap
            if exact:
                assert bits_equal(g, ww), (tag(case), tg, j,
                                           (g.float() - ww.float()).abs().max())
            else:
                np.testing.assert_allclose(g.numpy(), ww.numpy(),
                                           rtol=F32_RTOL, atol=F32_ATOL,
                                           err_msg=f"{tag(case)} {tg} {j}")


@pytest.mark.parametrize("case", CASES, ids=[tag(c) for c in CASES])
def test_process_exchange_matches_jax_engine(case, jax_runs):
    """The stacked exchange under a process, JAX's samples and draws
    injected, against ``make_gossip_exchange(process=)``."""
    proc, comp, spec, got, want, ex = run_stacked(case, jax_runs[tag(case)])
    check_state(case, comp, spec, got, want)


# -- the process objects ----------------------------------------------------------

def _jax_process(kind, name, n, **kw):
    from repro.comm.schedule import compile_schedule as jcompile
    from repro.comm.stochastic import make_topology_process as jmake
    from repro.core.topology import make_topology as jtopo
    return jmake(kind, jcompile(jtopo(name, n)), **kw)


def _port_process(kind, name, n, **kw):
    return stochastic.make_topology_process(
        kind, schedule.compile_schedule(topology.make_topology(name, n)),
        **kw)


GRAPHS = [(name, n) for name in topology.SYMMETRIC_TOPOLOGIES
          for n in (4, 8)]


@pytest.mark.parametrize("name,n", GRAPHS, ids=[f"{g}-{n}" for g, n in GRAPHS])
def test_process_objects_match_jax(name, n):
    """Every symmetric registry graph: the matching sampler's probs,
    branch vectors, sources and send bits (or the infeasible sampler's
    error, word for word), the link-failure edge indexing, and both
    expected matrices and their (delta, beta) against JAX."""
    for sampler in ("uniform", "weighted"):
        try:
            want = _jax_process("matching", name, n, matching_sampler=sampler)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                _port_process("matching", name, n, matching_sampler=sampler)
            assert str(got.value) == str(err)
            continue
        got = _port_process("matching", name, n, matching_sampler=sampler)
        for attr in ("probs", "branch_recv", "branch_self", "round_src",
                     "round_send"):
            assert getattr(got, attr) == getattr(want, attr), (sampler, attr)
        np.testing.assert_array_equal(got.branch_matrices(),
                                      want.branch_matrices())
        np.testing.assert_array_equal(got.expected_matrix(),
                                      want.expected_matrix())
        assert got.expected_delta_beta() == want.expected_delta_beta()
    for p in (0.0, 0.1, 0.5):
        want = _jax_process("linkfail", name, n, edge_drop_prob=p)
        got = _port_process("linkfail", name, n, edge_drop_prob=p)
        assert (got.n_edges, got._edges, got.round_edge_ids) == (
            want.n_edges, want._edges, want.round_edge_ids)
        assert got.round_recv == tuple(tuple(r) for r in want.round_recv)
        np.testing.assert_array_equal(got.expected_matrix(),
                                      want.expected_matrix())
        assert got.expected_delta_beta() == want.expected_delta_beta()


def test_sampled_matrices_match_jax():
    """The f32 mixing matrix of a given sample (a round, an edge mask),
    bit for bit, and JAX's own sampler's draw of the same (key, t) fed to
    the port gives JAX's matrix."""
    import jax
    for name, n in (("ring", 8), ("star", 4), ("hypercube", 8), ("chain", 5)):
        for kind in ("matching", "linkfail"):
            kw = ({"edge_drop_prob": 0.3} if kind == "linkfail" else
                  {"matching_sampler": "weighted"})
            want, got = (_jax_process(kind, name, n, **kw),
                         _port_process(kind, name, n, **kw))
            for t in range(6):
                key = jax.random.PRNGKey(t)
                sample = (int(want.round_index(key, t)) if kind == "matching"
                          else np.asarray(want.edge_mask(key, t)))
                np.testing.assert_array_equal(
                    got.sample_matrix(0, t, sample).numpy(),
                    np.asarray(want.sample_matrix(key, t)))


def test_infeasible_sampler_names_the_binding_round():
    sched = schedule.compile_schedule(topology.make_topology("ring", 8))
    bad = dataclasses_replace_round(sched)
    with pytest.raises(ValueError, match=r"round 0 scales a receive weight"):
        stochastic.MatchingProcess(bad, sampler="uniform")
    with pytest.raises(ValueError, match="unknown matching sampler"):
        stochastic.MatchingProcess(sched, sampler="greedy")
    with pytest.raises(ValueError, match="drop_prob must be in"):
        stochastic.LinkFailureProcess(sched, drop_prob=1.0)
    with pytest.raises(ValueError, match="unknown topology process"):
        stochastic.make_topology_process("push", sched)


def dataclasses_replace_round(sched):
    """The schedule with round 0's receive weight raised past 1 / R, so
    that the uniform sampler's upscale exceeds 1 there."""
    import dataclasses
    r0 = dataclasses.replace(sched.rounds[0], weight=0.75)
    return dataclasses.replace(sched, rounds=(r0,) + sched.rounds[1:])


def test_port_sampler_is_shared_and_has_the_process_law():
    """A sample is a pure function of (seed, t): rebuilding the process
    (another engine, another node) draws the same one.  Over 10^4 draws
    the round frequencies and the edge drop rate lie within 4 sigma of
    the process's probs and p."""
    draws = 10_000
    for sampler in ("uniform", "weighted"):
        a = _port_process("matching", "star", 5, matching_sampler=sampler)
        b = _port_process("matching", "star", 5, matching_sampler=sampler)
        rounds = [a.round_index(seed, t) for seed in range(draws // 2)
                  for t in (0, 1)]
        assert rounds[:50] == [b.round_index(seed, t)
                               for seed in range(25) for t in (0, 1)]
        counts = np.bincount(rounds, minlength=a.n_rounds)
        for r, p in enumerate(a.probs):
            sigma = np.sqrt(draws * p * (1 - p))
            assert abs(counts[r] - draws * p) <= 4 * sigma, (sampler, r)
    lf = _port_process("linkfail", "hypercube", 8, edge_drop_prob=0.25)
    masks = np.stack([lf.edge_mask(seed, 0) for seed in range(draws)])
    np.testing.assert_array_equal(masks[:20], np.stack(
        [_port_process("linkfail", "hypercube", 8,
                       edge_drop_prob=0.25).edge_mask(seed, 0)
         for seed in range(20)]))
    total = masks.size
    drops = total - masks.sum()
    sigma = np.sqrt(total * 0.25 * 0.75)
    assert abs(drops - 0.25 * total) <= 4 * sigma
    assert abs(masks[:, 0].mean() - 0.75) <= 4 * np.sqrt(0.75 * 0.25 / draws)


# -- the simulator and the averaging scheme ------------------------------------------

def _sim_inputs(kind, comp_name, n=8, d=300, steps=12, seed=3):
    """x0, both processes, the compressors, and JAX's per-step samples and
    row draws of ``run_choco_gossip_process`` with key PRNGKey(seed)."""
    import jax
    from repro.core import compression as jcomp
    kw = {"fraction": 0.1}
    jp = _jax_process(kind, "ring", n, edge_drop_prob=0.3)
    pp = _port_process(kind, "ring", n, edge_drop_prob=0.3)
    x0 = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    samples, draws = [], []
    jc = jcomp.make_compressor(comp_name, **kw)
    for step in range(steps):
        ek = jax.random.fold_in(key, step)
        samples.append(int(jp.round_index(ek, 0)) if kind == "matching"
                       else np.asarray(jp.edge_mask(ek, 0)))
        if jc.stochastic:
            keys = jax.random.split(jax.random.fold_in(ek, 1), n)
            k = max(1, min(d, int(np.ceil(0.1 * d))))
            draws.append(np.stack([np.asarray(
                jax.random.permutation(kk, d)[:k]) for kk in keys]))
    return (x0, jp, pp, jc, make_compressor(comp_name, **kw), key, samples,
            draws)


@pytest.mark.parametrize("kind", ["matching", "linkfail"])
@pytest.mark.parametrize("comp_name", ["top_k", "rand_k"])
def test_simulator_matches_jax(kind, comp_name):
    """``run_choco_gossip_process`` on ring 8, d 300, 12 steps, JAX's
    samples and draws injected: the consensus errors within 1e-5
    relative, x and the references within 1e-5 of their largest
    magnitude."""
    from repro.comm import stochastic as jsto
    import jax.numpy as jnp
    x0, jp, pp, jc, pc, key, samples, draws = _sim_inputs(kind, comp_name)
    gamma = 0.2
    jst, jerrs = jsto.run_choco_gossip_process(jnp.asarray(x0), jp, gamma,
                                               jc, len(samples), key=key)
    st, errs = stochastic.run_choco_gossip_process(
        torch.from_numpy(x0), pp, gamma, pc, len(samples),
        draws=(lambda t: torch.from_numpy(draws[t])) if draws else None,
        samples=lambda t: samples[t])
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), rtol=1e-5)
    for got, want in ((st.x, jst.x), (st.refs, jst.refs)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert errs[-1] < errs[0]


@pytest.mark.parametrize("kind", ["matching", "linkfail"])
def test_stochastic_choco_averaging_matches_jax(kind):
    """One call of the averaging scheme per step, 5 steps, top_k: X and Y
    within 1e-5 of their largest magnitude, and p equal."""
    import jax
    import jax.numpy as jnp
    from repro.core import consensus as jcons
    x0, jp, pp, jc, pc, key, samples, _ = _sim_inputs(kind, "top_k", steps=5)
    d = x0.shape[1]
    jh = jcons.stochastic_choco_averaging(jp, jc, d)
    ph = __import__("repro_torch.core.consensus",
                    fromlist=["x"]).stochastic_choco_averaging(pp, pc, d)
    assert ph.p == jh.p and ph.name == jh.name
    jx, jy = jnp.asarray(x0), jsto_init(jp, x0)
    px = torch.from_numpy(x0)
    py = stochastic.init_process_state(px, pp).refs
    for step in range(5):
        ek = jax.random.fold_in(key, step)
        jx, jy = jh.h(jx, jy, ek)
        px, py = ph.h(px, py, sample=samples[step])
    for got, want in ((px, jx), (py, jy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def jsto_init(jp, x0):
    import jax.numpy as jnp
    from repro.comm.stochastic import init_process_state
    return init_process_state(jnp.asarray(x0), jp).refs


# -- the per-rank engine ----------------------------------------------------------

DIST_CASES = [c for c in CASES if c[0] == "plain"] + [
    CASES[2], CASES[3], CASES[7], CASES[11], CASES[13]]


def _expected_calls(proc, samples, rank, units):
    """sendrecv calls of one rank: per gossip round, each live round in
    which the rank sends or receives, once per unit."""
    rounds = proc.schedule.rounds
    live = ([[int(r)] for r in samples] if proc.kind == "matching"
            else [list(range(len(rounds)))] * len(samples))
    return units * sum(rounds[r].peers(rank) != (None, None)
                       for per_t in live for r in per_t)


def _dist_rank(rank, store, out_dir, paths):
    from test_torch_dist import _join
    from repro_torch.launch import mesh
    group = _join(rank, store)
    calls = [0]
    sendrecv = group.sendrecv

    def counted(*args):
        calls[0] += 1
        return sendrecv(*args)
    group.sendrecv = counted
    results = {}
    for case in DIST_CASES:
        proc, comp, spec, ins, _, draws, samples, _ = setup_case(
            case, paths[tag(case)])
        if case[0] == "plain":
            ex = gossip.make_dist_plain_exchange(
                spec=spec, process=proc, gossip_steps=case[6], group=group)
        else:
            ex = gossip.make_dist_process_exchange(
                spec=spec, process=proc, compressor=comp, gamma=GAMMA,
                gossip_steps=case[6], group=group, packed=case[5])
        row = lambda obj: (obj[rank:rank + 1].clone()
                           if isinstance(obj, torch.Tensor)
                           else [row(o) for o in obj])
        x, x_hat, s = row(ins)
        before, calls[0] = group.bytes_sent, 0
        ex(x, x_hat, s, draws=None if draws is None else (
            lambda t, u: draws(t, u)[rank:rank + 1]), samples=samples)
        results[tag(case)] = (x, x_hat, s, group.bytes_sent - before,
                              ex.payload_bytes, list(ex.last_samples),
                              calls[0])
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_dist_process_exchange_bit_equal_to_stacked(tmp_path, jax_runs):
    """4 gloo ranks (one torch thread) against the stacked exchange, JAX's
    samples and draws injected: x, x_hat and s bit for bit; each rank's
    bytes its payload bytes times the rounds it shipped (matching: the
    sampled round only; link failures: every round); no ``sendrecv``
    call in a round that skips the rank."""
    from repro_torch.comm import packing
    from test_torch_dist import _spawn
    ranks = _spawn(_dist_rank, tmp_path, str(tmp_path), jax_runs)
    for case in DIST_CASES:
        proc, comp, spec, stacked, _, _ = run_stacked(case,
                                                      jax_runs[tag(case)])
        plain = case[0] == "plain"
        sizes = ([4 * b.size for b in spec.buckets] if plain else
                 packing.bucket_wire_nbytes(spec, comp) if case[5]
                 else packing.leaf_wire_nbytes(spec, comp))
        for r, got in enumerate(ranks):
            x, x_hat, s, sent, payload, samples, calls = got[tag(case)]

            def same(a, b):
                if isinstance(a, torch.Tensor):
                    assert bits_equal(a, b[r:r + 1]), (tag(case), r)
                else:
                    for aa, bb in zip(a, b):
                        same(aa, bb)
            same(x, stacked[0])
            if not plain:
                same(x_hat, stacked[1])
                same(s, stacked[2])
            assert payload == sizes
            rounds = proc.schedule.rounds
            shipped = (sum(rounds[int(t)].peers(r)[0] is not None
                           for t in samples)
                       if proc.kind == "matching" else
                       len(samples) * sum(rnd.peers(r)[0] is not None
                                          for rnd in rounds))
            assert sent == shipped * sum(sizes), (tag(case), r)
            assert calls == _expected_calls(proc, samples, r, len(sizes)), (
                tag(case), r)


# -- the trainer ------------------------------------------------------------------

class _ListRef:
    """A JAX reference npz seen through one element of its x_hat or s
    lists: ``x_hat:<path>`` reads ``x_hat:<r>/<path>`` (only for the
    listed prefixes)."""

    def __init__(self, ref, r, listed):
        self.ref, self.r, self.listed = ref, r, listed
        self.files = [self._plain(k) for k in ref.files]

    def _plain(self, key):
        tag, _, rest = key.partition(":")
        if tag in self.listed and rest.startswith(f"{self.r}/"):
            return f"{tag}:{rest.split('/', 1)[1]}"
        if tag in self.listed:
            return "other:" + key
        return key

    def __getitem__(self, key):
        tag, _, rest = key.partition(":")
        if tag in self.listed:
            return self.ref[f"{tag}:{self.r}/{rest}"]
        return self.ref[key]


TRAINER_CASES = [("matching", "float32", "packed"),
                 ("linkfail", "bfloat16", "per-leaf")]


@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("kind,sdt,engine", TRAINER_CASES,
                         ids=["-".join(c) for c in TRAINER_CASES])
def test_trainer_matches_jax_trainer(tmp_path_factory, kind, sdt, engine):
    """3 steps of the port's stacked trainer (top_k 0.05, ring, the smoke
    decoder in f32) against the JAX trainer under the same process, JAX's
    samples injected: the scalar gamma at the expected (delta, beta) equal
    to JAX's, and ``check_against_jax``'s tolerances on x and on every
    element of the x_hat and s lists."""
    import types
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import make_lm_batch_fn
    from test_torch_slice import (BPN, SEQ, STEPS, _port_trainer, _tree,
                                  check_against_jax, jax_reference_path)
    ref = Reference(jax_reference_path(
        tmp_path_factory, "top_k", 0.05, 1, False, state_dtype=sdt,
        engine=engine, process=kind))
    tr = _port_trainer("top_k", 0.05, 1, False, state_dtype=sdt,
                       engine=engine, process=kind)
    assert [tr.gamma] == list(ref["gamma"])
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0")))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    mets = []
    for j in range(STEPS):
        m = tr.step(state, tr.batch_to_device(batches()),
                    samples=lambda t, j=j: ref[f"sample:{j}:{t}"])
        mets.append([m["loss"], m["lr"], m["grad_norm"]])
    n_hat, n_s = tr.ef_layout()
    R = tr.process.schedule.n_rounds
    assert n_s == R and n_hat == (R if kind == "matching" else None)
    listed = ("x_hat", "s") if kind == "matching" else ("s",)
    for r in range(R):
        shim = types.SimpleNamespace(
            x=state.x, x_hat=state.x_hat[r] if n_hat else state.x_hat,
            s=state.s[r])
        check_against_jax(tr, shim, mets, _ListRef(ref, r, listed), "top_k")


# -- checkpoints ------------------------------------------------------------------

_JAX_CKPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.checkpoint.checkpointing import _flatten, tree_leaf_specs
    from repro.configs.base import ChocoConfig, get_config
    from repro.data.synthetic import make_lm_batch_fn
    from repro.models import build_model
    from repro.optim import constant_schedule, make_optimizer
    from repro.train.trainer import DecentralizedTrainer

    out = sys.argv[1]
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    report = {}
    for kind in ("matching", "linkfail"):
        tr = DecentralizedTrainer(
            model=build_model(cfg),
            choco=ChocoConfig(compressor="top_k",
                              comp_kwargs=(("fraction", 0.05),),
                              gossip_axis="data", kernel_backend="jnp",
                              topology_process=kind),
            mesh=mesh, n_nodes=4, optimizer=make_optimizer("momentum"),
            lr_fn=constant_schedule(0.05))
        report[kind] = {k: [list(s), d] for k, (s, d) in
                        tree_leaf_specs(tr.state_shape()).items()}
        state, man, warm = tr.restore_checkpoint(
            os.path.join(out, "port-" + kind))
        report[kind + "-warmup"] = warm
        np.savez(os.path.join(out, "jax-restored-" + kind + ".npz"),
                 **_flatten(state))
        state = tr.init_state(jax.random.PRNGKey(5))
        b = jax.tree.map(jnp.asarray, make_lm_batch_fn(cfg, 32, 2, 4, 1.0)())
        step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                    jax.eval_shape(lambda: b))
        state, _ = step(state, b)
        tr.save_checkpoint(os.path.join(out, "jax-" + kind), state)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)
""")


def _ckpt_trainer(kind, n=N):
    import dataclasses
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    return DecentralizedTrainer(
        model=Model(cfg),
        choco=ChocoConfig(compressor="top_k", comp_kwargs=(("fraction", 0.05),),
                          topology_process=kind),
        n_nodes=n, optimizer=make_optimizer("momentum"),
        lr_fn=lambda step: 0.05, device="cpu")


def _train_and_save(tr, path, steps=1, seed=3):
    from repro_torch.data.synthetic import make_lm_batch_fn
    state = tr.init_state(seed=seed)
    batches = make_lm_batch_fn(tr.model.cfg, 32, 2, N, 1.0)
    for _ in range(steps):
        tr.step(state, tr.batch_to_device(batches()))
    tr.save_checkpoint(str(path), state)
    return state


@pytest.mark.slow
@pytest.mark.distributed
def test_checkpoints_cross_restore_with_the_jax_trainer(tmp_path):
    """Under matching and link failures: the port's ``state_leaf_specs``
    are JAX's ``tree_leaf_specs(state_shape())``, the x_hat and s lists
    under JAX's flat keys; a port checkpoint restores in JAX as a resume
    (0 warmup rounds) to the same leaves, bit for bit; a JAX checkpoint
    restores in the port as a resume to JAX's stored leaves, bit for bit;
    and the fingerprint records the process."""
    from test_torch_checkpoint import _stored
    for kind in ("matching", "linkfail"):
        _train_and_save(_ckpt_trainer(kind), tmp_path / f"port-{kind}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_CKPT, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    for kind in ("matching", "linkfail"):
        tr = _ckpt_trainer(kind)
        specs = {k: [list(s), d] for k, (s, d) in
                 tr.state_leaf_specs().items()}
        assert specs == report[kind]
        assert report[kind + "-warmup"] == 0
        man, port = _stored(tmp_path / f"port-{kind}")
        assert man.fingerprint["topology_process"] == kind
        assert man.fingerprint["edge_drop_prob"] == 0.1
        assert man.fingerprint["matching_sampler"] == "uniform"
        restored = np.load(tmp_path / f"jax-restored-{kind}.npz")
        assert sorted(restored.files) == sorted(port)
        for key, arr in port.items():
            np.testing.assert_array_equal(restored[key], arr, err_msg=key)
        state, _, warm = tr.restore_checkpoint(str(tmp_path / f"jax-{kind}"))
        assert warm == 0
        tr.save_checkpoint(str(tmp_path / f"again-{kind}"), state)
        _, want = _stored(tmp_path / f"jax-{kind}")
        _, got = _stored(tmp_path / f"again-{kind}")
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_restore_across_a_process_change_takes_the_remix_path(tmp_path):
    """A checkpoint saved without a process restores into a matching
    trainer (and a matching one into a link-failure trainer) through the
    re-mix path: params read back exactly, the re-shaped x_hat and s lists
    zero, warmup rounds at the expected eigengap; the warmup runs the
    replica engine (the references are no longer zero) and training goes
    on (as ``tests/test_stochastic_topology.py:732`` holds the JAX
    trainer)."""
    from repro_torch.checkpoint.elastic import consensus_warmup_rounds
    from repro_torch.data.synthetic import make_lm_batch_fn
    saved = _train_and_save(_ckpt_trainer(None), tmp_path / "static", 2)
    _train_and_save(_ckpt_trainer("matching"), tmp_path / "matching", 1)
    for src, kind in (("static", "matching"), ("matching", "linkfail"),
                      ("matching", None)):
        tr = _ckpt_trainer(kind)
        state, man, warm = tr.restore_checkpoint(str(tmp_path / src))
        delta = (tr.process.expected_delta_beta()[0] if kind
                 else tr.topologies[0].delta)
        assert warm == consensus_warmup_rounds(delta) > 0, (src, kind)
        if src == "static":
            for a, b in zip(state.x, saved.x):
                assert torch.equal(a, b)
        n_hat, n_s = tr.ef_layout()
        hats = state.x_hat if n_hat else [state.x_hat]
        reps = state.s if n_s else [state.s]
        assert len(reps) == (n_s or 1)
        for bufs in hats + reps:
            assert all(float(b.abs().sum()) == 0.0 for b in bufs)
        tr.consensus_warmup(state, warm)
        assert sum(float(b.abs().sum()) for bufs in hats for b in bufs) > 0
        batches = make_lm_batch_fn(tr.model.cfg, 32, 2, N, 1.0)
        m = tr.step(state, tr.batch_to_device(batches()))
        assert np.isfinite(m["loss"])


# -- the launcher -----------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1", "--steps", "2",
          "--seq-len", "32", "--batch-per-node", "2", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    [], ["--topology-process", "linkfail", "--edge-drop-prob", "0.5"]],
    ids=["static", "linkfail"])
def test_launcher_cpu_ranks_match_the_stacked_run_under_load(tmp_path, extra):
    """``--simulate-devices 4 --device cpu`` with no thread settings of the
    test's own (the launcher pins each rank to one thread before its
    interpreter starts), 6 busy processes spinning beside it: the ranks'
    checkpoint after 2 steps bit-equal to the stacked run's."""
    from repro_torch.launch import train as launcher
    from test_torch_checkpoint import _stored
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(6)]
    try:
        for name, ranks in (("stacked", []),
                            ("ranks", ["--simulate-devices", "4"])):
            assert launcher.main(
                _SMOKE + extra + ranks + ["--checkpoint-dir",
                                          str(tmp_path / name),
                                          "--checkpoint-every", "2"]) == 0
    finally:
        for p in spin:
            p.kill()
            p.wait()
    _, want = _stored(tmp_path / "stacked" / "step2")
    _, got = _stored(tmp_path / "ranks" / "step2")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_launcher_spawns_cpu_ranks_on_one_thread(monkeypatch):
    """``_spawn`` sets the four thread variables of ``CPU_RANK_ENV`` while
    the ranks start, and restores the caller's after; ``_rank_main``
    trains on one torch thread."""
    from repro_torch.launch import mesh
    from repro_torch.launch import train as launcher
    names = list(launcher.CPU_RANK_ENV)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    monkeypatch.delenv("MKL_NUM_THREADS", raising=False)
    before = {k: os.environ.get(k) for k in names}
    seen = {}
    monkeypatch.setattr(mesh, "spawn_ranks", lambda *a, **k: seen.update(
        {k_: os.environ.get(k_) for k_ in names}))
    args = launcher._parser().parse_args(_SMOKE + ["--simulate-devices", "4"])
    assert launcher._spawn(args, N) == 0
    assert seen == launcher.CPU_RANK_ENV
    assert {k: os.environ.get(k) for k in names} == before
    threads = []
    monkeypatch.setattr(mesh, "make_node_group", lambda *a, **k: None)
    monkeypatch.setattr(mesh, "close_node_group", lambda: None)
    monkeypatch.setattr(launcher, "_train", lambda *a: threads.append(
        torch.get_num_threads()))
    torch.set_num_threads(2)
    launcher._rank_main(0, args, N, "unused")
    assert threads == [1]


@pytest.mark.parametrize("extra", [
    ["--topology-process", "matching", "--matching-sampler", "weighted",
     "--topology", "star"],
    ["--topology-process", "linkfail", "--gossip-engine", "per-leaf",
     "--state-dtype", "bfloat16", "--compressor", "qsgd", "--qsgd-s", "16"],
    ["--topology-process", "matching", "--mode", "plain"],
])
def test_launcher_trains_under_a_process_on_cpu(extra, capsys):
    from repro_torch.launch import train as launcher
    assert launcher.main(_SMOKE + extra) == 0
    out = capsys.readouterr().out
    kind = extra[1]
    assert f" process={kind} " in out and "expected_delta=" in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("extra,message", [
    (["--topology-process", "staleness", "--mode", "plain"],
     "staleness requires --mode choco"),
    (["--topology-process", "matching", "--topology", "ring,star",
      "--gossip-steps", "2"], "is ambiguous"),
    (["--topology-process", "linkfail", "--mode", "allreduce"],
     "no effect under --mode allreduce"),
    (["--edge-drop-prob", "0.2"], "only applies to --topology-process "
                                  "linkfail"),
    (["--topology-process", "linkfail", "--edge-drop-prob", "1.0"],
     "must be in [0, 1)"),
    (["--topology-process", "linkfail", "--matching-sampler", "uniform"],
     "only applies to --topology-process matching"),
    (["--topology-process", "matching", "--pipeline-gossip"],
     "deterministic delay-1"),
    (["--max-staleness", "2"], "--max-staleness only applies"),
    (["--straggler-edges", "0-1"], "requires --topology-process staleness"),
])
def test_launcher_refuses_what_jax_refuses(extra, message, capsys):
    """The JAX launcher's process rules, before torch is imported."""
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit):
        launcher.main(_SMOKE + extra)
    assert message in capsys.readouterr().err


def test_trainer_refuses_what_jax_refuses():
    import dataclasses
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    make = lambda mode="choco", **kw: DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(**kw), n_nodes=N,
        optimizer=make_optimizer("sgd"), lr_fn=lambda s: 0.1, device="cpu",
        mode=mode)
    for kw, mode, msg in (
            ({"topology_process": "staleness"}, "plain",
             "compressed choco engine only"),
            ({"topology_process": "matching"}, "allreduce", "choco/plain"),
            ({"topology_process": "linkfail", "pipeline_gossip": True},
             "choco", "delay-1"),
            ({"topology_process": "matching", "topology": "ring,star",
              "gossip_steps": 2}, "choco", "ambiguous"),
            ({"topology_process": "matching", "matching_sampler": "greedy"},
             "choco", "unknown matching sampler")):
        with pytest.raises(ValueError, match=msg):
            make(mode, **kw)
    spec = make_bucket_spec([torch.empty(s, device="meta") for s in SHAPES],
                            exact_small_leaves=True,
                            small_leaf_threshold=4224)
    proc = make_process(CASES[0])
    with pytest.raises(ValueError, match="without exact buckets"):
        gossip.make_process_exchange(spec=spec, process=proc,
                                     compressor=make_compressor("sign"),
                                     gamma=0.1)
    from repro_torch.core.choco_gossip import GammaSpec
    with pytest.raises(ValueError, match="GammaSpec"):
        gossip.make_process_exchange(
            spec=make_bucket_spec([torch.empty((700,), device="meta")]),
            process=proc, compressor=make_compressor("sign"),
            gamma=GammaSpec(0.5, 0.5))
