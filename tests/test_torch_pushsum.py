"""Directed push-sum gossip in the port (``comm/pushsum.py``; the directed
graphs, ``core/topology.py``; their compiler, ``comm/schedule.py``; the
push-sum simulator, ``core/choco_gossip.py``; the trainer's push-sum mode
and its ``psw`` checkpoint leaf), held against the JAX package on the CPU.

* ``directed_ring`` and ``random_digraph`` at n in {1, 2, 4, 5, 8, 16}:
  A, the out-neighbours, (delta, beta) and the compiled rounds (perms,
  per-destination weights, self weights) equal to JAX's;
* the simulator against ``run_pushsum_gossip`` (identity, top_k, QSGD,
  JAX's draws injected): x, x_hat, s, w and the de-biased error curve;
  with the identity, lazy push-sum's closed form;
* the stacked exchange against ``make_gossip_exchange(mode="pushsum")``
  on an ``AxisType.Auto`` mesh of 4 host devices (one JAX subprocess for
  every case, shared across xdist workers under a file lock), after one
  call and after CALLS calls: directed_ring, random_digraph and the
  symmetric ring; identity, top_k, QSGD and sign; f32 and bf16 state;
  1 and 2 gossip rounds per call; JAX's draws injected;
* the per-rank engine (4 gloo ranks on one torch thread) bit-equal to the
  stacked one, each rank's bytes its payload bytes plus 4 for w, per
  round it sends in;
* the trainer against the JAX trainer in push-sum mode (losses, x, x_hat,
  s and ``psw``), a same-mesh resume bit for bit, checkpoints crossing
  with the JAX trainer both ways, the elastic restore refused; and the
  launcher (its runs, and JAX's push-sum refusals word for word, before
  torch is imported).

Tolerances:

* the directed graphs, their schedules, the payloads' codes, indices and
  values, w and ``psw`` bit for bit; the QSGD and sign scales within
  1e-6 relative (the norm's summation order; on bf16 state the scale
  differs from JAX's by at most one f32 ulp, which the bf16 rounding of
  q absorbs: x_hat stays bit-equal);
* the EF update: the kernel takes ``w_self = a_jj``, ``q_nbr = nb`` (the
  rounds' sum in the state's dtype) and ``w_nbr = 1`` and computes
  ``s + (a_jj q + nb)`` with the product rounded, where XLA contracts
  ``a_jj q + nb`` into one FMA; the two agree where ``a_jj q`` is exact
  (the directed ring's 1/2) and in bf16 where the weighted sum runs in
  bf16 (a uniform self weight);
* bf16 state: x, x_hat and s bit for bit after every call, but for the
  cases of BF16_INEXACT (per-node self weights, measured gap not 0):
  there x, x_hat and s within 2^-7 (1 + |v|), one bf16 step of an
  increment below 2, on at most one element in 1000 (measured: 24 of
  132,924 differ, by at most 2^-7 on s and x_hat, 4.7e-3 on x);
* f32 state: after one call of one gossip round x_hat bit for bit, and s
  too on the directed ring (the identity and top_k; the QSGD and sign
  scales differ from JAX's by the norms' summation order, 1e-6 relative,
  and x_hat and s carry that); else within 1e-6 + 1e-6 relative (the
  product's rounding above, measured at most 4.8e-7 on s after one call
  of random_digraph; and x: XLA contracts ``x + gamma (s - x_hat)`` into
  an FMA, which the f32 EF kernel does not, measured at most 4.8e-7
  after one call, 1.4e-6 after three, on values up to 5);
* the simulator: f32 iterates within 1e-5 of their largest magnitude
  (``A @ q`` sums in another order than XLA's).
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

from repro_torch.comm import gossip, pushsum, schedule
from repro_torch.comm.packing import (bucket_wire_nbytes, compress_bufs,
                                      make_bucket_spec, pack_leaves,
                                      unpack_leaves)
from repro_torch.core import choco_gossip, topology
from repro_torch.core.compression import make_compressor
from test_torch_slice import ROOT, Reference, make_reference
from test_torch_slice import one_thread, tmp_path  # noqa: F401  (fixtures)

BF16 = torch.bfloat16
N = 4
GAMMA = 0.3
F32_ATOL = F32_RTOL = 1e-6
#: the cases of BF16_INEXACT: x, x_hat and s within BF16_TOL (1 + |v|),
#: on at most one element in BF16_DIFFER
BF16_TOL = 2.0 ** -7
BF16_DIFFER = 1000
#: exchange calls per case
CALLS = 3
#: per-node leaf shapes of the exchange cases
SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000))
_KW = {"identity": {}, "top_k": {"fraction": 0.05}, "qsgd": {"s": 16},
       "sign": {}}

#: (topology, compressor, state dtype, gossip_steps)
CASES = (
    ("directed_ring", "identity", "float32", 1),
    ("directed_ring", "top_k", "float32", 2),
    ("directed_ring", "qsgd", "float32", 1),
    ("directed_ring", "sign", "bfloat16", 1),
    ("directed_ring", "qsgd", "bfloat16", 2),
    ("directed_ring", "top_k", "bfloat16", 1),
    ("directed_ring", "identity", "bfloat16", 1),
    ("random_digraph", "identity", "float32", 1),
    ("random_digraph", "top_k", "float32", 1),
    ("random_digraph", "sign", "float32", 2),
    ("random_digraph", "identity", "bfloat16", 1),
    ("random_digraph", "qsgd", "bfloat16", 1),
    ("random_digraph", "top_k", "bfloat16", 2),
    ("ring", "qsgd", "float32", 1),
    ("ring", "top_k", "bfloat16", 1),
)


def tag(case) -> str:
    return "-".join(map(str, case))


#: the bf16 cases whose measured gap to JAX is not 0: per-node self
#: weights, where XLA contracts ``a_self q + nb`` into one FMA and the EF
#: kernel rounds the product first (19 of 132,924 s elements one bf16
#: step off after one call, 24 after CALLS calls)
BF16_INEXACT = {"random_digraph-identity-bfloat16-1"}


_JAX_EXCHANGES = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.comm import packing as jpacking
    from repro.comm.gossip import _pack_align, make_gossip_exchange
    from repro.comm.schedule import (compile_directed_schedule,
                                     compile_schedule)
    from repro.core.compression import make_compressor
    from repro.core.topology import is_directed, make_topology

    cases, gamma, calls, out_dir = (json.loads(sys.argv[1]),
                                    float(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4])
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fold = jax.jit(jax.random.fold_in)
    uniform = jax.jit(jax.random.uniform, static_argnums=1)
    bits = lambda v: v if v.dtype != jnp.bfloat16 else v.view(np.uint16)
    for c in cases:
        rng = np.random.default_rng(c["seed"])
        sdt = jnp.dtype(c["sdt"])
        shapes = [tuple(s) for s in c["shapes"]]
        topo = make_topology(c["topology"], 4)
        sched = (compile_directed_schedule(topo)
                 if is_directed(c["topology"]) else compile_schedule(topo))
        def tree(scale, dtype):
            return {f"l{i}": (scale * rng.standard_normal((4,) + s))
                    .astype(np.float32).astype(dtype)
                    for i, s in enumerate(shapes)}
        x, x_hat, s = tree(1.0, np.float32), tree(0.5, sdt), tree(0.5, sdt)
        w = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
        names = sorted(x)
        specs = {k: P("data", *([None] * (v.ndim - 1))) for k, v in x.items()}
        comp = make_compressor(c["name"], **c["kw"])
        ex = jax.jit(make_gossip_exchange(
            mode="pushsum", mesh=mesh, state_specs=specs, axis="data",
            compressor=comp, gamma=gamma, schedules=(sched,),
            weight_specs=P("data", None), gossip_steps=c["k"]))
        res = {}
        def save(tg, t):
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
                name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path)
                res[f"{tg}:{name}"] = bits(np.asarray(leaf))
        for tg, t in (("in_x", x), ("in_x_hat", x_hat), ("in_s", s)):
            save(tg, t)
        res["in_w"] = w
        spec = jpacking.make_bucket_spec(
            [jax.ShapeDtypeStruct(v.shape[1:], sdt) for v in x.values()],
            align=_pack_align(comp, None))
        # call 0's payloads in gossip round 0: node i compresses its delta
        # under fold(key, i), as the engine does inside shard_map (jitted,
        # as there: run eagerly, a bf16 delta's scale may round otherwise)
        key0 = fold(jax.random.PRNGKey(c["seed"]), 0)
        compress = jax.jit(lambda k, d: jpacking.compress_packed(
            comp, k, spec, d)[0])
        for i in range(4):
            deltas = [(jnp.asarray(x[nm][i]).astype(sdt)
                       - jnp.asarray(x_hat[nm][i])).ravel() for nm in names]
            pls = compress(fold(key0, i), deltas)
            for b, pl in enumerate(pls):
                for f in dataclasses.fields(pl):
                    v = getattr(pl, f.name)
                    if isinstance(v, jax.Array):
                        res[f"payload:{b}:{f.name}:{i}"] = bits(np.asarray(v))
        state = (jax.tree.map(jnp.asarray, x), jax.tree.map(jnp.asarray, x_hat),
                 jax.tree.map(jnp.asarray, s), jnp.asarray(w))
        for call in range(calls):
            key = fold(jax.random.PRNGKey(c["seed"]), call)
            state = ex(key, *state)
            if call == 0:
                for tg, t in zip(("one_x", "one_x_hat", "one_s"), state[:3]):
                    save(tg, t)
                res["one_w"] = np.asarray(state[3])
            if not comp.stochastic:
                continue
            for t in range(c["k"]):
                for i in range(4):
                    tk = fold(key, i)
                    tk = tk if t == 0 else fold(tk, t)
                    for b in spec.buckets:
                        res[f"draw:{call}:{t}:{b.index}:{i}"] = np.asarray(
                            uniform(fold(tk, b.index), (b.size,)))
        for tg, t in zip(("out_x", "out_x_hat", "out_s"), state[:3]):
            save(tg, t)
        res["out_w"] = np.asarray(state[3])
        savez(os.path.join(out_dir, c["tag"] + ".npz"), **res)
""")


def _case_dict(case, index):
    topo, comp, sdt, k = case
    return dict(tag=tag(case), topology=topo, name=comp, kw=_KW[comp],
                sdt=sdt, k=k, shapes=SHAPES, seed=700 + index)


def _jax_exchanges(tmp_path_factory):
    """``tag -> npz path`` of the JAX engine's runs of CASES, made once
    per pytest run in one subprocess (``make_reference``)."""
    out = make_reference(
        tmp_path_factory, "jax_pushsum_exchanges", _JAX_EXCHANGES,
        lambda part: [json.dumps([_case_dict(c, i)
                                  for i, c in enumerate(CASES)]),
                      GAMMA, CALLS, part])
    return {tag(c): str(out / (tag(c) + ".npz")) for c in CASES}


#: the trainer cases: (compressor, its argument, topology, state dtype)
TRAINER_CASES = (("top_k", 0.05, "directed_ring", "float32"),
                 ("qsgd", 16, "random_digraph", "bfloat16"))


@pytest.fixture(scope="module", autouse=True)
def jax_references(tmp_path_factory):
    """The module's JAX reference runs, started together at its first test
    (each a subprocess, so they run beside the tests that need none): the
    exchanges of CASES and the trainer's of TRAINER_CASES.  Each value is
    a future of its result."""
    from concurrent.futures import ThreadPoolExecutor
    from test_torch_slice import jax_reference_path
    tmp_path_factory.getbasetemp()      # made once, not raced by the threads
    with ThreadPoolExecutor(1 + len(TRAINER_CASES)) as pool:
        refs = {"exchanges": pool.submit(_jax_exchanges, tmp_path_factory)}
        for comp, arg, topo, sdt in TRAINER_CASES:
            refs[(comp, topo)] = pool.submit(
                jax_reference_path, tmp_path_factory, comp, arg, 1, False,
                topology=topo, state_dtype=sdt, mode="pushsum")
        yield refs


@pytest.fixture(scope="module")
def jax_runs(jax_references):
    return jax_references["exchanges"].result()


def _tensor(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(BF16) if a.dtype == np.uint16 else t


def bits_equal(a, b) -> bool:
    if a.dtype == BF16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def compile_for(name, n=N):
    topo = topology.make_topology(name, n)
    return (schedule.compile_directed_schedule(topo)
            if topology.is_directed(name) else schedule.compile_schedule(topo))


def setup_case(case, path):
    """(schedule, compressor, spec, (x, x_hat, s, w) in the engine's
    layout, draws(call, t, b), the npz)."""
    topo, comp_name, sdt, k = case
    comp = make_compressor(comp_name, **_KW[comp_name])
    spec = make_bucket_spec([torch.empty(sh, dtype=getattr(torch, sdt),
                                         device="meta") for sh in SHAPES],
                            align=gossip._pack_align(comp))
    res = Reference(path)
    leaves = lambda tg: [_tensor(res[f"{tg}:l{j}"])
                         for j in range(len(SHAPES))]
    ins = (pack_leaves(spec, leaves("in_x"), dtype=torch.float32),
           pack_leaves(spec, leaves("in_x_hat")),
           pack_leaves(spec, leaves("in_s")),
           torch.from_numpy(res["in_w"]).clone())
    draws = None
    if comp.stochastic:
        draws = lambda call, t, b: torch.from_numpy(np.stack(
            [res[f"draw:{call}:{t}:{b}:{i}"] for i in range(N)]))
    return compile_for(topo), comp, spec, ins, draws, res


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    return [_clone(o) for o in obj]


def exact_tags(case, calls: int) -> tuple:
    """Which of x, x_hat and s the case holds bit for bit against JAX
    after ``calls`` calls (the module docstring's tolerances)."""
    topo, comp, sdt, k = case
    if sdt == "bfloat16":
        return () if tag(case) in BF16_INEXACT else ("x", "x_hat", "s")
    if calls > 1 or k > 1 or comp in ("qsgd", "sign"):
        return ()
    return ("x_hat", "s") if topo == "directed_ring" else ("x_hat",)


def check_state(case, comp, spec, got, res, prefix, calls):
    """x, x_hat and s against the JAX engine's leaves ``<prefix>_*`` and w
    against ``<prefix>_w`` (bit for bit): ``exact_tags`` bit for bit, the
    rest within the module's f32 or bf16 tolerance."""
    bf16 = case[2] == "bfloat16"
    exact = exact_tags(case, calls)
    assert np.array_equal(got[3].numpy(), res[f"{prefix}_w"]), tag(case)
    for tg, bufs in zip(("x", "x_hat", "s"), got[:3]):
        want = [_tensor(res[f"{prefix}_{tg}:l{j}"])
                for j in range(len(SHAPES))]
        differ = total = 0
        for j, (g, ww) in enumerate(zip(unpack_leaves(spec, bufs), want)):
            g = g.reshape(ww.shape)
            err = f"{tag(case)} {tg} {j}"
            if tg in exact:
                assert bits_equal(g, ww), (err,
                                           (g.float() - ww.float()).abs().max())
            elif not bf16:
                np.testing.assert_allclose(
                    g.numpy(), ww.numpy(), rtol=F32_RTOL, atol=F32_ATOL,
                    err_msg=err)
            else:
                d = (g.double() - ww.double()).abs()
                assert bool((d <= BF16_TOL * (1 + ww.double().abs()))
                            .all()), (err, d.max())
                differ += int((d > 0).sum())
                total += d.numel()
        assert differ * BF16_DIFFER <= total, (tag(case), tg, differ, total)


def run_stacked(case, path, calls=CALLS):
    """``calls`` calls of the stacked exchange, JAX's draws injected.
    Returns (schedule, compressor, spec, the state, the npz)."""
    sched, comp, spec, ins, draws, res = setup_case(case, path)
    state = _clone(list(ins))
    ex = pushsum.make_pushsum_exchange(spec=spec, schedule=sched,
                                       compressor=comp, gamma=GAMMA,
                                       gossip_steps=case[3])
    for call in range(calls):
        out = ex(*state, seed=call,
                 draws=None if draws is None else
                 (lambda t, b, c=call: draws(c, t, b)))
        assert all(a is b for a, b in zip(out, state))
    return sched, comp, spec, state, res


# -- topologies and schedules ---------------------------------------------------

GRAPHS = [(name, n) for name in topology.DIRECTED_TOPOLOGIES
          for n in (1, 2, 4, 5, 8, 16)]


@pytest.mark.parametrize("name,n", GRAPHS,
                         ids=[f"{name}-{n}" for name, n in GRAPHS])
def test_directed_topologies_and_schedules_match_jax(name, n):
    from repro.comm import schedule as jschedule
    from repro.core import topology as jtopo
    got, want = topology.make_topology(name, n), jtopo.make_topology(name, n)
    assert isinstance(got, topology.DirectedTopology) and got.directed
    np.testing.assert_array_equal(got.A, want.A)
    assert got.out_neighbors == want.out_neighbors
    assert (got.delta, got.beta) == (want.delta, want.beta)
    a = schedule.compile_directed_schedule(got)
    b = jschedule.compile_directed_schedule(want)
    assert [(r.perm, r.weight, r.weights) for r in a.rounds] == [
        (r.perm, r.weight, r.weights) for r in b.rounds]
    assert (a.self_weights, a.self_weight) == (b.self_weights, b.self_weight)
    np.testing.assert_array_equal(a.mixing_matrix(), b.mixing_matrix())
    assert np.abs(a.mixing_matrix() - got.A).max() <= 1e-12


def test_directed_round_counts_and_registry():
    """directed_ring(4): one round, self weights 1/2; random_digraph(4):
    three rounds, self weights (1/3, 1/4, 1/2, 1/2); the registry's
    names and ``is_directed`` as JAX's; the symmetric compiler refuses a
    directed A, naming the push-sum engine."""
    from repro.core import topology as jtopo
    ring = schedule.compile_directed_schedule(topology.directed_ring(4))
    assert ring.n_rounds == 1 and ring.self_weights == (0.5,) * 4
    dig = schedule.compile_directed_schedule(topology.random_digraph(4))
    assert dig.n_rounds == 3
    assert dig.self_weights == (1 / 3, 0.25, 0.5, 0.5)
    assert set(topology.DIRECTED_TOPOLOGIES) == jtopo.DIRECTED_TOPOLOGIES
    for name in topology.TOPOLOGIES:
        assert topology.is_directed(name) == jtopo.is_directed(name)
    with pytest.raises(ValueError, match="push-sum engine"):
        schedule.compile_schedule(topology.Topology(
            "directed", topology.directed_ring(3).A, ()))
    with pytest.raises(ValueError, match="column-stochastic"):
        topology.DirectedTopology("bad", np.full((2, 2), 0.4), ()).validate()
    with pytest.raises(ValueError, match="self-loops"):
        topology.DirectedTopology("bad", np.array([[0.0, 1.0], [1.0, 0.0]]),
                                  ()).validate()


# -- the simulator ----------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("identity", {}),
                                     ("top_k", {"fraction": 0.25}),
                                     ("qsgd", {"s": 16})])
@pytest.mark.parametrize("graph", ["directed_ring", "random_digraph"])
def test_pushsum_simulator_matches_jax(name, kw, graph):
    """``run_pushsum_gossip`` on 8 nodes at d 64, 20 rounds (the horizon
    of ``test_torch_sim``'s CHOCO-Gossip parity, within which no QSGD
    level flips), against JAX's with its draws injected: x, x_hat, s, w
    and the de-biased error curve; 1^T w = n."""
    import jax
    from repro.core import choco_gossip as jchoco
    from repro.core import compression as jcomp
    from test_torch_sim import _close, _round_draws
    n, d, steps, gamma = 8, 64, 20, 0.4
    A = topology.make_topology(graph, n).A
    x0 = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    jc = jcomp.make_compressor(name, **kw)
    key = jax.random.PRNGKey(3)
    want, werrs = jchoco.run_pushsum_gossip(jax.numpy.asarray(x0),
                                            jax.numpy.asarray(A, "float32"),
                                            gamma, jc, steps, key)
    got, errs = choco_gossip.run_pushsum_gossip(
        torch.from_numpy(x0), A, gamma, make_compressor(name, **kw), steps,
        draws=_round_draws(jc, key, steps, n, d))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    _close(errs.numpy(), werrs)
    assert float(got.w.sum()) == pytest.approx(n, abs=1e-4)


def test_identity_pushsum_is_lazy_pushsum():
    """With Q the identity the recursion is x' = ((1 - g) I + g A) x and
    the same for w; ``pushsum_debias`` is x / w."""
    A = torch.from_numpy(topology.random_digraph(8, 0.5, seed=3).A).float()
    g = 0.7
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 8)).astype(np.float32))
    st = choco_gossip.init_pushsum_state(x0)
    M = (1 - g) * torch.eye(8) + g * A
    x_ref, w_ref = x0, torch.ones(8, 1)
    for _ in range(20):
        st = choco_gossip.pushsum_gossip_round(st, A, g,
                                               make_compressor("identity"))
        x_ref, w_ref = M @ x_ref, M @ w_ref
    np.testing.assert_allclose(st.x.numpy(), x_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.w.numpy(), w_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(choco_gossip.pushsum_debias(st), st.x / st.w)
    from repro_torch.core import PushSumState, run_pushsum_gossip
    assert PushSumState is choco_gossip.PushSumState
    assert run_pushsum_gossip is choco_gossip.run_pushsum_gossip


def test_pushsum_simulator_reaches_the_average():
    """Compressed push-sum on directed_ring(8), top 16 of 32, 400 rounds
    (the JAX package's own acceptance run): the de-biased error falls
    below 1e-6 and 1^T w stays n."""
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 32)).astype(np.float32))
    final, errs = choco_gossip.run_pushsum_gossip(
        x0, topology.directed_ring(8).A, 0.5, make_compressor(
            "top_k", fraction=0.5), 400)
    assert float(errs[-1]) < 1e-6
    assert float(final.w.sum()) == pytest.approx(8.0, abs=1e-4)


# -- the stacked exchange ---------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[tag(c) for c in CASES])
def test_pushsum_exchange_matches_jax_engine(case, jax_runs):
    """One call, then CALLS calls, of the stacked exchange against
    ``make_gossip_exchange(mode="pushsum")`` with the module's
    tolerances; call 0's payloads against JAX's ``compress_packed``."""
    path = jax_runs[tag(case)]
    sched, comp, spec, state, res = run_stacked(case, path, calls=1)
    check_state(case, comp, spec, state, res, "one", 1)
    _, _, _, state, _ = run_stacked(case, path)
    check_state(case, comp, spec, state, res, "out", CALLS)
    # call 0's payloads, gossip round 0
    _, _, _, ins, draws, _ = setup_case(case, path)
    for b, bucket in enumerate(spec.buckets):
        delta = ins[0][b].to(ins[1][b].dtype) - ins[1][b]
        (pl,), _ = compress_bufs(comp, spec, (bucket,), (delta,),
                                 draws=None if draws is None
                                 else (lambda u: draws(0, 0, u)))
        for f in dataclasses.fields(pl):
            v = getattr(pl, f.name)
            if not torch.is_tensor(v):
                continue
            want = np.stack([res[f"payload:{b}:{f.name}:{i}"]
                             for i in range(N)])
            got = v.view(torch.int16) if v.dtype == BF16 else v
            got = got.numpy().reshape(want.shape)
            if f.name == "scale":
                np.testing.assert_allclose(got, want, rtol=F32_RTOL)
            else:
                np.testing.assert_array_equal(got, want.view(got.dtype),
                                              err_msg=f"{tag(case)} {b}")


def test_mass_is_conserved_and_refusals():
    """1^T w = n over many calls (w leaves the ones it starts at), the
    round-weighted sum's bytes each node sends, and what the exchange
    refuses: exact buckets, a GammaSpec, no gossip round."""
    spec = make_bucket_spec([torch.empty(s, device="meta") for s in SHAPES])
    comp = make_compressor("top_k", fraction=0.05)
    sched = compile_for("random_digraph")
    ex = pushsum.make_pushsum_exchange(spec=spec, schedule=sched,
                                       compressor=comp, gamma=GAMMA)
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.standard_normal((N, b.size)).astype(
        np.float32)) for b in spec.buckets]
    zeros = lambda: [torch.zeros_like(b) for b in x]
    x_hat, s, w = zeros(), zeros(), torch.ones(N, 1)
    total = [float(b.sum(0).sum()) for b in x]
    for call in range(30):
        ex(x, x_hat, s, w, seed=call)
    assert float(w.sum()) == pytest.approx(N, rel=1e-6)
    assert float(w.max() / w.min()) > 1.0
    # 1^T x is kept: the EF integrates the same payloads everywhere
    for b, want in zip(x, total):
        assert float(b.sum(0).sum()) == pytest.approx(want, rel=1e-4,
                                                      abs=1e-3)
    exact = make_bucket_spec([torch.empty(s, device="meta") for s in SHAPES],
                             exact_small_leaves=True)
    with pytest.raises(ValueError, match="without exact buckets"):
        pushsum.make_pushsum_exchange(spec=exact, schedule=sched,
                                      compressor=comp, gamma=GAMMA)
    with pytest.raises(ValueError, match="scalar Theorem-2 gamma"):
        pushsum.make_pushsum_exchange(
            spec=spec, schedule=sched, compressor=comp,
            gamma=choco_gossip.GammaSpec(delta=0.1, beta=1.0))
    with pytest.raises(ValueError, match="gossip_steps must be >= 1"):
        pushsum.make_pushsum_exchange(spec=spec, schedule=sched,
                                      compressor=comp, gamma=GAMMA,
                                      gossip_steps=0)


def test_debias_divides_each_node_row():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 2, 3)
    w = torch.tensor([[1.0], [2.0], [4.0], [0.5]])
    z = pushsum.debias(x, w)
    for i in range(4):
        assert torch.equal(z[i], x[i] / w[i, 0])


# -- the per-rank engine ----------------------------------------------------------

DIST_CASES = [CASES[1], CASES[4], CASES[9], CASES[11], CASES[13]]


def _dist_rank(rank, store, out_dir, paths):
    from test_torch_dist import _join
    from repro_torch.launch import mesh
    group = _join(rank, store)
    results = {}
    for case in DIST_CASES:
        sched, comp, spec, ins, draws, _ = setup_case(case, paths[tag(case)])
        ex = pushsum.make_dist_pushsum_exchange(
            spec=spec, schedule=sched, compressor=comp, gamma=GAMMA,
            gossip_steps=case[3], group=group)
        state = [t[rank:rank + 1].clone() if isinstance(t, torch.Tensor)
                 else [b[rank:rank + 1].clone() for b in t] for t in ins]
        before = group.bytes_sent
        for call in range(CALLS):
            ex(*state, seed=call,
               draws=None if draws is None else (
                   lambda t, b, c=call: draws(c, t, b)[rank:rank + 1]))
        results[tag(case)] = (state, group.bytes_sent - before,
                              ex.payload_bytes, ex.sends, ex.w_bytes)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_dist_pushsum_exchange_bit_equal_to_stacked(tmp_path, jax_runs):
    """4 gloo ranks (one torch thread) against the stacked exchange over
    CALLS calls, JAX's draws injected: x, x_hat, s and w bit for bit;
    each rank's counted bytes its payload bytes plus 4 bytes of w, per
    round it sends in, per gossip round, per call."""
    from test_torch_dist import _spawn
    ranks = _spawn(_dist_rank, tmp_path, str(tmp_path), jax_runs)
    for case in DIST_CASES:
        sched, comp, spec, stacked, _ = run_stacked(case, jax_runs[tag(case)])
        sizes = bucket_wire_nbytes(spec, comp)
        for r, got in enumerate(ranks):
            state, sent, payload, sends, w_bytes = got[tag(case)]
            for a, b in zip(state[:3], stacked[:3]):
                for aa, bb in zip(a, b):
                    assert bits_equal(aa, bb[r:r + 1]), (tag(case), r)
            assert bits_equal(state[3], stacked[3][r:r + 1])
            rounds = case[3] * sum(rnd.peers(r)[0] is not None
                                   for rnd in sched.rounds)
            assert payload == sizes and sends == [rounds] * len(sizes)
            assert w_bytes == pushsum.W_BYTES * rounds
            assert sent == CALLS * rounds * (sum(sizes) + pushsum.W_BYTES), \
                (tag(case), r)


# -- the trainer ------------------------------------------------------------------

def _trainer(comp, arg, topo, sdt):
    from test_torch_slice import _port_trainer
    return _port_trainer(comp, arg, 1, False, topology=topo, state_dtype=sdt,
                         mode="pushsum")


@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("comp,arg,topo,sdt", TRAINER_CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in TRAINER_CASES])
def test_trainer_matches_jax_trainer(comp, arg, topo, sdt, jax_references):
    """3 steps of the port's stacked trainer in push-sum mode (the smoke
    decoder in f32, 4 nodes) against the JAX trainer's, QSGD's dither
    injected: gamma equal to JAX's scalar, ``check_against_jax``'s
    bounds on the losses, x, x_hat and s (bf16 state: its outlier
    bounds), ``psw`` bit for bit, 1^T w = n."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import make_lm_batch_fn
    from test_torch_slice import BPN, SEQ, STEPS, _tree, check_against_jax
    ref = Reference(jax_references[(comp, topo)].result())
    tr = _trainer(comp, arg, topo, sdt)
    assert [tr.gamma] == list(ref["gamma"])
    assert not any(b.exact for b in tr.spec.buckets)
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
    np.testing.assert_array_equal(state.psw.numpy(), ref["psw"])
    assert float(state.psw.sum()) == pytest.approx(N, rel=1e-6)


def _small_trainer(n=N, topo="directed_ring", sdt="float32"):
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    return DecentralizedTrainer(
        model=Model(cfg),
        choco=ChocoConfig(compressor="top_k", comp_kwargs=(("fraction", 0.05),),
                          topology=topo, state_dtype=sdt),
        n_nodes=n, optimizer=make_optimizer("momentum"),
        lr_fn=lambda step: 0.05, device="cpu", mode="pushsum")


def _run(tr, state, steps, seed=11):
    from repro_torch.data.synthetic import make_lm_batch_fn
    batches = make_lm_batch_fn(tr.model.cfg, 32, 2, tr.n_nodes, 1.0)
    for _ in range(state.step):
        batches()
    for _ in range(steps):
        tr.step(state, tr.batch_to_device(batches()))
    return state


def test_debiased_copy_is_freed_before_the_exchange(monkeypatch):
    """z = x / w, the gradient's state-sized copy, is freed when the
    gradient returns: nothing of the step (the losses' graph among them)
    keeps it through the exchange."""
    import weakref
    from repro_torch.train import trainer as trainer_mod
    tr = _small_trainer()
    state = tr.init_state(seed=0)
    made = []

    def debias(x, w):
        z = pushsum.debias(x, w)
        made.append(weakref.ref(z))
        return z
    monkeypatch.setattr(trainer_mod, "debias", debias)
    exchange, alive = tr.exchange, []

    def watched(*args, **kw):
        alive.append(sum(r() is not None for r in made))
        return exchange(*args, **kw)
    tr.exchange = watched
    _run(tr, state, 1)
    assert len(made) == tr.spec.n_buckets and alive == [0]


def test_resume_is_bit_exact_and_elastic_restore_is_refused(tmp_path):
    """3 steps straight against 1 step, a save, a restore and 2 steps
    (bf16 state): x, x_hat, s, the moments and ``psw`` bit for bit; a
    push-sum checkpoint into 8 nodes, or into another graph, raises
    ``ElasticRestoreError`` with JAX's wording."""
    from repro_torch.checkpoint.manifest import ElasticRestoreError
    tr = _small_trainer(sdt="bfloat16")
    straight = _run(tr, tr.init_state(seed=2), 3)
    half = _run(tr, tr.init_state(seed=2), 1)
    tr.save_checkpoint(str(tmp_path / "step1"), half)
    state, man, warm = tr.restore_checkpoint(str(tmp_path / "step1"))
    assert warm == 0 and man.fingerprint["mode"] == "pushsum"
    assert torch.equal(state.psw, half.psw)
    _run(tr, state, 2)
    for a, b in zip(state.x + state.x_hat + state.s + state.opt.mu,
                    straight.x + straight.x_hat + straight.s
                    + straight.opt.mu):
        assert bits_equal(a, b)
    assert torch.equal(state.psw, straight.psw) and state.step == 3
    for other in (_small_trainer(n=8, sdt="bfloat16"),
                  _small_trainer(topo="random_digraph", sdt="bfloat16")):
        with pytest.raises(ElasticRestoreError,
                           match="elastic restore is not supported for "
                                 "push-sum: the weight column w encodes "
                                 "conserved mass"):
            other.restore_checkpoint(str(tmp_path / "step1"))


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
    tr = DecentralizedTrainer(
        model=build_model(cfg),
        choco=ChocoConfig(compressor="top_k", comp_kwargs=(("fraction", 0.05),),
                          gossip_axis="data", kernel_backend="jnp",
                          topology="random_digraph"),
        mesh=mesh, n_nodes=4, optimizer=make_optimizer("momentum"),
        lr_fn=constant_schedule(0.05), mode="pushsum")
    report = {"specs": {k: [list(s), d] for k, (s, d) in
                        tree_leaf_specs(tr.state_shape()).items()}}
    state, man, warm = tr.restore_checkpoint(os.path.join(out, "port"))
    report["warmup"] = warm
    np.savez(os.path.join(out, "jax-restored.npz"), **_flatten(state))
    state = tr.init_state(jax.random.PRNGKey(5))
    b = jax.tree.map(jnp.asarray, make_lm_batch_fn(cfg, 32, 2, 4, 1.0)())
    step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                jax.eval_shape(lambda: b))
    for _ in range(2):
        state, _ = step(state, b)
    tr.save_checkpoint(os.path.join(out, "jax"), state)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)
""")


@pytest.mark.slow
@pytest.mark.distributed
def test_checkpoints_cross_restore_with_the_jax_trainer(tmp_path):
    """Push-sum on random_digraph: the port's ``state_leaf_specs`` are
    JAX's ``tree_leaf_specs(state_shape())``, ``psw`` (4, 1) f32 among
    them; a port checkpoint restores in JAX as a resume (0 rounds) to the
    same leaves bit for bit; a JAX checkpoint (w off its ones) restores in
    the port as a resume and saves back to JAX's stored leaves bit for
    bit."""
    from test_torch_checkpoint import _stored
    tr = _small_trainer(topo="random_digraph")
    tr.save_checkpoint(str(tmp_path / "port"), _run(tr, tr.init_state(3), 2))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_CKPT, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    specs = {k: [list(s), d] for k, (s, d) in tr.state_leaf_specs().items()}
    assert specs == report["specs"] and specs["psw"] == [[N, 1], "float32"]
    assert report["warmup"] == 0
    _, port = _stored(tmp_path / "port")
    restored = np.load(tmp_path / "jax-restored.npz")
    assert sorted(restored.files) == sorted(port)
    for key, arr in port.items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)
    state, _, warm = tr.restore_checkpoint(str(tmp_path / "jax"))
    assert warm == 0 and not torch.equal(state.psw, torch.ones(N, 1))
    tr.save_checkpoint(str(tmp_path / "again"), state)
    _, want = _stored(tmp_path / "jax")
    _, got = _stored(tmp_path / "again")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_trainer_refuses_what_jax_refuses():
    """JAX's rules: a directed graph under choco or plain, a time-varying
    push-sum sequence, a topology process, the per-leaf engine and
    pipelining under push-sum."""
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    make = lambda mode, **kw: DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(**kw), n_nodes=N,
        optimizer=make_optimizer("sgd"), lr_fn=lambda s: 0.1, device="cpu",
        mode=mode)
    for mode, kw, msg in (
            ("choco", {"topology": "directed_ring"},
             "is directed \\(column-stochastic\\): the symmetric 'choco'"),
            ("plain", {"topology": "random_digraph"},
             "the symmetric 'plain' engine"),
            ("pushsum", {"topology": "directed_ring,ring", "gossip_steps": 2},
             "push-sum runs one directed schedule"),
            ("pushsum", {"topology_process": "matching"},
             "the push-sum engine handles directed graphs itself"),
            ("pushsum", {"topology": "directed_ring", "packed_gossip": False},
             "packed-only"),
            ("pushsum", {"pipeline_gossip": True}, "requires mode='choco'")):
        with pytest.raises(ValueError, match=msg):
            make(mode, **kw)
    # push-sum on a symmetric graph runs its symmetric schedule
    tr = make("pushsum", topology="ring")
    assert tr.schedules[0].n_rounds == 2 and tr.ef_layout() == (None, None)
    assert tr.fingerprint()["mode"] == "pushsum"


# -- the launcher ------------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--seq-len", "32",
          "--batch-per-node", "2", "--device", "cpu", "--mode", "pushsum",
          "--topology", "random_digraph"]


def test_launcher_trains_pushsum_stacked_and_per_rank(tmp_path, capfd):
    """``--mode pushsum --topology random_digraph`` on 4 nodes, stacked
    (``--mesh 4x1``) and with ``--simulate-devices 4`` (the per-rank
    exchange): finite losses, the same losses both ways, rank 0's wire
    bytes its payload bytes plus 4 per round it sends in, and the two
    runs' checkpoints (``psw`` among their leaves) bit-equal."""
    from repro_torch.launch import train as launcher
    from test_torch_checkpoint import _stored
    runs = {}
    for name, extra in (("stacked", ["--mesh", "4x1"]),
                        ("ranks", ["--simulate-devices", "4"])):
        assert launcher.main(_SMOKE + extra + [
            "--checkpoint-dir", str(tmp_path / name),
            "--checkpoint-every", "2"]) == 0
        out = capfd.readouterr().out
        assert " mode=pushsum " in out and "topology=random_digraph " in out
        runs[name] = [line.split("loss ")[1].split()[0]
                      for line in out.splitlines()
                      if line.startswith("[train] step")]
        assert len(runs[name]) == 2
        assert all(np.isfinite(float(v)) for v in runs[name])
        if name == "ranks":
            sched = compile_for("random_digraph")
            sends = sum(rnd.peers(0)[0] is not None for rnd in sched.rounds)
            spec = _small_trainer(topo="random_digraph").spec
            per_step = sends * (sum(bucket_wire_nbytes(
                spec, make_compressor("top_k", fraction=0.01)))
                + pushsum.W_BYTES)
            assert f" wire {per_step} B sent by rank 0" in out
    assert runs["stacked"] == runs["ranks"]
    _, want = _stored(tmp_path / "stacked" / "step2")
    _, got = _stored(tmp_path / "ranks" / "step2")
    assert sorted(got) == sorted(want) and "psw" in want
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


_REFUSALS = [
    (["--topology", "directed_ring"], "choco"),
    (["--topology", "random_digraph", "--mode", "plain"], "plain"),
    (["--topology", "directed_ring", "--mode", "allreduce"], "allreduce"),
    (["--mode", "pushsum", "--topology", "directed_ring,ring",
      "--gossip-steps", "2"], "sequence"),
    (["--mode", "pushsum", "--topology", "directed_ring",
      "--topology-process", "linkfail"], "process"),
    (["--mode", "pushsum", "--gossip-engine", "per-leaf"], "per-leaf"),
]


@pytest.mark.parametrize("extra,case", _REFUSALS,
                         ids=[c for _, c in _REFUSALS])
def test_launcher_refuses_as_jax_word_for_word(extra, case, capsys):
    """The JAX launcher's directed-graph and push-sum rules: the port's
    error line is the JAX launcher's, and it comes before torch is
    imported."""
    from repro.launch import train as jlauncher
    base = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1"]
    errors = []
    for main in (jlauncher.main, _port_main):
        with pytest.raises(SystemExit) as exc:
            main(base + extra)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    jax_line = errors[0].split("error: ", 1)[1]
    assert errors[1].split("error: ", 1)[1] == jax_line
    code = ("import sys; from repro_torch.launch.train import main\n"
            "try:\n    main(sys.argv[1:])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    r = subprocess.run([sys.executable, "-c", code] + base + extra,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "refused", r.stderr
    assert jax_line in r.stderr


def _port_main(argv):
    from repro_torch.launch import train as launcher
    return launcher.main(argv)


def test_launcher_refuses_pipelined_pushsum(capsys):
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit):
        launcher.main(_SMOKE + ["--pipeline-gossip"])
    assert ("--mode pushsum has no (x_hat, s) state to double-buffer"
            in capsys.readouterr().err)
