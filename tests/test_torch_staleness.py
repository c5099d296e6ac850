"""Bounded-staleness gossip in the port (``StalenessProcess``,
``comm/stochastic.py``; the stale form of the replica engine,
``comm/gossip.py``; the stale simulator, ``core/choco_gossip.py``), held
against the JAX package on the CPU.

* the process objects on every symmetric registry graph against JAX's
  ``StalenessProcess``: the delay tables, the freshness, the expected
  matrix and its (delta, beta), the effective omega, the per-round
  delays, and every validation error word for word;
* the port's own sampler: a pure function of the exchange seed, both
  directions of a link one delay, the delay frequencies within 4 sigma
  over 10^4 draws, and an edge that is no straggler drawn exactly as
  without stragglers;
* the exchange against ``make_gossip_exchange(process=StalenessProcess)``
  on an ``AxisType.Auto`` mesh of 4 host devices (one JAX subprocess for
  every case, shared across xdist workers under a file lock), over 3
  calls so that the rings fill: tau 0 to 3, a non-uniform law, straggler
  links with and without their own law, ring, chain and star, packed and
  per leaf, f32 and bf16 state, QSGD s=16 and s=255, sign, top_k, rand_k
  and block_top_k; JAX's delays and draws injected;
* the stale simulator against ``run_choco_stale_gossip``; at delay 1 on
  every edge against the pipelined simulator; the average 1^T x kept;
* the per-rank engine (4 gloo ranks on one torch thread) bit-equal to the
  stacked one, each rank's bytes its payload bytes times the rounds it
  ships in times the gossip rounds;
* the trainer against the JAX trainer (``check_against_jax``'s bounds on
  x and on every element of the x_hat and s lists), checkpoints crossing
  with the JAX trainer bit for bit, the re-mix on a change of tau, and
  the launcher (its flags and refusals).

Tolerances:

* the delays, the wire payloads, x_hat, the replicas S_r and every ring
  slot bit for bit; on f32 state the QSGD and sign scales differ from
  JAX's by the norms' summation order (1e-6 relative), and where they do
  x_hat, S_r and the rings carry the difference: within 1e-6 absolute
  plus 1e-6 relative;
* x bit for bit (the plain version takes XLA's FMAs,
  ``ref.replica_stale_ref``), but with the f32 QSGD and sign scales'
  difference, within 1e-6 absolute plus 1e-6 relative;
* the simulator: f32 iterates within 1e-5 of their largest magnitude.
"""
import fcntl
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
from test_torch_slice import ROOT
from test_torch_slice import one_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
N = 4
GAMMA = 0.3
F32_ATOL = F32_RTOL = 1e-6
#: exchange calls per case (the rings fill over them)
CALLS = 3
#: per-node leaf shapes of the exchange cases
SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000))

_KW = {"top_k": {"fraction": 0.05}, "block_top_k": {"fraction": 0.05},
       "rand_k": {"fraction": 0.05}, "qsgd": {"s": 16}, "qsgd255": {"s": 255},
       "sign": {}}

#: (topology, compressor key, state dtype, packed, gossip_steps, tau,
#: delay_probs, straggler_edges, straggler_delay_probs)
CASES = (
    ("ring", "top_k", "float32", True, 1, 1, None, None, None),
    ("ring", "qsgd", "bfloat16", True, 2, 2, None, None, None),
    ("chain", "rand_k", "float32", True, 1, 3, (0.1, 0.2, 0.3, 0.4), None,
     None),
    ("star", "sign", "float32", True, 2, 2, None, ((0, 1),), None),
    ("ring", "top_k", "bfloat16", False, 1, 2, None, ((0, 1),),
     (0.2, 0.3, 0.5)),
    ("ring", "qsgd255", "float32", False, 1, 1, None, None, None),
    ("chain", "block_top_k", "bfloat16", False, 1, 1, (0.3, 0.7), None, None),
    ("star", "qsgd", "bfloat16", False, 1, 3, None, ((0, 2),), None),
    ("ring", "sign", "bfloat16", True, 1, 0, None, None, None),
    ("star", "top_k", "float32", False, 1, 0, None, None, None),
    ("ring", "rand_k", "bfloat16", False, 1, 3, None, None, None),
    ("chain", "qsgd", "float32", True, 1, 2, None, ((1, 2),),
     (0.5, 0.0, 0.5)),
    ("ring", "block_top_k", "float32", True, 1, 2, (0.2, 0.3, 0.5), None,
     None),
)


def tag(case) -> str:
    topo, comp, sdt, packed, k, tau, probs, edges, sprobs = case
    return (f"{topo}-{comp}-{sdt}-{'packed' if packed else 'leaf'}-{k}-"
            f"tau{tau}{'-p' if probs else ''}"
            f"{'-strag' if edges else ''}{'-sp' if sprobs else ''}")


_JAX_EXCHANGES = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.comm import packing as jpacking
    from repro.comm.gossip import _pack_align, make_gossip_exchange
    from repro.comm.schedule import compile_schedule
    from repro.comm.stochastic import make_topology_process
    from repro.core.compression import make_compressor
    from repro.core.topology import make_topology

    cases, gamma, calls, out_dir = (json.loads(sys.argv[1]),
                                    float(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4])
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fold = jax.jit(jax.random.fold_in)
    uniform = jax.jit(jax.random.uniform, static_argnums=1)
    permutation = jax.jit(jax.random.permutation, static_argnums=1)
    split = jax.jit(jax.random.split, static_argnums=1)
    bits = lambda v: v if v.dtype != jnp.bfloat16 else v.view(np.uint16)
    tup = lambda v: None if v is None else tuple(
        tuple(e) if isinstance(e, list) else e for e in v)
    for c in cases:
        rng = np.random.default_rng(c["seed"])
        sdt = jnp.dtype(c["sdt"])
        shapes = [tuple(s) for s in c["shapes"]]
        proc = make_topology_process(
            "staleness", compile_schedule(make_topology(c["topology"], 4)),
            max_staleness=c["tau"], delay_probs=tup(c["probs"]),
            straggler_edges=tup(c["edges"]),
            straggler_delay_probs=tup(c["sprobs"]))
        R, tau = proc.schedule.n_rounds, proc.max_staleness
        def tree(scale, dtype):
            return {f"l{i}": (scale * rng.standard_normal((4,) + s))
                    .astype(np.float32).astype(dtype)
                    for i, s in enumerate(shapes)}
        x = tree(1.0, np.float32)
        x_hat = [tree(0.5, sdt)] + [tree(0.05, sdt) for _ in range(tau)]
        s = ([tree(0.5, sdt) for _ in range(R)]
             + [tree(0.05, sdt) for _ in range(R * tau)])
        names = sorted(x)
        specs = {k: P("data", *([None] * (v.ndim - 1))) for k, v in x.items()}
        comp = make_compressor(c["name"], **c["kw"])
        ex = jax.jit(make_gossip_exchange(
            mode="choco", mesh=mesh, state_specs=specs, axis="data",
            compressor=comp, gamma=gamma, packed=c["packed"], process=proc,
            gossip_steps=c["k"]))
        res = {}
        def save(tg, t):
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
                name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path)
                res[f"{tg}:{name}"] = bits(np.asarray(leaf))
        for tg, t in (("in_x", x), ("in_x_hat", x_hat), ("in_s", s)):
            save(tg, t)
        jt = lambda t: jax.tree.map(jnp.asarray, t)
        state = (jt(x), jt(x_hat), jt(s))
        spec = jpacking.make_bucket_spec(
            [jax.ShapeDtypeStruct(v.shape[1:], sdt) for v in x.values()],
            align=_pack_align(comp, None))
        for call in range(calls):
            key = fold(jax.random.PRNGKey(c["seed"]), call)
            state = ex(key, *state)
            for t in range(c["k"]):
                res[f"delays:{call}:{t}"] = np.asarray(
                    proc.edge_delays(key, t))
            if not comp.stochastic:
                continue
            for t in range(c["k"]):
                for i in range(4):
                    tk = fold(key, i)
                    tk = tk if t == 0 else fold(tk, t)
                    if c["packed"]:
                        units = [(b.index, fold(tk, b.index), b.size,
                                  b.logical, spec.bucket_slots(b.index), b)
                                 for b in spec.buckets]
                    else:
                        lk = split(fold(tk, 0), len(names))
                        units = [(j, lk[j], x[nm][0].size, x[nm][0].size,
                                  None, None) for j, nm in enumerate(names)]
                    for u, uk, size, logical, slots, b in units:
                        if c["name"] == "qsgd":
                            d = uniform(uk, (size,))
                        elif b is not None:
                            kb = jpacking._slot_budget(comp, slots, b)
                            d = permutation(uk, logical)[:kb]
                        else:
                            kk = max(1, min(size, int(np.ceil(
                                c["kw"]["fraction"] * size))))
                            d = permutation(uk, size)[:kk]
                        res[f"draw:{call}:{t}:{u}:{i}"] = np.asarray(d)
        for tg, t in zip(("out_x", "out_x_hat", "out_s"), state):
            save(tg, t)
        np.savez(os.path.join(out_dir, c["tag"] + ".npz"), **res)
""")


def _case_dict(case, index):
    topo, comp, sdt, packed, k, tau, probs, edges, sprobs = case
    return dict(tag=tag(case), topology=topo,
                name=comp.rstrip("0123456789"), kw=_KW[comp], sdt=sdt,
                packed=packed, k=k, tau=tau, probs=probs, edges=edges,
                sprobs=sprobs, shapes=SHAPES, seed=900 + index)


@pytest.fixture(scope="module", autouse=True)
def jax_references(tmp_path_factory):
    """The module's two JAX reference runs, started together at its first
    test (each a subprocess, so they run beside the tests that need
    neither): the exchanges of CASES and the trainer's.  Each value is a
    future of its result."""
    from concurrent.futures import ThreadPoolExecutor
    from test_torch_slice import jax_reference_path
    tmp_path_factory.getbasetemp()      # made once, not raced by the threads
    with ThreadPoolExecutor(2) as pool:
        yield {"exchanges": pool.submit(_jax_exchanges, tmp_path_factory),
               "trainer": pool.submit(jax_reference_path, tmp_path_factory,
                                      "top_k", 0.05, 1, False,
                                      process="staleness")}


@pytest.fixture(scope="module")
def jax_runs(jax_references):
    return jax_references["exchanges"].result()


def _jax_exchanges(tmp_path_factory):
    """``tag -> npz path`` of the JAX engine's runs of CASES, made once
    per pytest run in one subprocess, shared across xdist workers."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "jax_reference"
    root.mkdir(exist_ok=True)
    out = root / "jax_stale_exchanges"
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            part = root / "jax_stale_exchanges.part"
            part.mkdir(exist_ok=True)
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                       JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            r = subprocess.run(
                [sys.executable, "-c", _JAX_EXCHANGES,
                 json.dumps([_case_dict(c, i) for i, c in enumerate(CASES)]),
                 str(GAMMA), str(CALLS), str(part)],
                env=env, capture_output=True, text=True, timeout=900)
            assert r.returncode == 0, \
                f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
            os.replace(part, out)
    return {tag(c): str(out / (tag(c) + ".npz")) for c in CASES}


def _tensor(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(BF16) if a.dtype == np.uint16 else t


def bits_equal(a, b) -> bool:
    if a.dtype == BF16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def make_process(case, n=N):
    topo, comp, sdt, packed, k, tau, probs, edges, sprobs = case
    return stochastic.make_topology_process(
        "staleness", schedule.compile_schedule(topology.make_topology(topo, n)),
        max_staleness=tau, delay_probs=probs, straggler_edges=edges,
        straggler_delay_probs=sprobs)


def setup_case(case, path):
    """(process, compressor, spec, (x, x_hat, s) bucket buffers in the
    engine's layout, the JAX outputs as leaf lists in the same layout,
    draws(call, t, u), samples(call, t), the npz)."""
    topo, comp_key, sdt, packed, k, tau, *_ = case
    proc = make_process(case)
    R = proc.schedule.n_rounds
    comp = make_compressor(comp_key.rstrip("0123456789"), **_KW[comp_key])
    dtype = getattr(torch, sdt)
    spec = make_bucket_spec([torch.empty(sh, dtype=dtype, device="meta")
                             for sh in SHAPES],
                            align=gossip._pack_align(comp))
    res = np.load(path)
    L = len(SHAPES)

    def leaves(tg, idx=None):
        pre = f"{tg}:" if idx is None else f"{tg}:{idx}/"
        return [_tensor(res[f"{pre}l{j}"]) for j in range(L)]

    pack = lambda lv, dt=None: pack_leaves(spec, lv, dtype=dt)
    ins = (pack(leaves("in_x"), torch.float32),
           [pack(leaves("in_x_hat", r)) for r in range(1 + tau)],
           [pack(leaves("in_s", r)) for r in range(R * (1 + tau))])
    want = (leaves("out_x"), [leaves("out_x_hat", r) for r in range(1 + tau)],
            [leaves("out_s", r) for r in range(R * (1 + tau))])
    samples = lambda call, t: res[f"delays:{call}:{t}"]
    draws = None
    if comp.stochastic:
        draws = lambda call, t, u: torch.from_numpy(np.stack(
            [res[f"draw:{call}:{t}:{u}:{i}"] for i in range(N)]))
    return proc, comp, spec, ins, want, draws, samples, res


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    return [_clone(o) for o in obj]


def run_stacked(case, path):
    """CALLS calls of the stacked exchange, JAX's delays and draws
    injected.  Returns (process, compressor, spec, the state, JAX's, the
    exchange)."""
    proc, comp, spec, ins, want, draws, samples, _ = setup_case(case, path)
    x, x_hat, s = _clone(ins)
    ex = gossip.make_process_exchange(spec=spec, process=proc,
                                      compressor=comp, gamma=GAMMA,
                                      gossip_steps=case[4], packed=case[3])
    for call in range(CALLS):
        ex(x, x_hat, s, seed=call,
           draws=None if draws is None else
           (lambda t, u, c=call: draws(c, t, u)),
           samples=lambda t, c=call: samples(c, t))
    return proc, comp, spec, (x, x_hat, s), want, ex


def quantizing(comp) -> bool:
    return comp.name in ("qsgd", "sign")


def check_state(case, comp, spec, got, want):
    """x, every x_hat slot and every s slot against the JAX engine's
    leaves, with the tolerances of this module's docstring."""
    scale_gap = case[2] == "float32" and quantizing(comp)
    for tg, bufs, w in zip(("x", "x_hat", "s"), got, want):
        pairs = (list(zip(unpack_leaves(spec, bufs), w)) if tg == "x" else
                 [(g, ww) for b, wl in zip(bufs, w)
                  for g, ww in zip(unpack_leaves(spec, b), wl)])
        assert len(pairs) == len(SHAPES) * (1 if tg == "x" else len(w))
        for j, (g, ww) in enumerate(pairs):
            g = g.reshape(ww.shape)
            if not scale_gap:
                assert bits_equal(g, ww), (tag(case), tg, j,
                                           (g.float() - ww.float()).abs().max())
            else:
                np.testing.assert_allclose(g.numpy(), ww.numpy(),
                                           rtol=F32_RTOL, atol=F32_ATOL,
                                           err_msg=f"{tag(case)} {tg} {j}")


@pytest.mark.parametrize("case", CASES, ids=[tag(c) for c in CASES])
def test_stale_exchange_matches_jax_engine(case, jax_runs):
    """The stacked stale exchange, JAX's delays and draws injected, over
    CALLS calls, against ``make_gossip_exchange(process=
    StalenessProcess)``; the exchange keeps the delays it used."""
    proc, comp, spec, got, want, ex = run_stacked(case, jax_runs[tag(case)])
    check_state(case, comp, spec, got, want)
    res = np.load(jax_runs[tag(case)])
    assert len(ex.last_samples) == case[4]
    for t, d in enumerate(ex.last_samples):
        np.testing.assert_array_equal(d, res[f"delays:{CALLS - 1}:{t}"])


def test_the_rings_turn_without_a_copy(jax_runs):
    """A call turns each ring as a list: the slot that held the oldest
    increment is the one the update overwrites (slot 0 afterwards), and
    the list objects are the caller's own."""
    case = CASES[1]
    proc, comp, spec, ins, _, draws, samples, _ = setup_case(
        case, jax_runs[tag(case)])
    x, x_hat, s = _clone(ins)
    R, tau = proc.schedule.n_rounds, proc.max_staleness
    before_hat = [b[0].data_ptr() for b in x_hat]
    before_s = [b[0].data_ptr() for b in s]
    ex = gossip.make_process_exchange(spec=spec, process=proc,
                                      compressor=comp, gamma=GAMMA,
                                      gossip_steps=1, packed=case[3])
    ex(x, x_hat, s, draws=lambda t, u: draws(0, t, u),
       samples=lambda t: samples(0, t))
    turn = lambda ptrs, lo: ptrs[:lo] + [ptrs[lo + tau - 1]] + ptrs[
        lo:lo + tau - 1] + ptrs[lo + tau:]
    assert [b[0].data_ptr() for b in x_hat] == turn(before_hat, 1)
    want_s = before_s
    for r in range(R):
        want_s = turn(want_s, R + r * tau)
    assert [b[0].data_ptr() for b in s] == want_s


# -- the process objects ----------------------------------------------------------

def _jax_process(name, n, **kw):
    from repro.comm.schedule import compile_schedule as jcompile
    from repro.comm.stochastic import make_topology_process as jmake
    from repro.core.topology import make_topology as jtopo
    return jmake("staleness", jcompile(jtopo(name, n)), **kw)


def _port_process(name, n, **kw):
    return stochastic.make_topology_process(
        "staleness", schedule.compile_schedule(topology.make_topology(name, n)),
        **kw)


GRAPHS = [(name, n) for name in topology.SYMMETRIC_TOPOLOGIES
          for n in (4, 8)]


@pytest.mark.parametrize("name,n", GRAPHS, ids=[f"{g}-{n}" for g, n in GRAPHS])
def test_process_objects_match_jax(name, n):
    """Every symmetric registry graph, tau 0 to 3, the uniform and a
    non-uniform law, with and without a straggler link (the support's
    first edge) and its own law: the delay tables, the freshness, the
    edge indexing and sources, the expected matrix and its (delta, beta),
    the effective omega and the per-round delays of a delay vector, all
    equal to JAX's; ``sample_matrix`` refuses with JAX's words."""
    import jax
    first = _port_process(name, n)._edges[0]
    for kw in (dict(max_staleness=0), dict(max_staleness=1),
               dict(max_staleness=2, delay_probs=(0.5, 0.3, 0.2)),
               dict(max_staleness=3, straggler_edges=(first[::-1],)),
               dict(max_staleness=2, delay_probs=(1.0, 1.0, 2.0),
                    straggler_edges=(first,),
                    straggler_delay_probs=(0.1, 0.0, 0.9))):
        want, got = _jax_process(name, n, **kw), _port_process(name, n, **kw)
        for attr in ("delay_probs", "straggler_edges",
                     "straggler_delay_probs", "edge_delay_probs", "n_edges",
                     "_edges", "round_edge_ids", "round_src", "mean_delay",
                     "freshness", "edge_freshness"):
            assert getattr(got, attr) == getattr(want, attr), (kw, attr)
        assert got.round_recv == tuple(tuple(r) for r in want.round_recv)
        np.testing.assert_array_equal(got.expected_matrix(),
                                      want.expected_matrix())
        assert got.expected_delta_beta() == want.expected_delta_beta()
        assert got.effective_omega(0.0123) == want.effective_omega(0.0123)
        key = jax.random.PRNGKey(n)
        delays = np.asarray(want.edge_delays(key, 1))
        for a, b in zip(got.round_delays(delays), want.round_delays(delays)):
            np.testing.assert_array_equal(a, np.asarray(b))
        with pytest.raises(NotImplementedError) as err_got:
            got.sample_matrix(0, 0)
        with pytest.raises(NotImplementedError) as err_want:
            want.sample_matrix(key, 0)
        assert str(err_got.value) == str(err_want.value)


@pytest.mark.parametrize("kw", [
    dict(max_staleness=-1),
    dict(max_staleness=1, delay_probs=(0.5, 0.3, 0.2)),
    dict(max_staleness=1, delay_probs=(0.5, -0.5)),
    dict(max_staleness=1, delay_probs=(0.0, 0.0)),
    dict(max_staleness=1, straggler_delay_probs=(0.0, 1.0)),
    dict(max_staleness=1, straggler_edges=((0, 2),)),
    dict(max_staleness=2, straggler_edges=((0, 1),),
         straggler_delay_probs=(0.5, 0.5)),
], ids=["negative-tau", "arity", "negative", "no-mass", "probs-no-edges",
        "unknown-edge", "straggler-arity"])
def test_validation_errors_match_jax(kw):
    """Each of JAX's build-time refusals, word for word (on the ring of
    4, whose support has no edge 0-2)."""
    with pytest.raises(ValueError) as want:
        _jax_process("ring", 4, **kw)
    with pytest.raises(ValueError) as got:
        _port_process("ring", 4, **kw)
    assert str(got.value) == str(want.value)


def test_parsers_match_jax():
    """The port's copies of ``parse_straggler_edges`` and
    ``parse_delay_probs``: the same values and the same refusals."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as pbase
    for spec in ("0-1", " 3-2 , 0-1,", "4-0"):
        assert pbase.parse_straggler_edges(spec) == \
            jbase.parse_straggler_edges(spec)
    for spec in ("0.1,0.2,0.7", "1, 0", "2"):
        assert pbase.parse_delay_probs(spec) == jbase.parse_delay_probs(spec)
    for fn, bad in (("parse_straggler_edges", ("0-1-2", "a-b", "-1-2",
                                               "3-3", ",")),
                    ("parse_delay_probs", ("x", ",", "-1,2", "0,0"))):
        for spec in bad:
            with pytest.raises(ValueError) as want:
                getattr(jbase, fn)(spec)
            with pytest.raises(ValueError) as got:
                getattr(pbase, fn)(spec)
            assert str(got.value) == str(want.value), (fn, spec)


def test_port_sampler_is_shared_and_has_the_process_law():
    """A sample is a pure function of (seed, t), the same on a rebuilt
    process (another engine, another node); both endpoints of a link read
    one delay; over 10^4 draws each delay's frequency lies within 4 sigma
    of its probability, the straggler link's under its own law; and an
    edge that is no straggler draws exactly what it draws without
    stragglers."""
    draws = 10_000
    probs = (0.2, 0.5, 0.3)
    a = _port_process("hypercube", 8, max_staleness=2, delay_probs=probs,
                      straggler_edges=((0, 1),),
                      straggler_delay_probs=(0.6, 0.0, 0.4))
    b = _port_process("hypercube", 8, max_staleness=2, delay_probs=probs,
                      straggler_edges=((0, 1),),
                      straggler_delay_probs=(0.6, 0.0, 0.4))
    plain = _port_process("hypercube", 8, max_staleness=2, delay_probs=probs)
    ds = np.stack([a.edge_delays(seed, seed % 3) for seed in range(draws)])
    np.testing.assert_array_equal(ds[:20], np.stack(
        [b.edge_delays(seed, seed % 3) for seed in range(20)]))
    others = np.stack([plain.edge_delays(seed, seed % 3)
                       for seed in range(draws)])
    strag = a._edges.index((0, 1))
    keep = [e for e in range(a.n_edges) if e != strag]
    np.testing.assert_array_equal(ds[:, keep], others[:, keep])
    for rnd, vec in zip(a.schedule.rounds, a.round_delays(ds[7])):
        for src, dst in rnd.perm:
            assert vec[dst] == vec[src]
    for column, law in ((ds[:, keep].ravel(), probs),
                        (ds[:, strag], (0.6, 0.0, 0.4))):
        counts = np.bincount(column, minlength=3)
        for k, p in enumerate(law):
            sigma = np.sqrt(column.size * p * (1 - p))
            assert abs(counts[k] - column.size * p) <= 4 * sigma, (law, k)


# -- the simulator ------------------------------------------------------------------

@pytest.mark.parametrize("comp_name,kw", [
    ("top_k", {"fraction": 0.1}), ("rand_k", {"fraction": 0.1}),
    ("qsgd", {"s": 16})], ids=["top_k", "rand_k", "qsgd"])
def test_stale_simulator_matches_jax(comp_name, kw):
    """``run_choco_stale_gossip`` on ring 8, d 300, 12 steps, tau 2 with a
    straggler link, JAX's delays and draws injected: the consensus errors
    within 1e-5 relative, x, x_hat and the ring within 1e-5 of their
    largest magnitude."""
    import jax
    import jax.numpy as jnp
    from repro.core import choco_gossip as jchoco
    from repro.core import compression as jcomp
    from repro_torch.core import choco_gossip
    from test_torch_sim import _node_draws
    n, d, steps, gamma = 8, 300, 12, 0.2
    kw_proc = dict(max_staleness=2, straggler_edges=((0, 1),))
    jp, pp = _jax_process("ring", n, **kw_proc), _port_process("ring", n,
                                                               **kw_proc)
    jc, pc = (jcomp.make_compressor(comp_name, **kw),
              make_compressor(comp_name, **kw))
    x0 = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    samples, draws = [], []
    for step in range(steps):
        ek = jax.random.fold_in(key, step)
        samples.append(np.asarray(jp.edge_delays(ek, 0)))
        if jc.stochastic:
            draws.append(np.array(_node_draws(jc, jax.random.fold_in(ek, 1),
                                              n, d)))
    jst, jerrs = jchoco.run_choco_stale_gossip(jnp.asarray(x0), jp, gamma,
                                               jc, steps, key=key)
    st, errs = choco_gossip.run_choco_stale_gossip(
        torch.from_numpy(x0), pp, gamma, pc, steps,
        draws=(lambda t: torch.from_numpy(draws[t])) if draws else None,
        samples=lambda t: samples[t])
    assert any(s.any() for s in samples) and not all(s.all() for s in samples)
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), rtol=1e-5)
    for got, want in ((st.x, jst.x), (st.x_hat, jst.x_hat),
                      (st.ring, jst.ring)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert errs[-1] < errs[0]


def test_stale_simulator_at_delay_one_is_the_pipelined_simulator():
    """Every edge one round late (``pipeline_delay_process``, delays
    (0, 1)) is the pipelined recursion (JAX ``core/choco_gossip.py:
    268-275``): the two simulators' iterates and public copies within
    1e-5 of their largest magnitude over 20 rounds."""
    from repro_torch.comm.pipelined import pipeline_delay_process
    from repro_torch.core import choco_gossip
    n, d, steps, gamma = 8, 200, 20, 0.3
    topo = topology.make_topology("ring", n)
    proc = pipeline_delay_process(schedule.compile_schedule(topo))
    comp = make_compressor("top_k", fraction=0.1)
    x0 = torch.from_numpy(
        np.random.default_rng(2).standard_normal((n, d)).astype(np.float32))
    stale, serr = choco_gossip.run_choco_stale_gossip(x0, proc, gamma, comp,
                                                      steps, seed=4)
    pipe, perr = choco_gossip.run_choco_pipelined_gossip(x0, topo.W, gamma,
                                                         comp, steps)
    for got, want in ((stale.x, pipe.x), (stale.x_hat, pipe.x_hat)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(serr.numpy(), perr.numpy(), rtol=1e-5)


def test_average_preserved():
    """Both endpoints of a link read one delay and w_ij = w_ji, so their
    updates cancel: 1^T x stays what it was, within f32 rounding, over 20
    rounds of the stacked exchange on the ring with tau = 2."""
    proc = _port_process("ring", N, max_staleness=2)
    comp = make_compressor("top_k", fraction=0.05)
    spec = make_bucket_spec([torch.empty(sh, device="meta") for sh in SHAPES],
                            align=gossip._pack_align(comp))
    rng = np.random.default_rng(1)
    x = pack_leaves(spec, [torch.from_numpy(
        rng.standard_normal((N,) + sh).astype(np.float32)) for sh in SHAPES])
    zeros = lambda: [torch.zeros_like(b) for b in x]
    x_hat = [zeros() for _ in range(3)]
    s = [zeros() for _ in range(2 * 3)]
    ex = gossip.make_process_exchange(spec=spec, process=proc,
                                      compressor=comp, gamma=GAMMA)
    total0 = [b.double().sum(0) for b in x]
    delays = []
    for step in range(20):
        ex(x, x_hat, s, seed=step)
        delays += [d.tolist() for d in ex.last_samples]
        for b, t0 in zip(x, total0):
            drift = (b.double().sum(0) - t0).abs()
            assert float(drift.max()) <= 1e-5 * max(
                1.0, float(b.double().abs().sum(0).max())), step
    assert {v for d in delays for v in d} == {0, 1, 2}
    assert sum(float((b.sum(0) - t0).abs().max()) for b, t0 in zip(
        x, total0)) < 1e-3 < sum(float(h.abs().sum()) for h in x_hat[0])


# -- the per-rank engine ----------------------------------------------------------

DIST_CASES = [CASES[1], CASES[3], CASES[4], CASES[7]]


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
        ex = gossip.make_dist_process_exchange(
            spec=spec, process=proc, compressor=comp, gamma=GAMMA,
            gossip_steps=case[4], group=group, packed=case[3])
        row = lambda obj: (obj[rank:rank + 1].clone()
                           if isinstance(obj, torch.Tensor)
                           else [row(o) for o in obj])
        x, x_hat, s = row(ins)
        before, calls[0], shipped = group.bytes_sent, 0, 0
        for call in range(CALLS):
            ex(x, x_hat, s, seed=call,
               draws=None if draws is None else (
                   lambda t, u, c=call: draws(c, t, u)[rank:rank + 1]),
               samples=lambda t, c=call: samples(c, t))
            shipped += ex.sent_rounds(ex.last_samples)
        results[tag(case)] = (x, x_hat, s, group.bytes_sent - before,
                              ex.payload_bytes, shipped, calls[0])
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_dist_stale_exchange_bit_equal_to_stacked(tmp_path, jax_runs):
    """4 gloo ranks (one torch thread) against the stacked exchange over
    CALLS calls, JAX's delays and draws injected: x, every x_hat slot and
    every s slot bit for bit; each rank's bytes its payload bytes times
    the rounds it ships in times the gossip rounds (every round ships, as
    under link failures), and one ``sendrecv`` per live round per unit."""
    from repro_torch.comm import packing
    from test_torch_dist import _spawn
    ranks = _spawn(_dist_rank, tmp_path, str(tmp_path), jax_runs)
    for case in DIST_CASES:
        proc, comp, spec, stacked, _, _ = run_stacked(case,
                                                      jax_runs[tag(case)])
        sizes = (packing.bucket_wire_nbytes(spec, comp) if case[3]
                 else packing.leaf_wire_nbytes(spec, comp))
        rounds = proc.schedule.rounds
        for r, got in enumerate(ranks):
            x, x_hat, s, sent, payload, shipped, calls = got[tag(case)]
            for a, b in zip([x] + x_hat + s,
                            [stacked[0]] + stacked[1] + stacked[2]):
                for aa, bb in zip(a, b):
                    assert bits_equal(aa, bb[r:r + 1]), (tag(case), r)
            assert payload == sizes
            per_call = case[4] * sum(rnd.peers(r)[0] is not None
                                     for rnd in rounds)
            assert shipped == CALLS * per_call
            assert sent == shipped * sum(sizes), (tag(case), r)
            assert calls == CALLS * case[4] * len(sizes) * sum(
                rnd.peers(r) != (None, None) for rnd in rounds), (tag(case), r)


# -- the trainer ------------------------------------------------------------------

class _ListRef:
    """A JAX reference npz seen through one element of each of its x_hat
    and s lists: ``x_hat:<path>`` reads ``x_hat:<index["x_hat"]>/<path>``,
    and so on."""

    def __init__(self, ref, index):
        self.ref, self.index = ref, index
        self.files = [self._plain(k) for k in ref.files]

    def _plain(self, key):
        tag_, _, rest = key.partition(":")
        if tag_ in self.index:
            if rest.startswith(f"{self.index[tag_]}/"):
                return f"{tag_}:{rest.split('/', 1)[1]}"
            return "other:" + key
        return key

    def __getitem__(self, key):
        tag_, _, rest = key.partition(":")
        if tag_ in self.index:
            return self.ref[f"{tag_}:{self.index[tag_]}/{rest}"]
        return self.ref[key]


@pytest.mark.slow
@pytest.mark.distributed
def test_trainer_matches_jax_trainer(jax_references):
    """3 steps of the port's stacked trainer (top_k 0.05, ring, f32 state,
    tau 2 with a straggler link, the smoke decoder in f32) against the JAX
    trainer under the same process, JAX's delays injected: the scalar
    gamma at the expected (delta, beta) and the effective omega equal to
    JAX's, the layout (1 + tau, R (1 + tau)), and ``check_against_jax``'s
    tolerances on x and on every element of the x_hat and s lists."""
    import types
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import make_lm_batch_fn
    from test_torch_slice import (BPN, PROCESS_TAU, SEQ, STEPS, _port_trainer,
                                  _tree, check_against_jax)
    ref = np.load(jax_references["trainer"].result())
    tr = _port_trainer("top_k", 0.05, 1, False, process="staleness")
    assert [tr.gamma] == list(ref["gamma"])
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0")))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    mets = []
    for j in range(STEPS):
        m = tr.step(state, tr.batch_to_device(batches()),
                    samples=lambda t, j=j: ref[f"sample:{j}:{t}"])
        mets.append([m["loss"], m["lr"], m["grad_norm"]])
    R = tr.process.schedule.n_rounds
    depth = 1 + PROCESS_TAU
    assert tr.ef_layout() == (depth, R * depth)
    assert len(state.x_hat) == depth and len(state.s) == R * depth
    for r in range(R * depth):
        h = min(r, depth - 1)
        shim = types.SimpleNamespace(x=state.x, x_hat=state.x_hat[h],
                                     s=state.s[r])
        check_against_jax(tr, shim, mets,
                          _ListRef(ref, {"x_hat": h, "s": r}), "top_k")


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

    out, tau, edges = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tr = DecentralizedTrainer(
        model=build_model(cfg),
        choco=ChocoConfig(compressor="top_k", comp_kwargs=(("fraction", 0.05),),
                          gossip_axis="data", kernel_backend="jnp",
                          topology_process="staleness", max_staleness=tau,
                          straggler_edges=edges),
        mesh=mesh, n_nodes=4, optimizer=make_optimizer("momentum"),
        lr_fn=constant_schedule(0.05))
    report = {"specs": {k: [list(s), d] for k, (s, d) in
                        tree_leaf_specs(tr.state_shape()).items()}}
    state, man, warm = tr.restore_checkpoint(os.path.join(out, "port"))
    report["warmup"] = warm
    np.savez(os.path.join(out, "jax-restored.npz"), **_flatten(state))
    state = tr.init_state(jax.random.PRNGKey(5))
    b = jax.tree.map(jnp.asarray, make_lm_batch_fn(cfg, 32, 2, 4, 1.0)())
    step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                jax.eval_shape(lambda: b))
    state, _ = step(state, b)
    tr.save_checkpoint(os.path.join(out, "jax"), state)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)
""")

CKPT_TAU, CKPT_EDGES = 2, "1-2"


def _ckpt_trainer(tau=CKPT_TAU, kind="staleness", edges=CKPT_EDGES):
    import dataclasses
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    stale = kind == "staleness"
    return DecentralizedTrainer(
        model=Model(cfg),
        choco=ChocoConfig(compressor="top_k", comp_kwargs=(("fraction", 0.05),),
                          topology_process=kind,
                          max_staleness=tau if stale else 1,
                          straggler_edges=edges if stale else None),
        n_nodes=N, optimizer=make_optimizer("momentum"),
        lr_fn=lambda step: 0.05, device="cpu")


def _train_and_save(tr, path, steps=2, seed=3):
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
    """Under staleness (tau 2, a straggler link): the port's
    ``state_leaf_specs`` are JAX's ``tree_leaf_specs(state_shape())``, the
    ring lists under JAX's flat keys (``x_hat__0..2``, ``s__0..5``); a
    port checkpoint restores in JAX as a resume (0 warmup rounds) to the
    same leaves, bit for bit; a JAX checkpoint restores in the port as a
    resume and saves back to JAX's stored leaves, bit for bit; and the
    fingerprint records tau and the straggler strings."""
    from test_torch_checkpoint import _stored
    _train_and_save(_ckpt_trainer(), tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_CKPT, str(tmp_path),
                        str(CKPT_TAU), CKPT_EDGES],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(tmp_path / "report.json") as f:
        report = json.load(f)
    tr = _ckpt_trainer()
    specs = {k: [list(s), d] for k, (s, d) in tr.state_leaf_specs().items()}
    assert specs == report["specs"]
    assert {k.split("__")[0] + "__" + k.split("__")[1] for k in specs
            if k.startswith(("x_hat__", "s__"))} == (
        {f"x_hat__{i}" for i in range(3)} | {f"s__{i}" for i in range(6)})
    assert report["warmup"] == 0
    man, port = _stored(tmp_path / "port")
    fp = man.fingerprint
    assert (fp["topology_process"], fp["max_staleness"],
            fp["straggler_edges"], fp["straggler_delay_probs"]) == (
        "staleness", CKPT_TAU, CKPT_EDGES, None)
    restored = np.load(tmp_path / "jax-restored.npz")
    assert sorted(restored.files) == sorted(port)
    for key, arr in port.items():
        np.testing.assert_array_equal(restored[key], arr, err_msg=key)
    state, _, warm = tr.restore_checkpoint(str(tmp_path / "jax"))
    assert warm == 0
    tr.save_checkpoint(str(tmp_path / "again"), state)
    _, want = _stored(tmp_path / "jax")
    _, got = _stored(tmp_path / "again")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_restore_across_a_change_of_tau_takes_the_remix_path(tmp_path):
    """A tau-2 checkpoint resumes exactly in a tau-2 trainer and restores
    into a tau-1 trainer through the re-mix path (as JAX ``:465-472``):
    params read back exactly, the re-shaped x_hat and s lists zero, the
    warmup rounds of the expected eigengap; a warmup round runs the stale
    engine and training goes on."""
    from repro_torch.checkpoint.elastic import consensus_warmup_rounds
    from repro_torch.data.synthetic import make_lm_batch_fn
    saved = _train_and_save(_ckpt_trainer(), tmp_path / "tau2", 1)
    state, _, warm = _ckpt_trainer().restore_checkpoint(str(tmp_path / "tau2"))
    assert warm == 0
    for bufs, want in zip(state.x_hat + state.s, saved.x_hat + saved.s):
        assert all(torch.equal(a, b) for a, b in zip(bufs, want))
    tr = _ckpt_trainer(tau=1)
    state, man, warm = tr.restore_checkpoint(str(tmp_path / "tau2"))
    assert warm == consensus_warmup_rounds(
        tr.process.expected_delta_beta()[0]) > 0
    for a, b in zip(state.x, saved.x):
        assert torch.equal(a, b)
    assert (len(state.x_hat), len(state.s)) == tr.ef_layout() == (2, 4)
    for bufs in state.x_hat + state.s:
        assert all(float(b.abs().sum()) == 0.0 for b in bufs)
    tr.consensus_warmup(state, 1)
    assert sum(float(b.abs().sum()) for b in state.x_hat[0]) > 0
    batches = make_lm_batch_fn(tr.model.cfg, 32, 2, N, 1.0)
    m = tr.step(state, tr.batch_to_device(batches()))
    assert np.isfinite(m["loss"])


# -- the launcher and the trainer's refusals ------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--seq-len", "32",
          "--batch-per-node", "2", "--device", "cpu", "--topology-process",
          "staleness", "--max-staleness", "2", "--straggler-edges", "0-1"]


def test_launcher_trains_under_staleness_stacked_and_per_rank(tmp_path,
                                                              capfd):
    """The smoke run under ``--topology-process staleness --max-staleness 2
    --straggler-edges 0-1`` on 4 nodes, stacked (``--mesh 4x1``) and with
    ``--simulate-devices 4`` and no ``--mesh`` (one node per rank: the
    per-rank stale exchange): finite losses,
    the header's process line, rank 0's wire bytes its payload bytes
    times its 2 rounds a step, and the two runs' checkpoints bit-equal."""
    from repro_torch.comm import packing
    from repro_torch.launch import train as launcher
    from test_torch_checkpoint import _stored
    for name, extra in (("stacked", ["--mesh", "4x1"]),
                        ("ranks", ["--simulate-devices", "4"])):
        assert launcher.main(_SMOKE + extra + [
            "--checkpoint-dir", str(tmp_path / name),
            "--checkpoint-every", "2"]) == 0
        out = capfd.readouterr().out
        assert " process=staleness max_staleness=2 " in out
        assert "straggler_edges=0-1 " in out and "expected_delta=" in out
        losses = [float(line.split("loss ")[1].split()[0])
                  for line in out.splitlines()
                  if line.startswith("[train] step")]
        assert len(losses) == 2 and all(np.isfinite(losses))
        if name == "ranks":
            per_step = 2 * sum(packing.bucket_wire_nbytes(
                _ckpt_trainer().spec, make_compressor("top_k", fraction=0.01)))
            assert f" wire {per_step} B sent by rank 0" in out
    _, want = _stored(tmp_path / "stacked" / "step2")
    _, got = _stored(tmp_path / "ranks" / "step2")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("extra,message", [
    (["--mode", "plain"], "staleness requires --mode choco"),
    (["--topology-process", "linkfail"], "--max-staleness only applies"),
    (["--max-staleness", "-1"], "--max-staleness must be >= 0"),
    (["--straggler-delay-probs", "0.5,0.5"], "needs max_staleness + 1 = 3"),
    (["--straggler-edges", "0-0"], "is a self-edge"),
    (["--straggler-delay-probs", "x"], "must be a comma-separated"),
    (["--topology", "ring,star", "--gossip-steps", "2"], "is ambiguous"),
    (["--pipeline-gossip"], "deterministic delay-1"),
], ids=["plain", "linkfail", "negative-tau", "arity", "self-edge",
        "bad-probs", "sequence", "pipelined"])
def test_launcher_refuses_what_jax_refuses(extra, message, capsys):
    """The JAX launcher's staleness rules, before torch is imported (a
    later flag overrides the smoke list's)."""
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit):
        launcher.main(_SMOKE + extra)
    assert message in capsys.readouterr().err


def test_launcher_refuses_straggler_flags_without_staleness(capsys):
    from repro_torch.launch import train as launcher
    base = _SMOKE[:_SMOKE.index("--topology-process")]
    for extra, message in (
            (["--straggler-edges", "0-1"],
             "requires --topology-process staleness"),
            (["--straggler-delay-probs", "0,1"], "requires --straggler-edges"),
            (["--max-staleness", "1"], "--max-staleness only applies")):
        with pytest.raises(SystemExit):
            launcher.main(base + extra)
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
            ({"straggler_edges": "0-1"}, "choco",
             "got no topology process"),
            ({"topology_process": "linkfail", "straggler_edges": "0-1"},
             "choco", "require topology_process='staleness'"),
            ({"topology_process": "staleness",
              "straggler_delay_probs": "0,1"}, "choco",
             "given without straggler_edges"),
            ({"topology_process": "staleness", "straggler_edges": "0-1",
              "straggler_delay_probs": "0.2,0.3,0.5"}, "choco",
             "needs max_staleness \\+ 1 = 2"),
            ({"topology_process": "staleness", "straggler_edges": "0-2"},
             "choco", "unknown straggler edge 0-2"),
            ({"topology_process": "staleness", "pipeline_gossip": True},
             "choco", "delay-1")):
        with pytest.raises(ValueError, match=msg):
            make(mode, **kw)
    spec = make_bucket_spec([torch.empty(s, device="meta") for s in SHAPES])
    with pytest.raises(ValueError, match="compressed choco engine only"):
        gossip.make_plain_exchange(spec=spec, process=make_process(CASES[0]))
    tr = make(topology_process="staleness", max_staleness=0)
    assert tr.ef_layout() == (1, 2)
    assert tr.fingerprint()["max_staleness"] == 0
    static = make()
    assert static.fingerprint()["max_staleness"] == 0
    assert make(topology_process="linkfail").effective_staleness() == 0
