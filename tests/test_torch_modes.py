"""The exact exchange modes of the port, held against the JAX package on
the CPU: ``--mode plain`` (exact D-SGD) and ``--mode allreduce`` (the
centralized baseline), in the stacked and the per-rank engine, the
trainer and the launcher.

One subprocess per pytest run (shared across xdist workers under a file
lock, as ``test_torch_slice.py``'s references are) runs every JAX case of
this file on 4 host devices (``AxisType.Auto``, ``kernel_backend="jnp"``,
the smoke qwen3 decoder in f32): 3 trainer steps each of plain on the
ring, plain on star with 2 gossip rounds (per-node weights, partial
rounds) and allreduce, and the exchanges alone
(``make_gossip_exchange(mode="plain" | "allreduce")``) on seeded leaves.
``test_torch_optim_data.py`` runs its cases the same way.

Tolerances:

* the plain exchange alone: bit-equal to ``make_plain_schedule_fn``
  (the same products and sums, each rounded to f32);
* the all-reduce exchange alone: within 1e-6 absolute of
  ``make_allreduce_fn``'s ``pmean`` (its all-reduce may add the nodes in
  another order than the port's node order 0, 1, 2, 3; the division by
  n is exact for n = 4);
* the trainer: ``test_torch_slice.py``'s (losses 1e-6 relative, lr
  equal, gradient norm 1e-5 relative, x 1e-6 absolute); the JAX state's
  x_hat and s stay zero in the exact modes, the port's are not allocated;
* the per-rank engine on gloo against the stacked one: plain bit-equal,
  allreduce within 1e-6 absolute (gloo's ring adds the ranks' chunks in
  its own order); each rank's bytes sent equal to its sends x 4 bytes x
  the padded bucket elements (plain), or 2 (n - 1) / n of the buckets'
  bytes (the ring all-reduce).
"""
import dataclasses
import fcntl
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.comm import gossip, schedule
from repro_torch.comm.packing import make_bucket_spec, pack_leaves
from repro_torch.configs.base import ChocoConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import topology
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.launch import mesh
from repro_torch.models.transformer import Model
from repro_torch.optim.sgd import cosine_schedule, make_optimizer
from repro_torch.train.trainer import DecentralizedTrainer
from test_torch_dist import THREADS, _join, _spawn
from test_torch_slice import (BPN, N, ROOT, SEQ, STEPS, _tree,
                              check_against_jax)
from test_torch_slice import one_thread  # noqa: F401  (autouse)

_JAX_CASES = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.comm.gossip import _resolve_bucket_gammas, make_gossip_exchange
    from repro.comm.schedule import compile_schedules
    from repro.configs.base import ChocoConfig, get_config, parse_topology
    from repro.core.topology import make_topology
    from repro.data.synthetic import make_lm_batch_fn
    from repro.models import build_model
    from repro.optim import cosine_schedule, make_optimizer
    from repro.train.trainer import DecentralizedTrainer

    cases, out_dir = json.loads(sys.argv[1]), sys.argv[2]
    steps, seq, bpn = (int(a) for a in sys.argv[3:6])
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def save(res, tag, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[tag + ":" + "/".join(k.key for k in path)] = np.asarray(leaf)

    def trainer_case(c):
        comp, arg = c["comp"], c["arg"]
        if comp == "qsgd":
            kw = (("s", int(arg)),)
        elif comp in ("sign", "identity"):
            kw = ()
        else:
            kw = (("fraction", float(arg)),)
        tr = DecentralizedTrainer(
            model=build_model(cfg),
            choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                              gossip_axis="data", topology=c["topology"],
                              gossip_steps=c["k"], kernel_backend="jnp",
                              data_skew_alpha=c["skew"]),
            mesh=mesh, n_nodes=4, optimizer=make_optimizer(c["optimizer"]),
            lr_fn=cosine_schedule(c["lr"], warmup=steps // 10 + 1,
                                  total=steps),
            mode=c["mode"])
        gammas = [tr.gamma]
        if tr.gamma_spec is not None:
            gammas += _resolve_bucket_gammas(tr.gamma_spec, tr._bucket_spec(),
                                             tr.compressor)
        res = {"gamma": np.array(gammas)}
        key = jax.random.PRNGKey(0)
        state = tr.init_state(key)
        save(res, "x0", state.params)
        batches = make_lm_batch_fn(cfg, seq, bpn, 4, 1.0,
                                   skew_alpha=c["skew"])
        res["skew_tv"] = np.array(batches.skew_tv)
        b0 = jax.tree.map(jnp.asarray, batches())
        step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                    jax.eval_shape(lambda: b0))
        mets = []
        for i in range(steps):
            batch = b0 if i == 0 else jax.tree.map(jnp.asarray, batches())
            state, m = step(state, batch)
            mets.append([float(m["loss"]), float(m["lr"]),
                         float(m["grad_norm"])])
        res["metrics"] = np.array(mets)
        save(res, "x", state.params)
        save(res, "x_hat", state.x_hat)
        save(res, "s", state.s)
        if comp == "qsgd" and c["mode"] == "choco":
            # the engine's dither, as test_torch_slice.py draws it
            fold = jax.random.fold_in
            for j in range(steps):
                for t in range(c["k"]):
                    for b in tr._bucket_spec().buckets:
                        rows = []
                        for i in range(4):
                            rk = fold(fold(key, j), i)
                            rk = rk if t == 0 else fold(rk, t)
                            rows.append(np.asarray(jax.random.uniform(
                                fold(rk, b.index), (b.size,))))
                        res[f"xi:{j}:{t}:{b.index}"] = np.stack(rows)
        return res

    def exchange_case(c):
        rng = np.random.default_rng(c["seed"])
        leaves = {f"l{i}": rng.standard_normal((4,) + tuple(s))
                  .astype(np.float32) for i, s in enumerate(c["shapes"])}
        specs = {k: P("data", *([None] * (v.ndim - 1)))
                 for k, v in leaves.items()}
        scheds = compile_schedules(tuple(
            make_topology(name, 4) for name in parse_topology(c["topology"])))
        ex = make_gossip_exchange(mode=c["mode"], mesh=mesh,
                                  state_specs=specs, axis="data",
                                  schedules=scheds, gossip_steps=c["k"],
                                  kernel_backend="jnp")
        x = jax.tree.map(jnp.asarray, leaves)
        out = jax.jit(ex)(jax.random.PRNGKey(0), x, x, x)[0]
        return {**{"in:" + k: v for k, v in leaves.items()},
                **{"out:" + k: np.asarray(v) for k, v in out.items()}}

    for c in cases:
        run = trainer_case if c["kind"] == "trainer" else exchange_case
        np.savez(os.path.join(out_dir, c["tag"] + ".npz"), **run(c))
""")


def trainer_case(tag, mode, comp="top_k", arg=0.05, k=1, topology="ring",
                 optimizer="momentum", lr=0.1, skew=None):
    """One JAX trainer case of a file's reference run."""
    return dict(kind="trainer", tag=tag, mode=mode, comp=comp, arg=arg, k=k,
                topology=topology, optimizer=optimizer, lr=lr, skew=skew)


def jax_cases(tmp_path_factory, name, cases):
    """``tag -> path`` of the npz files of the JAX reference run of
    ``cases``, made once per pytest run in one subprocess: tests that need it share it, across
    xdist workers too (they take turns under a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "jax_reference"
    root.mkdir(exist_ok=True)
    out = root / f"jax_cases_{name}"
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            part = root / f"jax_cases_{name}.part"
            part.mkdir(exist_ok=True)
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                       JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            r = subprocess.run(
                [sys.executable, "-c", _JAX_CASES, json.dumps(cases),
                 str(part), str(STEPS), str(SEQ), str(BPN)],
                env=env, capture_output=True, text=True, timeout=900)
            assert r.returncode == 0, \
                f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
            os.replace(part, out)
    return {c["tag"]: str(out / (c["tag"] + ".npz")) for c in cases}


def port_trainer(case, group=None):
    """The port's trainer for a ``trainer_case``, on the CPU."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    comp, arg = case["comp"], case["arg"]
    if comp == "qsgd":
        kw = (("s", arg),)
    elif comp in ("sign", "identity"):
        kw = ()
    else:
        kw = (("fraction", arg),)
    return DecentralizedTrainer(
        model=Model(cfg),
        choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                          topology=case["topology"], gossip_steps=case["k"],
                          data_skew_alpha=case["skew"]),
        n_nodes=N, optimizer=make_optimizer(case["optimizer"]),
        lr_fn=cosine_schedule(case["lr"], warmup=STEPS // 10 + 1,
                              total=STEPS),
        device="cpu", group=group, mode=case["mode"])


def run_port_case(case, ref, optimizer=None, node=None, group=None):
    """STEPS steps of ``case`` in the port from the JAX run's initial
    parameters and batches (QSGD's dither injected): (trainer, state,
    metrics).  ``optimizer`` replaces the case's; ``node`` and ``group``
    run one rank of the per-rank engine."""
    tr = port_trainer(case, group)
    if optimizer is not None:
        tr.optimizer = optimizer
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0"), node=node))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0,
                               skew_alpha=tr.choco.data_skew_alpha,
                               node=node)
    rows = slice(None) if node is None else slice(node, node + 1)
    mets = []
    for j in range(STEPS):
        draws = None
        if case["comp"] == "qsgd" and case["mode"] == "choco":
            draws = (lambda t, b, j=j:
                     torch.from_numpy(ref[f"xi:{j}:{t}:{b}"][rows]))
        m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
        mets.append([m["loss"], m["lr"], m["grad_norm"],
                     m.get("wire_bytes", 0), m.get("wire_bytes_modelled", 0)])
    return tr, state, mets


def check_exact_mode(tr, state, mets, ref):
    """An exact mode's metrics and x against the JAX trainer's (this
    module's tolerances); the JAX x_hat and s stayed zero and the port's
    were never allocated."""
    assert state.x_hat is None and state.s is None
    for key in ref.files:
        if key.startswith(("x_hat:", "s:")):
            assert not ref[key].any(), key
    check_against_jax(tr, state, [m[:3] for m in mets], ref, "exact")


MODE_CASES = [trainer_case("plain_ring", "plain"),
              trainer_case("plain_star_2", "plain", k=2, topology="star"),
              trainer_case("allreduce", "allreduce")]
#: per-node leaf shapes of the exchanges alone: buckets of several leaves,
#: a leaf bigger than a bucket, ragged sizes
LEAF_SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000))
EXCHANGE_CASES = [
    dict(kind="exchange", tag="ex_plain_ring", mode="plain", topology="ring",
         k=1, seed=5, shapes=LEAF_SHAPES),
    dict(kind="exchange", tag="ex_plain_star_2", mode="plain",
         topology="star", k=2, seed=6, shapes=LEAF_SHAPES),
    dict(kind="exchange", tag="ex_plain_ring+star_2", mode="plain",
         topology="ring,star", k=2, seed=7, shapes=LEAF_SHAPES),
    dict(kind="exchange", tag="ex_allreduce", mode="allreduce",
         topology="ring", k=1, seed=8, shapes=LEAF_SHAPES)]


@pytest.fixture(scope="module")
def ref_paths(tmp_path_factory):
    return jax_cases(tmp_path_factory, "modes", MODE_CASES + EXCHANGE_CASES)


@pytest.fixture(scope="module")
def refs(ref_paths):
    return {tag: np.load(path) for tag, path in ref_paths.items()}


def _spec():
    return make_bucket_spec(
        [torch.empty(s, device="meta") for s in LEAF_SHAPES],
        max_bucket_elems=8192)


def _exchange_inputs(ref, spec):
    return pack_leaves(spec, [torch.from_numpy(ref[f"in:l{i}"])
                              for i in range(len(LEAF_SHAPES))])


def _make_exchange(case, spec, group=None):
    if case["mode"] == "allreduce":
        if group is None:
            return gossip.make_allreduce_exchange(spec=spec, n=N)
        return gossip.make_dist_allreduce_exchange(spec=spec, n=N,
                                                   group=group)
    scheds = schedule.compile_schedules(tuple(
        topology.make_topology(name, N)
        for name in case["topology"].split(",")))
    kw = dict(spec=spec, schedules=scheds, gossip_steps=case["k"])
    if group is None:
        return gossip.make_plain_exchange(**kw)
    return gossip.make_dist_plain_exchange(**kw, group=group)


# -- the exchanges alone --------------------------------------------------------

@pytest.mark.parametrize("case", EXCHANGE_CASES, ids=lambda c: c["tag"])
def test_exact_exchange_matches_jax(refs, case):
    ref = refs[case["tag"]]
    spec = _spec()
    x = _exchange_inputs(ref, spec)
    before = [b.clone() for b in x]
    _make_exchange(case, spec)(x, None, None)
    want = _exchange_inputs({f"in:l{i}": ref[f"out:l{i}"]
                             for i in range(len(LEAF_SHAPES))}, spec)
    for got, w, b0 in zip(x, want, before):
        if case["mode"] == "plain":
            assert torch.equal(got, w)
        else:
            assert float((got - w).abs().max()) <= 1e-6
        assert not torch.equal(got, b0)           # the exchange mixed


def test_allreduce_exchange_sums_in_node_order():
    spec = _spec()
    rng = np.random.default_rng(11)
    x = [torch.from_numpy(rng.standard_normal((N, b.size)).astype(np.float32))
         for b in spec.buckets]
    want = [((b[0] + b[1] + b[2] + b[3]) / N).expand_as(b).clone() for b in x]
    gossip.make_allreduce_exchange(spec=spec, n=N)(x)
    for got, w in zip(x, want):
        assert torch.equal(got, w)


# -- the trainer ------------------------------------------------------------------

@pytest.mark.parametrize("case", MODE_CASES, ids=lambda c: c["tag"])
def test_exact_mode_matches_jax_trainer(refs, case):
    ref = refs[case["tag"]]
    tr, state, mets = run_port_case(case, ref)
    assert tr.compressor is None and tr.gamma == 1.0 == ref["gamma"][0]
    assert tr.spec.align == 128
    check_exact_mode(tr, state, mets, ref)


def test_trainer_refuses_pushsum():
    with pytest.raises(ValueError, match="push-sum is not ported"):
        port_trainer(trainer_case("x", "pushsum"))


# -- the per-rank engine on gloo ------------------------------------------------

def _modes_rank(rank, store, out_dir, paths):
    group = _join(rank, store)
    refs = {tag: np.load(p) for tag, p in paths.items()}
    out = {}
    for case in EXCHANGE_CASES:
        spec = _spec()
        ex = _make_exchange(case, spec, group)
        x = [b[rank:rank + 1].clone()
             for b in _exchange_inputs(refs[case["tag"]], spec)]
        before = (group.bytes_sent, group.bytes_modelled)
        ex(x, None, None)
        out[case["tag"]] = (x, (group.bytes_sent - before[0],
                                group.bytes_modelled - before[1]),
                            getattr(ex, "sends", None), ex.payload_bytes)
    for case in MODE_CASES:
        _, state, mets = run_port_case(case, refs[case["tag"]], node=rank,
                                       group=group)
        out[case["tag"]] = (state.x, mets)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


#: sends per gossip round of each node (0..3)
SENDS_PER_ROUND = {"ring": (2, 2, 2, 2), "star": (3, 1, 1, 1)}


def _wire_bytes(case, rank, nbytes):
    """(counted, modelled) bytes of node ``rank`` per exchange call of
    ``case``, with ``nbytes`` bytes in its buckets: plain sends them once
    per send of each gossip round, counted; allreduce sends nothing
    through ``sendrecv``, and its ring model says 2 (n - 1) / n of them."""
    if case["mode"] == "allreduce":
        return 0, 2 * (N - 1) * nbytes // N
    per_round = [SENDS_PER_ROUND[t][rank]
                 for t in case["topology"].split(",")]
    return nbytes * sum(per_round[t % len(per_round)]
                        for t in range(case["k"])), 0


def test_dist_exact_modes_match_stacked(refs, ref_paths, tmp_path):
    """4 gloo ranks: the exchanges alone against the stacked ones on the
    same inputs, and 3 trainer steps of each mode against the stacked
    trainer (x 1e-6) and the JAX trainer; bytes sent per rank by the
    formula."""
    ranks = _spawn(_modes_rank, tmp_path, str(tmp_path), ref_paths)
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for case in EXCHANGE_CASES:
            spec = _spec()
            x = _exchange_inputs(refs[case["tag"]], spec)
            _make_exchange(case, spec)(x, None, None)
            nbytes = [4 * b.size for b in spec.buckets]
            for r, rank in enumerate(ranks):
                got, sent, sends, payload = rank[case["tag"]]
                assert payload == nbytes
                for g, w in zip(got, x):
                    if case["mode"] == "plain":
                        assert torch.equal(g[0], w[r]), (case["tag"], r)
                    else:
                        assert float((g[0] - w[r]).abs().max()) <= 1e-6
                assert sent == _wire_bytes(case, r, sum(nbytes))
                if case["mode"] == "plain":
                    assert sent[0] == sends * sum(nbytes)
        for case in MODE_CASES:
            ref = refs[case["tag"]]
            tr, stacked, mets = run_port_case(case, ref)
            x = [torch.cat([r[case["tag"]][0][b] for r in ranks])
                 for b in range(tr.spec.n_buckets)]
            got = ranks[0][case["tag"]][1]
            nbytes = sum(4 * b.size for b in tr.spec.buckets)
            for r, rank in enumerate(ranks):
                # the all-reduced metrics agree; the wire bytes are the rank's
                assert [m[:3] for m in rank[case["tag"]][1]] == \
                    [m[:3] for m in got]
                assert all(tuple(m[3:]) == _wire_bytes(case, r, nbytes)
                           for m in rank[case["tag"]][1])
            np.testing.assert_allclose([m[0] for m in got],
                                       [m[0] for m in mets], rtol=1e-6)
            for a, b in zip(x, stacked.x):
                assert float((a - b).abs().max()) <= 1e-6
            check_against_jax(tr, types.SimpleNamespace(x=x, x_hat=None,
                                                        s=None),
                              [m[:3] for m in got], ref, "exact")
    finally:
        torch.set_num_threads(threads)


# -- the launcher -----------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1", "--steps", "2",
          "--seq-len", "32", "--batch-per-node", "2", "--device", "cpu"]


@pytest.mark.parametrize("extra,header", [
    (["--mode", "plain", "--optimizer", "adamw", "--data-skew-alpha", "0.5"],
     "mode=plain optimizer=adamw topology=ring"),
    (["--mode", "plain", "--topology", "star", "--gossip-steps", "2",
      "--optimizer", "sgd"], "mode=plain optimizer=sgd topology=star"),
    (["--mode", "allreduce", "--optimizer", "sgd"],
     "mode=allreduce optimizer=sgd"),
    (["--optimizer", "adamw", "--compressor", "qsgd", "--qsgd-s", "16"],
     "mode=choco optimizer=adamw"),
    (["--optimizer", "sgd", "--data-skew-alpha", "0.1"],
     "mode=choco optimizer=sgd"),
])
def test_launcher_runs_the_new_flags_on_cpu(extra, header, capsys):
    from repro_torch.launch import train as launcher
    assert launcher.main(_SMOKE + extra) == 0
    out = capsys.readouterr().out
    assert header in out
    exact = "choco" not in header
    assert ("compressor=none " in out) == exact
    assert ("gamma=1.000e+00" in out) == exact
    assert ("skew_tv=" in out) == ("--data-skew-alpha" in extra)
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    launches = json.loads(out.split("[train] kernel launches ")[1]
                          .splitlines()[0])
    assert not any(launches.values())           # the CPU launches no kernel


def test_launcher_skew_tv_is_the_streams():
    """The header's skew_tv is the Dirichlet token stream's mean TV
    distance, which grows as alpha falls."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    tv = [make_lm_batch_fn(cfg, 8, 1, N, 1.0, skew_alpha=a).skew_tv
          for a in (10.0, 0.5, 0.1)]
    assert 0 < tv[0] < tv[1] < tv[2] < 1


@pytest.mark.parametrize("extra,message", [
    (["--mode", "pushsum"], "--mode pushsum is not ported"),
    (["--data-skew-alpha", "0"], "--data-skew-alpha must be > 0"),
    (["--data-skew-alpha", "-1"], "--data-skew-alpha must be > 0"),
    (["--gossip-engine", "per-leaf"], "--gossip-engine"),
    (["--optimizer", "lamb"], "--optimizer 'lamb'"),
    (["--mode", "plain", "--pipeline-gossip"], "--pipeline-gossip"),
])
def test_launcher_refuses_before_importing_torch(extra, message):
    code = ("import sys; from repro_torch.launch.train import main\n"
            "try:\n"
            f"    main({_SMOKE + extra!r})\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
    assert message in r.stderr
