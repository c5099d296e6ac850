"""The pipelined gossip engine (``--pipeline-gossip``,
``ChocoConfig(pipeline_gossip=True)``) in the port, held against the JAX
package's ``comm/pipelined.py`` on the CPU.

* the exchange, packed and per-leaf, against ``make_gossip_exchange(
  pipelined=True)`` (``test_torch_per_leaf.py``'s JAX run of its cases and
  its tolerances: x_hat bit for bit where its payload's values are; x and s
  bit for bit with bf16 state, within 1e-6 absolute plus 1e-6 relative
  with f32 state), and per rank against stacked bit for bit;
* the EF update's plain version in the pipelined order against the
  jitted ``_pipelined_leaf_updates``: x_hat bit for bit; x and s bit for
  bit with bf16 state and within 1e-6 with f32 state (XLA contracts the
  f32 multiply-adds into FMAs; the f32 kernel does not, as the serial
  one);
* the matrix simulator against ``run_choco_pipelined_gossip`` (JAX's
  draws injected) and the tau = 1 surrogate's (delta, beta, omega)
  against ``pipeline_delay_process`` exactly, on every symmetric graph;
* the two-phase trainer step against the JAX trainer's
  ``pipelined_step`` (``test_torch_slice.py``'s reference run with an
  engine tag, its tolerances), the per-rank trainer against the stacked
  one (losses 1e-6 relative, x 1e-6), the optimizers' ``keep_params``
  half-step bit-equal to the in-place one, and the trainer's and the
  launcher's refusals;
* checkpoints: a per-leaf pipelined checkpoint of each package restores
  in the other exactly, and a restore into another engine routes as the
  JAX restore does (x_hat and s zeroed, the same warmup rounds).
"""
import dataclasses
import os
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.comm import gossip, schedule
from repro_torch.comm.pipelined import pipeline_delay_process
from repro_torch.core import choco_gossip, compression, topology
from repro_torch.kernels import ref
from repro_torch.launch import mesh
from repro_torch.optim.sgd import make_optimizer
from test_torch_dist import N, _join, _spawn
from test_torch_per_leaf import (CASES, check_dist_against_stacked,
                                 check_state, jax_exchanges, leaf_draws,
                                 run_against_jax_trainer, setup_case,
                                 stacked_run, tag)
from test_torch_slice import one_thread, tmp_path  # noqa: F401  (fixtures)

BF16 = torch.bfloat16
PIPE_CASES = [c for c in CASES if c[6]]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_exchanges(tmp_path_factory, PIPE_CASES,
                         "jax_pipelined_exchanges")


@pytest.mark.parametrize("case", PIPE_CASES, ids=[tag(c) for c in PIPE_CASES])
def test_stacked_pipelined_exchange_matches_jax_engine(case, jax_runs):
    comp, spec, stacked = stacked_run(case, jax_runs[tag(case)])
    want = setup_case(case, jax_runs[tag(case)])[4]
    check_state(case, comp, spec, stacked, want, tag(case))


def test_dist_pipelined_exchange_matches_stacked(tmp_path, jax_runs):
    check_dist_against_stacked(tmp_path, jax_runs, PIPE_CASES)


def test_pipelined_order_differs_from_the_serial_one(jax_runs):
    """The same case through the serial engine moves x elsewhere: the
    pipelined x reads the pre-round pair."""
    case = PIPE_CASES[0]
    _, _, (x_pipe, _, _) = stacked_run(case, jax_runs[tag(case)])
    serial = case[:6] + (False,) + case[7:]
    comp, spec, scheds, bufs, _, draws, _ = setup_case(case,
                                                       jax_runs[tag(case)])
    x, x_hat, s = [[b.clone() for b in part] for part in bufs]
    gossip.make_choco_exchange(spec=spec, schedules=scheds, compressor=comp,
                               gamma=0.3, packed=serial[5])(
        x, x_hat, s, draws=draws)
    assert not all(torch.equal(a, b) for a, b in zip(x, x_pipe))


# -- the EF update's pipelined order ------------------------------------------

def _jnp(t):
    import jax.numpy as jnp
    if t.dtype == BF16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _torch(a):
    a = np.array(a)
    return (torch.from_numpy(a.view(np.int16)).view(BF16)
            if a.dtype.itemsize == 2 else torch.from_numpy(a))


@pytest.mark.parametrize("dtype,q_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_plain_pipelined_update_matches_jitted_leaf_update(dtype, q_dtype):
    """``_pipelined_leaf_updates`` jitted on one leaf (uniform weights,
    Python floats) against the plain version with ``pipelined=True``; the
    payloads f32 or bf16 as the engines decode them."""
    import jax
    from repro.comm.pipelined import _pipelined_leaf_updates
    rng = np.random.default_rng(3)
    L = 4096
    sdt, qdt = getattr(torch, dtype), getattr(torch, q_dtype)
    mk = lambda scale: torch.from_numpy(
        (scale * rng.standard_normal((N, L))).astype(np.float32))
    x, x_hat, s, q = mk(1.0), mk(0.5).to(sdt), mk(0.1).to(sdt), mk(0.3)
    q[:, :64] = 0
    q = q.to(qdt)
    nbr = q.roll(1, 0) + q.roll(-1, 0)
    ws = wn = 1.0 / 3.0
    gamma = 0.3
    fn = jax.jit(lambda lx, ls, lh, qd, nb: _pipelined_leaf_updates(
        [lx], [ls], [lh], [qd], [nb], ws, wn, [gamma]))
    (sn,), (xn,) = fn(*(_jnp(t) for t in (x, s, x_hat, q, nbr)))
    new_hat = jax.jit(lambda a, b: a + b.astype(a.dtype))(_jnp(x_hat), _jnp(q))
    # the weights as the exchange compiles them: bf16-valued for bf16
    # payloads on bf16 state, f32 otherwise
    w = torch.full((N,), ws)
    if sdt == BF16 and qdt == BF16:
        w = w.to(BF16).float()
    if sdt == BF16:
        got = ref.ef_update_bf16_ref(x, x_hat, s, q, nbr, w, w, gamma,
                                     mix_in_bf16=True, pipelined=True)
    else:
        got = ref.ef_update_ref(x, x_hat, s, q, nbr, w, w, gamma,
                                pipelined=True)
    bits = lambda t: t.view(torch.int16) if t.dtype == BF16 else t
    assert torch.equal(bits(got[1]), bits(_torch(new_hat)))
    if sdt == BF16:
        assert torch.equal(bits(got[2]), bits(_torch(sn)))
        assert torch.equal(got[0], _torch(xn))
    else:
        for a, b in ((got[2], sn), (got[0], xn)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


# -- the simulator and the surrogate ------------------------------------------

@pytest.mark.parametrize("name,kw,gamma", [
    ("identity", {}, 0.5), ("top_k", {"fraction": 0.25}, 0.2),
    ("qsgd", {"s": 16}, 0.3)])
def test_pipelined_simulator_matches_jax(name, kw, gamma):
    import jax
    import jax.numpy as jnp
    from repro.core import choco_gossip as jchoco
    from repro.core import compression as jcomp
    from repro.core import topology as jtopo
    from test_torch_sim import SMALL_D, SMALL_N, SMALL_STEPS, _round_draws
    x0 = jax.random.normal(jax.random.PRNGKey(4), (SMALL_N, SMALL_D))
    W = jtopo.ring(SMALL_N).W
    jc = jcomp.make_compressor(name, **kw)
    key = jax.random.PRNGKey(9)
    want, werr = jchoco.run_choco_pipelined_gossip(x0, jnp.asarray(W), gamma,
                                                   jc, SMALL_STEPS, key=key)
    got, err = choco_gossip.run_choco_pipelined_gossip(
        torch.from_numpy(np.array(x0)), W, gamma,
        compression.make_compressor(name, **kw), SMALL_STEPS,
        draws=_round_draws(jc, key, SMALL_STEPS, SMALL_N, SMALL_D))
    np.testing.assert_allclose(err.numpy(), np.asarray(werr), rtol=1e-5)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.parametrize("graph", ["ring", "torus", "fully_connected", "chain",
                                   "star", "hypercube"])
def test_surrogate_matches_jax_delay_process(graph):
    from repro.comm.pipelined import pipeline_delay_process
    from repro.comm.schedule import compile_schedule as jcompile
    from repro.core.topology import make_topology as jtopology
    n = 8
    proc = pipeline_delay_process(jcompile(jtopology(graph, n)))
    mine = pipeline_delay_process(
        schedule.compile_schedule(topology.make_topology(graph, n)))
    np.testing.assert_array_equal(mine.expected_matrix(),
                                  proc.expected_matrix())
    assert mine.expected_delta_beta() == proc.expected_delta_beta()
    assert mine.effective_omega(0.0123) == proc.effective_omega(0.0123)
    assert mine.effective_omega(1.0) == 0.5


# -- the trainer -----------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("comp,arg,k,sdt,engine", [
    pytest.param("top_k", 0.05, 1, "float32", "pipelined",
                 id="packed-top_k-0.05-1-float32"),
    pytest.param("qsgd", 16, 2, "bfloat16", "per-leaf-pipelined",
                 id="per-leaf-qsgd-16-2-bfloat16"),
])
def test_pipelined_trainer_matches_jax(tmp_path_factory, comp, arg, k, sdt,
                                       engine):
    """3 two-phase steps against the JAX trainer's ``pipelined_step``:
    gamma from the surrogate (per bucket on the packed engine) equal to
    JAX's, and ``check_against_jax``'s tolerances."""
    run_against_jax_trainer(tmp_path_factory, comp, arg, k, sdt, engine)


def _trainer_rank(rank, store, out_dir, ref_path):
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import make_lm_batch_fn
    from test_torch_slice import (BPN, SEQ, STEPS, _port_trainer, _tree,
                                  Reference)
    group = _join(rank, store)
    ref_ = Reference(ref_path)
    tr = dataclasses.replace(_port_trainer(
        "qsgd", 16, 2, False, state_dtype="bfloat16",
        engine="per-leaf-pipelined"), group=group)
    state = tr.state_from_params(params_from_jax(_tree(ref_, "x0"), node=rank))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0, node=rank)
    mets = []
    for j in range(STEPS):
        draws = leaf_draws(tr, ref_, j)
        m = tr.step(state, tr.batch_to_device(batches()),
                    draws=lambda t, u, d=draws: d(t, u)[rank:rank + 1])
        mets.append([m["loss"], m["lr"], m["grad_norm"], m["wire_bytes"]])
    torch.save({"mets": mets, "x": state.x, "x_hat": state.x_hat,
                "s": state.s, "sent": tr.exchange.payload_bytes},
               os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


@pytest.mark.slow
@pytest.mark.distributed
def test_dist_pipelined_trainer_matches_stacked_and_jax(tmp_path,
                                                        tmp_path_factory):
    """The per-leaf pipelined trainer on 4 gloo ranks (QSGD 16, 2 rounds,
    bf16 state): against the JAX trainer with ``check_against_jax``'s
    tolerances and against the stacked trainer (losses 1e-6 relative, x
    1e-6), each rank sending 2 rounds x 2 neighbours x its leaves'
    payload bytes per step."""
    from test_torch_slice import (_port_trainer, check_against_jax,
                                  jax_reference_path, Reference)
    ref_path = str(jax_reference_path(tmp_path_factory, "qsgd", 16, 2, False,
                                      state_dtype="bfloat16",
                                      engine="per-leaf-pipelined"))
    ranks = _spawn(_trainer_rank, tmp_path, str(tmp_path), ref_path)
    tr = _port_trainer("qsgd", 16, 2, False, state_dtype="bfloat16",
                       engine="per-leaf-pipelined")
    cat = lambda tg: [torch.cat([r[tg][b] for r in ranks])
                      for b in range(tr.spec.n_buckets)]
    state = types.SimpleNamespace(x=cat("x"), x_hat=cat("x_hat"), s=cat("s"))
    mets = ranks[0]["mets"]
    for r in ranks[1:]:
        assert r["mets"] == mets
    check_against_jax(tr, state, [m[:3] for m in mets],
                      Reference(ref_path), "qsgd", bf16_ulp=True)
    assert all(m[3] == 2 * 2 * sum(ranks[0]["sent"]) for m in mets)
    _, stacked = run_against_jax_trainer(tmp_path_factory, "qsgd", 16, 2,
                                         "bfloat16", "per-leaf-pipelined")
    for a, b in zip(state.x, stacked.x):
        assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_keep_params_half_step_equals_the_in_place_one(name):
    """``update(..., keep_params=True)`` leaves x and writes the same
    half-step, bit for bit, into the gradients' buffers."""
    rng = np.random.default_rng(1)
    mk = lambda: [torch.from_numpy(rng.standard_normal((4, 300))
                                   .astype(np.float32)) for _ in range(2)]
    x, g = mk(), mk()
    opt = make_optimizer(name)
    st = opt.init(x)
    st = opt.update(x, [t.clone() for t in g], st, 0.1)   # moments non-zero
    a, b = [t.clone() for t in x], [t.clone() for t in x]
    sa = opt.init(a)._replace(mu=st.mu and [m.clone() for m in st.mu],
                              nu=st.nu and [v.clone() for v in st.nu],
                              count=st.count)
    sb = opt.init(b)._replace(mu=st.mu and [m.clone() for m in st.mu],
                              nu=st.nu and [v.clone() for v in st.nu],
                              count=st.count)
    opt.update(a, [t.clone() for t in g], sa, 0.05)
    halves = [t.clone() for t in g]
    opt.update(b, halves, sb, 0.05, keep_params=True)
    for xa, xb, xk, h in zip(a, b, x, halves):
        assert torch.equal(xb, xk) and torch.equal(h, xa)


def test_trainer_refuses_what_the_pipelined_engine_does_not_run():
    from test_torch_slice import _port_trainer
    with pytest.raises(ValueError, match="one static schedule"):
        _port_trainer("top_k", 0.05, 2, False, topology="ring,star",
                      engine="pipelined")
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import cosine_schedule, momentum_sgd
    from repro_torch.train.trainer import DecentralizedTrainer
    with pytest.raises(ValueError, match="requires mode='choco'"):
        DecentralizedTrainer(model=Model(get_config("qwen3-1.7b", smoke=True)),
                             choco=ChocoConfig(pipeline_gossip=True),
                             n_nodes=N, optimizer=momentum_sgd(),
                             lr_fn=cosine_schedule(0.1, 1, 3), device="cpu",
                             mode="plain")


_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1", "--steps", "2",
          "--seq-len", "32", "--batch-per-node", "2", "--device", "cpu"]


@pytest.mark.parametrize("extra,message", [
    (["--pipeline-gossip", "--mode", "allreduce"], "requires --mode choco"),
    (["--pipeline-gossip", "--topology", "ring,star", "--gossip-steps", "2"],
     "--pipeline-gossip needs one static schedule"),
    (["--pipeline-gossip", "--topology-process", "matching"],
     "--topology-process"),
])
def test_launcher_refuses_what_jax_refuses(extra, message, capsys):
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit) as exc:
        launcher.main(_SMOKE + extra)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_trains_with_the_pipelined_engine_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    assert launcher.main(_SMOKE + ["--pipeline-gossip", "--compressor",
                                   "qsgd", "--qsgd-s", "16"]) == 0
    out = capsys.readouterr().out
    assert "gossip_engine=packed pipelined " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


# -- checkpoints across the engines and the packages ------------------------------

_JAX_ENGINE_CKPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ChocoConfig, get_config
    from repro.data.synthetic import make_lm_batch_fn
    from repro.models import build_model
    from repro.optim import cosine_schedule, make_optimizer
    from repro.train.trainer import DecentralizedTrainer

    port_ckpt, out, key = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def trainer(packed, pipelined):
        return DecentralizedTrainer(
            model=build_model(cfg),
            choco=ChocoConfig(compressor="qsgd", comp_kwargs=(("s", 16),),
                              gossip_axis="data", kernel_backend="jnp",
                              packed_gossip=packed,
                              pipeline_gossip=pipelined),
            mesh=mesh, n_nodes=4, optimizer=make_optimizer("momentum"),
            lr_fn=cosine_schedule(0.1, warmup=1, total=3))

    report = {}
    tr = trainer(False, True)
    state = tr.init_state(jnp.array(key, jnp.uint32))
    b0 = jax.tree.map(jnp.asarray,
                      make_lm_batch_fn(cfg, 32, 2, 4, 1.0)())
    step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                jax.eval_shape(lambda: b0))
    state, _ = step(state, b0)
    tr.save_checkpoint(os.path.join(out, "jax_ckpt"), state)
    for tag, packed, pipelined in (("per-leaf-pipelined", False, True),
                                   ("packed", True, False),
                                   ("per-leaf", False, False)):
        _, man, warmup = trainer(packed, pipelined).restore_checkpoint(
            port_ckpt)
        report[tag] = warmup
    report["fingerprint"] = tr.fingerprint()
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)
""")


@pytest.mark.slow
@pytest.mark.distributed
def test_engine_checkpoints_cross_restore_with_jax(tmp_path):
    """A per-leaf pipelined QSGD checkpoint of each package restores in
    the other exactly (warmup 0; re-saved, the port's restore of JAX's
    checkpoint is that checkpoint bit for bit), the manifest records
    ``packed_gossip`` False and ``pipeline_gossip`` True with the JAX
    trainer's fingerprint, and a restore into another engine (packed, or
    per-leaf serial) routes as the JAX restore does: x_hat and s zeroed
    and the same warmup rounds."""
    import json
    import subprocess
    import sys
    from repro_torch.checkpoint.manifest import read_manifest
    from repro_torch.train.trainer import seed_of_key
    from test_torch_checkpoint import KEY_WORDS, _assert_same_checkpoint
    from test_torch_slice import ROOT, _port_trainer
    engine_of = {"per-leaf-pipelined": "per-leaf-pipelined",
                 "packed": "packed", "per-leaf": "per-leaf"}
    tr = _port_trainer("qsgd", 16, 1, False, engine="per-leaf-pipelined")
    state = tr.init_state(seed=seed_of_key(KEY_WORDS))
    from repro_torch.data.synthetic import make_lm_batch_fn
    tr.step(state, tr.batch_to_device(
        make_lm_batch_fn(tr.model.cfg, 32, 2, N, 1.0)()))
    port_ckpt = str(tmp_path / "port_ckpt")
    tr.save_checkpoint(port_ckpt, state)
    fp = read_manifest(port_ckpt).fingerprint
    assert fp["packed_gossip"] is False and fp["pipeline_gossip"] is True
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_ENGINE_CKPT, port_ckpt,
                        str(tmp_path), json.dumps(list(KEY_WORDS))],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["fingerprint"] == fp
    jax_ckpt = str(tmp_path / "jax_ckpt")
    for tag, engine in engine_of.items():
        port = _port_trainer("qsgd", 16, 1, False, engine=engine)
        got, man, warmup = port.restore_checkpoint(jax_ckpt)
        assert warmup == report[tag], tag
        assert (warmup == 0) == (tag == "per-leaf-pipelined"), tag
        assert got.seed == seed_of_key(KEY_WORDS)
        if warmup:
            assert all(not b.any() for b in got.x_hat + got.s), tag
        else:
            port.save_checkpoint(str(tmp_path / "again"), got,
                                 metadata=man.metadata)
            _assert_same_checkpoint(jax_ckpt, str(tmp_path / "again"))
