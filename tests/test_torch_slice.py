"""The port's CHOCO-SGD trainer held against the JAX ``DecentralizedTrainer``,
plus the launcher's device and flag rules.

Slice parity: a subprocess runs 3 steps of the JAX trainer (4 host
devices, an ``AxisType.Auto`` mesh, ``kernel_backend="jnp"``, the smoke
qwen3 decoder in float32) and saves its initial parameters, losses and
final state.  The port's trainer starts from the same parameters
(``repro_torch.convert``), draws the same token batches and runs the same
3 steps on the CPU, with 1 gossip round per step and, for QSGD, also 2.
With QSGD the JAX package's per-round, per-bucket dither is injected.
Tolerances:

* losses: 1e-6 relative (matmul summation order);
* x: 1e-6 absolute;
* x_hat and s: 1e-6 + 1e-5 relative.  Under SignNorm a handful of
  elements may instead differ by one whole sign code: where the EF
  delta x - x_hat lies within float rounding of zero, the ulp-level
  gradient difference flips its sign.  At most 1 in 10^5 elements may do
  so.  A flip moves x_hat by two payload scales (the bucket's mean
  |x - x_hat|) and s by at most as much, so each such difference is
  bounded by 8x the largest mean |x| of an initial leaf.
"""
import dataclasses
import fcntl
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.comm.packing import unpack_leaves
from repro_torch.configs.base import ChocoConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import Model
from repro_torch.optim.sgd import cosine_schedule, momentum_sgd
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import DecentralizedTrainer

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N, STEPS, SEQ, BPN = 4, 3, 128, 4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread per test (the files that import this fixture use
    it too): the tensors are small, and pytest-xdist's workers share the
    cores, which thousands of small parallel regions in every worker
    would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


_JAX_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ChocoConfig, get_config
    from repro.data.synthetic import make_lm_batch_fn
    from repro.models import build_model
    from repro.optim import cosine_schedule, make_optimizer
    from repro.train.trainer import DecentralizedTrainer

    comp, arg, k, exact, steps, seq, bpn, out, topology = sys.argv[1:]
    k, steps, seq, bpn = int(k), int(steps), int(seq), int(bpn)
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    if comp == "qsgd":
        kw = (("s", int(arg)),)
    elif comp in ("sign", "identity"):
        kw = ()
    else:
        kw = (("fraction", float(arg)),)
    tr = DecentralizedTrainer(
        model=build_model(cfg),
        choco=ChocoConfig(compressor=comp, comp_kwargs=kw, gossip_axis="data",
                          topology=topology, gossip_steps=k,
                          kernel_backend="jnp",
                          exact_small_leaves=exact == "exact"),
        mesh=mesh, n_nodes=4, optimizer=make_optimizer("momentum"),
        lr_fn=cosine_schedule(0.1, warmup=steps // 10 + 1, total=steps),
        mode="choco")
    from repro.comm.gossip import _resolve_bucket_gammas
    res = {"gamma": np.array([tr.gamma] + _resolve_bucket_gammas(
        tr.gamma_spec, tr._bucket_spec(), tr.compressor))}

    def save(tag, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[tag + ":" + "/".join(k.key for k in path)] = np.asarray(leaf)

    key = jax.random.PRNGKey(0)
    state = tr.init_state(key)
    save("x0", state.params)
    batches = make_lm_batch_fn(cfg, seq, bpn, 4, 1.0)
    b0 = jax.tree.map(jnp.asarray, batches())
    step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                jax.eval_shape(lambda: b0))
    mets = []
    for i in range(steps):
        batch = b0 if i == 0 else jax.tree.map(jnp.asarray, batches())
        state, m = step(state, batch)
        mets.append([float(m["loss"]), float(m["lr"]), float(m["grad_norm"])])
    res["metrics"] = np.array(mets)
    save("x", state.params)
    save("x_hat", state.x_hat)
    save("s", state.s)
    if comp == "qsgd":
        # the engine's dither: node i of step j, gossip round t, bucket b
        # draws uniform(fold_in(round_key, b)) with node_key =
        # fold_in(fold_in(key, j), i) and round_key = node_key (t = 0) or
        # fold_in(node_key, t)
        fold = jax.random.fold_in
        for j in range(steps):
            for t in range(k):
                for b in tr._bucket_spec().buckets:
                    rows = []
                    for i in range(4):
                        rk = fold(fold(key, j), i)
                        rk = rk if t == 0 else fold(rk, t)
                        rows.append(np.asarray(jax.random.uniform(
                            fold(rk, b.index), (b.size,))))
                    res[f"xi:{j}:{t}:{b.index}"] = np.stack(rows)
    np.savez(out, **res)
""")


def jax_reference_path(tmp_path_factory, comp, arg, k, exact,
                       topology="ring"):
    """The path of the JAX reference run of one case (on the ring unless
    ``topology`` names another graph or a comma-separated sequence), made
    once per pytest run: tests that need the same case share it, across
    xdist workers too (they meet in the run's common temporary directory
    and take turns under a file lock)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "jax_reference"
    root.mkdir(exist_ok=True)
    tag = "" if topology == "ring" else "_" + topology.replace(",", "+")
    out = root / f"jax_{comp}_{arg}_{k}_{'exact' if exact else '-'}{tag}.npz"
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            part = out.with_suffix(".part.npz")
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                       JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            r = subprocess.run(
                [sys.executable, "-c", _JAX_REFERENCE, comp, str(arg), str(k),
                 "exact" if exact else "-", str(STEPS), str(SEQ), str(BPN),
                 str(part), topology],
                env=env, capture_output=True, text=True, timeout=600)
            assert r.returncode == 0, \
                f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
            os.replace(part, out)
    return out


def _tree(ref, tag):
    tree = {}
    for key in ref.files:
        if key.startswith(tag + ":"):
            *parents, leaf = key.split(":", 1)[1].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = ref[key]
    return tree


def _port_trainer(comp, arg, k, exact, topology="ring"):
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    if comp == "qsgd":
        kw = (("s", arg),)
    elif comp in ("sign", "identity"):
        kw = ()
    else:
        kw = (("fraction", arg),)
    return DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                                            topology=topology, gossip_steps=k,
                                            exact_small_leaves=exact),
        n_nodes=N, optimizer=momentum_sgd(),
        lr_fn=cosine_schedule(0.1, warmup=STEPS // 10 + 1, total=STEPS),
        device="cpu")


@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("comp,arg,k,exact", [
    pytest.param("sign", 0, 1, False, id="sign-0-1"),
    pytest.param("qsgd", 16, 1, False, id="qsgd-16-1"),
    pytest.param("qsgd", 16, 2, False, id="qsgd-16-2"),
    pytest.param("top_k", 0.05, 1, False, id="top_k-0.05-1"),
    pytest.param("block_top_k", 0.05, 1, False, id="block_top_k-0.05-1"),
    pytest.param("identity", 0, 1, True, id="identity-exact-1"),
])
def test_slice_matches_jax_trainer(tmp_path_factory, comp, arg, k, exact):
    ref = np.load(jax_reference_path(tmp_path_factory, comp, arg, k, exact))
    tr = _port_trainer(comp, arg, k, exact)
    assert any(b.exact for b in tr.spec.buckets) == exact
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


def check_against_jax(tr, state, mets, ref, comp, x_atol=1e-6):
    """Metrics and state after the steps against the JAX trainer's, with
    the tolerances of this module's docstring (x_hat and s where the
    state has them; x within ``x_atol``)."""
    mets = np.array(mets)
    np.testing.assert_allclose(mets[:, 0], ref["metrics"][:, 0], rtol=1e-6)
    np.testing.assert_array_equal(mets[:, 1], ref["metrics"][:, 1])
    np.testing.assert_allclose(mets[:, 2], ref["metrics"][:, 2], rtol=1e-5)

    flip_bound = 0.0
    if comp == "sign":
        x0 = params_from_jax(_tree(ref, "x0"))
        flip_bound = 8 * max(float(v.abs().mean()) for v in x0.values())
    total = sum(b.numel() for b in state.x)
    for tag, bufs in (("x", state.x), ("x_hat", state.x_hat), ("s", state.s)):
        if bufs is None:                 # not allocated in the exact modes
            continue
        got = dict(zip(tr.paths, unpack_leaves(tr.spec, bufs)))
        want = params_from_jax(_tree(ref, tag))
        outliers = 0
        for path in tr.paths:
            a, b = got[path].numpy(), want[path].numpy()
            diff = np.abs(a - b)
            if tag == "x":
                assert diff.max() <= x_atol, path
                continue
            bad = diff > 1e-6 + 1e-5 * np.abs(b)
            outliers += int(bad.sum())
            if bad.any():
                assert diff[bad].max() <= flip_bound, (tag, path, diff.max())
        assert outliers <= total // 100_000, (tag, outliers)


# -- launcher -------------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1", "--steps", "2",
          "--seq-len", "32", "--batch-per-node", "2"]


def test_launcher_runs_on_cpu_when_asked(capsys):
    assert launcher.main(_SMOKE + ["--compressor", "qsgd", "--qsgd-s", "16",
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "buckets=2" in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launcher_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(_SMOKE + ["--compressor", "sign"])


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecentralizedTrainer(model=Model(get_config("qwen3-1.7b", smoke=True)),
                             choco=ChocoConfig(), n_nodes=N,
                             optimizer=momentum_sgd(),
                             lr_fn=cosine_schedule(0.1, 1, 3))
    assert trainer_mod.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("extra", [
    ["--compressor", "top_k", "--fraction", "0.05"],
    ["--compressor", "identity"],
    ["--compressor", "sign", "--exact-small-leaves"],
    ["--compressor", "block_top_k"],
    ["--compressor", "rand_k", "--fraction", "0.02"],
    ["--exact-small-leaves"],                     # the default, top_k 0.01
])
def test_launcher_runs_each_compressor_on_cpu(extra, capsys):
    assert launcher.main(_SMOKE + extra + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    comp = extra[extra.index("--compressor") + 1] if "--compressor" in extra \
        else "top_k"
    assert f"compressor={comp} " in out
    # the norm scales go to an exact bucket of their own
    assert "buckets=2 " in out
    assert f"exact_buckets={int('--exact-small-leaves' in extra)} " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("extra,message", [
    (["--compressor", "randomized_gossip"],
     "randomized_gossip takes a keep probability p"),
    (["--compressor", "power_sgd"], "--compressor power_sgd is not ported"),
    (["--compressor", "sign", "--gossip-steps", "0"],
     "--gossip-steps must be >= 1"),
    (["--compressor", "sign", "--mode", "pushsum"], "--mode pushsum"),
    (["--compressor", "sign", "--pipeline-gossip"], "--pipeline-gossip"),
    (["--compressor", "sign", "--topology-process", "matching"],
     "--topology-process"),
    (["--compressor", "sign", "--gossip-engine", "per-leaf"],
     "--gossip-engine"),
    (["--compressor", "sign", "--state-dtype", "bfloat16"], "--state-dtype"),
    (["--compressor", "sign", "--kernel-backend", "pallas"],
     "--kernel-backend"),
    (["--compressor", "sign", "--topology", "directed_ring"], "--topology"),
    (["--compressor", "sign", "--mesh", "4x2"], "model extent 2"),
    (["--compressor", "sign", "--resume", "ckpt"], "--resume"),
    (["--compressor", "qsgd"], "requires --qsgd-s"),
])
def test_launcher_refuses_flags_outside_the_slice(extra, message, capsys):
    with pytest.raises(SystemExit) as exc:
        launcher.main(_SMOKE + extra)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_refuses_before_importing_torch():
    code = ("import sys; from repro_torch.launch.train import main\n"
            "try:\n    main(['--arch', 'qwen3-1.7b', '--compressor',"
            " 'randomized_gossip', '--mesh', '4x1'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
