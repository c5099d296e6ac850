"""Checkpoints of the port (``src/repro_torch/checkpoint/``, the trainer's
``save_checkpoint``, ``restore_checkpoint`` and ``consensus_warmup``, the
launcher's checkpoint and resume flags), held against the JAX package on
the CPU.

Two JAX subprocesses per module (8 host devices, ``AxisType.Auto``
meshes of 4, 8 or 2 of them, ``kernel_backend="jnp"``, the smoke qwen3
decoder in f32, the key ``KEY_WORDS``, whose two words both matter):

* ``jax_cross``: per ``CROSS_CASES`` entry (top_k and QSGD, f32 and
  bf16 EF state, momentum and AdamW, each value in two cases) the JAX
  trainer runs 2 steps and saves a sharded checkpoint and a legacy flat
  npz, then runs step 3; the QSGD dither of step 3 is saved;
* ``jax_accept``: JAX reads the port's checkpoints (``read_manifest``,
  ``validate_tree`` against ``tree_leaf_specs(state_shape())``,
  ``restore_checkpoint``) and saves what it restored again; it saves
  checkpoints of its own in the exact modes; and it restores the QSGD f32
  AdamW case's step-2 checkpoint on 8 and on 2 nodes, runs its
  ``consensus_warmup`` and saves the state before and after and the
  warmup's dither.

Tolerances (CPU):

* JAX -> port: the port restores the step-2 checkpoint (warmup 0) and
  runs step 3 with the JAX dither; the result is held to
  ``test_torch_slice.check_against_jax`` (losses 1e-6 relative, x 1e-6,
  x_hat and s 1e-6 + 1e-5 relative; bf16 state: 1 in 10^5 elements may
  differ by a flipped bf16 rounding), x under AdamW to
  ``test_torch_optim_data.ADAMW_ATOL`` = 1e-5;
* every save and restore, and every round trip between the packages:
  bit-equal (leaves compared as stored bits, bf16 as uint16);
* the elastic restores: the remapped params bit-equal to JAX's, x_hat
  and s zero, the warmup round counts equal; after the warmup (7 rounds
  on 8 nodes, 1 on 2, QSGD with the JAX dither) x within 1e-6 and x_hat
  and s within 1e-6 + 1e-5 relative, ``check_against_jax``'s state
  bounds (the QSGD codes agree; the norms are summed in another order);
* the port's resume (1 step, save, restore in a fresh trainer, 2 steps
  against 3 uninterrupted steps): bit-equal, stacked and per rank.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
import types
import zipfile
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointing as ck
from repro_torch.checkpoint import elastic, manifest
from repro_torch.checkpoint.manifest import (ElasticRestoreError,
                                             ManifestError, ShardCoverageError,
                                             TreeMismatchError)
from repro_torch.configs.base import ChocoConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.launch import mesh
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import Model
from repro_torch.optim.sgd import cosine_schedule, make_optimizer
from repro_torch.train.trainer import (DecentralizedTrainer, key_words,
                                       seed_of_key)
from test_torch_dist import THREADS, _join, _spawn
from test_torch_optim_data import ADAMW_ATOL
from test_torch_slice import (BPN, N, ROOT, SEQ, STEPS, _tree,
                              check_against_jax)
from test_torch_slice import one_thread  # noqa: F401  (autouse)

#: the JAX key of every JAX run here, and the port seed it stands for
KEY_WORDS = (0x0BADF00D, 0x5EEDCAFE)
#: (name, compressor, state dtype, optimizer) of the JAX -> port cases
CROSS_CASES = (("top_k-f32-momentum", "top_k", "float32", "momentum"),
               ("top_k-bf16-adamw", "top_k", "bfloat16", "adamw"),
               ("qsgd-f32-adamw", "qsgd", "float32", "adamw"),
               ("qsgd-bf16-momentum", "qsgd", "bfloat16", "momentum"))
#: the case whose step-2 checkpoint is restored elastically
ELASTIC_SOURCE = "qsgd-f32-adamw"
ELASTIC_NODES = (8, 2)
#: the port-only runs' sequence and batch per node
PORT_SEQ, PORT_BPN = 32, 2


def _lr(opt):
    return 1e-3 if opt == "adamw" else 0.1


def _case(name, comp, sdt, opt, **kw):
    return dict(name=name, comp=comp, sdt=sdt, opt=opt, lr=_lr(opt), **kw)


def _trainer(comp="top_k", sdt="float32", opt="momentum", n=N, mode="choco",
             group=None, topology="ring"):
    """The port's trainer of a case (the JAX script's ``trainer``)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    kw = (("s", 16),) if comp == "qsgd" else (("fraction", 0.05),)
    return DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                                            topology=topology,
                                            state_dtype=sdt),
        n_nodes=n, optimizer=make_optimizer(opt),
        lr_fn=cosine_schedule(_lr(opt), warmup=STEPS // 10 + 1, total=STEPS),
        device="cpu", group=group, mode=mode)


_JAX = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.checkpoint.checkpointing import save_pytree, tree_leaf_specs
    from repro.checkpoint.manifest import read_manifest, validate_tree
    from repro.configs.base import ChocoConfig, get_config
    from repro.data.synthetic import make_lm_batch_fn
    from repro.models import build_model
    from repro.optim import cosine_schedule, make_optimizer
    from repro.train.trainer import DecentralizedTrainer

    phase, spec, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    STEPS, SEQ, BPN = spec["steps"], spec["seq"], spec["bpn"]
    KEY = jnp.array(spec["key"], jnp.uint32)
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    fold = jax.random.fold_in

    def trainer(c):
        n = c.get("n", 4)
        mesh = jax.make_mesh((n, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        kw = (("s", 16),) if c["comp"] == "qsgd" else (("fraction", 0.05),)
        return DecentralizedTrainer(
            model=build_model(cfg),
            choco=ChocoConfig(compressor=c["comp"], comp_kwargs=kw,
                              gossip_axis="data", kernel_backend="jnp",
                              state_dtype=c["sdt"]),
            mesh=mesh, n_nodes=n, optimizer=make_optimizer(c["opt"]),
            lr_fn=cosine_schedule(c["lr"], warmup=STEPS // 10 + 1,
                                  total=STEPS),
            mode=c.get("mode", "choco"))

    def save(res, tag, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[tag + ":" + "/".join(k.key for k in path)] = np.asarray(
                leaf.astype(jnp.float32))

    def dither(tr, res, tag, key, n):
        # the exchange called with ``key``: node i, gossip round t, bucket
        # b draws uniform(fold_in(round_key, b)), node_key = fold_in(key,
        # i), round_key = node_key (t = 0) or fold_in(node_key, t)
        for t in range(tr.choco.gossip_steps):
            for b in tr._bucket_spec().buckets:
                rows = []
                for i in range(n):
                    rk = fold(key, i)
                    rk = rk if t == 0 else fold(rk, t)
                    rows.append(np.asarray(jax.random.uniform(
                        fold(rk, b.index), (b.size,))))
                res[f"{tag}:{t}:{b.index}"] = np.stack(rows)

    if phase == "cross":
        for c in spec["cases"]:
            tr, res = trainer(c), {}
            d = os.path.join(out, c["name"])
            os.makedirs(d)
            state = tr.init_state(KEY)
            save(res, "x0", state.params)
            batches = make_lm_batch_fn(cfg, SEQ, BPN, 4, 1.0)
            b0 = jax.tree.map(jnp.asarray, batches())
            step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                        jax.eval_shape(lambda: b0))
            for i in range(STEPS - 1):
                batch = b0 if i == 0 else jax.tree.map(jnp.asarray, batches())
                state, _ = step(state, batch)
            tr.save_checkpoint(os.path.join(d, f"step{STEPS - 1}"), state,
                               metadata={"arch": cfg.name})
            save_pytree(os.path.join(d, "legacy.npz"), state)
            if c["comp"] == "qsgd":
                dither(tr, res, "xi", fold(KEY, STEPS - 1), 4)
            state, m = step(state, jax.tree.map(jnp.asarray, batches()))
            res["metrics"] = np.array([[float(m["loss"]), float(m["lr"]),
                                        float(m["grad_norm"])]])
            save(res, "x", state.params)
            save(res, "x_hat", state.x_hat)
            save(res, "s", state.s)
            np.savez(os.path.join(d, "ref.npz"), **res)
    else:
        report = {}
        for c in spec["accept"]:
            tr = trainer(c)
            specs = tree_leaf_specs(tr.state_shape())
            man = read_manifest(c["dir"])
            validate_tree(man.leaves, specs)
            state, man, warm = tr.restore_checkpoint(c["dir"])
            tr.save_checkpoint(c["dir"] + "-jax", state,
                               metadata=man.metadata)
            report[c["name"]] = {
                "warmup": warm, "step": int(state.step),
                "key": [int(w) for w in np.asarray(state.key)],
                "specs": {k: [list(s), d] for k, (s, d) in specs.items()},
                "saved": {k: [list(v.shape), v.dtype]
                          for k, v in man.leaves.items()}}
        for c in spec["exact"]:
            tr, res = trainer(c), {}
            state = tr.init_state(KEY)
            save(res, "x0", state.params)
            tr.save_checkpoint(os.path.join(out, c["name"]), state)
            np.savez(os.path.join(out, c["name"] + ".npz"), **res)
        for c in spec["elastic"]:
            tr, res = trainer(c), {}
            state, man, warm = tr.restore_checkpoint(c["dir"])
            res["warmup"] = np.array(warm)
            res["gammas"] = np.array(tr.gamma)
            save(res, "x", state.params)
            save(res, "x_hat", state.x_hat)
            save(res, "s", state.s)
            base = fold(state.key, 0x5EED)
            for r in range(warm):
                dither(tr, res, f"xi:{r}", fold(base, r), c["n"])
            state = tr.consensus_warmup(state, warm)
            save(res, "warm_x", state.params)
            save(res, "warm_x_hat", state.x_hat)
            save(res, "warm_s", state.s)
            np.savez(os.path.join(out, c["name"] + ".npz"), **res)
        with open(os.path.join(out, "accept.json"), "w") as f:
            json.dump(report, f)
""")


def _run_jax(phase, spec, out):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    spec = dict(spec, steps=STEPS, seq=SEQ, bpn=BPN, key=list(KEY_WORDS))
    r = subprocess.run([sys.executable, "-c", _JAX, phase, json.dumps(spec),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _stored(ckpt_dir):
    """Every leaf of a sharded checkpoint, whole, as stored (bf16 as its
    uint16 bits), with the manifest."""
    man = manifest.read_manifest(ckpt_dir)
    with ck.ShardStore(ckpt_dir) as store:
        return man, {k: store.read_region(k, [0] * len(s.shape),
                                          list(s.shape), s.storage)
                     for k, s in man.leaves.items()}


def _assert_same_checkpoint(a, b):
    """Two sharded checkpoints hold the same leaves, shapes, dtypes and
    bits, at the same step."""
    man_a, leaves_a = _stored(a)
    man_b, leaves_b = _stored(b)
    assert man_a.leaves == man_b.leaves and man_a.step == man_b.step
    for key, arr in leaves_a.items():
        assert arr.dtype == leaves_b[key].dtype, key
        np.testing.assert_array_equal(arr, leaves_b[key], err_msg=key)


def _assert_same_state(a, b):
    for group in ("x", "x_hat", "s"):
        got, want = getattr(a, group), getattr(b, group)
        assert (got is None) == (want is None), group
        for x, y in zip(got or (), want or ()):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), \
                group
    for group in ("mu", "nu"):
        got, want = getattr(a.opt, group), getattr(b.opt, group)
        assert (got is None) == (want is None), group
        for x, y in zip(got or (), want or ()):
            assert torch.equal(x, y), group
    assert (a.opt.count, a.step, a.seed) == (b.opt.count, b.step, b.seed)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A test here writes up to ~2 GB of checkpoints; they go when it ends,
    so that a run does not fill the temporary disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_cross(tmp_path_factory):
    """name -> directory of the JAX cross run of each CROSS_CASES case."""
    out = tmp_path_factory.mktemp("jax_cross")
    _run_jax("cross", {"cases": [_case(*c) for c in CROSS_CASES]}, out)
    yield {c[0]: out / c[0] for c in CROSS_CASES}
    shutil.rmtree(out, ignore_errors=True)


#: the port checkpoints JAX reads: (name, compressor, state dtype,
#: optimizer, mode, steps before the save)
ACCEPT_CASES = (("choco-qsgd-bf16-adamw", "qsgd", "bfloat16", "adamw",
                 "choco", 1),
                ("choco-top_k-f32-sgd", "top_k", "float32", "sgd", "choco", 1),
                ("plain-momentum", "top_k", "float32", "momentum", "plain", 1),
                ("allreduce-sgd", "top_k", "float32", "sgd", "allreduce", 0))
EXACT_CASES = (("jax-plain-momentum", "plain", "momentum"),
               ("jax-allreduce-adamw", "allreduce", "adamw"))


@pytest.fixture(scope="module")
def jax_accept(tmp_path_factory, jax_cross):
    """The port's ACCEPT_CASES checkpoints, what JAX made of them, the JAX
    exact-mode checkpoints and the JAX elastic restores."""
    out = tmp_path_factory.mktemp("jax_accept")
    seed = seed_of_key(KEY_WORDS)
    accept = []
    for name, comp, sdt, opt, mode, steps in ACCEPT_CASES:
        tr = _trainer(comp, sdt, opt, mode=mode)
        state = tr.init_state(seed=seed)
        batches = make_lm_batch_fn(tr.model.cfg, PORT_SEQ, PORT_BPN, N, 1.0)
        for _ in range(steps):
            tr.step(state, tr.batch_to_device(batches()))
        tr.save_checkpoint(str(out / name), state)
        accept.append(_case(name, comp, sdt, opt, mode=mode,
                            dir=str(out / name)))
    exact = [_case(name, "top_k", "float32", opt, mode=mode)
             for name, mode, opt in EXACT_CASES]
    src = str(jax_cross[ELASTIC_SOURCE] / f"step{STEPS - 1}")
    _, comp, sdt, opt = dict((c[0], c) for c in CROSS_CASES)[ELASTIC_SOURCE]
    el = [_case(f"elastic-{n}", comp, sdt, opt, n=n, dir=src)
          for n in ELASTIC_NODES]
    _run_jax("accept", {"accept": accept, "exact": exact, "elastic": el}, out)
    with open(out / "accept.json") as f:
        report = json.load(f)
    yield types.SimpleNamespace(dir=out, report=report)
    shutil.rmtree(out, ignore_errors=True)


# -- (a) the pieces, against the JAX package's -----------------------------------

def _leaves(step=0):
    """A small tree of leaves: f32 node-stacked, bf16, int32 scalar."""
    a = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    b = (torch.arange(8, dtype=torch.float32) / 3).to(torch.bfloat16)
    return [ck.Leaf("params__a", (4, 3), "float32",
                    [ck.Part([i, 0], [i + 1, 3], a[i:i + 1]) for i in range(4)]),
            ck.Leaf("x_hat__b", (8,), "bfloat16", [ck.Part([0], [8], b)]),
            ck.Leaf("step", (), "int32",
                    [ck.Part([], [], np.array(step, np.int32))])], a, b


def test_manifest_round_trip_and_the_jax_reader(tmp_path):
    """A port save: its manifest reads back; np.load and the JAX package's
    reader read its shards, bf16 as uint16 bits."""
    from repro.checkpoint.checkpointing import _ShardStore
    from repro.checkpoint.manifest import read_manifest as jax_read
    leaves, a, b = _leaves(step=7)
    d = str(tmp_path / "step7")
    ck.save_sharded(d, leaves, step=7, fingerprint={"n_nodes": 4},
                    metadata={"arch": "x"})
    man = manifest.read_manifest(d)
    assert man.step == 7 and man.n_nodes == 4 and man.metadata == {"arch": "x"}
    assert man.leaves["x_hat__b"] == manifest.LeafSpec((8,), "bfloat16",
                                                       "uint16")
    assert man.leaves == {k: manifest.LeafSpec(v.shape, v.dtype, v.storage)
                          for k, v in jax_read(d).leaves.items()}
    with np.load(os.path.join(d, "shards-p00000.npz")) as z:
        assert sorted(z.files) == sorted(
            [f"params__a@{i}" for i in range(4)] + ["x_hat__b@0", "step@0"])
        np.testing.assert_array_equal(z["params__a@2"], a[2:3].numpy())
    store = _ShardStore(d)
    np.testing.assert_array_equal(
        store.read_region("params__a", [1, 0], [3, 3], "float32"),
        a[1:3].numpy())
    bits = store.read_region("x_hat__b", [0], [8], "uint16")
    assert torch.equal(ck.storage_tensor(bits, "bfloat16"), b)
    store.close()


def test_torn_checkpoint_is_not_a_checkpoint(tmp_path):
    d = tmp_path / "torn"
    d.mkdir()
    assert not manifest.is_sharded_checkpoint(str(d))
    with pytest.raises(ManifestError, match="not a sharded"):
        manifest.read_manifest(str(d))
    (d / "manifest.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ManifestError, match="format"):
        manifest.read_manifest(str(d))
    (d / "manifest.json").write_text("{")
    with pytest.raises(ManifestError, match="unreadable"):
        manifest.read_manifest(str(d))


def test_shard_coverage_error_names_the_leaf(tmp_path):
    leaves, _, _ = _leaves()
    d = str(tmp_path / "ck")
    ck.save_sharded(d, leaves, step=0)
    path = os.path.join(d, "shards-p00000.index.json")
    with open(path) as f:
        index = json.load(f)
    del index["entries"]["params__a@3"]          # row 3 lost
    with open(path, "w") as f:
        json.dump(index, f)
    with ck.ShardStore(d) as store:
        store.read_region("params__a", [0, 0], [3, 3], "float32")
        with pytest.raises(ShardCoverageError, match="params__a"):
            store.read_region("params__a", [0, 0], [4, 3], "float32")


def test_tree_mismatch_enumerates_every_problem(tmp_path):
    leaves, _, _ = _leaves()
    d = str(tmp_path / "ck")
    ck.save_sharded(d, leaves, step=0)
    saved = manifest.read_manifest(d).leaves
    with pytest.raises(TreeMismatchError) as ei:
        manifest.validate_tree(saved, {"params__a": ((4, 4), "float32"),
                                       "x_hat__b": ((8,), "float32"),
                                       "zzz": ((1,), "int32")})
    err = ei.value
    assert err.missing == ("zzz",) and err.extra == ("step",)
    assert set(err.mismatched) == {("params__a", "shape", "(4, 3)", "(4, 4)"),
                                   ("x_hat__b", "dtype", "bfloat16",
                                    "float32")}
    # an elastic target passes the node extent; reset keys pass their dtype
    manifest.validate_tree(saved, {"params__a": ((8, 3), "float32"),
                                   "x_hat__b": ((8,), "float32"),
                                   "step": ((), "int32")},
                           node_remap=(4, 8), reset_prefixes=["x_hat"])


@pytest.mark.parametrize("n_old,n_new", [(4, 4), (4, 8), (4, 2), (2, 8),
                                         (8, 2), (4, 1), (1, 4)])
def test_elastic_policy_matches_jax(n_old, n_new):
    """The restore's rows (``source_rows``, the f32 ``mean_rows`` where
    several) are the JAX policy's ``remap_rows``, bit for bit."""
    from repro.checkpoint import elastic as jax_elastic
    old = np.random.default_rng(n_old * 10 + n_new).standard_normal(
        (n_old, 5, 3)).astype(np.float32)
    assert elastic.elastic_ratio(n_old, n_new) == \
        jax_elastic.elastic_ratio(n_old, n_new)
    rows = []
    for j in range(n_new):
        src = elastic.source_rows(j, n_old, n_new)
        assert src == jax_elastic.source_rows(j, n_old, n_new)
        rows.append(old[src[0]] if len(src) == 1
                    else elastic.mean_rows([old[i] for i in src]))
    np.testing.assert_array_equal(np.stack(rows),
                                  jax_elastic.remap_rows(old, n_new))


def test_elastic_refuses_what_it_cannot_map():
    for n_old, n_new in ((4, 6), (4, 3), (0, 4)):
        with pytest.raises(ElasticRestoreError):
            elastic.elastic_ratio(n_old, n_new)


@pytest.mark.parametrize("topo,n", [("ring", 8), ("ring", 2), ("ring", 16),
                                    ("star", 4), ("chain", 8),
                                    ("fully_connected", 4), ("torus", 9)])
def test_warmup_rounds_match_jax(topo, n):
    from repro.checkpoint.elastic import consensus_warmup_rounds as jax_rounds
    from repro.core.topology import make_topology as jax_topology
    from repro_torch.core.topology import make_topology
    delta = make_topology(topo, n).delta
    assert elastic.consensus_warmup_rounds(delta) == \
        jax_rounds(jax_topology(topo, n).delta)
    assert elastic.consensus_warmup_rounds(1e-6) == 64
    with pytest.raises(ElasticRestoreError):
        elastic.consensus_warmup_rounds(0.0)


def test_gc_keeps_the_newest_and_never_the_one_written(tmp_path):
    base = tmp_path / "ckpts"
    for step in (10, 20, 30):
        ck.save_sharded(str(base / f"step{step}"), _leaves(step)[0], step=step)
    (base / "torn").mkdir()                      # no manifest: never touched
    (base / "notes.txt").write_text("keep me")
    ck.save_sharded(str(base / "step40"), _leaves(40)[0], step=40,
                    keep_last=2)
    assert sorted(p.name for p in base.iterdir()) == \
        ["notes.txt", "step30", "step40", "torn"]
    assert ck.gc_checkpoints(str(base), 2) == []
    # the checkpoint being written survives even when older by its step
    ck.save_sharded(str(base / "step5"), _leaves(5)[0], step=5, keep_last=1)
    assert sorted(p.name for p in base.iterdir()) == \
        ["notes.txt", "step5", "torn"]
    with pytest.raises(ValueError, match="keep_last"):
        ck.gc_checkpoints(str(base), 0)


def test_legacy_npz_restores_as_the_jax_package_saves_it(tmp_path):
    """The JAX package's flat npz (bf16 widened to f32): the port's
    LegacyStore gives each region in its storage dtype, bf16 as its bits,
    reads only the region's rows from the file, and enumerates missing,
    extra and mis-shaped keys from the members' headers."""
    import jax.numpy as jnp
    from repro.checkpoint.checkpointing import save_pytree
    _, a, b = _leaves()
    path = str(tmp_path / "flat.npz")
    save_pytree(path, {"a": jnp.asarray(a.numpy()),
                       "b": jnp.asarray(b.float().numpy(), jnp.bfloat16),
                       "step": jnp.asarray(3, jnp.int32)})
    with ck.LegacyStore(path, {"a": ((4, 3), "float32"),
                               "b": ((8,), "bfloat16"),
                               "step": ((), "int32")}) as store:
        got = store.read_region("a", [0, 0], [4, 3], "float32")
        np.testing.assert_array_equal(got, a.numpy())
        np.testing.assert_array_equal(
            store.read_region("a", [1, 1], [3, 3], "float32"),
            a.numpy()[1:3, 1:3])
        bits = store.read_region("b", [0], [8], "uint16")
        assert bits.dtype == np.uint16
        assert torch.equal(ck.storage_tensor(bits, "bfloat16"), b)
        assert store.read_region("step", [], [], "int32") == 3
        read = []
        real = zipfile.ZipExtFile.read
        def counted(f, n=-1):
            out = real(f, n)
            read.append(len(out))
            return out
        with mock.patch.object(zipfile.ZipExtFile, "read", counted):
            row = store.read_region("a", [2, 0], [3, 3], "float32")
        np.testing.assert_array_equal(row, a.numpy()[2:3])
        assert sum(read) == 3 * 4                  # one f32 row, nothing else
    with pytest.raises(TreeMismatchError) as ei:
        ck.LegacyStore(path, {"a": ((4, 4), "float32"),
                              "c": ((1,), "int32"), "step": ((), "int32")})
    assert ei.value.missing == ("c",) and ei.value.extra == ("b",)
    assert ("a", "shape", "(4, 3)", "(4, 4)") in ei.value.mismatched


def test_key_words_are_the_jax_prng_key():
    import jax
    for seed in (0, 7, 2 ** 31 + 5):
        assert key_words(seed) == tuple(int(w) for w in
                                        np.asarray(jax.random.PRNGKey(seed)))
    assert seed_of_key(key_words(seed_of_key(KEY_WORDS))) == \
        seed_of_key(KEY_WORDS)
    with pytest.raises(ValueError):
        key_words(-1)


# -- (b) JAX -> port ----------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name,comp,sdt,opt", CROSS_CASES,
                         ids=[c[0] for c in CROSS_CASES])
def test_jax_checkpoint_resumes_in_the_port(jax_cross, tmp_path, name, comp,
                                            sdt, opt):
    """The port restores the JAX step-2 checkpoint (warmup 0, the JAX key
    as its seed), runs step 3 on the JAX dither and matches JAX's
    uninterrupted step 3; a save of what it restored is the JAX
    checkpoint, bit for bit, the key included."""
    d = jax_cross[name]
    ref = np.load(d / "ref.npz")
    tr = _trainer(comp, sdt, opt)
    state, man, warmup = tr.restore_checkpoint(str(d / f"step{STEPS - 1}"))
    assert warmup == 0 and man.step == state.step == STEPS - 1
    assert state.seed == seed_of_key(KEY_WORDS)
    assert state.opt.count == STEPS - 1
    tr.save_checkpoint(str(tmp_path / "again"), state,
                       metadata=man.metadata)
    _assert_same_checkpoint(str(d / f"step{STEPS - 1}"),
                            str(tmp_path / "again"))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    for _ in range(STEPS - 1):
        batches()
    draws = (None if comp != "qsgd" else
             lambda t, b: torch.from_numpy(ref[f"xi:{t}:{b}"]))
    m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
    check_against_jax(tr, state, [[m["loss"], m["lr"], m["grad_norm"]]], ref,
                      comp, x_atol=ADAMW_ATOL if opt == "adamw" else 1e-6)


@pytest.mark.slow
def test_jax_legacy_npz_restores_in_the_port(jax_cross):
    """JAX's flat npz (bf16 x_hat and s widened to f32) restores into the
    same state as its sharded checkpoint of the same step."""
    d = jax_cross["qsgd-bf16-momentum"]
    tr = _trainer("qsgd", "bfloat16", "momentum")
    legacy = tr.restore_legacy(str(d / "legacy.npz"))
    sharded, _, _ = tr.restore_checkpoint(str(d / f"step{STEPS - 1}"))
    _assert_same_state(legacy, sharded)


# -- (c) port -> JAX ----------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", [c[0] for c in ACCEPT_CASES])
def test_port_checkpoint_restores_in_jax(jax_accept, name):
    """JAX's read_manifest and validate_tree accept the port's checkpoint
    against its own state_shape (keys, shapes and dtypes all equal), its
    restore_checkpoint resumes exactly (warmup 0), and the key survives:
    what JAX saves of the restored state is the port's checkpoint, bit
    for bit."""
    rep = jax_accept.report[name]
    assert rep["warmup"] == 0 and rep["key"] == list(KEY_WORDS)
    comp, sdt, opt, mode, steps = dict(
        (c[0], c[1:]) for c in ACCEPT_CASES)[name]
    assert rep["step"] == steps
    assert rep["saved"] == rep["specs"]
    tr = _trainer(comp, sdt, opt, mode=mode)
    assert {k: [list(s), d] for k, (s, d) in tr.state_leaf_specs().items()} \
        == rep["specs"]
    path = str(jax_accept.dir / name)
    _assert_same_checkpoint(path, path + "-jax")
    state, _, warmup = tr.restore_checkpoint(path + "-jax")
    assert warmup == 0 and state.seed == seed_of_key(KEY_WORDS)


# -- (d) the port's resume ----------------------------------------------------------

RESUME_CASES = (("sgd", "float32", "qsgd"), ("sgd", "bfloat16", "top_k"),
                ("momentum", "float32", "top_k"),
                ("momentum", "bfloat16", "qsgd"),
                ("adamw", "float32", "qsgd"), ("adamw", "bfloat16", "top_k"))


def _resume_runs(tr_of, seed, batches, path):
    """(3 uninterrupted steps, 1 step + save + restore in a fresh trainer +
    2 steps) from ``seed`` on ``batches``; saves the step-1 checkpoint at
    ``path``."""
    a = tr_of()
    sa = a.init_state(seed=seed)
    for b in batches:
        a.step(sa, a.batch_to_device(b))
    b_ = tr_of()
    sb = b_.init_state(seed=seed)
    b_.step(sb, b_.batch_to_device(batches[0]))
    b_.save_checkpoint(path, sb)
    c = tr_of()
    sc, man, warmup = c.restore_checkpoint(path)
    assert warmup == 0 and man.step == 1
    for b in batches[1:]:
        c.step(sc, c.batch_to_device(b))
    return sa, sc, sb


@pytest.mark.parametrize("opt,sdt,comp", RESUME_CASES,
                         ids=["-".join(c) for c in RESUME_CASES])
def test_port_resume_is_bit_exact(tmp_path, opt, sdt, comp):
    tr_of = lambda: _trainer(comp, sdt, opt)
    batches_of = make_lm_batch_fn(tr_of().model.cfg, PORT_SEQ, PORT_BPN, N,
                                  1.0)
    batches = [batches_of() for _ in range(STEPS)]
    whole, resumed, _ = _resume_runs(tr_of, 11, batches,
                                     str(tmp_path / "step1"))
    _assert_same_state(resumed, whole)


#: the per-rank resume cases: (optimizer, state dtype, compressor)
DIST_RESUME_CASES = (("sgd", "bfloat16", "qsgd"),
                     ("momentum", "float32", "qsgd"),
                     ("adamw", "bfloat16", "top_k"))


#: the leaves of a state that are not stacked by node
_SCALARS = ("opt__count", "step", "key")


def _legacy_from(ckpt_dir, path):
    """The legacy flat npz of a sharded checkpoint, as the JAX package's
    ``save_pytree`` writes it (flat keys, bf16 widened to f32).  Returns
    the bytes a trainer holding one node row of ``n`` must read from it:
    every member's header, its own row of each stacked leaf, and the
    scalars."""
    man, leaves = _stored(ckpt_dir)
    flat = {k: (ck.storage_tensor(v, "bfloat16").float().numpy()
                if man.leaves[k].dtype == "bfloat16" else v)
            for k, v in leaves.items()}
    np.savez(path, **flat)
    n = man.n_nodes
    with zipfile.ZipFile(path) as z:
        heads = 0
        for name in z.namelist():
            with z.open(name) as f:
                assert np.lib.format.read_magic(f) == (1, 0)
                np.lib.format.read_array_header_1_0(f)
                heads += f.tell()
    return heads + sum(v.nbytes if k in _SCALARS else v.nbytes // n
                       for k, v in flat.items())


def _dist_resume_rank(rank, store, out_dir):
    torch.set_num_threads(THREADS)
    group = _join(rank, store)
    out = {}
    for i, (opt, sdt, comp) in enumerate(DIST_RESUME_CASES):
        tr_of = lambda: _trainer(comp, sdt, opt, group=group)
        cfg = tr_of().model.cfg
        rows = make_lm_batch_fn(cfg, PORT_SEQ, PORT_BPN, N, 1.0, node=rank)
        batches = [rows() for _ in range(STEPS)]
        whole, resumed, step1 = _resume_runs(
            tr_of, 11, batches, os.path.join(out_dir, f"ranks{i}"))
        # the stacked engine's step-1 checkpoint, restored on this rank
        stacked, _, warmup = tr_of().restore_checkpoint(
            os.path.join(out_dir, f"stacked{i}"))
        # its legacy flat npz, restored on this rank; every byte read from
        # the file is counted
        read = []
        real = zipfile.ZipExtFile.read
        def counted(f, n=-1):
            got = real(f, n)
            read.append(len(got))
            return got
        tr = tr_of()
        with mock.patch.object(zipfile.ZipExtFile, "read", counted):
            legacy = tr.restore_legacy(
                os.path.join(out_dir, f"legacy{i}.npz"))
        out[i] = {"whole": whole, "resumed": resumed, "step1": step1,
                  "stacked": stacked, "warmup": warmup, "legacy": legacy,
                  "legacy_read": sum(read)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_per_rank_resume_is_bit_exact_and_crosses_with_stacked(tmp_path):
    """On 4 gloo ranks, each case: the per-rank resume is bit-exact; each
    rank restores its row of a stacked checkpoint bit for bit, and of its
    legacy flat npz too, reading from the file only the headers, its own
    rows and the scalars; the stacked engine restores the ranks'
    checkpoint into the ranks' own state."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        stacked, row_bytes = [], []
        for i, (opt, sdt, comp) in enumerate(DIST_RESUME_CASES):
            tr = _trainer(comp, sdt, opt)
            state = tr.init_state(seed=5)
            batches = make_lm_batch_fn(tr.model.cfg, PORT_SEQ, PORT_BPN, N,
                                       1.0)
            tr.step(state, tr.batch_to_device(batches()))
            tr.save_checkpoint(str(tmp_path / f"stacked{i}"), state)
            stacked.append(state)
            row_bytes.append(_legacy_from(str(tmp_path / f"stacked{i}"),
                                          str(tmp_path / f"legacy{i}.npz")))
        ranks = _spawn(_dist_resume_rank, tmp_path, str(tmp_path))
        for i, (opt, sdt, comp) in enumerate(DIST_RESUME_CASES):
            row = lambda st, r: types.SimpleNamespace(
                x=[b[r:r + 1] for b in st.x],
                x_hat=[b[r:r + 1] for b in st.x_hat],
                s=[b[r:r + 1] for b in st.s],
                opt=st.opt._replace(
                    mu=None if st.opt.mu is None
                    else [b[r:r + 1] for b in st.opt.mu],
                    nu=None if st.opt.nu is None
                    else [b[r:r + 1] for b in st.opt.nu]),
                step=st.step, seed=st.seed)
            for r, res in enumerate(ranks):
                rec = res[i]
                _assert_same_state(rec["resumed"], rec["whole"])
                assert rec["warmup"] == 0
                _assert_same_state(rec["stacked"], row(stacked[i], r))
                _assert_same_state(rec["legacy"], row(stacked[i], r))
                assert rec["legacy_read"] == row_bytes[i]
            # the ranks' step-1 checkpoint in the stacked engine
            back, man, warmup = _trainer(comp, sdt, opt).restore_checkpoint(
                str(tmp_path / f"ranks{i}"))
            assert warmup == 0 and man.process_count == N
            for r, res in enumerate(ranks):
                _assert_same_state(row(back, r), res[i]["step1"])
    finally:
        torch.set_num_threads(threads)


# -- (e) elastic restore against JAX ---------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("n", ELASTIC_NODES)
def test_elastic_restore_and_warmup_match_jax(jax_cross, jax_accept, n):
    """The JAX step-2 checkpoint of 4 nodes on ``n``: the remapped params
    bit-equal to JAX's, x_hat and s zero, the same warmup rounds, and after
    the warmup (the JAX dither injected) the state within
    ``check_against_jax``'s state bounds; the warmup's launches, none on
    the CPU, are counted on the card (``test_torch_cuda.py``)."""
    ref = np.load(jax_accept.dir / f"elastic-{n}.npz")
    _, comp, sdt, opt = dict((c[0], c) for c in CROSS_CASES)[ELASTIC_SOURCE]
    tr = _trainer(comp, sdt, opt, n=n)
    state, man, warmup = tr.restore_checkpoint(
        str(jax_cross[ELASTIC_SOURCE] / f"step{STEPS - 1}"))
    assert man.n_nodes == N and warmup == int(ref["warmup"])
    assert warmup == (7 if n == 8 else 1)
    assert tr.gamma == float(ref["gammas"])
    got = tr.params(state)
    for path, want in params_from_jax(_tree(ref, "x")).items():
        assert torch.equal(got[path], want), path
    assert not any(b.any() for b in state.x_hat + state.s)
    tr.consensus_warmup(state, warmup, draws=lambda r, t, b: torch.from_numpy(
        ref[f"xi:{r}:{t}:{b}"]))
    for tag, bufs in (("warm_x", state.x), ("warm_x_hat", state.x_hat),
                      ("warm_s", state.s)):
        got = tr.params(types.SimpleNamespace(x=bufs))
        for path, want in params_from_jax(_tree(ref, tag)).items():
            diff = (got[path].float() - want).abs()
            bound = (1e-6 if tag == "warm_x"
                     else 1e-6 + 1e-5 * want.abs())
            assert bool((diff <= bound).all()), (tag, path,
                                                 float(diff.max()))
    # the warmup moved the state: the public copies are rebuilt
    assert all(b.any() for b in state.x_hat)


def test_elastic_restore_refuses_an_unmappable_resize(tmp_path):
    tr = _trainer()
    tr.save_checkpoint(str(tmp_path / "ck"), tr.init_state(seed=1))
    with pytest.raises(ElasticRestoreError, match="4 -> 3"):
        _trainer(n=3).restore_checkpoint(str(tmp_path / "ck"))


def test_graph_or_compression_change_resets_the_ef_state(tmp_path):
    """Same node count, another graph or compressor: x and the moments
    restored, x_hat and s zero, the new graph's warmup rounds; the exact
    modes take every checkpoint with 0 rounds."""
    tr = _trainer("top_k")
    state = tr.init_state(seed=3)
    tr.step(state, tr.batch_to_device(make_lm_batch_fn(
        tr.model.cfg, PORT_SEQ, PORT_BPN, N, 1.0)()))
    tr.save_checkpoint(str(tmp_path / "ck"), state)
    for other in (_trainer("top_k", topology="star"), _trainer("qsgd")):
        got, _, warmup = other.restore_checkpoint(str(tmp_path / "ck"))
        assert warmup == elastic.consensus_warmup_rounds(
            other.topologies[0].delta)
        assert all(torch.equal(a, b) for a, b in zip(got.x, state.x))
        assert not any(b.any() for b in got.x_hat + got.s)
    got, _, warmup = _trainer("top_k", mode="plain").restore_checkpoint(
        str(tmp_path / "ck"))
    assert warmup == 0 and got.x_hat is None
    assert all(torch.equal(a, b) for a, b in zip(got.x, state.x))


# -- (f) the exact modes ------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", ["plain-momentum", "allreduce-sgd"])
def test_exact_mode_checkpoints_carry_zero_ef_leaves(jax_accept, name):
    """The port's plain and allreduce checkpoints hold x_hat and s as the
    JAX state does, zero leaves of its shape and dtype (JAX accepts them:
    ``test_port_checkpoint_restores_in_jax``)."""
    man, leaves = _stored(str(jax_accept.dir / name))
    ef = [k for k in leaves if manifest.key_prefix(k) in ("x_hat", "s")]
    assert len(ef) == 2 * len(_trainer().paths)
    for key in ef:
        assert man.leaves[key].dtype == "float32" and not leaves[key].any()


@pytest.mark.slow
@pytest.mark.parametrize("name,mode,opt", EXACT_CASES,
                         ids=[c[0] for c in EXACT_CASES])
def test_jax_exact_mode_checkpoint_restores_in_the_port(jax_accept, name,
                                                        mode, opt):
    ref = np.load(jax_accept.dir / f"{name}.npz")
    tr = _trainer("top_k", "float32", opt, mode=mode)
    state, man, warmup = tr.restore_checkpoint(str(jax_accept.dir / name))
    assert warmup == 0 and state.x_hat is None and state.s is None
    assert man.fingerprint["mode"] == mode and state.step == 0
    assert state.seed == seed_of_key(KEY_WORDS)
    got = tr.params(state)
    for path, want in params_from_jax(_tree(ref, "x0")).items():
        assert torch.equal(got[path], want), path


# -- (g) the launcher ---------------------------------------------------------------

_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--seq-len", "32",
          "--batch-per-node", "2", "--device", "cpu", "--compressor", "qsgd",
          "--qsgd-s", "16"]


def _steps(out):
    return [int(line.split()[2]) for line in out.splitlines()
            if line.startswith("[train] step")]


def test_launcher_checkpoints_every_k_steps_and_keeps_the_newest(tmp_path,
                                                                 capsys):
    d = str(tmp_path / "ck")
    assert launcher.main(_SMOKE + ["--mesh", "4x1", "--steps", "4",
                                   "--checkpoint-dir", d,
                                   "--checkpoint-every", "1",
                                   "--keep-checkpoints", "2"]) == 0
    out = capsys.readouterr().out
    assert [line for line in out.splitlines() if "checkpointed" in line] == \
        [f"[train] checkpointed {d}/step{k}" for k in range(1, 5)]
    assert sorted(os.listdir(d)) == ["step3", "step4"]
    man = manifest.read_manifest(os.path.join(d, "step4"))
    assert man.step == 4 and man.metadata == {"arch": "qwen3-1.7b-smoke"}
    assert man.fingerprint["compressor_config"] == {"s": 16}


@pytest.mark.parametrize("extra,message", [
    (["--keep-checkpoints", "0", "--checkpoint-dir", "x"],
     "--keep-checkpoints must be >= 1"),
    (["--keep-checkpoints", "-1", "--checkpoint-dir", "x"],
     "--keep-checkpoints must be >= 1"),
])
def test_launcher_refuses_bad_checkpoint_flags(extra, message, capsys):
    with pytest.raises(SystemExit) as exc:
        launcher.main(_SMOKE + ["--mesh", "4x1", "--steps", "2"] + extra)
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_launcher_resume_keeps_the_total_budget(tmp_path, capsys):
    """--steps is the total: a step-2 checkpoint with --steps 3 trains one
    step, at the schedule's step 3; an exhausted budget exits before any
    restore (the shards are gone, the manifest says step 2)."""
    d = str(tmp_path / "ck")
    assert launcher.main(_SMOKE + ["--mesh", "4x1", "--steps", "3",
                                   "--checkpoint-dir", d,
                                   "--checkpoint-every", "2"]) == 0
    full = capsys.readouterr().out
    assert launcher.main(_SMOKE + ["--mesh", "4x1", "--steps", "3",
                                   "--resume", f"{d}/step2"]) == 0
    out = capsys.readouterr().out
    assert f"[train] resumed from {d}/step2 at step 2" in out
    assert _steps(out) == [3] and _steps(full) == [1, 3]
    lr = lambda text: [line.split(" lr ")[1].split()[0]
                       for line in text.splitlines()
                       if line.startswith("[train] step     3")]
    assert lr(out) == lr(full)                # anchored at step 0
    for f in os.listdir(f"{d}/step2"):
        if f.startswith("shards-"):
            os.remove(os.path.join(d, "step2", f))
    with pytest.raises(SystemExit) as exc:
        launcher.main(_SMOKE + ["--mesh", "4x1", "--steps", "2",
                                "--resume", f"{d}/step2"])
    assert "--steps 2 is the TOTAL step budget" in str(exc.value)
    assert "already at step 2" in str(exc.value)


@pytest.mark.slow
def test_launcher_resumes_a_jax_legacy_npz(jax_cross, capsys):
    legacy = str(jax_cross["top_k-f32-momentum"] / "legacy.npz")
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--seq-len", "32",
            "--batch-per-node", "2", "--device", "cpu", "--mesh", "4x1",
            "--compressor", "top_k", "--fraction", "0.05"]
    assert launcher.main(argv + ["--steps", "4", "--resume", legacy]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {legacy} at step 2" in out
    assert _steps(out) == [3, 4]
    with pytest.raises(SystemExit, match="already at step 2"):
        launcher.main(argv + ["--steps", "2", "--resume", legacy])


def test_launcher_elastic_restore_runs_the_warmup(tmp_path, capsys):
    d = str(tmp_path / "ck")
    assert launcher.main(_SMOKE + ["--mesh", "4x1", "--steps", "1",
                                   "--checkpoint-dir", d,
                                   "--checkpoint-every", "1"]) == 0
    capsys.readouterr()
    assert launcher.main(_SMOKE + ["--mesh", "8x1", "--steps", "2",
                                   "--resume", f"{d}/step1"]) == 0
    out = capsys.readouterr().out
    line = [s for s in out.splitlines() if "elastic restore" in s]
    assert len(line) == 1 and "n_nodes=4 topology=ring -> n_nodes=8" in \
        line[0] and "consensus warmup 7 CHOCO-GOSSIP rounds" in line[0]
    assert "re-derived Theorem-2 gamma=" in line[0]
    assert launcher.main(_SMOKE + ["--mesh", "8x1", "--steps", "2",
                                   "--resume", f"{d}/step1",
                                   "--elastic-warmup-rounds", "2"]) == 0
    assert "consensus warmup 2 CHOCO-GOSSIP rounds" in capsys.readouterr().out


def _launch(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *_SMOKE, *args], env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_per_rank_launcher_checkpoints_and_resumes(tmp_path):
    """4 ranks save every step (each its own row, rank 0 the manifest and
    the GC); 2 ranks resume the step-2 checkpoint elastically, and the
    stacked engine resumes it exactly."""
    d = str(tmp_path / "ck")
    r = _launch("--mesh", "4x1", "--simulate-devices", "4", "--steps", "2",
                "--checkpoint-dir", d, "--checkpoint-every", "1",
                "--keep-checkpoints", "1")
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(d)) == ["step2"]
    assert sorted(f for f in os.listdir(f"{d}/step2") if f.endswith(".npz")) \
        == [f"shards-p{r:05d}.npz" for r in range(4)]
    assert manifest.read_manifest(f"{d}/step2").process_count == 4
    r = _launch("--mesh", "2x1", "--simulate-devices", "2", "--steps", "3",
                "--resume", f"{d}/step2")
    assert r.returncode == 0, r.stderr
    assert "n_nodes=4 topology=ring -> n_nodes=2" in r.stdout
    assert _steps(r.stdout) == [3]
    r = _launch("--mesh", "4x1", "--steps", "3", "--resume", f"{d}/step2")
    assert r.returncode == 0, r.stderr
    assert "elastic" not in r.stdout and _steps(r.stdout) == [3]
