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
* bf16 EF state (``test_torch_state_bf16.py``): the delta x - x_hat is
  rounded to bf16 before it is compressed, and where it lies within the
  ulp-level gradient difference of a bf16 rounding boundary, its rounding
  flips.  That q, and so x_hat, moves by one bf16 step of the delta and
  the s of the node and its neighbours by at most as much, and x by gamma
  times that.  At most 1 in 10^5 elements of x, x_hat and s each may do
  so; each such difference is bounded by two bf16 steps of the leaf's
  largest initial |x| (2^-6 of it), times the largest bucket gamma for x
  (above the 1e-6).  Measured on 5,773,312 elements per state: top_k
  0.05 on the ring, 2 x_hat and 6 s elements (at most 9.8e-4) and 2 x
  elements (1.07e-6); on star, 1 and 3 (x within 1e-6); QSGD, none.
"""
import collections.abc
import dataclasses
import fcntl
import os
import shutil
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
#: the link-failure reference runs' edge drop probability
PROCESS_DROP = 0.3
#: the bounded-staleness reference runs' tau and straggler link
PROCESS_TAU = 2
PROCESS_STRAGGLERS = "0-1"


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


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends (the files that
    import this fixture use it too): their tests write checkpoints and
    launcher runs of up to a gigabyte, and pytest keeps the temporary
    directories of the last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# -- the JAX reference runs --------------------------------------------------------
#
# Each reference run is a JAX script run once per pytest run in a
# subprocess (:func:`make_reference`), its npz files written by ``savez``
# (:data:`REFERENCE_SAVEZ`) and read through :class:`Reference`.  They
# share one directory, ``jax_reference`` beside the xdist workers' base
# temporary directories.  ``savez`` keeps what it writes small without
# dropping an array: an array with a tenth or more of zeros (the EF states
# x_hat and s), or of any type but float, is deflated; a large float array
# (the weights, the dither) is stored once under its content hash in
# ``jax_reference/blobs`` and the npz holds its name (every trainer run
# starts from the same weights, and the QSGD runs share their first
# rounds' dither).

#: the npz entry of an array stored in ``blobs``: this prefix and its path
BLOB = "@jax-reference-blob:"
#: the float arrays of at least this many bytes go to ``blobs``
BLOB_BYTES = 1 << 20

REFERENCE_SAVEZ = textwrap.dedent(f"""
    def savez(path, **arrays):
        import hashlib, io, os, zipfile
        import numpy as np

        def npy(a):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, a, allow_pickle=False)
            return buf.getvalue()

        with zipfile.ZipFile(path, "w", allowZip64=True) as zf:
            for name, a in arrays.items():
                a = np.asarray(a)
                data = npy(a)
                if a.dtype.kind not in "fc" or (
                        a.size and np.count_nonzero(a) <= 0.9 * a.size):
                    zf.writestr(name + ".npy", data, zipfile.ZIP_DEFLATED, 1)
                    continue
                if a.nbytes >= {BLOB_BYTES}:
                    blob = os.path.join(os.environ["JAX_REFERENCE_BLOBS"],
                                        hashlib.sha1(data).hexdigest()
                                        + ".npy")
                    if not os.path.exists(blob):
                        part = f"{{blob}}.{{os.getpid()}}.part"
                        with open(part, "wb") as f:
                            f.write(data)
                        os.replace(part, blob)
                    data = npy(np.array({BLOB!r} + blob))
                zf.writestr(name + ".npy", data, zipfile.ZIP_STORED)
""")


def reference_root(tmp_path_factory):
    """The run's shared ``jax_reference`` directory (and its ``blobs``)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "jax_reference"
    (root / "blobs").mkdir(parents=True, exist_ok=True)
    return root


def _remove(path):
    if path.is_dir():
        shutil.rmtree(path, ignore_errors=True)
    elif path.exists():
        path.unlink()


def _remove_parts(root, part, pid):
    """What a failed reference run leaves: its ``part`` and the blobs that
    its process ``pid`` had not finished (``savez`` names them by pid)."""
    _remove(part)
    for blob in (root / "blobs").glob(f"*.{pid}.part"):
        blob.unlink()


def make_reference(tmp_path_factory, name, script, argv, timeout=900):
    """The path of the reference ``name`` in :func:`reference_root`, made
    once per pytest run: tests that need it share it, across xdist workers
    too (they take turns under a file lock).  ``script`` runs in a
    subprocess on the JAX package (``savez`` defined before it) with the
    arguments ``argv(part)``, and writes ``part``: a directory when
    ``name`` has no ``.npz`` suffix, else one npz file.  ``part`` becomes
    the reference only when the script exits 0; otherwise it and the
    blobs the script left half written are removed, and the run fails
    with the script's output and the disk's free space."""
    root = reference_root(tmp_path_factory)
    out = root / name
    part = root / (name + ".part")
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        _remove(part)                     # left by a run that was killed
        if out.suffix != ".npz":
            part.mkdir()
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu", JAX_REFERENCE_BLOBS=str(root / "blobs"))
        env.pop("XLA_FLAGS", None)
        proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE_SAVEZ + script,
             *map(str, argv(part))], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except BaseException:
            proc.kill()
            proc.wait()
            _remove_parts(root, part, proc.pid)
            raise
        if proc.returncode != 0:
            _remove_parts(root, part, proc.pid)
            free = shutil.disk_usage(root).free / 2 ** 30
            raise RuntimeError(
                f"the JAX reference run {name} exited {proc.returncode}, "
                f"with {free:.2f} GiB free on {root}\nSTDOUT:\n{stdout}\n"
                f"STDERR:\n{stderr}")
        os.replace(part, out)
    return out


class Reference(collections.abc.Mapping):
    """A reference npz written by ``savez``, as ``np.load`` reads it, with
    the arrays stored in ``blobs`` read from there."""

    def __init__(self, path):
        self._npz = np.load(path)
        self.files = self._npz.files

    def __getitem__(self, key):
        a = self._npz[key]
        if a.dtype.kind == "U" and a.ndim == 0 and str(a).startswith(BLOB):
            return np.load(str(a)[len(BLOB):])
        return a

    def __iter__(self):
        return iter(self.files)

    def __len__(self):
        return len(self.files)


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

    (comp, arg, k, exact, steps, seq, bpn, out, topology, sdt, engine,
     process, drop, tau, stragglers, mode, arch, dtype) = sys.argv[1:]
    process = None if process == "none" else process
    packed = not engine.startswith("per-leaf")
    k, steps, seq, bpn = int(k), int(steps), int(seq), int(bpn)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
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
                          kernel_backend="jnp", state_dtype=sdt,
                          exact_small_leaves=exact == "exact",
                          packed_gossip=packed,
                          pipeline_gossip=engine.endswith("pipelined"),
                          topology_process=process,
                          edge_drop_prob=(float(drop) if process == "linkfail"
                                          else 0.1),
                          **({"max_staleness": int(tau),
                              "straggler_edges": stragglers}
                             if process == "staleness" else {})),
        mesh=mesh, n_nodes=4, optimizer=make_optimizer("momentum"),
        lr_fn=cosine_schedule(0.1, warmup=steps // 10 + 1, total=steps),
        mode=mode)
    from repro.comm.gossip import _resolve_bucket_gammas
    res = {"gamma": np.array([tr.gamma] + (_resolve_bucket_gammas(
        tr.gamma_spec, tr._bucket_spec(), tr.compressor)
        if packed and process is None and mode == "choco" else []))}

    if packed and mode == "choco":
        spec = tr._bucket_spec()
        res["spec_buckets"] = np.array([[b.size, b.logical, int(b.exact)]
                                        for b in spec.buckets])
        res["spec_slots"] = np.array([[sl.bucket, sl.offset, sl.size]
                                      for sl in spec.slots])

    def save(tag, tree):
        # bf16 state is saved as the f32 values it holds (exact)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[tag + ":" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                     for k in path)] = np.asarray(
                leaf.astype(jnp.float32))

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
    for j in range(steps if process else 0):
        # the process's sample of step j, gossip round t (exchange key
        # fold_in(key, j))
        for t in range(k):
            ek = jax.random.fold_in(key, j)
            res[f"sample:{j}:{t}"] = np.asarray(
                tr.process.round_index(ek, t) if process == "matching"
                else tr.process.edge_delays(ek, t) if process == "staleness"
                else tr.process.edge_mask(ek, t))
    save("x", state.params)
    save("x_hat", state.x_hat)
    save("s", state.s)
    if state.psw is not None:
        res["psw"] = np.asarray(state.psw)
    if comp == "qsgd" and not packed:
        # the per-leaf engine's dither: node i of step j, gossip round t,
        # leaf l (tree order) draws uniform(split(fold_in(round_key, 0),
        # leaves)[l]), round_key as below
        fold = jax.random.fold_in
        paths = ["/".join(k.key for k in p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(state.params)[0]]
        for j in range(steps):
            for t in range(k):
                keys = []
                for i in range(4):
                    rk = fold(fold(key, j), i)
                    rk = rk if t == 0 else fold(rk, t)
                    keys.append(jax.random.split(fold(rk, 0), len(paths)))
                for l, (path, leaf) in enumerate(zip(
                        paths, jax.tree_util.tree_leaves(state.params))):
                    res[f"xi:{j}:{t}:{path}"] = np.stack([np.asarray(
                        jax.random.uniform(keys[i][l], (leaf[0].size,)))
                        for i in range(4)])
    elif comp == "qsgd":
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
    savez(out, **res)
""")


def jax_reference_path(tmp_path_factory, comp, arg, k, exact,
                       topology="ring", state_dtype="float32",
                       engine="packed", process=None, mode="choco",
                       arch="qwen3-1.7b", dtype="float32", steps=STEPS):
    """The path of the JAX reference run of one case (on the ring unless
    ``topology`` names another graph or a comma-separated sequence; f32
    EF state unless ``state_dtype`` says "bfloat16"; the packed engine
    unless ``engine`` says "per-leaf", "pipelined" or
    "per-leaf-pipelined"; the static graph unless ``process`` names a
    topology process, "matching", "linkfail" at PROCESS_DROP, or
    "staleness" at PROCESS_TAU with the PROCESS_STRAGGLERS link, whose
    samples the run saves as ``sample:<step>:<round>``; the choco mode
    unless ``mode`` says "pushsum", whose run saves ``psw``; the smoke
    qwen3 decoder in f32 for STEPS steps unless ``arch``, ``dtype`` (the
    compute dtype) or ``steps`` say otherwise; the packed choco runs save
    their bucket spec), made once per pytest run: tests that need the
    same case share it, across xdist workers too (they meet in the run's
    common temporary directory and take turns under a file lock)."""
    tag = "" if topology == "ring" else "_" + topology.replace(",", "+")
    if state_dtype != "float32":
        tag += "_" + state_dtype
    if engine != "packed":
        tag += "_" + engine
    if process is not None:
        tag += "_" + process
    if mode != "choco":
        tag += "_" + mode
    if arch != "qwen3-1.7b":
        tag += "_" + arch
    if dtype != "float32":
        tag += "_compute-" + dtype
    if steps != STEPS:
        tag += f"_steps{steps}"
    return make_reference(
        tmp_path_factory,
        f"jax_{comp}_{arg}_{k}_{'exact' if exact else '-'}{tag}.npz",
        _JAX_REFERENCE,
        lambda part: [comp, arg, k, "exact" if exact else "-", steps, SEQ,
                      BPN, part, topology, state_dtype, engine,
                      process or "none", PROCESS_DROP, PROCESS_TAU,
                      PROCESS_STRAGGLERS, mode, arch, dtype],
        timeout=600)


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


def _port_trainer(comp, arg, k, exact, topology="ring",
                  state_dtype="float32", engine="packed", process=None,
                  mode="choco", arch="qwen3-1.7b", dtype="float32",
                  steps=STEPS):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    if comp == "qsgd":
        kw = (("s", arg),)
    elif comp in ("sign", "identity"):
        kw = ()
    else:
        kw = (("fraction", arg),)
    return DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                                            topology=topology, gossip_steps=k,
                                            exact_small_leaves=exact,
                                            state_dtype=state_dtype,
                                            packed_gossip=not engine.startswith(
                                                "per-leaf"),
                                            pipeline_gossip=engine.endswith(
                                                "pipelined"),
                                            topology_process=process,
                                            edge_drop_prob=(
                                                PROCESS_DROP
                                                if process == "linkfail"
                                                else 0.1),
                                            **({"max_staleness": PROCESS_TAU,
                                                "straggler_edges":
                                                    PROCESS_STRAGGLERS}
                                               if process == "staleness"
                                               else {})),
        n_nodes=N, optimizer=momentum_sgd(),
        lr_fn=cosine_schedule(0.1, warmup=steps // 10 + 1, total=steps),
        device="cpu", mode=mode)


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
    ref = Reference(jax_reference_path(tmp_path_factory, comp, arg, k,
                                            exact))
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


def check_against_jax(tr, state, mets, ref, comp, x_atol=1e-6,
                      bf16_ulp=False):
    """Metrics and state after the steps against the JAX trainer's, with
    the tolerances of this module's docstring (x_hat and s where the
    state has them; x within ``x_atol``).  ``bf16_ulp``: an x_hat or s
    outlier may also be one bf16 step of its own value (a flipped bf16
    rounding in a leaf initialised to zero, whose initial magnitude bounds
    nothing), still within the outlier count."""
    mets = np.array(mets)
    np.testing.assert_allclose(mets[:, 0], ref["metrics"][:, 0], rtol=1e-6)
    np.testing.assert_array_equal(mets[:, 1], ref["metrics"][:, 1])
    np.testing.assert_allclose(mets[:, 2], ref["metrics"][:, 2], rtol=1e-5)

    flip_bound = 0.0
    bf16 = state.x_hat is not None and state.x_hat[0].dtype == torch.bfloat16
    x0 = (params_from_jax(_tree(ref, "x0")) if comp == "sign" or bf16
          else None)
    if comp == "sign":
        flip_bound = 8 * max(float(v.abs().mean()) for v in x0.values())
    gamma = max(tr.exchange.gammas) if bf16 else 0.0
    total = sum(b.numel() for b in state.x)
    for tag, bufs in (("x", state.x), ("x_hat", state.x_hat), ("s", state.s)):
        if bufs is None:                 # not allocated in the exact modes
            continue
        got = dict(zip(tr.paths, unpack_leaves(tr.spec, bufs)))
        want = params_from_jax(_tree(ref, tag))
        outliers = 0
        for path in tr.paths:
            a, b = got[path].float().numpy(), want[path].numpy()
            diff = np.abs(a - b)
            bf16_step = 2.0 ** -6 * float(x0[path].abs().max()) if bf16 else 0
            if tag == "x":
                if not bf16:
                    assert diff.max() <= x_atol, path
                    continue
                bad = diff > x_atol
                bound = x_atol + gamma * bf16_step
            else:
                bad = diff > 1e-6 + 1e-5 * np.abs(b)
                bound = max(flip_bound, bf16_step)
                if bf16_ulp and bad.any():
                    ulp = 2.0 ** (np.floor(np.log2(np.abs(b[bad]))) - 7)
                    bound = np.maximum(bound, ulp)
            outliers += int(bad.sum())
            if bad.any():
                assert np.all(diff[bad] <= bound), (tag, path, diff.max())
        assert outliers <= total // 100_000, (tag, outliers)


# -- the reference store ---------------------------------------------------------

_STORE_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    rng = np.random.default_rng(0)
    big = rng.standard_normal(300_000).astype(np.float32)
    sparse = np.where(rng.random(300_000) < 0.5, big, 0).astype(np.float32)
    savez(sys.argv[1], big=big, again=big.copy(), sparse=sparse,
          codes=(big > 0).astype(np.int8), small=big[:10],
          name=np.array("QuantPayload"))
""")


def test_reference_store_round_trips_and_shares_equal_arrays(
        tmp_path_factory):
    """``savez`` and ``Reference``: every array comes back as it was
    written; two equal large float arrays take one blob; the sparse and
    integer ones are deflated in the npz, the small one stored there."""
    path = make_reference(tmp_path_factory, "store_round_trip.npz",
                          _STORE_SCRIPT, lambda part: [part])
    ref = Reference(path)
    big = np.random.default_rng(0).standard_normal(300_000).astype(np.float32)
    np.testing.assert_array_equal(ref["big"], big)
    np.testing.assert_array_equal(ref["again"], big)
    assert sorted(ref) == ["again", "big", "codes", "name", "small", "sparse"]
    assert str(ref["name"]) == "QuantPayload"
    np.testing.assert_array_equal(ref["codes"], (big > 0).astype(np.int8))
    raw = np.load(path)
    assert str(raw["big"]) == str(raw["again"])       # one blob, by content
    assert str(raw["big"]).startswith(BLOB)
    assert raw["sparse"].shape == (300_000,) and raw["small"].shape == (10,)
    import zipfile
    with zipfile.ZipFile(path) as zf:
        kinds = {i.filename: i.compress_type for i in zf.infolist()}
    assert kinds["sparse.npy"] == kinds["codes.npy"] == zipfile.ZIP_DEFLATED
    assert kinds["small.npy"] == kinds["big.npy"] == zipfile.ZIP_STORED


def test_failed_reference_run_leaves_no_part(tmp_path_factory):
    """A reference script that writes its part and half a blob and fails:
    the run raises with the script's stderr and the free space, and leaves
    neither the part, the blob's part nor the reference; the next attempt
    runs the script again."""
    script = ("import os, sys\nopen(sys.argv[1], 'w').write('half')\n"
              "open(os.path.join(os.environ['JAX_REFERENCE_BLOBS'], "
              "f'failing.npy.{os.getpid()}.part'), 'w').write('half')\n"
              "sys.exit('no space for the reference')\n")
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"(?s)exited 1, with "
                           r"[0-9.]+ GiB free.*no space for the reference"):
            make_reference(tmp_path_factory, "failing.npz", script,
                           lambda part: [part])
        root = reference_root(tmp_path_factory)
        assert not (root / "failing.npz").exists()
        assert not (root / "failing.npz.part").exists()
        assert not list((root / "blobs").glob("failing.npy.*"))


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
    (["--compressor", "sign", "--mode", "pushsum", "--topology-process",
      "matching"], "--mode pushsum owns its directed schedule"),
    (["--compressor", "sign", "--pipeline-gossip", "--topology", "ring,star",
      "--gossip-steps", "2"], "--pipeline-gossip needs one static schedule"),
    (["--compressor", "sign", "--topology-process", "staleness",
      "--mode", "plain"], "--topology-process staleness requires --mode "
                          "choco"),
    (["--compressor", "sign", "--gossip-engine", "leaf"],
     "--gossip-engine 'leaf'"),
    (["--compressor", "sign", "--state-dtype", "float16"], "--state-dtype"),
    (["--compressor", "sign", "--kernel-backend", "pallas"],
     "--kernel-backend"),
    (["--compressor", "sign", "--topology", "directed_ring"],
     "--topology 'directed_ring' is directed (column-stochastic); --mode "
     "choco assumes a symmetric W"),
    (["--compressor", "sign", "--mesh", "4x2"], "model extent 2"),
    (["--compressor", "sign", "--keep-checkpoints", "2"],
     "--keep-checkpoints requires --checkpoint-dir"),
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
