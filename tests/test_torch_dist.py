"""The per-rank gossip engine on the CPU: one process per gossip node over
gloo, held against the stacked engine and the JAX package.

* the collective-layer probe: its plain version against the JAX probe's
  body (``pallas_call`` in interpret mode), bit for bit; and
  ``probe_collectives`` on 4 gloo ranks;
* the exchange alone: 4 ranks against ``make_choco_exchange`` on the same
  x_half, x_hat and s for every ported compressor (identity with and
  without exact small leaves, top_k, block_top_k, rand_k, QSGD, sign,
  randomized gossip) at gossip_steps 1 and 2, with the draws each engine
  makes itself (node i's are the same in both): x, x_hat and s bit-equal,
  and the bytes each rank sent equal to what the ``BucketSpec`` says its
  payloads have;
* three trainer steps on 4 ranks against the stacked trainer and the JAX
  trainer (``test_torch_slice.py``'s reference run and tolerances, QSGD
  with the JAX dither injected, 2 gossip rounds);
* the launcher: ``--simulate-devices 4 --mesh 4x1 --device cpu`` trains
  and prints the engine and the probe record; mismatched counts are
  refused before torch is imported;
* a rank that raises fails the run within its deadline.

Every spawn meets in a ``FileStore`` under ``tmp_path`` (no fixed port)
and has a deadline; the CPU reductions of the exchange run on
``THREADS`` threads in every process, since a sum over more threads adds
in another order.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.comm import gossip, packing, schedule
from repro_torch.comm.packing import (bucket_wire_nbytes, from_wire,
                                      make_bucket_spec, pack_leaves, to_wire)
from repro_torch.configs.base import get_config
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.kernels import dispatch, ref
from repro_torch.launch import env, mesh
from repro_torch.models.transformer import Model

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N = 4
THREADS = 2
DEADLINE_S = 120.0
GROUP_TIMEOUT_S = 60.0

#: (compressor, kwargs, exact_small_leaves) of the exchange cases
EXCHANGE_CASES = (
    ("identity", {}, False), ("identity", {}, True),
    ("top_k", {"fraction": 0.05}, False),
    ("block_top_k", {"fraction": 0.05}, False),
    ("rand_k", {"fraction": 0.05}, False), ("qsgd", {"s": 16}, False),
    ("sign", {}, False), ("randomized_gossip", {"p": 0.5}, False))
GOSSIP_STEPS = (1, 2)
#: per-node leaf shapes: several buckets (max 8192 elements each), a leaf
#: bigger than a bucket, ragged sizes and, with exact_small_leaves, an
#: exact bucket
LEAF_SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000))
EXCHANGE_SEED = 1234


def _join(rank, store, timeout_s=GROUP_TIMEOUT_S):
    torch.set_num_threads(THREADS)
    return mesh.make_node_group(N, "cpu", env.file_rendezvous(store, rank, N),
                                timeout_s=timeout_s)


def _exchange_case(index):
    """Compressor, spec, schedules, gamma and node-stacked (x_half, x_hat,
    s) of exchange case ``index``, the same in every process."""
    name, kw, exact = EXCHANGE_CASES[index]
    comp = make_compressor(name, **kw)
    spec = make_bucket_spec(
        [torch.empty(s, device="meta") for s in LEAF_SHAPES],
        align=gossip._pack_align(comp), exact_small_leaves=exact,
        small_leaf_threshold=4224, max_bucket_elems=8192)
    rng = np.random.default_rng(index)
    bufs = [pack_leaves(spec, [torch.from_numpy(
        scale * rng.standard_normal((N,) + s).astype(np.float32))
        for s in LEAF_SHAPES]) for scale in (1.0, 0.5, 0.1)]
    sched = schedule.compile_schedule(topology.make_topology("ring", N))
    return comp, spec, (sched,), 0.25, bufs


def _exchange_rank(rank, store, out_dir):
    group = _join(rank, store)
    results = {}
    for i in range(len(EXCHANGE_CASES)):
        comp, spec, scheds, gamma, bufs = _exchange_case(i)
        for k in GOSSIP_STEPS:
            ex = gossip.make_dist_choco_exchange(
                spec=spec, schedules=scheds, compressor=comp, gamma=gamma,
                gossip_steps=k, group=group)
            x, x_hat, s = [[b[rank:rank + 1].clone() for b in part]
                           for part in bufs]
            before = group.bytes_sent
            ex(x, x_hat, s, seed=EXCHANGE_SEED)
            results[(i, k)] = (x, x_hat, s, group.bytes_sent - before,
                               ex.payload_bytes)
    results["probe"] = dataclasses.asdict(ex.probe)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def _probe_rank(rank, store, out_dir):
    group = _join(rank, store)
    dispatch.reset_launch_counts()
    record = dispatch.probe_collectives(group)
    again = dispatch.probe_collectives(group)           # cached
    torch.save({"record": dataclasses.asdict(record), "same": again is record,
                "bytes": group.bytes_sent,
                "launches": dispatch.launch_counts()["probe_scale"]},
               os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def _raising_rank(rank, store):
    group = _join(rank, store, timeout_s=30.0)
    if rank == 2:
        raise RuntimeError("rank 2 fails on purpose")
    dispatch.probe_collectives(group)       # blocks on rank 2's payload
    mesh.close_node_group()


def _sleeping_rank(rank, seconds):
    time.sleep(seconds)


def _spawn(fn, tmp_path, *extra):
    store = str(tmp_path / "store")
    mesh.spawn_ranks(fn, N, (store, *extra), deadline_s=DEADLINE_S)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(N)] if extra else None


# -- the probe ------------------------------------------------------------------

def test_probe_plain_version_matches_the_jax_probe_body():
    """The JAX probe's ``kern`` (``o = x * 2.0``) through ``pallas_call``
    in interpret mode, on the probe's seeded (8, 128) input."""
    import jax
    from jax.experimental import pallas as pl

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    x = dispatch._probe_block(3)
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, np.float32),
        interpret=True)(x.numpy())
    got = dispatch.probe_scale(x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)


def test_probe_collectives_on_four_gloo_ranks(tmp_path):
    for r in _spawn(_probe_rank, tmp_path, str(tmp_path)):
        assert r["record"] == {"torch_version": torch.__version__,
                               "backend": "gloo", "world_size": N,
                               "device_type": "cpu", "staged": False,
                               "intact": True}
        assert r["same"]
        assert r["bytes"] == 8 * 128 * 4         # one hop of the block
        assert r["launches"] == 0                # CPU: the plain version


class _LoopbackGroup:
    """Rank 0 of 2 with a stand-in transport: it delivers what rank 1 would
    send (twice rank 1's block), with one bit flipped if ``flip``."""
    rank, size, backend, staged = 0, 2, "gloo", False
    device = torch.device("cpu")

    def __init__(self, flip):
        self.flip = flip

    def sendrecv(self, send, dst, src):
        assert (dst, src) == (1, 1) and send.numel() == 8 * 128 * 4
        got = ref.probe_scale_ref(dispatch._probe_block(src))
        got = got.reshape(-1).view(torch.uint8).clone()
        if self.flip:
            got[5] ^= 1
        return got


def test_probe_raises_when_the_transport_corrupts_a_payload():
    assert dispatch.probe_collectives(_LoopbackGroup(flip=False)).intact
    with pytest.raises(RuntimeError, match="not twice"):
        dispatch.probe_collectives(_LoopbackGroup(flip=True))


# -- the exchange alone -------------------------------------------------------

def test_dist_exchange_bit_equal_to_stacked(tmp_path):
    ranks = _spawn(_exchange_rank, tmp_path, str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for i, (name, kw, exact) in enumerate(EXCHANGE_CASES):
            comp, spec, scheds, gamma, bufs = _exchange_case(i)
            assert any(b.exact for b in spec.buckets) == exact
            for k in GOSSIP_STEPS:
                x, x_hat, s = [[b.clone() for b in part] for part in bufs]
                gossip.make_choco_exchange(
                    spec=spec, schedules=scheds, compressor=comp, gamma=gamma,
                    gossip_steps=k)(x, x_hat, s, seed=EXCHANGE_SEED)
                per_step = k * scheds[0].n_rounds * sum(
                    bucket_wire_nbytes(spec, comp))
                for r, res in enumerate(ranks):
                    got_x, got_hat, got_s, sent, payload = res[(i, k)]
                    for want, got in ((x, got_x), (x_hat, got_hat),
                                      (s, got_s)):
                        for b, g in zip(want, got):
                            assert torch.equal(g[0], b[r]), (name, exact, k, r)
                    assert payload == bucket_wire_nbytes(spec, comp)
                    assert sent == per_step, (name, k, sent, per_step)
                # the exchange moved the iterates
                assert not torch.equal(x[0], bufs[0][0])
    finally:
        torch.set_num_threads(threads)
    assert ranks[0]["probe"]["intact"] and ranks[0]["probe"]["world_size"] == N


@pytest.mark.parametrize("i", range(len(EXCHANGE_CASES)))
def test_wire_form_round_trips_at_the_spec_size(i):
    """A payload's wire bytes rebuild the payload exactly, and their count
    is what ``bucket_wire_nbytes`` reads off the spec."""
    comp, spec, _, _, (x, _, _) = _exchange_case(i)
    sizes = bucket_wire_nbytes(spec, comp)
    for bucket, buf, nbytes in zip(spec.buckets, x, sizes):
        (payload,), (q,) = packing.compress_bufs(
            comp, spec, (bucket,), (buf[2:3],), seed=5, nodes=(2,))
        raw = to_wire(payload)
        assert raw.dtype == torch.uint8 and raw.numel() == nbytes
        back = from_wire(raw.clone(), payload)
        assert type(back) is type(payload)
        assert torch.equal(packing.bucket_dense(back, bucket), q)


@pytest.mark.parametrize("name,kw", [("qsgd", {"s": 16}),
                                     ("rand_k", {"fraction": 0.05}),
                                     ("randomized_gossip", {"p": 0.5})])
def test_node_draws_do_not_depend_on_the_other_rows(name, kw):
    """Node i's draw alone equals row i of the draw for all nodes: what
    lets one rank reproduce the stacked engine's row."""
    comp, spec, _, _, (x, _, _) = _exchange_case(0)
    comp = make_compressor(name, **kw)
    bucket = spec.buckets[0]
    slots = spec.bucket_slots(0)
    every = packing.draw(comp, bucket, slots, x[0], 99)
    for i in range(N):
        alone = packing.draw(comp, bucket, slots, x[0][i:i + 1], 99, (i,))
        assert torch.equal(alone[0], every[i])
    if name != "randomized_gossip":         # one coin per node may agree
        assert not torch.equal(every[0], every[1])


# -- the trainer --------------------------------------------------------------

def _trainer_rank(rank, store, out_dir, ref_path):
    from repro_torch.convert import params_from_jax
    from test_torch_slice import BPN, SEQ, STEPS, _port_trainer, _tree
    group = _join(rank, store)
    ref = np.load(ref_path)
    tr = dataclasses.replace(_port_trainer("qsgd", 16, 2, False), group=group)
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0"), node=rank))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0, node=rank)
    mets = []
    for j in range(STEPS):
        draws = (lambda t, b, j=j: torch.from_numpy(
            ref[f"xi:{j}:{t}:{b}"][rank:rank + 1]))
        m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
        mets.append([m["loss"], m["lr"], m["grad_norm"],
                     m["node_loss_spread"], m["wire_bytes"]])
    torch.save({"mets": mets, "x": state.x, "x_hat": state.x_hat,
                "s": state.s, "sent": tr.exchange.payload_bytes},
               os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def test_dist_trainer_matches_stacked_and_jax(tmp_path, tmp_path_factory):
    """3 steps of QSGD(16) gossip, 2 rounds per step, on 4 ranks: against
    the JAX trainer with ``test_torch_slice.py``'s tolerances (the same
    reference run as its qsgd-16-2 case, made once per pytest run), and
    against the stacked trainer (losses 1e-6 relative, x 1e-6)."""
    from repro_torch.convert import params_from_jax
    from test_torch_slice import (BPN, SEQ, STEPS, _port_trainer, _tree,
                                  check_against_jax, jax_reference_path)
    ref_path = str(jax_reference_path(tmp_path_factory, "qsgd", 16, 2, False))
    ref = np.load(ref_path)
    ranks = _spawn(_trainer_rank, tmp_path, str(tmp_path), ref_path)
    tr = _port_trainer("qsgd", 16, 2, False)
    cat = lambda tag: [torch.cat([r[tag][b] for r in ranks])
                       for b in range(tr.spec.n_buckets)]
    state = types.SimpleNamespace(x=cat("x"), x_hat=cat("x_hat"), s=cat("s"))
    mets = ranks[0]["mets"]
    for r in ranks[1:]:
        assert r["mets"] == mets            # the all-reduced metrics agree
    check_against_jax(tr, state, [m[:3] for m in mets], ref, "qsgd")
    per_step = 2 * 2 * sum(ranks[0]["sent"])     # 2 rounds x 2 neighbours
    assert all(m[4] == per_step for m in mets)

    stacked = tr.state_from_params(params_from_jax(_tree(ref, "x0")))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    for j in range(STEPS):
        draws = lambda t, b, j=j: torch.from_numpy(ref[f"xi:{j}:{t}:{b}"])
        m = tr.step(stacked, tr.batch_to_device(batches()), draws=draws)
        np.testing.assert_allclose(mets[j][0], m["loss"], rtol=1e-6)
        np.testing.assert_allclose(mets[j][2], m["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(mets[j][3], m["node_loss_spread"],
                                   atol=1e-5)
    for a, b in zip(state.x, stacked.x):
        assert float((a - b).abs().max()) <= 1e-6


# -- the launcher ---------------------------------------------------------------

def _launch(*args, environ=None, timeout=180):
    run_env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run_env.update(environ or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "qwen3-1.7b", "--smoke", *args],
                          env=run_env, capture_output=True, text=True,
                          timeout=timeout)


def test_launcher_runs_the_per_rank_engine_on_cpu():
    r = _launch("--simulate-devices", "4", "--mesh", "4x1", "--device", "cpu",
                "--steps", "2", "--seq-len", "32", "--batch-per-node", "2",
                "--compressor", "qsgd", "--qsgd-s", "16")
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "engine=per-rank" in out and "nodes=4" in out
    assert "transport backend=gloo ranks=4 device=cpu" in out
    assert "probe CollectiveProbe(" in out and "intact=True" in out
    steps = [line for line in out.splitlines()
             if line.startswith("[train] step")]
    assert len(steps) == 2                      # rank 0 prints, alone
    losses = [float(line.split("loss ")[1].split()[0]) for line in steps]
    assert all(np.isfinite(losses))
    assert all(" B sent by rank 0" in line for line in steps)
    # rank 0's launches: none on the CPU, where the plain versions run
    launched = [line for line in out.splitlines()
                if line.startswith("[train] kernel launches on rank 0 ")]
    assert len(launched) == 1
    assert set(json.loads(launched[0].split(" rank 0 ")[1]).values()) == {0}


def test_launcher_prints_the_stacked_engine_by_default():
    r = _launch("--mesh", "2x1", "--device", "cpu", "--steps", "1",
                "--seq-len", "16", "--batch-per-node", "1")
    assert r.returncode == 0, r.stderr
    assert "engine=stacked" in r.stdout and "[train] probe" not in r.stdout
    assert "[train] kernel launches {" in r.stdout


@pytest.mark.parametrize("args,environ,message", [
    (["--simulate-devices", "4", "--mesh", "2x1"], None,
     "--simulate-devices 4 must match --mesh 2x1"),
    (["--simulate-devices", "2", "--mesh", "2x1"],
     {"RANK": "0", "WORLD_SIZE": "2"}, "under torchrun leave it out"),
    (["--mesh", "4x1"], {"RANK": "0", "WORLD_SIZE": "2"},
     "torchrun started 2 ranks for --mesh 4x1"),
])
def test_launcher_refuses_mismatched_ranks_before_importing_torch(
        args, environ, message):
    code = ("import sys; from repro_torch.launch.train import main\n"
            "try:\n    main(sys.argv[1:])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    run_env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   **(environ or {}))
    r = subprocess.run([sys.executable, "-c", code, "--arch", "qwen3-1.7b",
                        "--smoke", *args], env=run_env, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
    assert message in r.stderr


def test_a_rank_that_raises_fails_the_run_within_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 2 fails on purpose"):
        mesh.spawn_ranks(_raising_rank, N, (str(tmp_path / "store"),),
                         deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < DEADLINE_S


def test_launcher_spawn_deadline_grows_with_the_steps():
    from repro_torch.launch import train
    assert train.spawn_deadline_s(1) == 2 * mesh.DEFAULT_TIMEOUT_S
    assert train.spawn_deadline_s(100) == 101 * mesh.DEFAULT_TIMEOUT_S


def test_spawn_deadline_kills_every_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="every rank was killed"):
        mesh.spawn_ranks(_sleeping_rank, 2, (60,), deadline_s=3)
    assert time.monotonic() - t0 < 30


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("device,cards,local,want", [
    ("cuda", 4, 4, ("nccl", False)), ("cuda", 8, 4, ("nccl", False)),
    ("cuda", 1, 4, ("gloo", True)), ("cuda", 2, 4, ("gloo", True)),
    ("cpu", 0, 4, ("gloo", False)), ("cpu", 4, 4, ("gloo", False)),
])
def test_transport_rule(device, cards, local, want):
    assert mesh.transport_for(device, cards, local) == want


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_round_peers_agree_with_the_gather_sources(n):
    sched = schedule.compile_schedule(topology.make_topology("ring", n))
    for rnd in sched.rounds:
        src = rnd.sources(n)
        for rank in range(n):
            dst, got_src = rnd.peers(rank)
            assert got_src == src[rank] and src[dst] == rank


def test_rendezvous_from_torchrun_and_file(tmp_path):
    assert env.torchrun_rendezvous({}) is None
    rdv = env.torchrun_rendezvous({"RANK": "3", "WORLD_SIZE": "4",
                                   "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"})
    assert rdv == env.Rendezvous(3, 4, 1, 2, "env://")
    f = env.file_rendezvous(str(tmp_path / "s"), 2, 4)
    assert (f.rank, f.world_size, f.local_rank, f.local_world_size) == \
        (2, 4, 2, 4)
    assert f.init_method == "file://" + str(tmp_path / "s")


def test_one_rank_reproduces_its_row_of_weights_batches_and_params():
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = Model(cfg)
    every = model.init(N, 7, "cpu")
    alone = model.init(N, 7, "cpu", nodes=(2,))
    for path, p in every.items():
        assert torch.equal(alone[path][0], p[2]), path
    assert not torch.equal(every["embed/tok"][0], every["embed/tok"][1])
    full = make_lm_batch_fn(cfg, 16, 2, N, 1.0)
    row = make_lm_batch_fn(cfg, 16, 2, N, 1.0, node=3)
    for _ in range(2):
        a, b = full(), row()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(b[key][0], a[key][3])
    from repro_torch.convert import params_from_jax, params_to_jax
    tree = params_to_jax(every)
    sliced = params_from_jax(tree, node=1)
    for path, p in every.items():
        assert torch.equal(sliced[path], p[1:2])
