"""The per-leaf gossip engine (``--gossip-engine per-leaf``,
``ChocoConfig(packed_gossip=False)``) in the port, held against the JAX
package's per-leaf engine on the CPU.

The JAX engine (``make_gossip_exchange(packed=False)``, its ``local_fn``)
compresses each leaf on its own (a leaf above ``BLOCK_COMPRESS_SIZE`` as
zero-padded rows of that width, each a vector of its own; with
``exact_small_leaves`` a leaf of at most the threshold uncompressed) and
ships one payload per leaf per round.  The port keeps its state in bucket
space and runs the same algebra on each leaf's slot of its bucket.

A subprocess (one for this file's cases and one for
``test_torch_pipelined.py``'s, each shared across xdist workers under a
file lock) runs the JAX engines on 4 host devices (an ``AxisType.Auto`` mesh, ``kernel_backend="jnp"``) for every
case of ``CASES``, and saves their inputs, outputs, draws (the dither,
RandK's positions and the keep bits of each node, round and leaf, or
bucket for the packed pipelined cases) and, per leaf, the payloads of
round 0 (``_compress_leaf`` vmapped over the nodes, jitted).  Tolerances:

* wire payloads of round 0: codes, sparse values and indices, dense
  values bit for bit; the QSGD and sign scales within 1e-6 relative
  (their norms are f32 sums in another order; on bf16 state the rounding
  to bf16 absorbs it);
* x_hat bit for bit, except with f32 state where the QSGD and sign x_hat
  carry the scale's own difference (held within 1e-6 absolute plus 1e-6
  relative, and bit for bit to x_hat + codes * scale of the port's own
  payload) and where a second gossip round compresses the x of the first
  (whose difference is the next point's);
* s and x: bit for bit with bf16 state (every case, per-node weights
  and the pipelined order included); with f32 state within 1e-6
  absolute plus 1e-6 relative (XLA contracts the update's multiply-adds,
  the port's f32 EF kernel does not; measured at most 4.77e-7 on values
  of order 1);
* the per-rank engine (4 gloo ranks, one torch thread) bit-equal to the
  stacked one, each rank's bytes sent equal to its sends times the
  per-leaf payload bytes (``packing.leaf_wire_nbytes``, which equal the
  bytes of JAX's payload arrays);
* three trainer steps against the JAX trainer with
  ``--gossip-engine per-leaf`` (``test_torch_slice.py``'s reference run
  with an engine tag and its tolerances; with QSGD on bf16 state a
  handful of x_hat and s elements may instead differ by one bf16 step of
  their own value, ``check_against_jax(bf16_ulp=True)``: measured 4 of
  5.8M s elements, two in the zero-initialised final norm, where the
  leaf's initial magnitude gives no bound).
"""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.comm import gossip, packing, schedule
from repro_torch.comm.packing import (BLOCK_COMPRESS_SIZE, leaf_wire_nbytes,
                                      make_bucket_spec, pack_leaves,
                                      unpack_leaves)
from repro_torch.core import topology
from repro_torch.core.compression import make_compressor
from repro_torch.launch import mesh
from test_torch_dist import LEAF_SHAPES, N, _join, _spawn
from test_torch_slice import Reference, make_reference
from test_torch_slice import one_thread, tmp_path  # noqa: F401  (fixtures)

BF16 = torch.bfloat16
SMALL_LEAF_THRESHOLD = 4224
#: a leaf of two block rows per node (the second one mostly padding)
BIG_SHAPE = (BLOCK_COMPRESS_SIZE + 1000,)
GAMMA = 0.3
F32_ATOL = F32_RTOL = 1e-6
SCALE_RTOL = 1e-6

_KW = {"identity": {}, "top_k": {"fraction": 0.05},
       "block_top_k": {"fraction": 0.05}, "rand_k": {"fraction": 0.05},
       "qsgd": {"s": 16}, "qsgd255": {"s": 255}, "sign": {},
       "randomized_gossip": {"p": 0.5}, "top_k01": {"fraction": 0.01}}

#: (compressor key of _KW, exact_small_leaves, state dtype, topology,
#: gossip_steps, packed, pipelined, with the big leaf)
CASES = (
    ("identity", False, "float32", "ring", 1, False, False, False),
    ("top_k", False, "float32", "ring", 1, False, False, False),
    ("block_top_k", False, "float32", "ring", 1, False, False, False),
    ("rand_k", False, "float32", "ring", 1, False, False, False),
    ("qsgd", False, "float32", "ring", 1, False, False, False),
    ("qsgd255", False, "float32", "ring", 1, False, False, False),
    ("sign", False, "float32", "ring", 1, False, False, False),
    ("randomized_gossip", False, "float32", "ring", 1, False, False, False),
    ("top_k", True, "float32", "ring", 1, False, False, False),
    ("qsgd", True, "float32", "ring", 2, False, False, False),
    ("qsgd", False, "bfloat16", "ring", 1, False, False, False),
    ("qsgd255", False, "bfloat16", "ring", 1, False, False, False),
    ("sign", False, "bfloat16", "ring", 1, False, False, False),
    ("top_k", True, "bfloat16", "ring", 1, False, False, False),
    ("rand_k", False, "bfloat16", "ring", 2, False, False, False),
    ("qsgd", False, "float32", "star", 1, False, False, False),
    ("top_k", False, "bfloat16", "star", 1, False, False, False),
    ("qsgd", False, "bfloat16", "chain", 1, False, False, False),
    ("qsgd", False, "float32", "ring", 1, False, False, True),
    ("qsgd", False, "bfloat16", "ring", 1, False, False, True),
    ("top_k01", False, "float32", "ring", 1, False, False, True),
    # the pipelined engine (test_torch_pipelined.py)
    ("qsgd", False, "float32", "ring", 1, True, True, False),
    ("top_k", False, "bfloat16", "ring", 2, True, True, False),
    ("top_k", False, "float32", "star", 1, True, True, False),
    ("qsgd", False, "float32", "ring", 1, False, True, False),
    ("qsgd", True, "bfloat16", "ring", 2, False, True, False),
    ("sign", False, "float32", "star", 1, False, True, False),
    ("top_k", False, "bfloat16", "ring", 1, False, True, False),
)


def tag(case) -> str:
    comp, exact, sdt, topo, k, packed, pipe, big = case
    return (f"{'packed' if packed else 'leaf'}{'-pipe' if pipe else ''}-"
            f"{comp}{'-exact' if exact else ''}-{sdt}-{topo}-{k}"
            f"{'-big' if big else ''}")


def shapes_of(case):
    return LEAF_SHAPES + ((BIG_SHAPE,) if case[7] else ())


_JAX_EXCHANGES = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.comm import packing as jpacking
    from repro.comm.gossip import (BLOCK_COMPRESS_SIZE, _compress_leaf,
                                   _pack_align, make_gossip_exchange)
    from repro.comm.schedule import compile_schedule
    from repro.core.compression import Identity, make_compressor
    from repro.core.topology import make_topology

    cases, threshold, gamma, out_dir = (json.loads(sys.argv[1]),
                                        int(sys.argv[2]), float(sys.argv[3]),
                                        sys.argv[4])
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fold = jax.random.fold_in
    for c in cases:
        rng = np.random.default_rng(c["seed"])
        sdt = jnp.dtype(c["sdt"])
        shapes = [tuple(s) for s in c["shapes"]]
        def draw(scale, dtype):
            return {f"l{i}": (scale * rng.standard_normal((4,) + s))
                    .astype(np.float32).astype(dtype)
                    for i, s in enumerate(shapes)}
        x, x_hat, s = draw(1.0, np.float32), draw(0.5, sdt), draw(0.1, sdt)
        names = sorted(x)
        specs = {k: P("data", *([None] * (v.ndim - 1))) for k, v in x.items()}
        comp = make_compressor(c["name"], **c["kw"])
        ex = make_gossip_exchange(
            mode="choco", mesh=mesh, state_specs=specs, axis="data",
            compressor=comp, gamma=gamma, exact_small_leaves=c["exact"],
            small_leaf_threshold=threshold, packed=c["packed"],
            pipelined=c["pipelined"],
            schedules=(compile_schedule(make_topology(c["topology"], 4)),),
            gossip_steps=c["k"], kernel_backend="jnp")
        key = jax.random.PRNGKey(c["seed"])
        tree = lambda t: jax.tree.map(jnp.asarray, t)
        out = jax.jit(ex)(key, tree(x), tree(x_hat), tree(s))
        res = {}
        bits = lambda v: v if v.dtype != jnp.bfloat16 else v.view(np.uint16)
        for tg, t in (("in_x", x), ("in_x_hat", x_hat), ("in_s", s)) + tuple(
                zip(("out_x", "out_x_hat", "out_s"), out)):
            for k, v in t.items():
                res[f"{tg}:{k}"] = bits(np.asarray(v))
        ident = Identity()
        small = lambda nm: (c["exact"] and x[nm][0].size <= threshold)
        if not c["packed"]:
            # node i, round t: leaf j takes split(fold_in(t_key, 0), leaves)[j]
            # (t_key = fold_in(key, i), then fold_in(., t) for t > 0), and a
            # leaf above BLOCK_COMPRESS_SIZE splits that key per block row
            def node_keys(i, t):
                tk = fold(key, i)
                tk = tk if t == 0 else fold(tk, t)
                return jax.random.split(fold(tk, 0), len(names))
            for t in range(c["k"]):
                for j, nm in enumerate(names):
                    d = x[nm][0].size
                    if small(nm) or not comp.stochastic:
                        continue
                    rows = []
                    for i in range(4):
                        lk = node_keys(i, t)[j]
                        R = -(-d // BLOCK_COMPRESS_SIZE)
                        ks = [lk] if R == 1 else list(jax.random.split(lk, R))
                        L = d if R == 1 else BLOCK_COMPRESS_SIZE
                        row = []
                        for rk in ks:
                            if c["name"] == "qsgd":
                                row.append(jax.random.uniform(rk, (L,)))
                            elif c["name"] == "rand_k":
                                kk = max(1, min(L, int(np.ceil(
                                    c["kw"]["fraction"] * L))))
                                row.append(jax.random.permutation(rk, L)[:kk])
                            else:
                                row.append(jax.random.bernoulli(rk, comp.p))
                        rows.append(np.stack([np.asarray(r) for r in row]))
                    res[f"draw:{t}:{j}"] = np.stack(rows)
            # the payloads of round 0, per leaf, jitted over the nodes
            for j, nm in enumerate(names):
                cj = ident if small(nm) else comp
                delta = (jnp.asarray(x[nm]).astype(sdt)
                         - jnp.asarray(x_hat[nm])).reshape(4, -1)
                keys = jnp.stack([node_keys(i, 0)[j] for i in range(4)])
                fn = jax.jit(jax.vmap(lambda kk, d: _compress_leaf(
                    cj, kk if cj.stochastic else None, d)[0]))
                pl = fn(keys, delta)
                for f, arr in enumerate(jax.tree_util.tree_leaves(pl)):
                    res[f"pl:{j}:{f}"] = bits(np.asarray(arr))
                res[f"plkind:{j}"] = np.array(type(pl).__name__)
        elif comp.stochastic:
            spec = jpacking.make_bucket_spec(
                [jax.ShapeDtypeStruct(v.shape[1:], sdt)
                 for v in x_hat.values()],
                align=_pack_align(comp, None), exact_small_leaves=c["exact"],
                small_leaf_threshold=threshold)
            for t in range(c["k"]):
                for b in spec.buckets:
                    if b.exact:
                        continue
                    rows = []
                    for i in range(4):
                        rk = fold(key, i) if t == 0 else fold(fold(key, i), t)
                        bk = fold(rk, b.index)
                        if c["name"] == "qsgd":
                            rows.append(jax.random.uniform(bk, (b.size,)))
                        elif c["name"] == "rand_k":
                            kb = jpacking._slot_budget(
                                comp, spec.bucket_slots(b.index), b)
                            rows.append(jax.random.permutation(
                                bk, b.logical)[:kb])
                        else:
                            rows.append(jax.random.bernoulli(bk, comp.p))
                    res[f"draw:{t}:{b.index}"] = np.stack(
                        [np.asarray(r) for r in rows])
        savez(os.path.join(out_dir, c["tag"] + ".npz"), **res)
""")


def _case_dict(case, index):
    comp, exact, sdt, topo, k, packed, pipe, big = case
    return dict(tag=tag(case), name=comp.rstrip("0123456789"),
                kw=_KW[comp], exact=exact, sdt=sdt, topology=topo, k=k,
                packed=packed, pipelined=pipe, shapes=shapes_of(case),
                seed=500 + index)


def jax_exchanges(tmp_path_factory, cases, name):
    """``tag -> path`` of the JAX engines' runs of ``cases`` (a part of
    CASES), made once per pytest run in one subprocess under ``name``
    (``make_reference``)."""
    out = make_reference(
        tmp_path_factory, name, _JAX_EXCHANGES,
        lambda part: [json.dumps([_case_dict(c, CASES.index(c))
                                  for c in cases]),
                      SMALL_LEAF_THRESHOLD, GAMMA, part])
    return {tag(c): str(out / (tag(c) + ".npz")) for c in cases}


def _tensor(a):
    """An npz array as a tensor: uint16 arrays hold bf16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(BF16) if a.dtype == np.uint16 else t


def setup_case(case, path):
    """(compressor, spec, schedules, (x, x_hat, s) node-stacked bucket
    buffers, the JAX outputs per leaf, draws(t, unit), the npz)."""
    comp_key, exact, sdt, topo, k, packed, pipe, big = case
    comp = make_compressor(comp_key.rstrip("0123456789"), **_KW[comp_key])
    dtype = getattr(torch, sdt)
    shapes = shapes_of(case)
    spec = make_bucket_spec(
        [torch.empty(sh, dtype=dtype, device="meta") for sh in shapes],
        align=gossip._pack_align(comp), exact_small_leaves=exact,
        small_leaf_threshold=SMALL_LEAF_THRESHOLD)
    res = Reference(path)
    leaves = lambda tg: [_tensor(res[f"{tg}:l{j}"]) for j in range(len(shapes))]
    bufs = (pack_leaves(spec, leaves("in_x"), dtype=torch.float32),
            pack_leaves(spec, leaves("in_x_hat")),
            pack_leaves(spec, leaves("in_s")))
    want = [leaves(tg) for tg in ("out_x", "out_x_hat", "out_s")]
    sched = schedule.compile_schedule(topology.make_topology(topo, N))
    draws = None
    if comp.stochastic:
        draws = lambda t, u: torch.from_numpy(res[f"draw:{t}:{u}"])
    return comp, spec, (sched,), bufs, want, draws, res


def bits_equal(a, b) -> bool:
    if a.dtype == BF16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def quantizing(comp) -> bool:
    return comp.name in ("qsgd", "sign")


def check_state(case, comp, spec, got, want, what=""):
    """x, x_hat and s (node-stacked bucket buffers) against the JAX
    engine's leaves, with the tolerances of this module's docstring."""
    f32 = case[2] == "float32"
    quant = quantizing(comp)
    for tg, bufs, w in zip(("x", "x_hat", "s"), got, want):
        for j, (g, ww) in enumerate(zip(unpack_leaves(spec, bufs), w)):
            g = g.reshape(ww.shape)
            exact_leaf = spec.buckets[spec.slots[j].bucket].exact
            if not f32 or (tg == "x_hat" and case[4] == 1
                           and (not quant or exact_leaf)):
                assert bits_equal(g, ww), (what, tg, j)
                continue
            np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=F32_RTOL,
                                       atol=F32_ATOL,
                                       err_msg=f"{what} {tg} {j}")


LEAF_CASES = [c for c in CASES if not c[5] and not c[6]]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_exchanges(tmp_path_factory, LEAF_CASES, "jax_leaf_exchanges")


def _payload_arrays(payload):
    import dataclasses
    return [getattr(payload, f.name) for f in dataclasses.fields(payload)
            if torch.is_tensor(getattr(payload, f.name))]


@pytest.mark.parametrize("case", LEAF_CASES, ids=[tag(c) for c in LEAF_CASES])
def test_stacked_per_leaf_exchange_matches_jax_engine(case, jax_runs,
                                                      monkeypatch):
    """Every leaf's payload of round 0 bit-equal to JAX's (the QSGD and
    sign scales within 1e-6 relative) and of ``leaf_wire_nbytes``' bytes;
    x, x_hat and s after the exchange against the JAX engine's; one
    compression per leaf per round."""
    comp, spec, scheds, bufs, want, draws, res = setup_case(
        case, jax_runs[tag(case)])
    calls = []
    compress = gossip.compress_rows

    def record(*args, **kwargs):
        out = compress(*args, **kwargs)
        calls.append((args[1].clone(), out))
        return out
    monkeypatch.setattr(gossip, "compress_rows", record)
    x, x_hat, s = [[b.clone() for b in part] for part in bufs]
    gossip.make_choco_exchange(spec=spec, schedules=scheds, compressor=comp,
                               gamma=GAMMA, gossip_steps=case[4],
                               packed=False)(x, x_hat, s, draws=draws)
    check_state(case, comp, spec, (x, x_hat, s), want, tag(case))
    n_leaves = len(spec.slots)
    assert len(calls) == case[4] * n_leaves
    sizes = leaf_wire_nbytes(spec, comp)
    for j, (rows, payload) in enumerate(calls[:n_leaves]):
        assert type(payload).__name__ == str(res[f"plkind:{j}"])
        nbytes = 0
        for f, got in enumerate(_payload_arrays(payload)):
            w = _tensor(res[f"pl:{j}:{f}"])
            nbytes += w[0].numel() * w.element_size()
            got = got.reshape(w.shape)
            if f == 1 and type(payload).__name__ == "QuantPayload":
                np.testing.assert_allclose(got.numpy(), w.numpy(),
                                           rtol=SCALE_RTOL, atol=0)
            else:
                assert bits_equal(got, w), (j, f)
        assert nbytes == sizes[j], j
        if case[2] == "float32" and quantizing(comp) and \
                not spec.buckets[spec.slots[j].bucket].exact and case[4] == 1:
            # x_hat is the input plus this payload's dense rows, bit for bit
            slot = spec.slots[j]
            q = payload.dense().reshape(N, -1)[:, :slot.size]
            before = bufs[1][slot.bucket][:, slot.offset:slot.offset
                                          + slot.size]
            after = x_hat[slot.bucket][:, slot.offset:slot.offset + slot.size]
            assert torch.equal(after, before + q), j


def _dist_rank(rank, store, out_dir, paths, cases):
    group = _join(rank, store)
    results = {}
    for case in cases:
        comp, spec, scheds, bufs, _, draws, _ = setup_case(case,
                                                           paths[tag(case)])
        ex = gossip.make_dist_choco_exchange(
            spec=spec, schedules=scheds, compressor=comp,
            gamma=GAMMA if not case[5] else GAMMA, gossip_steps=case[4],
            group=group, packed=case[5], pipelined=case[6])
        x, x_hat, s = [[b[rank:rank + 1].clone() for b in part]
                       for part in bufs]
        before = group.bytes_sent
        row = None if draws is None else (
            lambda t, u: draws(t, u)[rank:rank + 1])
        ex(x, x_hat, s, draws=row)
        results[tag(case)] = (x, x_hat, s, group.bytes_sent - before,
                              ex.payload_bytes, ex.sends)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def stacked_run(case, path):
    comp, spec, scheds, bufs, want, draws, _ = setup_case(case, path)
    x, x_hat, s = [[b.clone() for b in part] for part in bufs]
    gossip.make_choco_exchange(spec=spec, schedules=scheds, compressor=comp,
                               gamma=GAMMA, gossip_steps=case[4],
                               packed=case[5], pipelined=case[6])(
        x, x_hat, s, draws=draws)
    return comp, spec, (x, x_hat, s)


def check_dist_against_stacked(tmp_path, jax_runs, cases):
    """4 gloo ranks run ``cases`` with JAX's draws: each rank's x, x_hat
    and s bit-equal to its row of the stacked exchange's, its bytes sent
    its sends times the spec's payload bytes."""
    ranks = _spawn(_dist_rank, tmp_path, str(tmp_path), jax_runs, cases)
    for case in cases:
        comp, spec, stacked = stacked_run(case, jax_runs[tag(case)])
        sizes = (packing.bucket_wire_nbytes(spec, comp) if case[5]
                 else leaf_wire_nbytes(spec, comp))
        for r, got in enumerate(ranks):
            x, x_hat, s, sent, payload, sends = got[tag(case)]
            for tg, mine, full in zip(("x", "x_hat", "s"), (x, x_hat, s),
                                      stacked):
                for g, f in zip(mine, full):
                    assert bits_equal(g, f[r:r + 1]), (tag(case), r, tg)
            assert payload == sizes
            assert sent == sends * sum(sizes), (tag(case), r)


DIST_CASES = [c for c in LEAF_CASES if not c[7]][::2] + [
    c for c in LEAF_CASES if c[7]][:1]


def test_dist_per_leaf_exchange_matches_stacked(tmp_path, jax_runs):
    check_dist_against_stacked(tmp_path, jax_runs, DIST_CASES)


def test_per_leaf_engine_refuses_a_gamma_spec():
    from repro_torch.core.choco_gossip import GammaSpec
    spec = make_bucket_spec([torch.empty((700,), device="meta")])
    ring = (schedule.compile_schedule(topology.make_topology("ring", N)),)
    with pytest.raises(ValueError, match="requires the packed engine"):
        gossip.make_choco_exchange(spec=spec, schedules=ring,
                                   compressor=make_compressor("sign"),
                                   gamma=GammaSpec(0.5, 0.5), packed=False)


def test_leaf_rows_and_wire_bytes():
    """A leaf above BLOCK_COMPRESS_SIZE compresses as ceil(size / C) rows
    of C; the wire bytes per leaf follow the payload per row."""
    assert packing.leaf_rows(100) == (1, 100)
    assert packing.leaf_rows(BLOCK_COMPRESS_SIZE) == (1, BLOCK_COMPRESS_SIZE)
    assert packing.leaf_rows(BLOCK_COMPRESS_SIZE + 1) == (
        2, BLOCK_COMPRESS_SIZE)
    spec = make_bucket_spec([torch.empty(s, device="meta")
                             for s in ((1000,), BIG_SHAPE, (7,))],
                            exact_small_leaves=True, small_leaf_threshold=8)
    C = BLOCK_COMPRESS_SIZE
    assert leaf_wire_nbytes(spec, make_compressor("qsgd", s=255)) == [
        1000 * 2 + 4, 2 * (C * 2 + 4), 7 * 4]
    assert leaf_wire_nbytes(spec, make_compressor("top_k", fraction=0.01)) \
        == [10 * 8, 2 * (C // 100 + 1) * 8, 7 * 4]
    assert leaf_wire_nbytes(spec, make_compressor("sign")) == [
        1004, 2 * (C + 4), 28]


# -- the trainer and the launcher -----------------------------------------------

def leaf_draws(tr, ref, j):
    """The JAX per-leaf engine's dither of step j: ``draws(t, leaf)``."""
    return lambda t, u: torch.from_numpy(ref[f"xi:{j}:{t}:{tr.paths[u]}"])


def run_against_jax_trainer(tmp_path_factory, comp, arg, k, state_dtype,
                            engine):
    """Three steps of the port's stacked trainer from the JAX trainer's
    initial parameters (the JAX dither injected), held by
    ``check_against_jax``."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import make_lm_batch_fn
    from test_torch_slice import (BPN, SEQ, STEPS, _port_trainer, _tree,
                                  check_against_jax, jax_reference_path)
    ref = Reference(jax_reference_path(
        tmp_path_factory, comp, arg, k, False, state_dtype=state_dtype,
        engine=engine))
    tr = _port_trainer(comp, arg, k, False, state_dtype=state_dtype,
                       engine=engine)
    packed = not engine.startswith("per-leaf")
    assert [tr.gamma] + (tr.exchange.gammas if packed else []) == \
        list(ref["gamma"])
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0")))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    mets = []
    for j in range(STEPS):
        draws = None
        if comp == "qsgd":
            draws = (leaf_draws(tr, ref, j) if not packed else
                     lambda t, b, j=j: torch.from_numpy(ref[f"xi:{j}:{t}:{b}"]))
        m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
        mets.append([m["loss"], m["lr"], m["grad_norm"]])
    check_against_jax(tr, state, mets, ref, comp,
                      bf16_ulp=comp == "qsgd" and state_dtype == "bfloat16")
    return tr, state


@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("comp,arg,k,sdt", [
    pytest.param("qsgd", 16, 1, "float32", id="qsgd-16-1-float32"),
    pytest.param("top_k", 0.05, 1, "bfloat16", id="top_k-0.05-1-bfloat16"),
])
def test_per_leaf_trainer_matches_jax(tmp_path_factory, comp, arg, k, sdt):
    """``--gossip-engine per-leaf``: 3 steps against the JAX trainer
    (the scalar gamma at omega(2^20) equal to JAX's), with
    ``check_against_jax``'s tolerances; the exchange is the per-leaf
    one (one unit per leaf)."""
    tr, _ = run_against_jax_trainer(tmp_path_factory, comp, arg, k, sdt,
                                    "per-leaf")
    assert len(tr.exchange.gammas) == len(tr.paths)


_SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", "4x1", "--steps", "2",
          "--seq-len", "32", "--batch-per-node", "2", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--gossip-engine", "per-leaf", "--compressor", "qsgd", "--qsgd-s", "16"],
    ["--gossip-engine", "per-leaf", "--exact-small-leaves",
     "--state-dtype", "bfloat16"],
    ["--gossip-engine", "per-leaf", "--pipeline-gossip", "--compressor",
     "sign"],
])
def test_launcher_trains_with_the_per_leaf_engine_on_cpu(extra, capsys):
    from repro_torch.launch import train as launcher
    assert launcher.main(_SMOKE + extra) == 0
    out = capsys.readouterr().out
    pipe = " pipelined" if "--pipeline-gossip" in extra else ""
    assert f"gossip_engine=per-leaf{pipe} " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
