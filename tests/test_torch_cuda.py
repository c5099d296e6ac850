"""The PyTorch port on the card: each CUDA kernel against its plain version,
the trainer through the gossip kernels (with QSGD, sign and top-k gossip),
the per-rank exchange (4 ranks sharing the card) against the stacked one,
the topology-process engine's replica update, the prefill through
the flash kernel (the dense decoders', the MoE decoders' and the
frontends'), and the WKV6 kernel with the recurrent families' serving.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ChocoConfig, get_config
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models.transformer import Model
from repro_torch.optim.sgd import cosine_schedule, momentum_sgd
from repro_torch.train.trainer import DecentralizedTrainer

N = 4
LENGTHS = [4096, 1_000_003]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normal(seed, shape, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def _launched(name, fn):
    before = dispatch.launch_counts()[name]
    out = fn()
    assert dispatch.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("s", [16, 255])
def test_qsgd_codes_and_dequantize_bit_equal_to_plain(cuda, s, length):
    x = _normal(length, (N, length), cuda)
    xi = torch.rand((N, length), device=cuda)
    inv = 0.999 / x.abs().amax(dim=1)
    codes = _launched("qsgd_codes", lambda: dispatch.qsgd_codes(x, xi, inv, s))
    assert codes.dtype == (torch.int8 if s <= 127 else torch.int16)
    assert torch.equal(codes, ref.qsgd_codes_ref(x, xi, inv, s))
    scale = torch.rand(N, device=cuda)
    dense = _launched("dequantize", lambda: dispatch.dequantize(codes, scale))
    assert torch.equal(dense, ref.dequantize_ref(codes, scale))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS)
def test_sign_and_ef_update_bit_equal_to_plain(cuda, length):
    ins = [_normal(length + i, (N, length), cuda) for i in range(5)]
    ins[0][:, ::5] = 0.0
    codes = _launched("sign_codes", lambda: dispatch.sign_codes(ins[0]))
    assert torch.equal(codes, ref.sign_codes_ref(ins[0]))
    # per-node weights (star's self weights at n = 4; one neighbour
    # weight), and the ring's uniform ones
    for w_self, w_nbr in (((0.25, 0.75, 0.75, 0.75), (0.25,) * 4),
                          ((1 / 3,) * 4, (1 / 3,) * 4)):
        ws, wn = (torch.tensor(w, dtype=torch.float32, device=cuda)
                  for w in (w_self, w_nbr))
        want = ref.ef_update_ref(*ins, ws, wn, 2.8e-4)
        # in place, over its own x_half, x_hat and s
        inplace = [t.clone() for t in ins[:3]]
        got = _launched("ef_update", lambda: dispatch.ef_bucket_update(
            *inplace, *ins[3:], ws, wn, 2.8e-4))
        assert all(g is t for g, t in zip(got, inplace))
        for g, w in zip(inplace, want):
            assert torch.equal(g, w)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("length", LENGTHS)
def test_ef_update_bf16_bit_equal_to_plain(cuda, length):
    """The bf16-state EF update against ``ref.ef_update_bf16_ref``, in place:
    the ring's uniform weights (bf16-valued, the sum in bf16), star's and
    chain's per-node self weights (f32, the sum in f32; chain's 2/3 and
    1/3 make the FMA recomputation for x differ from s' in some
    elements), bit for bit; at 4096 the 4-wide loads, at the odd length
    and on misaligned buffers one element at a time."""
    x = _normal(length, (N, length), cuda)
    x_hat, s, q_self, q_nbr = (
        (_normal(length + i, (N, length), cuda) * sc).to(torch.bfloat16)
        for i, sc in ((1, 0.5), (2, 0.1), (3, 0.3), (4, 0.6)))
    q_self[:, ::7] = 0
    bf = lambda w: torch.tensor(w, dtype=torch.float32).to(
        torch.bfloat16).float().to(cuda)
    for w_self, w_nbr, in_bf16 in (
            (bf((1 / 3,) * N), bf((1 / 3,) * N), True),
            (torch.tensor((0.25, 0.75, 0.75, 0.75), device=cuda),
             bf((0.25,) * N), False),
            (torch.tensor((2 / 3, 1 / 3, 1 / 3, 2 / 3), device=cuda),
             bf((1 / 3,) * N), False)):
        want = ref.ef_update_bf16_ref(x, x_hat, s, q_self, q_nbr, w_self,
                                      w_nbr, 2.8e-4, in_bf16)
        inplace = [t.clone() for t in (x, x_hat, s)]
        got = _launched("ef_update_bf16", lambda: dispatch.ef_bucket_update(
            *inplace, q_self, q_nbr, w_self, w_nbr, 2.8e-4, in_bf16))
        assert all(g is t for g, t in zip(got, inplace))
        for g, w in zip(inplace, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    # buffers one element off 16-byte alignment take the one-element loop
    shifted = lambda t: torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(
        t.shape)
    ins = [shifted(t) for t in (x, x_hat, s, q_self, q_nbr)]
    assert ins[0].data_ptr() % 16 and ins[1].data_ptr() % 8
    want = ref.ef_update_bf16_ref(*ins, w_self, w_nbr, 2.8e-4, False)
    dispatch.ef_bucket_update(*ins, w_self, w_nbr, 2.8e-4, False)
    for g, w in zip(ins, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="bfloat16"):
        dispatch.ef_bucket_update(x.clone(), x_hat.clone(), s.clone(),
                                  q_self.float(), q_nbr, w_self, w_nbr, 0.1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_probe_kernel_bit_equal_to_plain(cuda):
    """The collective-layer probe's x * 2 at the JAX probe's (8, 128) block
    and at an odd length."""
    for shape in [(8, 128), (1_000_003,)]:
        x = _normal(3, shape, cuda)
        got = _launched("probe_scale", lambda: dispatch.probe_scale(x))
        assert torch.equal(got, ref.probe_scale_ref(x))
    with pytest.raises(ValueError, match="float32"):
        dispatch.probe_scale(x.double())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _normal(0, (N, 64), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.sign_codes(x[:, ::2])
    with pytest.raises(ValueError, match="float32"):
        dispatch.sign_codes(x.double())
    with pytest.raises(ValueError, match="shape"):
        dispatch.qsgd_codes(x, x[:, :32].contiguous(), x[:, 0].contiguous(), 16)


def _counts(**launched):
    """The six launch counts: those named, 0 for the rest."""
    return {name: launched.get(name, 0) for name in dispatch.KERNELS}


def _run(compressor, device, steps=2, state_dtype="float32", packed=True,
         pipelined=False, process=None):
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    kw = {"qsgd": (("s", 16),), "sign": ()}.get(compressor,
                                                 (("fraction", 0.05),))
    tr = DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=compressor,
                                            comp_kwargs=kw,
                                            state_dtype=state_dtype,
                                            packed_gossip=packed,
                                            pipeline_gossip=pipelined,
                                            topology_process=process),
        n_nodes=N, optimizer=momentum_sgd(),
        lr_fn=cosine_schedule(0.1, 1, steps), device=device)
    state = tr.state_from_params(tr.model.init(N, 0, "cpu"))
    batches = make_lm_batch_fn(cfg, 64, 2, N, 1.0)
    losses = [tr.step(state, tr.batch_to_device(batches()))["loss"]
              for _ in range(steps)]
    return tr, state, losses


@pytest.mark.cuda
def test_trainer_goes_through_the_kernels_and_agrees_with_cpu(cuda):
    """Sign compression is deterministic, so the card's run and the CPU
    run of the same steps differ only by float summation order."""
    dispatch.reset_launch_counts()
    tr, state, losses = _run("sign", cuda)
    counts = dispatch.launch_counts()
    torch.cuda.synchronize()
    launches = 2 * tr.choco.gossip_steps * tr.spec.n_buckets
    assert counts == _counts(sign_codes=launches, dequantize=launches,
                             ef_update=launches)
    _, cpu_state, cpu_losses = _run("sign", "cpu")
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    for a, b in zip(state.x, cpu_state.x):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_trainer_qsgd_launches_per_bucket_per_round(cuda):
    dispatch.reset_launch_counts()
    tr, _, losses = _run("qsgd", cuda)
    launches = 2 * tr.choco.gossip_steps * tr.spec.n_buckets
    assert dispatch.launch_counts() == _counts(
        qsgd_codes=launches, dequantize=launches, ef_update=launches)
    assert all(np.isfinite(losses))


@pytest.mark.cuda
@pytest.mark.parametrize("compressor", ["qsgd", "top_k"])
def test_trainer_bf16_state_launches_per_bucket_per_round(cuda, compressor):
    """bf16 EF state: one bf16-state EF launch per bucket per round (and no
    f32 one), the codes and decode launches as with f32 state; x_hat and
    s bf16 on the card; losses finite and within 1e-4 of the CPU run's
    (the first step's within 1e-5)."""
    dispatch.reset_launch_counts()
    tr, state, losses = _run(compressor, cuda, state_dtype="bfloat16")
    launches = 2 * tr.choco.gossip_steps * tr.spec.n_buckets
    codes = ({"qsgd_codes": launches, "dequantize": launches}
             if compressor == "qsgd" else {})
    assert dispatch.launch_counts() == _counts(ef_update_bf16=launches,
                                               **codes)
    assert {b.dtype for b in state.x_hat + state.s} == {torch.bfloat16}
    assert {b.dtype for b in state.x} == {torch.float32}
    _, _, cpu_losses = _run(compressor, "cpu", state_dtype="bfloat16")
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], cpu_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-4)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# -- the per-leaf and the pipelined engines ------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [16, 255])
@pytest.mark.parametrize("length", LENGTHS)
def test_qsgd_leaf_codes_bit_equal_to_plain(cuda, length, s, dtype):
    """The per-leaf codes variant, f32 and bf16 rows, with the norm as the
    per-leaf engine passes it (a row of zeros takes norm 1) and with
    max|x| in its place, which reaches every level up to s; and the sign
    codes of bf16 rows."""
    x = (_normal(length, (N, length), cuda) * 0.01).to(dtype)
    x[2] = 0
    xi = torch.rand((N, length), device=cuda)
    norm = x.float().square().sum(dim=1).sqrt()
    top = x.float().abs().amax(dim=1)
    for nrm in (norm, top):
        nrm = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        codes = _launched("qsgd_leaf_codes",
                          lambda: dispatch.qsgd_leaf_codes(x, xi, nrm, s))
        assert torch.equal(codes, ref.qsgd_leaf_codes_ref(x, xi, nrm, s))
        assert int(codes[2].abs().sum()) == 0
    assert int(codes.abs().max()) == s
    signs = _launched("sign_codes", lambda: dispatch.sign_codes(x))
    assert torch.equal(signs, ref.sign_codes_ref(x))
    torch.cuda.synchronize()


SLOT = 128


def _ef_inputs(length, state_dtype, q_dtype, device, width=None):
    """x f32, x_hat and s in ``state_dtype``, the payloads in ``q_dtype``,
    (N, length); with ``width`` each is a slot [:, 128:128 + length] of an
    (N, width) buffer, the payloads' own buffers of another width."""
    def mk(i, scale, dtype, w):
        full = (_normal(length + i, (N, w or length), device)
                * scale).to(dtype)
        return full if w is None else full[:, SLOT:SLOT + length]
    x = mk(0, 1.0, torch.float32, width)
    x_hat, s = mk(1, 0.5, state_dtype, width), mk(2, 0.1, state_dtype, width)
    qw = None if width is None else width + 64
    q_self, q_nbr = mk(3, 0.3, q_dtype, qw), mk(4, 0.6, q_dtype, qw)
    return x, x_hat, s, q_self, q_nbr


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("width", [None, 5000])
def test_ef_update_variants_bit_equal_to_plain(cuda, state_dtype, q_dtype,
                                               pipelined, width):
    """Every EF entry (f32 state; bf16 state with bf16 or f32 payloads;
    serial and pipelined order), in place, against its plain version:
    on whole (N, 4096) buffers and on bucket-slot views at offset 128
    whose rows lie 5000 apart (the payloads' 5064), as the per-leaf engine
    calls it (its slots start at multiples of 128: the 4-wide loads)."""
    ins = _ef_inputs(4096, state_dtype, q_dtype, cuda, width)
    assert width is None or not ins[0].is_contiguous()
    w_self = torch.tensor((0.25, 0.75, 0.75, 0.75), device=cuda)
    w_nbr = torch.full((N,), 0.25, device=cuda)
    bf16 = state_dtype == torch.bfloat16
    want = (ref.ef_update_bf16_ref(*ins, w_self, w_nbr, 2.8e-4, False,
                                   pipelined) if bf16 else
            ref.ef_update_ref(*ins, w_self, w_nbr, 2.8e-4, pipelined))
    name = ("ef_update_bf16" if bf16 else "ef_update") + (
        "_pipelined" if pipelined else "")
    base = [t._base if t._base is not None else t for t in ins[:3]]
    before = [b.clone() for b in base]
    _launched(name, lambda: dispatch.ef_bucket_update(
        *ins, w_self, w_nbr, 2.8e-4, False, pipelined))
    for g, w in zip(ins[:3], want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    if width is not None:                    # nothing outside the slot moves
        for b, old in zip(base, before):
            assert torch.equal(_bits(b[:, :SLOT]), _bits(old[:, :SLOT]))
            assert torch.equal(_bits(b[:, SLOT + 4096:]),
                               _bits(old[:, SLOT + 4096:]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ef_wrapper_rejects_mismatched_row_strides(cuda):
    x, x_hat, s, q_self, q_nbr = _ef_inputs(64, torch.float32, torch.float32,
                                            cuda, width=300)
    w = torch.full((N,), 0.25, device=cuda)
    with pytest.raises(ValueError, match="one row stride"):
        dispatch.ef_bucket_update(x, x_hat.contiguous(), s, q_self, q_nbr, w,
                                  w, 0.1)
    with pytest.raises(ValueError, match="contiguous rows"):
        dispatch.ef_bucket_update(x[:, ::2], x_hat[:, ::2], s[:, ::2],
                                  q_self[:, :32], q_nbr[:, :32], w, w, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("compressor,state_dtype", [
    ("qsgd", "float32"), ("sign", "bfloat16"), ("top_k", "float32"),
    ("qsgd", "bfloat16")])
def test_per_leaf_trainer_launches_per_leaf_per_round(cuda, compressor,
                                                      state_dtype):
    """``packed_gossip=False``: per step, one codes, one dequantize and one
    EF launch per leaf per gossip round (the EF update alone for top_k),
    none of the packed codes kernel; losses finite and within 1e-4 of the
    CPU run's."""
    dispatch.reset_launch_counts()
    tr, state, losses = _run(compressor, cuda, state_dtype=state_dtype,
                             packed=False)
    per = 2 * tr.choco.gossip_steps * len(tr.paths)
    ef = "ef_update_bf16" if state_dtype == "bfloat16" else "ef_update"
    codes = {"qsgd": {"qsgd_leaf_codes": per, "dequantize": per},
             "sign": {"sign_codes": per, "dequantize": per}}.get(
                 compressor, {})
    assert dispatch.launch_counts() == _counts(**{ef: per}, **codes)
    _, _, cpu_losses = _run(compressor, "cpu", state_dtype=state_dtype,
                            packed=False)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_pipelined_trainer_on_the_side_stream_agrees_with_cpu(cuda, packed,
                                                              monkeypatch):
    """``pipeline_gossip`` (sign, deterministic): the exchange runs on the
    trainer's side stream and launches the pipelined-order EF kernel once
    per bucket (or leaf) per round, never the serial one; x, x_hat and s
    bit-equal to the same run on the card with the two phases in turn (no
    side stream), and x within 1e-5 of the CPU run's."""
    dispatch.reset_launch_counts()
    tr, state, losses = _run("sign", cuda, packed=packed, pipelined=True)
    assert tr._stream is not None
    units = tr.spec.n_buckets if packed else len(tr.paths)
    per = 2 * tr.choco.gossip_steps * units
    assert dispatch.launch_counts() == _counts(
        ef_update_pipelined=per, dequantize=per, sign_codes=per)
    monkeypatch.setattr(DecentralizedTrainer, "_side_stream",
                        lambda self: None)
    _, in_turn, turn_losses = _run("sign", cuda, packed=packed,
                                   pipelined=True)
    assert losses == turn_losses
    for a, b in zip(state.x + state.x_hat + state.s,
                    in_turn.x + in_turn.x_hat + in_turn.s):
        assert torch.equal(a, b)
    _, cpu_state, cpu_losses = _run("sign", "cpu", packed=packed,
                                    pipelined=True)
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    for a, b in zip(state.x, cpu_state.x):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("compressor", ["qsgd", "top_k"])
def test_checkpoint_on_the_card_bit_equal_and_warmup_launches(
        cuda, compressor, tmp_path):
    """bf16 EF state on the card: a save and a restore into a fresh
    trainer give back x, x_hat, s, the moments, the step and the seed bit
    for bit; the CPU restores the card's checkpoint bit for bit too; an
    elastic restore on 8 nodes zeroes x_hat and s and its warmup launches,
    per round and bucket, one EF update (bf16) and for QSGD one codes and
    one dequantize."""
    tr, state, _ = _run(compressor, cuda, state_dtype="bfloat16")
    tr.save_checkpoint(str(tmp_path / "ck"), state)
    kw = tr.choco.comp_kwargs
    for device in (cuda, "cpu"):
        fresh = dataclasses.replace(tr, device=device)
        got, man, warmup = fresh.restore_checkpoint(str(tmp_path / "ck"))
        assert warmup == 0 and man.step == got.step == state.step == 2
        assert got.seed == state.seed and got.opt.count == state.opt.count
        for group in ("x", "x_hat", "s"):
            for a, b in zip(getattr(got, group), getattr(state, group)):
                assert a.dtype == b.dtype
                assert torch.equal(_bits(a).cpu(), _bits(b).cpu()), group
        for a, b in zip(got.opt.mu, state.opt.mu):
            assert torch.equal(a.cpu(), b.cpu())
    grown = DecentralizedTrainer(
        model=tr.model, choco=ChocoConfig(compressor=compressor,
                                          comp_kwargs=kw,
                                          state_dtype="bfloat16"),
        n_nodes=8, optimizer=momentum_sgd(),
        lr_fn=cosine_schedule(0.1, 1, 2), device=cuda)
    big, _, rounds = grown.restore_checkpoint(str(tmp_path / "ck"))
    assert rounds == 7 and not any(b.any() for b in big.x_hat + big.s)
    dispatch.reset_launch_counts()
    grown.consensus_warmup(big, rounds)
    torch.cuda.synchronize()
    per = rounds * grown.choco.gossip_steps * grown.spec.n_buckets
    codes = ({"qsgd_codes": per, "dequantize": per}
             if compressor == "qsgd" else {})
    assert dispatch.launch_counts() == _counts(ef_update_bf16=per, **codes)
    assert all(b.any() for b in big.x_hat)


def moved_selections(tr, gpu_state, cpu_state):
    """Card against CPU after sparse gossip.  A summation-order difference
    in a gradient can move a selection at the k-th magnitude; that moves
    x_hat there by a whole delta (> 1e-4), and x by gamma times at most
    twice the largest |x_hat|.  Returns the count of such coordinates, and
    holds x elsewhere to 1e-5 + 1e-5 max|x|."""
    moved = 0
    for xg, xc, hg, hc, g in zip(gpu_state.x, cpu_state.x, gpu_state.x_hat,
                                 cpu_state.x_hat, tr.exchange.bucket_gammas):
        xg, hg = xg.cpu(), hg.cpu()
        at = (hg - hc).abs() > 1e-4
        moved += int(at.sum())
        dx = (xg - xc).abs()
        if (~at).any():
            assert float(dx[~at].max()) <= 1e-5 + 1e-5 * float(xc.abs().max())
        if at.any():
            assert float(dx[at].max()) <= 1e-5 + 2 * g * float(hc.abs().max())
    return moved


@pytest.mark.cuda
@pytest.mark.parametrize("compressor", ["top_k", "block_top_k"])
def test_trainer_sparse_gossip_agrees_with_cpu(cuda, compressor):
    """Top-k gossip: one EF-update launch per bucket per round, no codes,
    no decode kernel and no mask kernel (sparse payloads decode by
    scatter); losses within 1e-5 relative of the CPU run's, iterates as
    ``moved_selections`` says, with no coordinate moved: on an H100 none
    has moved at these seeds, so one that does is a difference to look
    into."""
    dispatch.reset_launch_counts()
    tr, state, losses = _run(compressor, cuda)
    launches = 2 * tr.choco.gossip_steps * tr.spec.n_buckets
    assert dispatch.launch_counts() == _counts(ef_update=launches)
    _, cpu_state, cpu_losses = _run(compressor, "cpu")
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    assert moved_selections(tr, state, cpu_state) == 0


_CARD_EXCHANGES = (("qsgd", {"s": 16}), ("top_k", {"fraction": 0.05}),
                   ("sign", {}))


def _card_exchange_case(name, kw):
    from repro_torch.comm import gossip, packing, schedule
    from repro_torch.core import compression, topology
    comp = compression.make_compressor(name, **kw)
    shapes = ((300, 70), (5000,), (128, 33), (3, 1000))
    spec = packing.make_bucket_spec(
        [torch.empty(s, device="meta") for s in shapes],
        align=gossip._pack_align(comp), max_bucket_elems=8192)
    rng = np.random.default_rng(len(name))
    bufs = [packing.pack_leaves(spec, [torch.from_numpy(
        scale * rng.standard_normal((N,) + s).astype(np.float32))
        for s in shapes]) for scale in (1.0, 0.5, 0.1)]
    sched = schedule.compile_schedule(topology.make_topology("ring", N))
    return comp, spec, (sched,), bufs


def _card_exchange_rank(rank, store, out_dir):
    from repro_torch.comm import gossip
    from repro_torch.launch import env, mesh
    group = mesh.make_node_group(N, "cuda", env.file_rendezvous(store, rank, N),
                                 timeout_s=120)
    dispatch.reset_launch_counts()
    out = {"staged": group.staged, "backend": group.backend}
    for name, kw in _CARD_EXCHANGES:
        comp, spec, scheds, bufs = _card_exchange_case(name, kw)
        ex = gossip.make_dist_choco_exchange(
            spec=spec, schedules=scheds, compressor=comp, gamma=0.25,
            gossip_steps=2, group=group)
        parts = [[b[rank:rank + 1].to(group.device) for b in p] for p in bufs]
        ex(*parts, seed=3)
        out[name] = [[b.cpu() for b in p] for p in parts]
    torch.cuda.synchronize()
    out["launches"] = dispatch.launch_counts()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


@pytest.mark.cuda
def test_dist_exchange_on_the_card_bit_equal_to_stacked(cuda, tmp_path):
    """4 ranks run the per-rank exchange, 2 gossip rounds: x, x_hat and s
    bit-equal to the stacked exchange on the card on the same inputs; each
    rank ran the probe kernel once and decoded its own and both
    neighbours' QSGD / sign payloads through the dequantize kernel.  On
    one card the ranks share it over gloo, staged through pinned host
    buffers; on four cards each rank has its own, over NCCL."""
    from repro_torch.comm import gossip
    from repro_torch.launch import mesh
    mesh.spawn_ranks(_card_exchange_rank, N,
                     (str(tmp_path / "store"), str(tmp_path)), deadline_s=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(N)]
    for name, kw in _CARD_EXCHANGES:
        comp, spec, scheds, bufs = _card_exchange_case(name, kw)
        parts = [[b.to(cuda) for b in p] for p in bufs]
        gossip.make_choco_exchange(spec=spec, schedules=scheds,
                                   compressor=comp, gamma=0.25,
                                   gossip_steps=2)(*parts, seed=3)
        for r, res in enumerate(ranks):
            for want, got in zip(parts, res[name]):
                for w, g in zip(want, got):
                    assert torch.equal(g[0], w[r].cpu()), (name, r)
    # QSGD and sign: 2 rounds x buckets x (own payload + 2 neighbours')
    decodes = sum(2 * _card_exchange_case(name, kw)[1].n_buckets * 3
                  for name, kw in _CARD_EXCHANGES if name != "top_k")
    backend, staged = mesh.transport_for("cuda", torch.cuda.device_count(), N)
    for res in ranks:
        assert (res["backend"], res["staged"]) == (backend, staged)
        assert res["launches"]["probe_scale"] == 1
        assert res["launches"]["dequantize"] == decodes


def _ties(seed, shape, device):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, shape).astype(np.float32)
    x[::3] = 1.0
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cols", [128, 256, 1024])
@pytest.mark.parametrize("k", [1, 2, 13])
def test_block_topk_mask_bit_equal_to_plain(cuda, k, cols, ties):
    shape = (1000, cols)
    x = _ties(cols, shape, cuda) if ties else _normal(cols, shape, cuda)
    mask, thresh = _launched("block_topk_mask",
                             lambda: dispatch.block_topk_mask(x, k))
    want_mask, want_thresh = ref.block_topk_mask_ref(x, k)
    assert torch.equal(mask, want_mask) and torch.equal(thresh, want_thresh)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_block_topk_compress_vector_through_the_kernel(cuda):
    from repro_torch.kernels import ops
    x = _normal(7, (1_000_003,), cuda)
    got = _launched("block_topk_mask",
                    lambda: ops.block_topk_compress_vector(x, 13))
    assert torch.equal(got.cpu(), ops.block_topk_compress_vector(x.cpu(), 13))


@pytest.mark.cuda
def test_topk_selection_on_the_card_matches_the_cpu(cuda):
    """The tie rule holds on the card: the same indices, in the same order,
    as on the CPU (torch.topk alone would break ties differently)."""
    from repro_torch.kernels import ops
    x = _ties(3, (4, 70_001), cuda)
    for k in (1, 700, 5000):
        assert torch.equal(ops.topk_rows(x, k).cpu(),
                           ops.topk_rows(x.cpu(), k))
    v, i = ops.block_topk_select(x, 2)
    cv, ci = ops.block_topk_select(x.cpu(), 2)
    assert torch.equal(v.cpu(), cv) and torch.equal(i.cpu(), ci)


@pytest.mark.cuda
def test_topk_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _normal(0, (8, 2048), cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        dispatch.block_topk_mask(x, 2)
    with pytest.raises(ValueError, match="multiple of 128"):
        dispatch.block_topk_mask(x[:, :100].contiguous(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.block_topk_mask(x[:, :256], 2)


def _attn_inputs(seed, n, s, h, kv, dh, dtype, device):
    return [_normal(seed + i, (n, s, x, dh), device).to(dtype)
            for i, x in enumerate((h, kv, kv))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,h,kv,dh,dtype,causal,softcap", [
    (1, 2048, 16, 8, 128, torch.bfloat16, True, None),
    (2, 1000, 16, 8, 128, torch.bfloat16, True, None),
    (2, 512, 8, 8, 64, torch.bfloat16, False, 50.0),
    (2, 1000, 16, 8, 128, torch.bfloat16, False, None),
    (2, 512, 8, 8, 64, torch.float32, False, 50.0),
    (1, 2048, 16, 8, 128, torch.float32, True, None),
    (2, 1000, 16, 8, 128, torch.float32, True, None),
    (2, 512, 8, 8, 64, torch.float32, True, 50.0),
])
def test_flash_attention_kernel_matches_plain(cuda, n, s, h, kv, dh, dtype,
                                              causal, softcap):
    """bf16 (the tensor-core kernel, P rounded to bf16 as the plain version
    rounds it): contract (a), max|d| / max|want| within FLASH_BF16_RTOL and
    at most FLASH_BF16_ULP_SHARE of the elements more than one bf16 ulp
    apart; f32 (the 3xTF32 tensor-core kernel): within 1e-5 of max |out|
    of the plain version, whose matmuls run in full f32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v = _attn_inputs(s, n, s, h, kv, dh, dtype, cuda)
    got = _launched("flash_attention", lambda: dispatch.flash_attention(
        q, k, v, causal=causal, softcap=softcap))
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        rel, share = flash_kernel.bf16_gap(got, want)
        assert rel <= flash_kernel.FLASH_BF16_RTOL
        assert share <= flash_kernel.FLASH_BF16_ULP_SHARE
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,h,kv,dh,dtype,causal,softcap,window", [
    (1, 2048, 16, 8, 256, torch.bfloat16, True, 50.0, None),
    (2, 1000, 16, 8, 256, torch.bfloat16, True, None, 300),
    (2, 1000, 16, 16, 256, torch.bfloat16, False, 50.0, None),
    (2, 1000, 16, 8, 256, torch.bfloat16, False, None, 300),
    (1, 2048, 16, 8, 256, torch.bfloat16, True, 50.0, 512),
    (2, 1000, 16, 8, 128, torch.bfloat16, True, None, 300),
    (2, 1000, 16, 8, 128, torch.bfloat16, False, None, 129),
    (2, 512, 4, 2, 64, torch.bfloat16, True, 50.0, 16),
    (2, 1000, 8, 8, 64, torch.float32, True, 50.0, 300),
    (2, 1000, 16, 8, 128, torch.float32, True, 50.0, 300),
    (2, 1000, 8, 4, 64, torch.float32, False, None, 100),
    (1, 700, 4, 2, 128, torch.float32, True, None, 1),
    (1, 2048, 16, 8, 256, torch.float32, True, 50.0, None),
    (2, 1000, 16, 8, 256, torch.float32, True, None, 300),
    (2, 1000, 16, 16, 256, torch.float32, False, 50.0, None),
    (2, 1000, 16, 8, 256, torch.float32, False, None, 300),
    (1, 2048, 16, 8, 256, torch.float32, True, 50.0, 512),
    (1, 700, 4, 2, 256, torch.float32, True, None, 1),
])
def test_flash_attention_kernel_dh256_and_window_match_plain(
        cuda, n, s, h, kv, dh, dtype, causal, softcap, window):
    """The bf16 kernel at Dh 256 and both kernels with a sliding window,
    to the contracts of the test above; each launch counted under its
    variant."""
    q, k, v = _attn_inputs(s + dh, n, s, h, kv, dh, dtype, cuda)
    variants = flash_kernel.flash_attention.variants
    name = flash_kernel.variant(dtype, dh, window)
    before = variants[name]
    got = _launched("flash_attention", lambda: dispatch.flash_attention(
        q, k, v, causal=causal, softcap=softcap, window=window))
    assert variants[name] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                   window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        rel, share = flash_kernel.bf16_gap(got, want)
        assert rel <= flash_kernel.FLASH_BF16_RTOL
        assert share <= flash_kernel.FLASH_BF16_ULP_SHARE
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,h,kv,dtype,causal,softcap,window", [
    (1, 1500, 16, 16, torch.bfloat16, False, None, None),
    (2, 1000, 16, 16, torch.bfloat16, True, None, None),
    (2, 1000, 8, 2, torch.bfloat16, False, 50.0, None),
    (2, 1000, 16, 8, torch.bfloat16, True, None, 300),
    (1, 200, 4, 4, torch.bfloat16, False, None, 129),
    (1, 1500, 16, 16, torch.float32, False, None, None),
    (2, 1000, 16, 16, torch.float32, True, None, None),
    (2, 1000, 8, 2, torch.float32, False, 50.0, None),
    (2, 1000, 16, 8, torch.float32, True, None, 300),
    (1, 200, 4, 4, torch.float32, False, None, 129),
])
def test_flash_attention_kernel_dh80_matches_plain(cuda, n, s, h, kv, dtype,
                                                   causal, softcap, window):
    """Both kernels at head dim 80 (hubert-xlarge's: bf16 padded to two
    64-column boxes with TMA's zero fill, f32 in three 32-column boxes
    with P V at n80), at ragged lengths, causal or not, GQA, a softcap and
    a window, to the contracts of the tests above; each launch counted
    under its variant ("bf16_dh80", "f32_dh80_window", ...)."""
    q, k, v = _attn_inputs(s + 80, n, s, h, kv, 80, dtype, cuda)
    variants = flash_kernel.flash_attention.variants
    name = flash_kernel.variant(dtype, 80, window)
    before = variants[name]
    got = _launched("flash_attention", lambda: dispatch.flash_attention(
        q, k, v, causal=causal, softcap=softcap, window=window))
    assert variants[name] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                   window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        rel, share = flash_kernel.bf16_gap(got, want)
        assert rel <= flash_kernel.FLASH_BF16_RTOL
        assert share <= flash_kernel.FLASH_BF16_ULP_SHARE
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,h,kv,dtype,causal,softcap,window", [
    (1, 2048, 32, 4, torch.bfloat16, True, None, None),
    (2, 1000, 4, 2, torch.bfloat16, True, None, None),
    (2, 1000, 8, 2, torch.bfloat16, False, 50.0, None),
    (2, 1000, 4, 2, torch.bfloat16, True, None, 300),
    (1, 200, 4, 4, torch.bfloat16, False, None, 129),
    (1, 2048, 32, 4, torch.float32, True, None, None),
    (2, 1000, 4, 2, torch.float32, True, None, None),
    (2, 1000, 8, 2, torch.float32, False, 50.0, None),
    (2, 1000, 4, 2, torch.float32, True, None, 300),
    (1, 200, 4, 4, torch.float32, False, None, 129),
])
def test_flash_attention_kernel_dh32_matches_plain(cuda, n, s, h, kv, dtype,
                                                   causal, softcap, window):
    """Both kernels at head dim 32 (the qwen3-moe, llama4 and yi-9b smoke
    models': bf16 in one 64-column box with TMA's zero fill and P V at
    n64, f32 in one 32-column box with P V at n32), at ragged lengths,
    causal or not, GQA, a softcap and a window, to the contracts of the
    tests above; each launch counted under its variant ("bf16_dh32",
    "f32_dh32_window", ...)."""
    q, k, v = _attn_inputs(s + 32, n, s, h, kv, 32, dtype, cuda)
    variants = flash_kernel.flash_attention.variants
    name = flash_kernel.variant(dtype, 32, window)
    before = variants[name]
    got = _launched("flash_attention", lambda: dispatch.flash_attention(
        q, k, v, causal=causal, softcap=softcap, window=window))
    assert variants[name] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap,
                                   window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        rel, share = flash_kernel.bf16_gap(got, want)
        assert rel <= flash_kernel.FLASH_BF16_RTOL
        assert share <= flash_kernel.FLASH_BF16_ULP_SHARE
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b"])
def test_frontend_prefill_agrees_with_cpu(cuda, arch):
    """The frontends' f32 smoke models through the flash kernel, card
    against CPU within 1e-5 (+ 1e-5 relative) of the logits: hubert at
    head dim 80 (its full config's), non-causal, over 300 frames, prefill
    logits; llava's prefill of 16 patches and 40 text tokens, then 8
    decode steps past it.  The caches within 1e-4 (+ 1e-5 relative): on an
    H100 (80GB HBM3, 700 W) hubert's layer-0 k cache, which no attention
    has touched, differed from the CPU's by 5.2e-05 at position 261 in 3
    of 384,000 elements, above the qwen3 prefill test's 4e-5 (measured at
    200 positions): the rotary angle is the position times an inverse
    frequency, and the devices' frequencies and sines differ by ulps."""
    from repro_torch.data.synthetic import make_lm_batch_fn
    kw = dict(dtype="float32", attn_impl="chunked")
    if arch == "hubert-xlarge":
        kw["head_dim"] = 80
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    model = Model(cfg)
    params = model.init(1, 0, "cpu")
    seq = 300 if arch == "hubert-xlarge" else 56
    batch = {k: torch.from_numpy(v) for k, v in
             make_lm_batch_fn(cfg, seq, 2, 1, seed=3)().items()}
    batch = {k: v.long() if k in ("tokens", "labels", "targets") else v
             for k, v in batch.items()}
    follow = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 2, 8)))
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = {k: v.to(device) for k, v in params.items()}
        dispatch.reset_launch_counts()
        logits, cache = model.prefill(p, {k: v.to(device)
                                          for k, v in batch.items()})
        if device.type == "cuda":
            assert dispatch.launch_counts()["flash_attention"] == cfg.n_layers
        steps = [logits.cpu()]
        if arch != "hubert-xlarge":
            cache = {k: torch.cat([c, c.new_zeros(c.shape[:3] + (8,)
                                                  + c.shape[4:])], dim=3)
                     for k, c in cache.items()}
            for t in range(8):
                lg, cache = model.decode_step(
                    p, follow[:, :, t:t + 1].to(device), cache,
                    torch.full((2,), seq + t, device=device))
                steps.append(lg.cpu())
        out[device.type] = (torch.cat(steps, dim=2),
                            {k: c.cpu() for k, c in cache.items()})
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for name, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], want, rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,attn_impl", [
    ("gemma2-9b", "chunked"), ("gemma2-9b", "naive"), ("gemma-7b", "chunked"),
    ("yi-9b", "naive"), ("yi-9b", "chunked"),
    ("qwen3-moe-30b-a3b", "chunked"), ("qwen3-moe-30b-a3b", "naive"),
    ("llama4-maverick-400b-a17b", "chunked"),
    ("llama4-maverick-400b-a17b", "naive")])
def test_dense_variant_serving_agrees_with_cpu(cuda, arch, attn_impl):
    """The f32 smoke model's prefill of 24 tokens and 40 decode steps past
    it (gemma2's local rings of 16 wrap), on the card against the CPU,
    within 1e-5 (+ 1e-5 relative) of the logits; the MoE smoke models
    (their experts routed on each device; head dim 32, as yi-9b's, through
    the f32 kernel when chunked) too."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              attn_impl=attn_impl)
    model = Model(cfg)
    params = model.init(1, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 2, 64)))
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = {k: v.to(device) for k, v in params.items()}
        t = toks.to(device)
        cache = model.init_cache(2, 64, device)
        model.hidden(p, t[:, :, :24], cache)
        steps = []
        for i in range(24, 64):
            lg, cache = model.decode_step(p, t[:, :, i:i + 1], cache,
                                          torch.full((2,), i, device=device))
            steps.append(lg.cpu())
        out[device.type] = torch.cat(steps, dim=2)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _attn_inputs(0, 1, 128, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        dispatch.flash_attention(q[..., :48].contiguous(),
                                 k[..., :48].contiguous(),
                                 v[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        # the right shape, laid out (N, KV, S, Dh) underneath
        dispatch.flash_attention(q, k.transpose(1, 2).contiguous()
                                 .transpose(1, 2), v)
    with pytest.raises(ValueError, match="shape"):
        dispatch.flash_attention(q, k[:, :64].contiguous(), v)
    with pytest.raises(RuntimeError, match="no backward"):
        dispatch.flash_attention(q.requires_grad_(), k, v)
    # the bf16 kernel loads by TMA: a base 2 bytes off 16-byte alignment
    qb, kb, vb = (t.detach().to(torch.bfloat16) for t in (q, k, v))
    flat = torch.empty(1 + vb.numel(), dtype=torch.bfloat16, device=cuda)
    off = flat[1:].view(vb.shape).copy_(vb)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dispatch.flash_attention(qb, kb, off)
    # the f32 kernel loads K and V 16 bytes at a time: a base 4 bytes off
    flat = torch.empty(1 + v.numel(), device=cuda)
    off = flat[1:].view(v.shape).copy_(v.detach())
    with pytest.raises(ValueError, match="16-byte aligned"):
        dispatch.flash_attention(q.detach(), k, off)


@pytest.mark.cuda
def test_prefill_goes_through_the_flash_kernel_and_agrees_with_cpu(cuda):
    """Logits within 1e-5 (+ 1e-5 relative) of the CPU's; the k and v
    caches within 4e-5 (+ 1e-5 relative).  The cache bound comes from
    ``chip_smoke.py:prefill_budget``, which then looped over five weight
    draws (NVIDIA H100 80GB HBM3, 700 W): the flash kernel differs from
    its plain version on the card by at most 4.8e-07 in layer 0's
    attention output, while the card and the CPU differ there by 2.0e-06
    to 3.0e-06 through the kernel
    and 2.5e-06 to 2.9e-06 with naive attention (no kernel of the port):
    matmul order, not the kernel.  qk-norm amplifies it in the caches,
    where naive attention on the card differs from the CPU by up to
    1.8358e-05 and the kernel path by up to 1.4782e-05, above the 1e-5 the
    logits keep.  The script now measures this test's own draw and holds
    it to these bounds: its k cache differs by 1.4782e-05, 0.904 of the
    bound."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32", attn_impl="chunked")
    model = Model(cfg)
    params = model.init(1, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 2, 200)))
    want, want_cache = model.prefill(params, toks)
    dispatch.reset_launch_counts()
    got, cache = model.prefill({k: v.to(cuda) for k, v in params.items()},
                               toks.to(cuda))
    assert dispatch.launch_counts()["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert sorted(cache) == sorted(want_cache)
    for name in want_cache:
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   rtol=1e-5, atol=4e-5)


# -- the topology-process engine's replica update -----------------------------------

def _replica_inputs(length, state_dtype, q_dtype, device, width, rounds):
    """x f32 and x_hat in ``state_dtype`` as bucket-slot views [:, 128:128
    + length] of (N, width) buffers, ``rounds`` replicas the same way, the
    payloads (q_self and one per round) slots of (N, width + 64) buffers."""
    def mk(i, scale, dtype, w):
        full = (_normal(length + i, (N, w), device) * scale).to(dtype)
        return full[:, SLOT:SLOT + length]
    x, h = mk(0, 1.0, torch.float32, width), mk(1, 0.5, state_dtype, width)
    reps = [mk(2 + r, 0.5, state_dtype, width) for r in range(rounds)]
    qs = mk(10, 0.1, q_dtype, width + 64)
    qr = [mk(11 + r, 0.1, q_dtype, width + 64) for r in range(rounds)]
    return x, h, reps, qs, qr


def _linkfail(x, h, qs, reps, qr, w, gamma):
    """The link-failure update: the ring form at tau = 0."""
    return dispatch.replica_stale(x, h, qs, reps, qr, [], [[]] * len(reps),
                                  w, None, gamma)


def _linkfail_ref(x, h, qs, reps, qr, w, gamma):
    return ref.replica_stale_ref(x, h, qs, reps, qr, [], [[]] * len(reps),
                                 w, None, gamma)[:3]


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("length", [4096, 1_000_003])
def test_replica_update_bit_equal_to_plain(cuda, state_dtype, q_dtype,
                                           length):
    """Both forms of the replica update, in place, on bucket-slot views
    (the per-leaf engine's call), against their plain versions bit for
    bit: matching with per-node send bits and weights (one row outside the
    round), link failures with 3 replicas and a different link mask per
    round; one launch per call; nothing outside the slots moves."""
    x, h, reps, qs, qr = _replica_inputs(length, state_dtype, q_dtype, cuda,
                                         length + 300, 3)
    send = torch.tensor((1.0, 1.0, 0.0, 1.0), device=cuda)
    gv = torch.tensor((2.5e-4, 2.5e-4, 0.0, 1.25e-4), device=cuda)
    want = ref.replica_matching_ref(x, h, reps[0], qs, qr[0], send, gv)
    base = [t._base for t in (x, h, reps[0])]
    before = [b.clone() for b in base]
    _launched("replica_update", lambda: dispatch.replica_matching(
        x, h, reps[0], qs, qr[0], send, gv))
    for g, w in zip((x, h, reps[0]), want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    for b, old in zip(base, before):
        assert torch.equal(_bits(b[:, :SLOT]), _bits(old[:, :SLOT]))
        assert torch.equal(_bits(b[:, SLOT + length:]),
                           _bits(old[:, SLOT + length:]))
    x, h, reps, qs, qr = _replica_inputs(length, state_dtype, q_dtype, cuda,
                                         length + 300, 3)
    # receive weights under a different link mask per round
    w = torch.tensor([[1 / 3, 1 / 3, 0.0, 1 / 3], [0.25, 0.5, 0.25, 0.5],
                      [0.0, 0.0, 0.2, 0.0]], device=cuda)
    want_x, want_h, want_s = _linkfail_ref(x, h, qs, reps, qr, w, 3.7e-4)
    _launched("replica_update", lambda: _linkfail(x, h, qs, reps, qr, w,
                                                  3.7e-4))
    for g, w in zip([x, h] + reps, [want_x, want_h] + want_s):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replica_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, h, reps, qs, qr = _replica_inputs(64, torch.float32, torch.float32,
                                         cuda, 300, 2)
    w = torch.full((2, N), 0.25, device=cuda)
    with pytest.raises(ValueError, match="one row stride"):
        _linkfail(x, h.contiguous(), qs, reps, qr, w, 0.1)
    with pytest.raises(ValueError, match="w: expected shape"):
        _linkfail(x, h, qs, reps, qr, w[:1], 0.1)
    with pytest.raises(ValueError, match="w: expected a CUDA tensor"):
        _linkfail(x, h, qs, reps, qr, w.cpu(), 0.1)
    with pytest.raises(ValueError, match="payloads of"):
        _linkfail(x, h, qs.to(torch.bfloat16), reps,
                  [q.to(torch.bfloat16) for q in qr], w, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["matching", "linkfail"])
def test_replica_update_takes_any_rows_and_rounds(cuda, form):
    """More than 64 node rows, and under link failures more than 64
    rounds (a star or fully connected graph of 70 nodes, stacked), bit for
    bit against the plain version: the kernel caps neither, as the CPU
    route and the JAX engine do not."""
    rows, rounds, length = 70, 69 if form == "linkfail" else 1, 1000
    gen = torch.Generator(device=cuda).manual_seed(5)
    mk = lambda sc: torch.randn((rows, length), generator=gen,
                                device=cuda) * sc
    x, h, qs = mk(1.0), mk(0.5), mk(0.1)
    reps, qr = [mk(0.5) for _ in range(rounds)], [mk(0.1)
                                                   for _ in range(rounds)]
    if form == "matching":
        send = (torch.arange(rows, device=cuda) % 3 != 0).float()
        gv = torch.full((rows,), 2.5e-4, device=cuda)
        want = ref.replica_matching_ref(x, h, reps[0], qs, qr[0], send, gv)
        _launched("replica_update", lambda: dispatch.replica_matching(
            x, h, reps[0], qs, qr[0], send, gv))
        got = (x, h, reps[0])
    else:
        keep = torch.rand((rounds, rows), generator=gen, device=cuda) > 0.3
        w = keep.float() / rounds
        want_x, want_h, want_s = _linkfail_ref(x, h, qs, reps, qr, w, 3.7e-4)
        want = [want_x, want_h] + want_s
        _launched("replica_update", lambda: _linkfail(x, h, qs, reps, qr, w,
                                                      3.7e-4))
        got = [x, h] + reps
    for g, wt in zip(got, want):
        assert torch.equal(_bits(g), _bits(wt))


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("tau", [0, 1, 3])
@pytest.mark.parametrize("length", [4096, 1_000_003])
def test_replica_stale_bit_equal_to_plain(cuda, state_dtype, q_dtype, tau,
                                          length):
    """The bounded-staleness form, in place, on bucket-slot views with 3
    rounds and every delay 0..tau on some row, against
    ``ref.replica_stale_ref`` bit for bit (4096: the kernel's 4-wide
    form; an odd length: one element a thread): x, x_hat, the replicas
    and slot 0 of the own ring and each receive ring; one launch per
    call; the older ring slots untouched."""
    x, h, reps, qs, qr = _replica_inputs(length, state_dtype, q_dtype, cuda,
                                         length + 300, 3)
    slot = lambda i: (_normal(i, (N, length + 300), cuda) * 0.1).to(
        state_dtype)[:, SLOT:SLOT + length]
    own = [slot(40 + j) for j in range(tau)]
    rings = [[slot(50 + 10 * r + j) for j in range(tau)] for r in range(3)]
    w = torch.tensor([[1 / 3, 1 / 3, 0.0, 1 / 3], [0.25, 0.5, 0.25, 0.5],
                      [0.0, 0.0, 0.2, 0.0]], device=cuda)
    delays = torch.tensor([[(i + r) % (tau + 1) for i in range(N)]
                           for r in range(3)], dtype=torch.int32, device=cuda)
    old = [t.clone() for t in own[1:]] + [t.clone() for rg in rings
                                          for t in rg[1:]]
    want_x, want_h, want_s, want_own, want_rings = ref.replica_stale_ref(
        x, h, qs, reps, qr, own, rings, w, delays, 3.7e-4)
    _launched("replica_update", lambda: dispatch.replica_stale(
        x, h, qs, reps, qr, own, rings, w, delays, 3.7e-4))
    got = [x, h] + reps
    want = [want_x, want_h] + want_s
    if tau:
        got += [own[0]] + [rg[0] for rg in rings]
        want += [want_own] + want_rings
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(_bits(g), _bits(wt))
    for g, o in zip(own[1:] + [t for rg in rings for t in rg[1:]], old):
        assert torch.equal(_bits(g), _bits(o))


@pytest.mark.cuda
def test_stale_trainer_launches_per_unit_per_round(cuda):
    """Under bounded staleness (tau 2, a straggler link), per step and
    bucket one compression and one replica-update launch, no EF launch;
    the delays the same as the CPU run's and the losses within 1e-4."""
    import dataclasses as dc
    dispatch.reset_launch_counts()
    runs = {}
    for dev in (cuda, "cpu"):
        cfg = dc.replace(get_config("qwen3-1.7b", smoke=True), dtype="float32")
        tr = DecentralizedTrainer(
            model=Model(cfg), choco=ChocoConfig(
                compressor="qsgd", comp_kwargs=(("s", 16),),
                topology_process="staleness", max_staleness=2,
                straggler_edges="0-1"),
            n_nodes=N, optimizer=momentum_sgd(),
            lr_fn=cosine_schedule(0.1, 1, 2), device=dev)
        state = tr.state_from_params(tr.model.init(N, 0, "cpu"))
        batches = make_lm_batch_fn(cfg, 64, 2, N, 1.0)
        losses, delays = [], []
        for _ in range(2):
            losses.append(tr.step(state, tr.batch_to_device(batches()))["loss"])
            delays.append([d.tolist() for d in tr.exchange.last_samples])
        runs[str(dev)] = (losses, delays)
        if dev != "cpu":
            per = 2 * tr.spec.n_buckets
            assert dispatch.launch_counts() == _counts(
                replica_update=per, qsgd_codes=per, dequantize=per)
    (lc, dc_), (lh, dh) = runs[str(cuda)], runs["cpu"]
    assert dc_ == dh
    assert all(np.isfinite(lc))
    np.testing.assert_allclose(lc, lh, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("process,compressor,state_dtype,packed", [
    ("matching", "qsgd", "float32", True),
    ("matching", "top_k", "bfloat16", False),
    ("linkfail", "qsgd", "bfloat16", True),
    ("linkfail", "sign", "float32", False)])
def test_process_trainer_launches_per_unit_per_round(cuda, process,
                                                     compressor, state_dtype,
                                                     packed):
    """Under a process, per step and unit (bucket or leaf): one
    compression (under matching, of the one sampled round: one codes and
    one dequantize, not one per schedule round) and one replica-update
    launch, no EF launch; one sample per gossip round; losses finite and
    within 1e-4 of the CPU run's (the samples are drawn on the host, the
    same on both)."""
    dispatch.reset_launch_counts()
    tr, state, losses = _run(compressor, cuda, state_dtype=state_dtype,
                             packed=packed, process=process)
    units = tr.spec.n_buckets if packed else len(tr.paths)
    per = 2 * tr.choco.gossip_steps * units
    codes = ({"qsgd": {"qsgd_codes" if packed else "qsgd_leaf_codes": per,
                       "dequantize": per},
              "sign": {"sign_codes": per, "dequantize": per}}
             .get(compressor, {}))
    assert dispatch.launch_counts() == _counts(replica_update=per, **codes)
    assert len(tr.exchange.last_samples) == tr.choco.gossip_steps
    _, _, cpu_losses = _run(compressor, "cpu", state_dtype=state_dtype,
                            packed=packed, process=process)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 63, 257])
def test_wkv6_kernel_matches_plain(cuda, s, carried, dtype):
    """Out and the final state within 1e-5 of their largest value (FMA
    contraction on in the kernel, none in the plain version)."""
    rng = np.random.default_rng(s)
    shape = (2, s, 4, 64)
    r, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * 0.5).to(cuda, dtype) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.3, 0.999, shape).astype(np.float32)).to(cuda)
    u = _normal(s + 1, (2, 4, 64), cuda) * 0.1
    state = _normal(s + 2, (2, 4, 64, 64), cuda) if carried else None
    out, final = _launched("wkv6", lambda: dispatch.wkv6(r, k, v, w, u, state))
    torch.cuda.synchronize()
    want, want_final = ref.wkv6_ref(r, k, v, w, u, state)
    for got, exp in ((out, want), (final, want_final)):
        assert got.dtype == torch.float32
        assert float((got - exp).abs().max()) <= 1e-5 * float(exp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b"])
def test_recurrent_serving_agrees_with_cpu(cuda, arch):
    """The f32 smoke model (zamba2's shared block through the f32 flash
    kernel at Dh 64) over a 32-token prompt and 16 decode steps past it,
    on the card against the CPU, within 1e-5 (+ 1e-5 relative)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              attn_impl="chunked")
    model = Model(cfg)
    params = model.init(1, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 2, 48)))
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = {k: v.to(device) for k, v in params.items()}
        t = toks.to(device)
        cache = model.init_cache(2, 48, device)
        model.hidden(p, t[:, :, :32], cache)
        steps = []
        for i in range(32, 48):
            lg, cache = model.decode_step(p, t[:, :, i:i + 1], cache,
                                          torch.full((2,), i, device=device))
            steps.append(lg.cpu())
        out[device.type] = torch.cat(steps, dim=2)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5)
