"""The PyTorch port on the card: each CUDA kernel against its plain version,
the trainer through the gossip kernels (with QSGD, sign and top-k gossip),
the per-rank exchange (4 ranks sharing the card) against the stacked one,
and the prefill through the flash kernel.

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


def _run(compressor, device, steps=2):
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    kw = {"qsgd": (("s", 16),), "sign": ()}.get(compressor,
                                                 (("fraction", 0.05),))
    tr = DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=compressor,
                                            comp_kwargs=kw),
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
])
def test_flash_attention_kernel_matches_plain(cuda, n, s, h, kv, dh, dtype,
                                              causal, softcap):
    """bf16 (the tensor-core kernel, P rounded to bf16 as the plain version
    rounds it): contract (a), max|d| / max|want| within FLASH_BF16_RTOL and
    at most FLASH_BF16_ULP_SHARE of the elements more than one bf16 ulp
    apart; f32 (the CUDA-core kernel): within 1e-5 of max |out|."""
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
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _attn_inputs(0, 1, 128, 4, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        dispatch.flash_attention(q[..., :32].contiguous(),
                                 k[..., :32].contiguous(),
                                 v[..., :32].contiguous())
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
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   rtol=1e-5, atol=4e-5)
