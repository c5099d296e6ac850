"""Kernel layer of the PyTorch port (``src/repro_torch/kernels``).

On the CPU each plain version is held against the JAX package's Pallas
kernel, run in interpret mode through its own dispatch entry (which pads
to (R, 128) tiles and slices the tail), on the same numpy inputs:

* QSGD and sign codes bit-equal, with the dither xi injected, at
  s in {1, 16, 127, 128, 255} (int8 and int16 codes), at aligned, odd and
  padding-tail lengths;
* dequantize bit-equal;
* the EF update bit-equal to the JAX jnp oracle, and within 2 ulp of the
  Pallas kernel: the reference EF kernel is not reliably bitwise even
  against its own oracle, so the port is held to a ulp bound there.

The flash-attention plain version is held against the Pallas kernel in
interpret mode and against the JAX oracle (see the section below).  The
top-k mask's plain version is bit-equal to the JAX oracle and to the
Pallas kernel in interpret mode, ties included, and
``ops.block_topk_compress_vector`` to the JAX op at odd lengths.

The routing tests show that a tensor off the CPU never reaches a plain
version.  ``tests/test_torch_cuda.py`` holds each CUDA kernel against its
plain version on the card.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels import flash_attention as flash_kernel

N = 4
LENGTHS = [2048, 1000, 4097]          # tile-aligned, odd, one-past-a-tile
LEVELS = [1, 16, 127, 128, 255]


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qsgd_inputs(seed, length):
    x = _normal(seed, (N, length))
    x[:, ::7] = 0.0                                     # exact zeros
    xi = np.random.default_rng(seed + 1).random((N, length), dtype=np.float32)
    # 1/max|x| (slightly shrunk) drives the levels across the whole [-s, s]
    inv = (0.999 / np.abs(x).max(axis=1)).astype(np.float32)
    return x, xi, inv


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("s", LEVELS)
def test_qsgd_codes_plain_matches_jax_kernel(s, length):
    x, xi, inv = _qsgd_inputs(s * 31 + length, length)
    got = ref.qsgd_codes_ref(torch.from_numpy(x), torch.from_numpy(xi),
                             torch.from_numpy(inv), s)
    assert got.dtype == (torch.int8 if s <= 127 else torch.int16)
    for i in range(N):
        want = jdispatch.qsgd_codes(jnp.asarray(x[i]), jnp.asarray(xi[i]),
                                    jnp.float32(inv[i]), s, backend="pallas")
        assert np.asarray(want).dtype == got.numpy().dtype
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert int(got.abs().max()) >= s - 1                # the range is exercised


@pytest.mark.parametrize("length", LENGTHS)
def test_sign_codes_plain_matches_jax_kernel(length):
    x = _normal(length, (N, length))
    x[:, ::5] = 0.0
    got = ref.sign_codes_ref(torch.from_numpy(x))
    for i in range(N):
        want = jdispatch.sign_codes(jnp.asarray(x[i]), backend="pallas")
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("s", [16, 255])
def test_dequantize_plain_matches_jax_kernel(s, length):
    rng = np.random.default_rng(s + length)
    ctype = np.int8 if s <= 127 else np.int16
    codes = rng.integers(-s, s + 1, (N, length)).astype(ctype)
    scale = (rng.random(N) * 1e-2).astype(np.float32)
    got = ref.dequantize_ref(torch.from_numpy(codes), torch.from_numpy(scale))
    for i in range(N):
        want = jops.qsgd_decompress_vector(jnp.asarray(codes[i]),
                                           jnp.float32(scale[i]),
                                           interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def _node_weights(w):
    """A weight as the EF update takes it: (N,) f32, one entry per node
    (a float fills the vector)."""
    return torch.tensor(w if isinstance(w, tuple) else (w,) * N,
                        dtype=torch.float32)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("coef", [
    (1 / 3, 1 / 3, 2.8e-4), (0.5, 0.5, 0.046), (1.0, 0.0, 1.0),
    # per-node weights: star's self weights at n = 4, and chain's
    ((0.25, 0.75, 0.75, 0.75), 0.25, 0.1),
    ((2 / 3, 1 / 3, 1 / 3, 2 / 3), (1 / 3, 0.5, 0.25, 1.0), 0.046)])
def test_ef_update_plain_matches_jax(coef, length):
    """Bit-equal to the JAX package's jnp oracle, node row i with node i's
    weights: a uniform weight as the python float the JAX engine keeps
    (so the ring's numbers do not move by a bit with the vector form),
    per-node weights as the f32 scalar it gathers by node index.  Within
    2 ulp of the Pallas kernel, counted at the scale of each output's
    largest operand (the interpreted kernel rounds s + (w_self q_self +
    w_nbr q_nbr) differently from its own oracle, by up to 2 ulp)."""
    ins = [_normal(10 * length + i, (N, length)) for i in range(5)]
    w_self, w_nbr = _node_weights(coef[0]), _node_weights(coef[1])
    got = ref.ef_update_ref(*map(torch.from_numpy, ins), w_self, w_nbr,
                            coef[2])
    x_half, x_hat, s, q_self, q_nbr = ins
    ws, wn = w_self.numpy()[:, None], w_nbr.numpy()[:, None]
    mix = np.abs(ws * q_self) + np.abs(wn * q_nbr)
    for i in range(N):
        row = [jnp.asarray(a[i]) for a in ins]
        w = [c if isinstance(c, float) else np.float32(c[i])
             for c in coef[:2]]
        oracle = jref.ef_gossip_update_ref(*row, *w, coef[2])
        kernel = jops.ef_gossip_update_vector(*row, *w, coef[2],
                                              interpret=True)
        for g, o in zip(got, oracle):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(o))
        g = [t[i].numpy() for t in got]
        # 2 ulp of each output's largest operand; x' also inherits
        # gamma times the bound on s'
        tol_s = 2 * np.spacing(np.maximum.reduce(
            [np.abs(s[i]), mix[i], np.abs(g[2])]))
        tol_hat = 2 * np.spacing(np.maximum(np.abs(x_hat[i]), np.abs(g[1])))
        tol_x = 2 * np.spacing(np.maximum.reduce(
            [np.abs(x_half[i]), np.abs(g[0]),
             np.abs(coef[2] * (g[2] - g[1]))])) + abs(coef[2]) * tol_s
        for out, k, tol in zip(g, kernel, (tol_x, tol_hat, tol_s)):
            assert np.all(np.abs(out - np.asarray(k)) <= tol)


def test_cpu_tensors_take_the_plain_versions_without_launches():
    dispatch.reset_launch_counts()
    x, xi, inv = map(torch.from_numpy, _qsgd_inputs(0, 1000))
    codes = dispatch.qsgd_codes(x, xi, inv, 16)
    assert torch.equal(codes, ref.qsgd_codes_ref(x, xi, inv, 16))
    assert torch.equal(dispatch.sign_codes(x), ref.sign_codes_ref(x))
    scale = torch.full((N,), 0.5)
    assert torch.equal(dispatch.dequantize(codes, scale),
                       ref.dequantize_ref(codes, scale))
    # in place, over its own x_half, x_hat and s
    ins = [x + i for i in range(5)]
    inplace = [t.clone() for t in ins[:3]]
    w = _node_weights(0.3)
    got = dispatch.ef_bucket_update(*inplace, *ins[3:], w, w, 0.1)
    assert all(g is t for g, t in zip(got, inplace))
    for a, b in zip(inplace, ref.ef_update_ref(*ins, w, w, 0.1)):
        assert torch.equal(a, b)
    tiles = x.reshape(-1, 125)[:, :1].repeat(1, 128)
    for a, b in zip(dispatch.block_topk_mask(tiles, 3),
                    ref.block_topk_mask_ref(tiles, 3)):
        assert torch.equal(a, b)
    assert torch.equal(dispatch.probe_scale(x), ref.probe_scale_ref(x))
    assert set(dispatch.launch_counts().values()) == {0}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_ENTRIES = {
    "qsgd_codes": lambda: dispatch.qsgd_codes(_meta((N, 8)), _meta((N, 8)),
                                              _meta((N,)), 16),
    "qsgd_leaf_codes": lambda: dispatch.qsgd_leaf_codes(
        _meta((N, 8), torch.bfloat16), _meta((N, 8)), _meta((N,)), 16),
    "sign_codes": lambda: dispatch.sign_codes(_meta((N, 8))),
    "dequantize": lambda: dispatch.dequantize(_meta((N, 8), torch.int8),
                                              _meta((N,))),
    "ef_update": lambda: dispatch.ef_bucket_update(
        *[_meta((N, 8)) for _ in range(5)], _meta((N,)), _meta((N,)), 0.1),
    "ef_update_pipelined": lambda: dispatch.ef_bucket_update(
        *[_meta((N, 8)) for _ in range(5)], _meta((N,)), _meta((N,)), 0.1,
        pipelined=True),
    "ef_update_bf16_pipelined": lambda: dispatch.ef_bucket_update(
        _meta((N, 8)), *[_meta((N, 8), torch.bfloat16) for _ in range(2)],
        *[_meta((N, 8)) for _ in range(2)], _meta((N,)), _meta((N,)), 0.1,
        pipelined=True),
    "block_topk_mask": lambda: dispatch.block_topk_mask(_meta((8, 128)), 2),
    "probe_scale": lambda: dispatch.probe_scale(_meta((8, 128))),
}
#: the library each entry's kernel is in
_LIBRARY = {"block_topk_mask": "topk", "probe_scale": "probe"}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_off_cpu_tensor_never_reaches_a_plain_version(entry, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel loader: when the
    loader fails, the call raises and no plain version runs."""
    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for an off-CPU tensor")

    def loader(name):
        assert name == _LIBRARY.get(entry, "gossip")
        raise RuntimeError("kernel loader reached")

    for name in ("qsgd_codes_ref", "qsgd_leaf_codes_ref", "sign_codes_ref",
                 "dequantize_ref", "ef_update_ref", "ef_update_bf16_ref",
                 "block_topk_mask_ref", "probe_scale_ref"):
        monkeypatch.setattr(ref, name, no_plain)
    monkeypatch.setattr(build, "load_library", loader)
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        _ENTRIES[entry]()


def test_ef_kernel_refuses_aliased_buffers(monkeypatch):
    """The EF kernel updates x_half, x_hat and s in place with no aliasing
    among its five buffers; the wrapper raises before it launches."""
    from repro_torch.kernels import ef_update
    monkeypatch.setattr(build, "load_library", lambda name: None)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    x, q, w = torch.zeros(N, 8), torch.ones(N, 8), _node_weights(0.3)
    with pytest.raises(ValueError, match="five distinct buffers"):
        ef_update.ef_update(x, x.clone(), x.clone(), q, q, w, w, 0.1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("gossip")
    assert not (tmp_path / "build").exists()


# -- flash attention ---------------------------------------------------------------
#
# The plain version against the JAX Pallas kernel in interpret mode (which
# needs S % 128 == 0) and against the JAX oracle ``flash_attention_ref``
# (plain softmax over the KV-repeated heads, any S), float32, within 2e-6
# absolute: outputs are convex combinations of N(0, 1) values, and the
# online softmax sums in another order than one softmax.

FLASH_TOL = 2e-6


def _flash_inputs(seed, n, s, h, kv, dh):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((n, s, x, dh)).astype(np.float32)
            for x in (h, kv))
    v = rng.standard_normal((n, s, kv, dh)).astype(np.float32)
    return q, k, v


def _plain_flash(q, k, v, **kw):
    """The plain version on one torch thread.  On more, the CPU splits its
    vectorised ``exp`` over OpenMP threads, and under load (the 6-worker
    tier-1 run) a worker thread's chunk came out about 6e-5 off once, in
    11,733 of the 131,072 outputs, as MKL's vector math computed the
    rotary ``sin`` off for the per-rank trainer test
    (``test_torch_dist.py``); one thread has no worker chunk."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       **kw).numpy()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("causal,dh", [(True, 64), (False, 64), (True, 256),
                                       (False, 256), (True, 32), (False, 32)],
                         ids=["True", "False", "True-256", "False-256",
                              "True-32", "False-32"])
def test_flash_plain_matches_jax_pallas_kernel(causal, dh):
    from repro.kernels.flash_attention import flash_attention as jflash
    q, k, v = _flash_inputs(0, 2, 256, 4, 2, dh)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    got = _plain_flash(q, k, v, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FLASH_TOL)


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 200])
def test_flash_plain_matches_jax_oracle(s, causal, softcap):
    q, k, v = _flash_inputs(s, 2, s, 4, 2, 64)
    rep = lambda a: jnp.repeat(jnp.asarray(a), 2, axis=2)
    want = jref.flash_attention_ref(jnp.asarray(q), rep(k), rep(v),
                                    causal=causal, softcap=softcap)
    got = _plain_flash(q, k, v, causal=causal, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FLASH_TOL)


# bf16 inputs: the plain version rounds where the tensor-core kernel does
# (logits scaled after the product, row sums over the f32 p, p rounded to
# bf16 before p @ v), so it is no longer the f32 result rounded once.


def _bf16_flash_inputs(seed, n, s, h, kv, dh):
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _flash_inputs(seed, n, s, h, kv, dh)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_plain_bf16_one_block_is_the_rounded_p_formula(dh, causal):
    """At S = 128 (one key block) the bf16 plain version is, bit for bit,
    ``(bf16(exp(l - max)) @ v) / sum(exp(l - max))`` with
    ``l = (q k^T) * (1/sqrt(Dh))`` on the f32 upcasts."""
    q, k, v = _bf16_flash_inputs(dh, 1, 128, 1, 1, dh)
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    q2, k2, v2 = (t[0, :, 0].float() for t in (q, k, v))
    logits = (q2 @ k2.T) * (1.0 / math.sqrt(dh))
    if causal:
        keep = torch.ones(128, 128, dtype=torch.bool).tril()
        logits = torch.where(keep, logits, ref.NEG_INF)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    want = (e.to(torch.bfloat16).float() @ v2) / e.sum(-1, keepdim=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[0, :, 0], want.to(torch.bfloat16))


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_plain_bf16_rounds_p(dh):
    """The rounding of P is really there: the bf16 plain version differs
    from the f32-P result (the f32 path on the upcast inputs, rounded once)
    in about a tenth of its elements by more than one bf16 ulp (measured
    0.10-0.12 at S = 300), within the contract's sanity bound."""
    q, k, v = _bf16_flash_inputs(7, 1, 300, 4, 1, dh)
    got = dispatch.flash_attention(q, k, v, causal=True)
    f32p = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True).to(torch.bfloat16)
    rel, share = flash_kernel.bf16_gap(got, f32p)
    assert not torch.equal(got, f32p)
    assert share > 0.01
    assert rel <= flash_kernel.FLASH_BF16_F32P_RTOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128, 256, 32])
@pytest.mark.parametrize("s", [256, 384])
def test_flash_plain_bf16_matches_jax_pallas_kernel(s, dh, causal):
    """The bf16 plain version against the JAX Pallas kernel in interpret
    mode on the same bf16 inputs.  The Pallas kernel keeps P in f32, so
    the two differ by P's rounding: max|d| / max|want| measured 2.5e-3 to
    6.0e-3 in these cases, held to FLASH_BF16_F32P_RTOL (1e-2)."""
    from repro.kernels.flash_attention import flash_attention as jflash
    q, k, v = _bf16_flash_inputs(s + dh, 2, s, 4, 2, dh)
    want = jflash(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                    for t in (q, k, v)), causal=causal, interpret=True)
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    rel, _ = flash_kernel.bf16_gap(
        got, torch.from_numpy(np.array(want.astype(jnp.float32))))
    assert rel <= flash_kernel.FLASH_BF16_F32P_RTOL


# A sliding window (gemma2's local layers): the plain version against the
# JAX jnp scan ``_chunked_attention(local=True)`` at the same 128-key
# partition (``attn_chunk=128``), which masks every block where the plain
# version skips those wholly before a query tile's window.


def _jax_local_attention(q, k, v, window, causal, softcap):
    from repro.configs.base import get_config as jget_config
    from repro.models.layers import _chunked_attention
    cfg = dataclasses.replace(jget_config("gemma2-9b", smoke=True),
                              attn_chunk=128, sliding_window=window,
                              causal=causal, attn_logit_softcap=softcap)
    rep = q.shape[2] // k.shape[2]
    n, s = q.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s)[None], (n, s))
    out = _chunked_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
        jnp.repeat(jnp.asarray(v), rep, axis=2), cfg, positions, local=True)
    return np.asarray(out)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,dh", [(16, 64), (100, 64), (300, 256)])
def test_flash_plain_window_matches_jax_chunked_local(window, dh, causal,
                                                      softcap):
    """f32 within FLASH_TOL: the same mask and partition, summed in
    another order."""
    q, k, v = _flash_inputs(window + dh, 2, 384, 4, 2, dh)
    want = _jax_local_attention(q, k, v, window, causal, softcap)
    got = _plain_flash(q, k, v, causal=causal, softcap=softcap, window=window)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLASH_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 100, 129, 300])
def test_flash_plain_window_skipping_is_bit_equal_to_masking(window, causal,
                                                             dtype):
    """A key block wholly before a row's window, skipped (per row:
    ``row_tile=1``; per 64- or 128-row tile, as the kernels skip) or
    masked (``row_tile=S``, one tile): the outputs are bit-equal.  The
    first kept key's alpha = exp(-1e30 - m) is exactly 0, which clears
    what the masked blocks summed."""
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _flash_inputs(window, 2, 700, 4, 2, 64))
    run = lambda tile: ref.flash_attention_ref(
        q, k, v, causal=causal, softcap=50.0, window=window, row_tile=tile)
    masked = run(700)
    for tile in (1, 64, 128):
        assert torch.equal(run(tile), masked), tile
    assert torch.isfinite(masked.float()).all()


def test_flash_plain_window_wider_than_the_sequence_is_no_window():
    """A window of S or more keeps every causal key: the windowed plain
    version equals the causal one bit for bit (no block is skipped)."""
    q, k, v = map(torch.from_numpy, _flash_inputs(11, 1, 300, 4, 2, 64))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    for window in (300, 4096):
        got = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        assert torch.equal(got, want)


def test_flash_entries_refuse_head_dims_and_windows_they_do_not_take(
        monkeypatch):
    """Both dtypes take Dh 32, 64, 80, 128 and 256; a window below 1 is
    refused.  Each before any library is loaded."""
    def loader(name):
        raise RuntimeError(f"kernel loader reached: {name}")

    monkeypatch.setattr(build, "load_library", loader)
    for dtype, dh, match in (
            (torch.float32, 96,
             r"the float32 kernel takes \(32, 64, 80, 128, 256\)"),
            (torch.float32, 48, "head dim 48"),
            (torch.bfloat16, 48,
             r"the bfloat16 kernel takes \(32, 64, 80, 128, 256\)"),
            (torch.bfloat16, 96, "head dim 96")):
        q, kv = _meta((1, 128, 4, dh), dtype), _meta((1, 128, 2, dh), dtype)
        with pytest.raises(ValueError, match=match):
            dispatch.flash_attention(q, kv, kv, causal=True)
    q, kv = (_meta((1, 128, h, 256), torch.bfloat16) for h in (4, 2))
    with pytest.raises(RuntimeError, match="loader reached: flash_tc"):
        dispatch.flash_attention(q, kv, kv, causal=True, window=4096)
    for window in (0, -3):
        with pytest.raises(ValueError, match="window"):
            dispatch.flash_attention(q, kv, kv, causal=True, window=window)


# Head dim 256 in f32 (gemma2-9b's and gemma-7b's layers with dtype
# float32): the plain version against the Pallas kernel in interpret mode
# (S 256), the JAX oracle (a ragged S) and the jnp scan
# ``_chunked_attention(local=True)`` (a window), GQA 16/8 and MHA 16/16,
# within 1e-5 of max|out|, the f32 kernel's contract.

F32_DH256_RTOL = 1e-5


@pytest.mark.parametrize("s,h,kv,causal,softcap,window", [
    (256, 16, 8, True, None, None),
    (256, 16, 8, False, None, None),
    (256, 16, 16, True, 50.0, None),
    (300, 16, 8, True, 50.0, None),
    (300, 16, 16, False, None, None),
    (384, 16, 8, True, 50.0, 300),
    (384, 16, 16, False, None, 300),
])
def test_flash_plain_f32_dh256_matches_jax(s, h, kv, causal, softcap, window):
    from repro.kernels.flash_attention import flash_attention as jflash
    q, k, v = _flash_inputs(s + h + kv, 1, s, h, kv, 256)
    if window is not None:
        want = _jax_local_attention(q, k, v, window, causal, softcap)
    elif s % 128 == 0:
        want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 softcap=softcap, interpret=True))
    else:
        rep = lambda a: jnp.repeat(jnp.asarray(a), h // kv, axis=2)
        want = np.asarray(jref.flash_attention_ref(
            jnp.asarray(q), rep(k), rep(v), causal=causal, softcap=softcap))
    got = _plain_flash(q, k, v, causal=causal, softcap=softcap, window=window)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_DH256_RTOL * np.abs(want).max()


# Head dim 80 (hubert-xlarge): the plain version against the Pallas kernel
# in interpret mode (S = 256) and against the JAX oracle at a ragged S.


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dh80_matches_jax_pallas_kernel(dtype, causal):
    """f32 within FLASH_TOL; bf16 (P rounded where the Pallas kernel keeps
    it in f32) within FLASH_BF16_F32P_RTOL of max|want|."""
    from repro.kernels.flash_attention import flash_attention as jflash
    q, k, v = _flash_inputs(80, 2, 256, 4, 2, 80)
    if dtype == "float32":
        want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                      interpret=True)
        got = _plain_flash(q, k, v, causal=causal)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=FLASH_TOL)
        return
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = jflash(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                    for t in (qb, kb, vb)), causal=causal, interpret=True)
    got = ref.flash_attention_ref(qb, kb, vb, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == qb.shape
    rel, _ = flash_kernel.bf16_gap(
        got, torch.from_numpy(np.array(want.astype(jnp.float32))))
    assert rel <= flash_kernel.FLASH_BF16_F32P_RTOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [200, 300])
def test_flash_plain_dh80_ragged_matches_jax_oracle(s, dtype, causal):
    """A ragged last key block (S = 200, 300), hubert's 4/4 heads and GQA
    4/2: f32 within FLASH_TOL of the oracle's plain softmax over the
    KV-repeated heads; bf16 within FLASH_BF16_F32P_RTOL of the oracle on
    the same bf16 values in f32."""
    for kv in (4, 2):
        q, k, v = _flash_inputs(s + kv, 1, s, 4, kv, 80)
        if dtype == "bfloat16":
            q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (q, k, v))
        rep = lambda a: jnp.repeat(jnp.asarray(a), 4 // kv, axis=2)
        want = np.array(jref.flash_attention_ref(
            jnp.asarray(q), rep(k), rep(v), causal=causal))
        if dtype == "float32":
            got = _plain_flash(q, k, v, causal=causal)
            np.testing.assert_allclose(got, want, rtol=0, atol=FLASH_TOL)
            continue
        got = ref.flash_attention_ref(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
            causal=causal)
        rel, _ = flash_kernel.bf16_gap(got, torch.from_numpy(want))
        assert rel <= flash_kernel.FLASH_BF16_F32P_RTOL


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_entries_take_head_dim_80(dtype, window, monkeypatch):
    """Both entries pass Dh 80 (hubert-xlarge's 16/16 heads, non-causal) to
    their library, with and without a window, from metadata alone: the
    check raises nothing and the loader is reached; its launch would be
    counted as "bf16_dh80" / "f32_dh80_window" ...; Dh 96, which no kernel
    takes, is still refused before any library is loaded."""
    def loader(name):
        raise RuntimeError(f"kernel loader reached: {name}")

    monkeypatch.setattr(build, "load_library", loader)
    assert 80 in flash_kernel.HEAD_DIMS[dtype]
    q = kv = _meta((1, 1500, 16, 80), dtype)
    lib = "flash" if dtype == torch.float32 else "flash_tc"
    with pytest.raises(RuntimeError, match=f"loader reached: {lib}$"):
        dispatch.flash_attention(q, kv, kv, causal=False, window=window)
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    assert flash_kernel.variant(dtype, 80, window) == (
        f"{name}_dh80" + ("" if window is None else "_window"))
    q = kv = _meta((1, 1500, 16, 96), dtype)
    with pytest.raises(ValueError, match="head dim 96"):
        dispatch.flash_attention(q, kv, kv, causal=False, window=window)


def test_flash_off_cpu_tensor_never_reaches_the_plain_version(monkeypatch):
    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for an off-CPU tensor")

    def loader(name):
        assert name == "flash_tc"
        raise RuntimeError("kernel loader reached")

    monkeypatch.setattr(ref, "flash_attention_ref", no_plain)
    monkeypatch.setattr(build, "load_library", loader)
    q = _meta((1, 128, 4, 64), torch.bfloat16)
    kv = _meta((1, 128, 2, 64), torch.bfloat16)
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        dispatch.flash_attention(q, kv, kv, causal=True)


@pytest.mark.parametrize("view", ["misaligned", "strided"])
def test_flash_bf16_entry_refuses_what_tma_cannot_load(view, monkeypatch):
    """The bf16 kernel loads q, k and v by TMA: a base address that is not
    16-byte aligned, or a view that is not contiguous, is refused before
    any library is loaded."""
    def loader(name):
        raise AssertionError(f"library {name} loaded for a refused view")

    monkeypatch.setattr(build, "load_library", loader)
    q = _meta((1, 128, 4, 64), torch.bfloat16)
    kv = _meta((1, 128, 2, 64), torch.bfloat16)
    if view == "misaligned":
        # one bf16 element past an aligned base: 2 bytes off
        flat = _meta((1 + kv.numel(),), torch.bfloat16)
        bad = flat[1:].view(kv.shape)
        assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
        match = "16-byte aligned"
    else:
        bad = _meta((1, 2, 128, 64), torch.bfloat16).transpose(1, 2)
        match = "contiguous"
    with pytest.raises(ValueError, match=match):
        dispatch.flash_attention(q, kv, bad, causal=True)


def test_flash_f32_entry_refuses_a_misaligned_base(monkeypatch):
    """The f32 kernel loads K and V 16 bytes at a time: a base address 4
    bytes off 16-byte alignment is refused before any library is loaded."""
    def loader(name):
        raise AssertionError(f"library {name} loaded for a refused view")

    monkeypatch.setattr(build, "load_library", loader)
    q = _meta((1, 128, 4, 64))
    kv = _meta((1, 128, 2, 64))
    bad = _meta((1 + kv.numel(),))[1:].view(kv.shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        dispatch.flash_attention(q, kv, bad, causal=True)


def test_flash_has_its_own_library_and_build_flags():
    """The gossip, top-k and probe libraries keep --fmad=false (bit-equal
    outputs); both flash kernels and the WKV6 kernel, held to a
    tolerance, are built without it: the f32 one (``flash``) with the
    common flags alone, the bf16 tensor-core one (``flash_tc``) in its own
    library with the same flags and no CUTLASS include, ``wkv6`` alike.  Each library's name hashes its own source and
    flags, and each entry sits in the library its dtype picks."""
    libs = build.LIBRARIES
    assert "--fmad=false" in libs["gossip"].flags
    assert "--fmad=false" in libs["topk"].flags
    assert "--fmad=false" in libs["probe"].flags
    assert libs["flash"].flags == build._COMMON_FLAGS
    assert libs["flash_tc"].flags == build._COMMON_FLAGS
    assert libs["flash"].source.name == "flash_attention.cu"
    assert libs["flash_tc"].source.name == "flash_attention_sm90.cu"
    assert set(libs["flash"].signatures) == {"flash_attention_f32"}
    assert set(libs["flash_tc"].signatures) == {"flash_attention_bf16_tc"}
    assert flash_kernel._ENTRY == {
        torch.float32: ("flash", "flash_attention_f32"),
        torch.bfloat16: ("flash_tc", "flash_attention_bf16_tc")}
    assert libs["topk"].source.name == "block_topk.cu"
    assert libs["probe"].source.name == "probe.cu"
    assert libs["wkv6"].source.name == "wkv6.cu"
    assert libs["wkv6"].flags == build._COMMON_FLAGS
    assert set(libs["wkv6"].signatures) == {"wkv6_f32", "wkv6_bf16"}
    assert all(lib.source.exists() for lib in libs.values())
    paths = {build.library_path(name) for name in libs}
    assert len(paths) == 6
    assert set(dispatch.launch_counts()) == {
        "qsgd_codes", "qsgd_leaf_codes", "sign_codes", "dequantize",
        "ef_update", "ef_update_pipelined", "ef_update_bf16",
        "ef_update_bf16_pipelined", "replica_update", "flash_attention",
        "block_topk_mask", "probe_scale", "wkv6"}
    assert set(libs["gossip"].signatures) >= {"ef_update", "ef_update_bf16",
                                              "qsgd_leaf_codes",
                                              "replica_update"}


# -- block top-k mask ----------------------------------------------------------------
#
# The plain version against the JAX oracle ``block_topk_mask_ref`` and the
# Pallas kernel in interpret mode (R % 8 == 0), bit for bit in mask and
# thresholds: bisection does nothing but exact compares, a max and two
# roundings that both sides do in f32.


def _topk_tiles(seed, rows, cols, ties):
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(-3, 4, (rows, cols)).astype(np.float32)
        x[::3] = 1.0                               # whole rows of one magnitude
        x[1::5, cols // 2:] = 0.0
        return x
    return rng.standard_normal((rows, cols)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2, 13, 64])
@pytest.mark.parametrize("cols", [128, 256])
def test_block_topk_mask_plain_matches_jax(cols, k, ties):
    from repro.kernels.topk import block_topk_mask as jmask
    x = _topk_tiles(cols + k, 64, cols, ties)
    mask, thresh = ref.block_topk_mask_ref(torch.from_numpy(x), k)
    for want_mask, want_thresh in (jref.block_topk_mask_ref(jnp.asarray(x), k),
                                   jmask(jnp.asarray(x), k, interpret=True)):
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(thresh.numpy(), np.asarray(want_thresh))
    kept = mask.sum(dim=1)
    assert bool((kept >= min(k, cols)).all())
    if not ties:
        assert bool((kept == k).all())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("d", [1000, 4097, 130_001])
def test_block_topk_compress_vector_matches_jax(d, ties):
    from repro_torch.kernels import ops
    x = _topk_tiles(d, 1, d, ties)[0]
    got = ops.block_topk_compress_vector(torch.from_numpy(x), 13)
    want = jops.block_topk_compress_vector(jnp.asarray(x), 13, interpret=True)
    assert got.shape == (d,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
