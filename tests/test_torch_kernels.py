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

The routing tests show that a tensor off the CPU never reaches a plain
version.  ``tests/test_torch_cuda.py`` holds each CUDA kernel against its
plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, dispatch, ref

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


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("coef", [(1 / 3, 1 / 3, 2.8e-4), (0.5, 0.5, 0.046),
                                  (1.0, 0.0, 1.0)])
def test_ef_update_plain_matches_jax(coef, length):
    """Bit-equal to the JAX package's jnp oracle; within 2 ulp of the
    Pallas kernel, counted at the scale of each output's largest operand
    (the interpreted kernel rounds s + (w_self q_self + w_nbr q_nbr)
    differently from its own oracle, by up to 2 ulp)."""
    ins = [_normal(10 * length + i, (N, length)) for i in range(5)]
    got = ref.ef_update_ref(*map(torch.from_numpy, ins), *coef)
    x_half, x_hat, s, q_self, q_nbr = ins
    mix = np.abs(coef[0] * q_self) + np.abs(coef[1] * q_nbr)
    for i in range(N):
        row = [jnp.asarray(a[i]) for a in ins]
        oracle = jref.ef_gossip_update_ref(*row, *coef)
        kernel = jops.ef_gossip_update_vector(*row, *coef, interpret=True)
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
    outs = dispatch.ef_bucket_update(x, x, x, x, x, 0.3, 0.3, 0.1)
    for a, b in zip(outs, ref.ef_update_ref(x, x, x, x, x, 0.3, 0.3, 0.1)):
        assert torch.equal(a, b)
    assert set(dispatch.launch_counts().values()) == {0}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_ENTRIES = {
    "qsgd_codes": lambda: dispatch.qsgd_codes(_meta((N, 8)), _meta((N, 8)),
                                              _meta((N,)), 16),
    "sign_codes": lambda: dispatch.sign_codes(_meta((N, 8))),
    "dequantize": lambda: dispatch.dequantize(_meta((N, 8), torch.int8),
                                              _meta((N,))),
    "ef_update": lambda: dispatch.ef_bucket_update(
        *[_meta((N, 8))] * 5, 0.3, 0.3, 0.1),
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_off_cpu_tensor_never_reaches_a_plain_version(entry, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel loader: when the
    loader fails, the call raises and no plain version runs."""
    def no_plain(*a, **k):
        raise AssertionError("a plain version ran for an off-CPU tensor")

    def loader():
        raise RuntimeError("kernel loader reached")

    for name in ("qsgd_codes_ref", "sign_codes_ref", "dequantize_ref",
                 "ef_update_ref"):
        monkeypatch.setattr(ref, name, no_plain)
    monkeypatch.setattr(build, "load_library", loader)
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        _ENTRIES[entry]()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()
