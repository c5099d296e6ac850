"""The PyTorch port on the card: each CUDA kernel against its plain version,
and the trainer through the kernels.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ChocoConfig, get_config
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.kernels import dispatch, ref
from repro_torch.models.transformer import Model
from repro_torch.optim.sgd import MomentumSGD, cosine_schedule
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
    got = _launched("ef_update", lambda: dispatch.ef_bucket_update(
        *ins, 1 / 3, 1 / 3, 2.8e-4))
    for g, w in zip(got, ref.ef_update_ref(*ins, 1 / 3, 1 / 3, 2.8e-4)):
        assert torch.equal(g, w)
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


def _run(compressor, device, steps=2):
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    kw = (("s", 16),) if compressor == "qsgd" else ()
    tr = DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=compressor,
                                            comp_kwargs=kw),
        n_nodes=N, optimizer=MomentumSGD(),
        lr_fn=cosine_schedule(0.1, 1, steps), device=device)
    gen = torch.Generator().manual_seed(0)
    state = tr.state_from_params(tr.model.init(N, gen, "cpu"))
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
    assert counts == {"qsgd_codes": 0, "sign_codes": launches,
                      "dequantize": launches, "ef_update": launches}
    _, cpu_state, cpu_losses = _run("sign", "cpu")
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    for a, b in zip(state.x, cpu_state.x):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_trainer_qsgd_launches_per_bucket_per_round(cuda):
    dispatch.reset_launch_counts()
    tr, _, losses = _run("qsgd", cuda)
    launches = 2 * tr.choco.gossip_steps * tr.spec.n_buckets
    assert dispatch.launch_counts() == {
        "qsgd_codes": launches, "sign_codes": 0, "dequantize": launches,
        "ef_update": launches}
    assert all(np.isfinite(losses))
