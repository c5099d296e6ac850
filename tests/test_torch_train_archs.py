"""The port's trainer on the archs it serves beside qwen3-1.7b (gemma2-9b,
gemma-7b, yi-9b, hubert-xlarge and llava-next-mistral-7b) held against the
JAX ``DecentralizedTrainer``, plus the training launcher on them.

Each case runs the JAX trainer once per pytest run in a subprocess (the
smoke config in f32, 4 host devices, 2 steps of top_k 0.05 or QSGD s=16 on
the ring, ``test_torch_slice.make_reference``) and the port's trainer from
the same weights on the same batches (the families' batch makers are
bit-equal to JAX's), with JAX's QSGD dither injected.  It holds:

* the bucket spec: every bucket's padded and logical size and exactness,
  and every leaf's bucket, offset and size, equal to JAX's
  ``_bucket_spec()`` (gemma's tied embedding, hubert's ``in_proj``,
  ``final_norm`` and class ``head``, llava's projector ``w1`` and ``w2``);
* the per-node losses, x, x_hat and s, to the qwen3 trainer's tolerances
  (``test_torch_slice.check_against_jax``).

gemma2-9b's smoke window (16) lies inside the sequence (128), so its
local layers' mask and both softcaps are in the gradient.  A bf16 run of
gemma2 holds the losses, the x updates, x_hat and s to the port's bf16
model tolerance, as a norm.  11 JAX reference runs in all, one per arch and
compressor and the bf16 one.
"""
import dataclasses
import os
import subprocess
import sys

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
from repro_torch.train.trainer import DecentralizedTrainer

from test_torch_slice import (BPN, N, ROOT, SEQ, Reference, _port_trainer,
                              _tree, check_against_jax, jax_reference_path)
from test_torch_slice import one_thread  # noqa: F401  (autouse)

ARCHS = ("gemma2-9b", "gemma-7b", "yi-9b", "hubert-xlarge",
         "llava-next-mistral-7b")
COMPRESSORS = (("top_k", 0.05), ("qsgd", 16))
STEPS = 2
#: the port's bf16 model tolerance (tests/test_torch_dense_variants.py),
#: here relative to a norm
BF16_RTOL = 3e-2


def _run(ref, arch, comp, arg, dtype="float32"):
    """The port's trainer on the reference's weights and batches: (the
    trainer, its state after STEPS steps, the metrics of each step)."""
    tr = _port_trainer(comp, arg, 1, False, arch=arch, dtype=dtype,
                       steps=STEPS)
    state = tr.state_from_params(params_from_jax(_tree(ref, "x0")))
    batches = make_lm_batch_fn(tr.model.cfg, SEQ, BPN, N, 1.0)
    mets = []
    for j in range(STEPS):
        draws = None
        if comp == "qsgd":
            draws = lambda t, b, j=j: torch.from_numpy(ref[f"xi:{j}:{t}:{b}"])
        m = tr.step(state, tr.batch_to_device(batches()), draws=draws)
        mets.append([m["loss"], m["lr"], m["grad_norm"]])
    return tr, state, mets


@pytest.mark.slow
@pytest.mark.distributed
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("comp,arg", COMPRESSORS)
def test_trainer_matches_jax_on_each_served_arch(tmp_path_factory, arch,
                                                 comp, arg):
    cfg = get_config(arch, smoke=True)
    if cfg.sliding_window:
        assert cfg.sliding_window < SEQ
    ref = Reference(jax_reference_path(tmp_path_factory, comp, arg, 1, False,
                                       arch=arch, steps=STEPS))
    tr, state, mets = _run(ref, arch, comp, arg)
    buckets = [[b.size, b.logical, int(b.exact)] for b in tr.spec.buckets]
    slots = [[sl.bucket, sl.offset, sl.size] for sl in tr.spec.slots]
    np.testing.assert_array_equal(buckets, ref["spec_buckets"])
    np.testing.assert_array_equal(slots, ref["spec_slots"])
    assert [tr.gamma] + tr.exchange.bucket_gammas == list(ref["gamma"])
    check_against_jax(tr, state, mets, ref, comp)


def _l2_rel(got, want):
    return float((got - want).norm()) / float(want.norm())


@pytest.mark.slow
@pytest.mark.distributed
def test_gemma2_bf16_compute_matches_jax(tmp_path_factory):
    """gemma2-9b's smoke model computing in bf16 (f32 parameters and EF
    state), top_k, to the port's bf16 tolerance as a norm: the losses
    within BF16_RTOL relative; each leaf's update x - x0 within BF16_RTOL
    of its norm (measured at most 1.3e-2: the frameworks round the bf16
    gradient's products at other points, a few elements of a leaf up to
    13% of its largest update); x_hat and s, all leaves together, within
    BF16_RTOL of their norm (measured 1.0e-2: where a gradient difference
    moves a top-k selection at the k-th magnitude, x_hat and s move by a
    whole delta there, up to a third of a small leaf's largest value)."""
    ref = Reference(jax_reference_path(tmp_path_factory, "top_k", 0.05, 1,
                                       False, arch="gemma2-9b",
                                       dtype="bfloat16", steps=STEPS))
    tr, state, mets = _run(ref, "gemma2-9b", "top_k", 0.05, "bfloat16")
    np.testing.assert_allclose(np.array(mets)[:, 0], ref["metrics"][:, 0],
                               rtol=BF16_RTOL)
    x0 = params_from_jax(_tree(ref, "x0"))
    for tag, bufs in (("x", state.x), ("x_hat", state.x_hat), ("s", state.s)):
        got = dict(zip(tr.paths, unpack_leaves(tr.spec, bufs)))
        want = params_from_jax(_tree(ref, tag))
        if tag == "x":                      # the update, not the weights
            for path in tr.paths:
                rel = _l2_rel(got[path] - x0[path], want[path] - x0[path])
                assert rel <= BF16_RTOL, (path, rel)
            continue
        flat = lambda leaves: torch.cat([leaves[p].float().reshape(-1)
                                         for p in tr.paths])
        rel = _l2_rel(flat(got), flat(want))
        assert rel <= BF16_RTOL, (tag, rel)


def test_trainer_refuses_chunked_attention_on_gemma2():
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True),
                              attn_impl="chunked")
    with pytest.raises(ValueError, match="flash-attention kernel has no "
                                         "backward"):
        DecentralizedTrainer(model=Model(cfg), choco=ChocoConfig(),
                             n_nodes=N, optimizer=momentum_sgd(),
                             lr_fn=cosine_schedule(0.1, 1, 2), device="cpu")


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma-7b", "yi-9b"])
def test_launcher_trains_the_dense_variants_on_cpu(arch, capsys):
    assert launcher.main(["--arch", arch, "--smoke", "--mesh", "4x1",
                          "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke " in out and "buckets=2 " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("arch", launcher.MOE_ARCHS)
def test_launcher_refuses_the_moe_family(arch, capsys):
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--arch", arch, "--smoke", "--mesh", "4x1",
                       "--device", "cpu"])
    assert exc.value.code == 2
    assert "training the MoE family is not ported" in capsys.readouterr().err


def test_launcher_refuses_llava_without_text_before_importing_torch():
    """The full llava config's default sequence (512) is shorter than its
    2880 image tokens: refused before torch is imported, where the batch
    maker would fail."""
    code = ("import sys; from repro_torch.launch.train import main\n"
            "try:\n    main(['--arch', 'llava-next-mistral-7b', '--mesh',"
            " '4x1'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
    assert "leaves no text after llava-next-mistral-7b's 2880 image" in r.stderr
