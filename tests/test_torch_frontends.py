"""The frontend families of the port (hubert-xlarge's audio encoder,
llava-next-mistral-7b's image-prefixed decoder) against the JAX model, on
the CPU.

The JAX smoke models' weights move through ``repro_torch.convert`` and both
models run on the same numpy-made batches (the port's batch makers, which
are bit-equal to JAX's: checked here too).

* hubert: ``Model.prefill`` of 64 frames (the last frame's logits and the
  caches JAX builds for every layer, although nothing decodes), at the
  smoke config's head dim 64 and at a narrow config of head dim 80, the
  full config's (``dataclasses.replace`` on both sides), f32 and bf16,
  naive and chunked (the port's chunked path is the flash kernel's plain
  version, non-causal; JAX's the jnp scan ``_chunked_attention``, whose
  S divides by its block); the masked loss (8% of the frames); decode
  refused.
* llava: prefill of 16 patch embeddings and 48 text tokens (the
  projector's tanh gelu, positions over both), then 8 decode steps of
  text into caches padded past the prompt; the ``valid``-masked loss
  (labels zero-padded over the image prefix), unchunked and in chunks.
* f32 within 1e-5 of the largest value, bf16 within 3e-2 (the dense
  variants' tolerances, ``tests/test_torch_dense_variants.py``; measured
  at most 1.2e-6 and 1.4e-2).
* ``param_shapes`` against ``jax.eval_shape`` of the JAX init and
  ``count_params`` against JAX's for the full and smoke configs; the
  serve launcher refuses hubert (JAX's reason) before torch is imported,
  and the training launcher trains both archs' smoke models.

About 20 s alone on one worker: one JAX init per config and one jitted
JAX function per case.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data.synthetic import make_lm_batch_fn as jmake_lm_batch_fn
from repro.models.transformer import Model as JModel
from repro.models.transformer import count_params as jcount_params
from repro_torch.configs.base import get_config
from repro_torch.convert import caches_from_jax, model_params_from_jax
from repro_torch.data.synthetic import make_lm_batch_fn
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import (Model, block_pattern,
                                            count_params, param_shapes)

from test_torch_slice import one_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HUBERT, LLAVA = "hubert-xlarge", "llava-next-mistral-7b"
B, FRAMES, TEXT = 2, 64, 48
RTOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: JAX ``count_params`` of the full configs
N_PARAMS = {HUBERT: 945_143_040, LLAVA: 7_262_703_616}


def _cfgs(arch, **kw):
    """The JAX and the port's smoke config with the same replacements."""
    return (dataclasses.replace(jget_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, head_dim=None):
    cfg = _cfgs(arch, **({} if head_dim is None else {"head_dim": head_dim}))[0]
    return jax.tree.map(np.asarray, JModel(cfg).init(jax.random.PRNGKey(0)))


def _models(arch, dtype="float32", attn_impl="naive", head_dim=None, **kw):
    if head_dim is not None:
        kw["head_dim"] = head_dim
    jcfg, cfg = _cfgs(arch, dtype=dtype, attn_impl=attn_impl, **kw)
    jmodel, model = JModel(jcfg), Model(cfg)
    jparams = _jax_params(arch, head_dim)
    return jmodel, jparams, model, model.compute_params(
        model_params_from_jax(jparams))


@functools.lru_cache(maxsize=None)
def _batch(arch, seq, seed):
    """One node's batch from the port's maker: numpy, node dim first."""
    return make_lm_batch_fn(get_config(arch, smoke=True), seq, B, 1,
                            seed=seed)()


def _jax_batch(batch, keys):
    return {k: jnp.asarray(batch[k][0]) for k in keys}


def _torch_batch(batch, keys):
    return {k: torch.from_numpy(batch[k]) for k in keys}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _assert_caches(got, jcaches, rtol):
    want = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert _rel(got[name], want[name]) < rtol, name


# -- hubert-xlarge: the bidirectional audio encoder ------------------------------

@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [None, 80], ids=["dh64", "dh80"])
def test_hubert_prefill_matches_jax(head_dim, dtype, attn_impl):
    jmodel, jparams, model, params = _models(HUBERT, dtype, attn_impl,
                                             head_dim)
    assert not model.cfg.causal
    assert model.cfg.resolved_head_dim == (head_dim or 64)
    batch = _batch(HUBERT, FRAMES, 0)
    jlogits, jcaches = jax.jit(jmodel.prefill)(
        jparams, _jax_batch(batch, ["frame_embeds"]))
    dispatch.reset_launch_counts()
    logits, caches = model.prefill(params,
                                   _torch_batch(batch, ["frame_embeds"]))
    assert set(dispatch.launch_counts().values()) == {0}   # CPU: plain only
    assert logits.shape == (1, B, 1, model.cfg.vocab_size)
    assert _rel(logits[0], jlogits) < RTOL[dtype]
    assert caches["stack/c0/k"].shape == (1, 2, B, FRAMES, 4,
                                          head_dim or 64)
    _assert_caches(caches, jcaches, RTOL[dtype])


@pytest.mark.parametrize("head_dim", [None, 80], ids=["dh64", "dh80"])
def test_hubert_masked_loss_matches_jax(head_dim):
    jmodel, jparams, model, params = _models(HUBERT, head_dim=head_dim)
    keys = ["frame_embeds", "targets", "mask"]
    batch = _batch(HUBERT, FRAMES, 1)
    assert 0 < batch["mask"].sum() < batch["mask"].size     # 8% masked
    want, _ = jax.jit(jmodel.loss)(jparams, _jax_batch(batch, keys))
    got = model.loss(params, _torch_batch(batch, keys))
    assert got.shape == (1,)
    assert abs(float(got[0]) - float(want)) <= RTOL["float32"] * abs(
        float(want))
    # the mask weights the frames: unmasked, the loss is another number
    unmasked = model.loss(params, {**_torch_batch(batch, keys[:2])})
    assert abs(float(unmasked[0]) - float(got[0])) > 1e-3


def test_hubert_has_no_decode_step():
    _, _, model, params = _models(HUBERT)
    cache = model.init_cache(B, 8, "cpu")
    with pytest.raises(ValueError, match="encoder"):
        model.decode_step(params, torch.zeros((1, B, 1), dtype=torch.long),
                          cache, torch.zeros(B, dtype=torch.long))


def test_hubert_full_config_is_the_dense_encoder_at_head_dim_80():
    cfg = get_config(HUBERT)
    assert block_pattern(cfg) == (("dense_global",), 48, ())
    assert (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads) == (80, 16, 16)
    shapes = dict(param_shapes(cfg))
    assert shapes["in_proj"] == (512, 1280) and shapes["head"] == (1280, 504)
    assert not any(p.startswith("embed/") for p in shapes)


# -- llava-next-mistral-7b: image prefix, then text ------------------------------

def _llava_inputs(seed):
    batch = _batch(LLAVA, 16 + TEXT, seed)
    assert batch["patch_embeds"].shape == (1, B, 16, 64)
    assert batch["tokens"].shape == (1, B, TEXT)
    return batch


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llava_prefill_matches_jax(dtype, attn_impl):
    jmodel, jparams, model, params = _models(LLAVA, dtype, attn_impl)
    batch = _llava_inputs(2)
    keys = ["patch_embeds", "tokens"]
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams,
                                               _jax_batch(batch, keys))
    logits, caches = model.prefill(params, _torch_batch(batch, keys))
    assert logits.shape == (1, B, 1, model.cfg.vocab_size)
    assert _rel(logits[0], jlogits) < RTOL[dtype]
    assert caches["stack/c0/k"].shape == (1, 2, B, 16 + TEXT, 2, 64)
    _assert_caches(caches, jcaches, RTOL[dtype])


def test_llava_decode_after_the_image_prefix_matches_jax():
    """8 text tokens decoded past the 64-position prompt, into both
    prefills' caches padded with 8 empty slots: logits and caches, f32."""
    jmodel, jparams, model, params = _models(LLAVA)
    batch = _llava_inputs(3)
    keys = ["patch_embeds", "tokens"]
    _, jcaches = jax.jit(jmodel.prefill)(jparams, _jax_batch(batch, keys))
    _, caches = model.prefill(params, _torch_batch(batch, keys))
    S, steps = 16 + TEXT, 8
    jcache = jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0)] * (a.ndim - 3) + [(0, steps), (0, 0), (0, 0)]), jcaches)
    cache = {k: torch.cat([c, c.new_zeros(c.shape[:3] + (steps,)
                                          + c.shape[4:])], dim=3)
             for k, c in caches.items()}
    toks = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (B, steps)).astype(np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.full((B,), S + t, jnp.int32))
        logits, cache = model.decode_step(
            params, torch.from_numpy(toks[None, :, t:t + 1]).long(), cache,
            torch.full((B,), S + t, dtype=torch.long))
        assert _rel(logits[0], jlogits) < RTOL["float32"], t
    _assert_caches(cache, jcache, RTOL["float32"])


@pytest.mark.parametrize("loss_chunk", [0, 16])
def test_llava_valid_masked_loss_matches_jax(loss_chunk):
    """The image prefix's 16 positions carry label 0 and weight 0: the
    loss is the text's mean CE, unchunked and in chunks of 16 (one chunk
    wholly inside the prefix)."""
    jmodel, jparams, model, params = _models(LLAVA, loss_chunk=loss_chunk)
    batch = _llava_inputs(5)
    keys = ["patch_embeds", "tokens", "labels"]
    want, _ = jax.jit(jmodel.loss)(jparams, _jax_batch(batch, keys))
    got = model.loss(params, _torch_batch(batch, keys))
    assert got.shape == (1,)
    assert abs(float(got[0]) - float(want)) <= RTOL["float32"] * abs(
        float(want))
    x, labels, valid = model.embed_inputs(params, _torch_batch(batch, keys))
    assert x.shape == (1, B, 16 + TEXT, model.cfg.d_model)
    assert labels.shape == valid.shape == (1, B, 16 + TEXT)
    assert not labels[:, :, :16].any() and not valid[:, :, :16].any()
    assert bool((valid[:, :, 16:] == 1).all())


# -- configs, data and launchers ----------------------------------------------------

def _jax_shapes(cfg):
    tree = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [HUBERT, LLAVA])
def test_param_shapes_and_count_match_jax(arch, smoke):
    jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert param_shapes(cfg) == _jax_shapes(jcfg)
    assert count_params(cfg) == jcount_params(jcfg)
    if not smoke:
        assert count_params(cfg) == N_PARAMS[arch]


@pytest.mark.parametrize("node", [None, 1])
@pytest.mark.parametrize("arch,seq", [(HUBERT, 40), (LLAVA, 48)])
def test_batch_makers_bit_equal_to_jax(arch, seq, node):
    """Three nodes, two draws; with ``node``, that node's row of the same
    draws (one rank's batch)."""
    kw = dict(heterogeneity=0.5, seed=7)
    want = jmake_lm_batch_fn(jget_config(arch, smoke=True), seq, 2, 3, **kw)
    got = make_lm_batch_fn(get_config(arch, smoke=True), seq, 2, 3, node=node,
                           **kw)
    assert got.skew_tv == want.skew_tv
    rows = slice(None) if node is None else slice(node, node + 1)
    for _ in range(2):
        a, b = want(), got()
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k][rows])


def test_serve_launcher_refuses_hubert_before_importing_torch():
    code = ("import sys; from repro_torch.launch.serve import main\n"
            "try:\n    main(['--arch', 'hubert-xlarge', '--smoke'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 2 and 'torch' not in sys.modules\n"
            "    print('refused')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "refused" in r.stdout, r.stderr
    assert "encoder-only arch has no decode step" in r.stderr


def test_serve_launcher_serves_llava_text_prompts(capsys):
    assert serve.main(["--arch", LLAVA, "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen-len", "3",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=llava-next-smoke" in out and "decoded 3x2 tokens" in out


@pytest.mark.parametrize("arch", [HUBERT, LLAVA])
def test_training_launcher_refuses_the_frontends(arch, capsys):
    """The training launcher no longer refuses the frontends: it trains
    both smoke models on the CPU (the masked losses; hubert's ``in_proj``
    and ``head`` and llava's projector in the buckets), with finite
    losses (``tests/test_torch_train_archs.py`` holds them to JAX)."""
    assert launcher.main(["--arch", arch, "--smoke", "--mesh", "4x1",
                          "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={get_config(arch, smoke=True).name} " in out
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
