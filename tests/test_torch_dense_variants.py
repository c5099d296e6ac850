"""The dense variants of the port (gemma2-9b, gemma-7b, yi-9b) against the
JAX model, on the CPU.

The JAX smoke models' weights (one model, no node dimension) move through
``repro_torch.convert`` and both models run on the same numpy-made
tokens.  gemma2-9b brings local layers (a sliding window of 16 in its
smoke config) alternating with global ones, and ring-buffer caches;
gemma-7b and yi-9b are plain dense stacks (gemma-7b MHA at 4/4 heads, yi
GQA at 8/2 with head dim 32).

* ``Model.prefill``: last-token logits and every cache leaf of both
  kinds, naive and chunked attention (the port's chunked path is the
  flash kernel's plain version, with the window; JAX's the jnp scan
  ``_chunked_attention``).  float32 within 1e-5 of the largest value
  (measured at most 1.3e-6 over the three archs, the logits and every
  leaf), bfloat16 within the serve tests' 3e-2 (measured at most 1.3e-2):
  the frameworks sum in other orders, and the port's bf16 plain flash
  rounds P to bf16 where JAX keeps it in f32.
  The prompt is 64 tokens, so the local caches' 16 slots divide it: the
  JAX prefill keeps ``k[:, -16:]`` in slots 0..15, the port position p in
  slot p % 16, the same slots then.
* ``Model.decode_step`` over 40 steps, past the window of 16, so the
  local rings wrap twice: logits and both cache kinds, float32, within
  1e-5 (measured at most 1.4e-6).
* a stack with a tail block (gemma2 smoke at 3 layers: one pattern of
  local + global, then a local tail ``tail/t0``), prefill and decode.
* the serve launcher's loop (``launch.serve.run_request``) on gemma2:
  greedy tokens equal to the JAX decode loop's over 24 generated tokens.
* ``param_shapes`` against ``jax.eval_shape`` of the JAX init, path for
  path in flatten order, and ``count_params`` against the JAX
  ``n_params()``, for the full and smoke configs.
* the two cache kinds through ``convert`` both ways; the port's own
  prefill continued by decode steps from a prefill whose local ring
  wrapped (S not a multiple of the window: where the port and the JAX
  prefill differ, ROADMAP §3.4), against decoding every token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.transformer import Model as JModel
from repro_torch.configs.base import get_config
from repro_torch.convert import (caches_from_jax, caches_to_jax,
                                 model_params_from_jax)
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.models.transformer import (Model, block_pattern,
                                            count_params, param_shapes)

from test_torch_slice import one_thread  # noqa: F401  (autouse)

ARCHS = ("gemma2-9b", "gemma-7b", "yi-9b")
B, S = 2, 64
RTOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: JAX ``n_params()`` of the full configs
N_PARAMS = {"gemma2-9b": 9_241_404_928, "gemma-7b": 8_537_680_896,
            "yi-9b": 8_829_407_232}


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n_layers=None):
    cfg = jget_config(arch, smoke=True)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jax.tree.map(np.asarray, JModel(cfg).init(jax.random.PRNGKey(0)))


def _models(arch, dtype="float32", attn_impl="naive", n_layers=None):
    kw = dict(dtype=dtype, attn_impl=attn_impl)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    jmodel = JModel(dataclasses.replace(jget_config(arch, smoke=True), **kw))
    model = Model(dataclasses.replace(get_config(arch, smoke=True), **kw))
    jparams = _jax_params(arch, n_layers)
    params = model.compute_params(model_params_from_jax(jparams))
    return jmodel, jparams, model, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _assert_caches(got, jcaches, rtol=None):
    """Every leaf of the JAX cache tree, under the same path, shape and
    dtype; within ``rtol`` of the largest value unless it is None."""
    want = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        if rtol is not None:
            assert _rel(got[name], want[name]) < rtol, name


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype, attn_impl):
    jmodel, jparams, model, params = _models(arch, dtype, attn_impl)
    toks = _tokens(0, (B, S), jmodel.cfg.vocab_size)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams,
                                               {"tokens": jnp.asarray(toks)})
    dispatch.reset_launch_counts()
    logits, caches = model.prefill(params, torch.from_numpy(toks)[None].long())
    assert set(dispatch.launch_counts().values()) == {0}   # CPU: plain only
    assert logits.shape == (1, B, 1, jmodel.cfg.vocab_size)
    assert _rel(logits[0], jlogits) < RTOL[dtype]
    _assert_caches(caches, jcaches, RTOL[dtype])


def _decode_against_jax(jmodel, jparams, model, params, steps, seed):
    toks = _tokens(seed, (B, steps), jmodel.cfg.vocab_size)
    jcache = jmodel.init_cache(B, steps)
    cache = model.init_cache(B, steps, "cpu")
    _assert_caches(cache, jcache)          # the same leaves, zeroed
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.full((B,), t, jnp.int32))
        logits, cache = model.decode_step(
            params, torch.from_numpy(toks[None, :, t:t + 1]).long(), cache,
            torch.full((B,), t, dtype=torch.long))
        assert _rel(logits[0], jlogits) < RTOL["float32"], t
        _assert_caches(cache, jcache, RTOL["float32"])


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma-7b"])
def test_head_dim_256_f32_chunked_prefill_and_decode_match_jax(arch):
    """The smoke model at the full configs' head dim 256 in f32 with
    ``attn_impl="chunked"`` (the f32 flash path at Dh 256: gemma2's local
    layers with the window of 16 and a softcap of 50, its global layers
    and gemma-7b's MHA layers without one): prefill of 64 tokens, then 8
    decode steps, logits and every cache leaf within 1e-5 of JAX's."""
    kw = dict(dtype="float32", attn_impl="chunked", head_dim=256)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **kw)
    jmodel = JModel(jcfg)
    model = Model(dataclasses.replace(get_config(arch, smoke=True), **kw))
    assert model.cfg.resolved_head_dim == 256
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    params = model.compute_params(model_params_from_jax(jparams))
    toks = _tokens(7, (B, S), jcfg.vocab_size)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams,
                                               {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, torch.from_numpy(toks)[None].long())
    assert _rel(logits[0], jlogits) < RTOL["float32"]
    _assert_caches(caches, jcaches, RTOL["float32"])
    _decode_against_jax(jmodel, jparams, model, params, 8, seed=8)


def test_gemma2_decode_steps_wrap_the_ring_as_jax():
    jmodel, jparams, model, params = _models("gemma2-9b")
    cache = model.init_cache(B, 40, "cpu")
    assert cache["stack/c0/k"].shape == (1, 1, B, 16, 2, 64)      # local ring
    assert cache["stack/c1/k"].shape == (1, 1, B, 40, 2, 64)      # global
    _decode_against_jax(jmodel, jparams, model, params, 40, seed=1)


def test_gemma2_tail_block_matches_jax():
    """3 layers: the pattern (local, global) once, then a local tail."""
    jmodel, jparams, model, params = _models("gemma2-9b", n_layers=3)
    assert block_pattern(model.cfg) == (("dense_local", "dense_global"), 1,
                                        ("dense_local",))
    assert "tail/t0/attn/wq" in params and params["tail/t0/attn/wq"].dim() == 3
    toks = _tokens(2, (B, 32), jmodel.cfg.vocab_size)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams,
                                               {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, torch.from_numpy(toks)[None].long())
    assert _rel(logits[0], jlogits) < RTOL["float32"]
    _assert_caches(caches, jcaches, RTOL["float32"])
    _decode_against_jax(jmodel, jparams, model, params, 20, seed=3)


def _jax_serve_loop(jmodel, jparams, prompt, gen_len):
    """The loop of ``src/repro/launch/serve.py`` on an injected prompt."""
    b, p = prompt.shape
    max_seq = p + gen_len
    cache = jmodel.init_cache(b, max_seq)
    decode = jax.jit(jmodel.decode_step)
    tok, out = prompt[:, :1], []
    for t in range(max_seq - 1):
        logits, cache = decode(jparams, tok, cache, jnp.full((b,), t, jnp.int32))
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        tok = prompt[:, t + 1:t + 2] if t + 1 < p else nxt
        if t + 1 >= p:
            out.append(nxt)
    return np.concatenate([np.asarray(o) for o in out], axis=1)


def test_gemma2_serve_loop_tokens_match_jax():
    jmodel, jparams, model, params = _models("gemma2-9b")
    prompt = _tokens(4, (B, 8), jmodel.cfg.vocab_size)
    want = _jax_serve_loop(jmodel, jparams, jnp.asarray(prompt), 24)
    got, ttft, times = serve.run_request(
        model, params, torch.from_numpy(prompt).long(), 24, lambda: None)
    assert got.shape == (B, 24) and len(times) == 23 and ttft > 0
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_shapes(cfg):
    tree = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    return [("/".join(k.key for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_count_match_jax(arch, smoke):
    jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert param_shapes(cfg) == _jax_shapes(jcfg)
    assert count_params(cfg) == jcfg.n_params()
    if not smoke:
        assert count_params(cfg) == N_PARAMS[arch]


def test_gemma2_full_config_has_42_alternating_layers():
    cfg = get_config("gemma2-9b")
    assert block_pattern(cfg) == (("dense_local", "dense_global"), 21, ())
    model = Model(cfg)
    kinds = [kind for kind, _, _ in model._layers(
        {p: torch.empty((1,) + s, device="meta") for p, s in param_shapes(cfg)})]
    assert kinds == ["dense_local", "dense_global"] * 21
    assert model.cache_len("dense_local", 32768) == 4096
    assert model.cache_len("dense_global", 32768) == 32768
    assert model.cache_len("dense_local", 100) == 100


def test_two_kind_caches_round_trip():
    jmodel, jparams, model, params = _models("gemma2-9b", "bfloat16")
    toks = _tokens(5, (B, 48), jmodel.cfg.vocab_size)
    _, jcaches = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches))
    assert sorted(caches) == ["stack/c0/k", "stack/c0/v", "stack/c1/k",
                              "stack/c1/v"]
    assert caches["stack/c0/k"].shape == (1, 1, B, 16, 2, 64)
    assert caches["stack/c1/k"].shape == (1, 1, B, 48, 2, 64)
    assert caches["stack/c0/k"].dtype == torch.bfloat16
    back = caches_to_jax(caches)
    assert back["tail"] == {}
    for c in ("c0", "c1"):
        for name in ("k", "v"):
            want = np.asarray(jcaches["stack"][c][name], np.float32)
            np.testing.assert_array_equal(back["stack"][c][name], want)
    with pytest.raises(ValueError, match="n = 1"):
        caches_to_jax({k: torch.cat([v, v]) for k, v in caches.items()})


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
def test_prefill_continued_by_decode_matches_decoding_every_token(attn_impl):
    """The port's prefill of 20 tokens into caches of 40 slots (the local
    ring of 16 wraps: position p in slot p % 16), then 20 decode steps,
    against 40 decode steps from an empty cache, float32 within 1e-5."""
    _, _, model, params = _models("gemma2-9b", attn_impl=attn_impl)
    toks = torch.from_numpy(_tokens(6, (1, B, 40), model.cfg.vocab_size)).long()
    pos = lambda t: torch.full((B,), t, dtype=torch.long)
    cache = model.init_cache(B, 40, "cpu")
    for t in range(40):
        want, cache = model.decode_step(params, toks[:, :, t:t + 1], cache,
                                        pos(t))
    cache = model.init_cache(B, 40, "cpu")
    model.hidden(params, toks[:, :, :20], cache)
    for t in range(20, 40):
        got, cache = model.decode_step(params, toks[:, :, t:t + 1], cache,
                                       pos(t))
    assert _rel(got, want) < RTOL["float32"]
