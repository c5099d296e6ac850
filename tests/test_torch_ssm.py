"""The recurrent families of the port (zamba2-1.2b's Mamba2 stack with its
weight-shared attention block, rwkv6-3b's RWKV-6 blocks) against the JAX
package on the CPU.

The JAX smoke models' weights move through ``repro_torch.convert``; every
other input is a numpy draw.  The JAX functions run jitted in this
process (their scans compile in well under a second at these lengths),
so nothing is left on disk.

* ``ref.wkv6_ref``, the WKV6 kernel's plain version, against JAX's
  ``_wkv_scan``, with and without a carried-in state, at ragged lengths:
  out and the final state within 1e-5 of their largest value (measured
  at most 3.0e-7: the two sum over p in other orders).
* ``_ssd_chunked``, ``mamba_forward`` (output and cache),
  ``mamba_decode_step``, ``timemix_forward`` and ``channelmix_forward``
  against their JAX functions, float32, within 1e-5 of the largest value
  (measured at most 3.7e-6, mamba_forward's; the SSD einsums run as two
  products each, JAX's in the order XLA picks).
* both smoke models' ``Model.prefill`` (logits and every cache leaf, its
  dtype: the rwkv ``wkv`` state f32, the mamba ``ssm`` state in the
  compute dtype) and 12 teacher-forced ``decode_step``\\ s, against JAX's
  ``Model``: float32 within 1e-5 of the largest value (measured at most
  2.3e-6), bfloat16 within the dense tests' 3e-2 (measured at most
  2.0e-2, rwkv6's decode caches: XLA keeps excess precision between bf16 elementwise steps that
  the port rounds, and a rounding moved there moves later layers).
* zamba2's block pattern, ``param_shapes`` in JAX flatten order,
  ``count_params`` against JAX's exact count and ``n_params`` against
  JAX's analytic one for every config the port has; the init rules'
  fixed leaves, the block and cache inits' leaves, shapes and dtypes; the
  new leaves and caches through ``convert`` both ways;
  the serve loop's greedy tokens against JAX's; the CUDA wrapper refusing
  CPU tensors before it loads a library.

About 28 s on one of six workers (tier-1 run); it writes nothing to disk.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jr6
from repro.models.transformer import Model as JModel
from repro.models.transformer import count_params as jcount_params
from repro_torch.configs.base import get_config
from repro_torch.convert import (model_params_from_jax, params_from_jax,
                                 params_to_jax)
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import wkv6 as wkv6_kernel
from repro_torch.launch import serve
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.transformer import (Model, block_pattern,
                                            count_params, param_shapes)

from test_torch_dense_variants import (_jax_serve_loop, _jax_shapes, _rel,
                                       _tokens)
from test_torch_slice import one_thread  # noqa: F401  (autouse)

ARCHS = ("zamba2-1.2b", "rwkv6-3b")
B, S = 2, 64
RTOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: every config the port has, for the analytic count
ALL_ARCHS = ("qwen3-1.7b", "gemma2-9b", "gemma-7b", "yi-9b", "hubert-xlarge",
             "llava-next-mistral-7b", "qwen3-moe-30b-a3b",
             "llama4-maverick-400b-a17b") + ARCHS


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    """numpy -> a tensor with the node dimension n = 1 first."""
    return torch.from_numpy(np.array(a, dtype=np.float32))[None]


# -- the WKV6 kernel's plain version --------------------------------------------


def _wkv_inputs(seed, s, h=4, p=64, batch=2):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((batch, s, h, p)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.3, 0.999, (batch, s, h, p)).astype(np.float32)
    u = (rng.standard_normal((h, p)) * 0.1).astype(np.float32)
    state = rng.standard_normal((batch, h, p, p)).astype(np.float32)
    return r, k, v, w, u, state


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 7, 33])
def test_wkv6_ref_matches_jax_scan(s, carried):
    r, k, v, w, u, state = _wkv_inputs(s, s)
    jstate = jnp.asarray(state) if carried else None
    jout, jfinal = jax.jit(jr6._wkv_scan, static_argnums=5)(
        *map(jnp.asarray, (r, k, v, w, u)), 4, jstate)
    tstate = torch.from_numpy(state) if carried else None
    out, final = ref.wkv6_ref(*map(torch.from_numpy, (r, k, v, w, u)),
                              state=tstate)
    assert out.dtype == final.dtype == torch.float32
    assert _rel(out, jout) <= 1e-5 and _rel(final, jfinal) <= 1e-5
    # per-node u (N, H, P) and a dispatch route on the CPU: the plain version
    dispatch.reset_launch_counts()
    out2, final2 = dispatch.wkv6(
        *map(torch.from_numpy, (r, k, v, w)),
        torch.from_numpy(np.broadcast_to(u, (2,) + u.shape).copy()), tstate)
    assert torch.equal(out2, out) and torch.equal(final2, final)
    assert dispatch.launch_counts()["wkv6"] == 0


def test_wkv6_ref_chains_across_calls():
    """Two calls, the second carrying the first's final state in, equal one
    call over both halves: the decode cache's contract."""
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _wkv_inputs(3, 20))
    whole, final = ref.wkv6_ref(r, k, v, w, u)
    a, mid = ref.wkv6_ref(r[:, :9], k[:, :9], v[:, :9], w[:, :9], u)
    b, end = ref.wkv6_ref(r[:, 9:], k[:, 9:], v[:, 9:], w[:, 9:], u, mid)
    assert torch.equal(torch.cat([a, b], dim=1), whole)
    assert torch.equal(end, final)


def test_wkv6_wrapper_refuses_cpu_tensors_before_loading():
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _wkv_inputs(1, 4))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wkv6_kernel.wkv6(r, k, v, w, u[None].expand(2, 4, 64).contiguous())
    with pytest.raises(ValueError, match="head size 32"):
        wkv6_kernel.wkv6(r[..., :32], k[..., :32], v[..., :32],
                         w[..., :32], u[None, :, :32])
    assert wkv6_kernel.wkv6.launches == 0


# -- the mixers ------------------------------------------------------------------


def _block_params(arch, sub):
    """One block's JAX-init leaves under ``sub`` (no node dim), numpy f32."""
    jcfg = jget_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
    block = params["stack"]["p0"][sub]
    return jcfg, jax.tree.map(lambda a: a[0], block)


@functools.lru_cache(maxsize=None)
def _mamba_case():
    jcfg, jp = _block_params("zamba2-1.2b", "mixer")
    x = _normal(7, (B, S, jcfg.d_model))
    return jcfg, jp, {k: _t(v) for k, v in jp.items()}, x


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(11)
    Z, H, P, N, chunk = 2, 4, 16, 8, 16
    x = rng.standard_normal((Z, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Z, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Z, S, N)).astype(np.float32)
              for _ in range(2))
    jy, jfinal = jax.jit(jm2._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    y, final = mamba2._ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                   chunk)
    assert _rel(y, jy) <= 1e-5 and _rel(final, jfinal) <= 1e-5
    with pytest.raises(ValueError, match="chunk"):
        mamba2._ssd_chunked(*map(torch.from_numpy, (x[:, :40], dt[:, :40], A,
                                                    Bm[:, :40], Cm[:, :40])),
                            chunk)


def test_mamba_forward_and_cache_match_jax():
    jcfg, jp, p, x = _mamba_case()
    cfg = get_config("zamba2-1.2b", smoke=True)
    jout, jcache = jax.jit(jm2.mamba_forward, static_argnums=(2, 3))(
        jp, jnp.asarray(x), jcfg, True)
    out, cache = mamba2.mamba_forward(p, _t(x), cfg, want_cache=True)
    assert _rel(out[0], jout) <= 1e-5
    assert sorted(cache) == sorted(jcache)
    for name, want in jcache.items():
        assert cache[name][0].shape == want.shape, name
        assert _rel(cache[name][0], want) <= 1e-5, name
    assert torch.equal(mamba2.mamba_forward(p, _t(x), cfg), out)


def test_mamba_decode_steps_match_jax():
    """Six steps from a zeroed cache, each step's output and cache."""
    jcfg, jp, p, x = _mamba_case()
    cfg = get_config("zamba2-1.2b", smoke=True)
    jcache = jm2.init_mamba_cache(jcfg, B, jnp.float32)
    cache = mamba2.init_mamba_cache(cfg, B, torch.float32, "cpu")
    assert {k: tuple(v.shape[1:]) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    step = jax.jit(jm2.mamba_decode_step, static_argnums=3)
    for t in range(6):
        jout, jcache = step(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        out, cache = mamba2.mamba_decode_step(p, _t(x[:, t:t + 1]), cache, cfg)
        assert _rel(out[0], jout) <= 1e-5, t
        for name, want in jcache.items():
            assert _rel(cache[name][0], want) <= 1e-5, (t, name)


@functools.lru_cache(maxsize=None)
def _rwkv_case():
    jcfg, jtm = _block_params("rwkv6-3b", "tm")
    _, jcm = _block_params("rwkv6-3b", "cm")
    x = _normal(8, (B, S, jcfg.d_model))
    return jcfg, jtm, jcm, x


@pytest.mark.parametrize("carried", [False, True])
def test_timemix_matches_jax(carried):
    jcfg, jtm, _, x = _rwkv_case()
    cfg = get_config("rwkv6-3b", smoke=True)
    H, P = rwkv6.heads(cfg)
    last = _normal(9, (B, cfg.d_model)) if carried else None
    state = _normal(10, (B, H, P, P)) if carried else None
    fn = jax.jit(lambda p, x, xl, st: jr6.timemix_forward(p, x, jcfg, xl, st))
    jout, (jlast, jfinal) = fn(jtm, jnp.asarray(x),
                               None if last is None else jnp.asarray(last),
                               None if state is None else jnp.asarray(state))
    out, (tlast, final) = rwkv6.timemix_forward(
        {k: _t(v) for k, v in jtm.items()}, _t(x), cfg,
        x_prev_last=None if last is None else _t(last),
        state=None if state is None else _t(state))
    assert _rel(out[0], jout) <= 1e-5
    assert torch.equal(tlast[0], torch.from_numpy(np.array(jlast)))
    assert final.dtype == torch.float32 and _rel(final[0], jfinal) <= 1e-5


@pytest.mark.parametrize("carried", [False, True])
def test_channelmix_matches_jax(carried):
    _, _, jcm, x = _rwkv_case()
    last = _normal(12, (B, x.shape[-1])) if carried else None
    jout, jlast = jax.jit(jr6.channelmix_forward)(
        jcm, jnp.asarray(x), None if last is None else jnp.asarray(last))
    out, tlast = rwkv6.channelmix_forward(
        {k: _t(v) for k, v in jcm.items()}, _t(x),
        None if last is None else _t(last))
    assert _rel(out[0], jout) <= 1e-5
    assert torch.equal(tlast[0], torch.from_numpy(np.array(jlast)))


# -- the models ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, JModel(jget_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0)))


def _models(arch, dtype="float32", attn_impl="naive"):
    kw = dict(dtype=dtype, attn_impl=attn_impl)
    jmodel = JModel(dataclasses.replace(jget_config(arch, smoke=True), **kw))
    model = Model(dataclasses.replace(get_config(arch, smoke=True), **kw))
    jparams = _jax_params(arch)
    params = model.compute_params(model_params_from_jax(jparams))
    return jmodel, jparams, model, params


def _assert_caches(got, jcaches, rtol):
    want = model_params_from_jax(jax.tree.map(np.asarray, jcaches))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        assert _rel(got[name], w) <= rtol, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, dtype):
    """Logits and every cache leaf; zamba2 with chunked attention too (the
    port's flash plain version at head dim 64)."""
    for impl in ("naive", "chunked") if arch == "zamba2-1.2b" else ("naive",):
        jmodel, jparams, model, params = _models(arch, dtype, impl)
        toks = _tokens(0, (B, S), jmodel.cfg.vocab_size)
        jlogits, jcaches = jax.jit(jmodel.prefill)(
            jparams, {"tokens": jnp.asarray(toks)})
        logits, caches = model.prefill(params, torch.from_numpy(toks)[None].long())
        assert _rel(logits[0], jlogits) <= RTOL[dtype], impl
        _assert_caches(caches, jcaches, RTOL[dtype])
    if arch == "rwkv6-3b":
        assert caches["stack/c0/wkv"].dtype == torch.float32
    else:
        assert caches["stack/c0/ssm"].dtype == model.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    """12 teacher-forced decode steps from an empty cache: every step's
    logits, then every cache leaf."""
    jmodel, jparams, model, params = _models(arch, dtype)
    steps = 12
    toks = _tokens(1, (B, steps), jmodel.cfg.vocab_size)
    jcache = jmodel.init_cache(B, steps)
    cache = model.init_cache(B, steps, "cpu")
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(steps):
        jlogits, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]),
                                  jcache, jnp.full((B,), t, jnp.int32))
        logits, cache = model.decode_step(
            params, torch.from_numpy(toks[None, :, t:t + 1]).long(), cache,
            torch.full((B,), t, dtype=torch.long))
        assert _rel(logits[0], jlogits) <= RTOL[dtype], t
    _assert_caches(cache, jcache, RTOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continues_the_sequence(arch):
    """A prefill's caches carried into decode steps equal decoding the whole
    sequence step by step (float32, within 1e-5): the recurrent states and
    the tails hand over as JAX's do."""
    _, _, model, params = _models(arch)
    toks = torch.from_numpy(_tokens(2, (B, 40), 512))[None].long()
    prompt = 32
    cache = model.init_cache(B, 40, "cpu")
    model.hidden(params, toks[:, :, :prompt], cache)
    full = model.init_cache(B, 40, "cpu")
    for t in range(40):
        pos = torch.full((B,), t, dtype=torch.long)
        want, full = model.decode_step(params, toks[:, :, t:t + 1], full, pos)
        if t >= prompt:
            got, cache = model.decode_step(params, toks[:, :, t:t + 1], cache,
                                           pos)
            assert _rel(got, want) <= 1e-5, t


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_tokens_match_jax(arch):
    jmodel, jparams, model, params = _models(arch)
    prompt = _tokens(4, (B, 6), jmodel.cfg.vocab_size)
    want = _jax_serve_loop(jmodel, jparams, jnp.asarray(prompt), 10)
    got, ttft, times = serve.run_request(
        model, params, torch.from_numpy(prompt).long(), 10, lambda: None)
    assert got.shape == (B, 10) and len(times) == 9 and ttft > 0
    np.testing.assert_array_equal(got.numpy(), want)


# -- shapes, counts, init, convert ------------------------------------------------


def test_zamba2_block_pattern():
    cfg = get_config("zamba2-1.2b")
    assert block_pattern(cfg) == (("mamba",) * 5 + ("shared",), 6,
                                  ("mamba", "mamba"))
    model = Model(cfg)
    params = {p: torch.empty((1,) + s, device="meta")
              for p, s in param_shapes(cfg)}
    kinds = [kind for kind, _, _ in model._layers(params)]
    assert kinds == (["mamba"] * 5 + ["shared"]) * 6 + ["mamba"] * 2
    assert not any(p.startswith("stack/p5/") for p in params)
    assert params["shared/attn/wq"].shape == (1, 2048, 32 * 64)
    caches = {k: v.shape for k, v in model.init_cache(1, 32768, "meta").items()}
    assert caches["stack/c5/k"] == (1, 6, 1, 32768, 32, 64)
    assert caches["stack/c0/ssm"] == (1, 6, 1, 64, 64, 64)
    assert caches["tail/t1/conv_x"] == (1, 1, 3, 4096)
    assert block_pattern(get_config("rwkv6-3b")) == (("rwkv",), 32, ())
    assert block_pattern(get_config("zamba2-1.2b", smoke=True)) == (
        ("mamba", "shared"), 1, ())


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_count_match_jax(arch, smoke):
    jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert param_shapes(cfg) == _jax_shapes(jcfg)
    assert count_params(cfg) == jcount_params(jcfg)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_n_params_matches_jax(arch):
    for smoke in (False, True):
        assert get_config(arch, smoke=smoke).n_params() == jget_config(
            arch, smoke=smoke).n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_jax_rules(arch):
    """The fixed leaves equal JAX's (within f32 rounding of linspace), the
    drawn ones have JAX's scale (the bf16 cast leaves them finite)."""
    cfg = get_config(arch, smoke=True)
    params = Model(cfg).init(2, 0, "cpu")
    jparams = _jax_params(arch)
    got = {k: v[0] for k, v in params.items()}
    want = {k: v[0] for k, v in model_params_from_jax(jparams).items()}
    fixed = (("A_log", "D", "dt_bias", "norm") if arch == "zamba2-1.2b"
             else ("decay_base", "ln_out"))
    for name in got:
        leaf = name.rsplit("/", 1)[-1]
        assert torch.isfinite(got[name]).all(), name
        if leaf in fixed:
            assert torch.allclose(got[name], want[name], rtol=1e-6,
                                  atol=1e-6), name
        elif leaf in ("mu", "mu_x", "mu_k", "mu_r"):
            assert 0 <= float(got[name].min()) and float(got[name].max()) < 0.1
        elif leaf in ("lora_B", "decay_B", "bonus_u", "conv_x"):
            ratio = float(got[name].std()) / float(want[name].std())
            assert 0.8 < ratio < 1.25, (name, ratio)
    drawn = ("stack/p0/mixer/w_x" if arch == "zamba2-1.2b"
             else "stack/p0/tm/w_r")
    assert not torch.equal(params[drawn][0], params[drawn][1])


def test_block_inits_and_caches_have_the_jax_leaves():
    """The per-block inits and cache inits give the JAX functions' leaves,
    shapes and dtypes (f32 draws; the rwkv state f32, the rest in the
    compute dtype)."""
    gen = torch.Generator().manual_seed(0)
    for arch, fns in (("zamba2-1.2b", ((mamba2.init_mamba, jm2.init_mamba),)),
                      ("rwkv6-3b", ((rwkv6.init_rwkv_timemix,
                                     jr6.init_rwkv_timemix),
                                    (rwkv6.init_rwkv_channelmix,
                                     jr6.init_rwkv_channelmix)))):
        cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
        for ours, theirs in fns:
            got = ours(gen, cfg, "cpu")
            want = jax.eval_shape(lambda: theirs(jax.random.PRNGKey(0), jcfg,
                                                 jnp.float32))
            assert {k: tuple(v.shape) for k, v in got.items()} == {
                k: v.shape for k, v in want.items()}
            assert all(v.dtype == torch.float32 for v in got.values())
    for arch, ours, theirs in (
            ("zamba2-1.2b", mamba2.init_mamba_cache, jm2.init_mamba_cache),
            ("rwkv6-3b", rwkv6.init_rwkv_cache, jr6.init_rwkv_cache)):
        cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
        got = ours(cfg, B, torch.bfloat16, "cpu")
        want = theirs(jcfg, B, jnp.bfloat16)
        assert {k: (tuple(v.shape[1:]), str(v.dtype)[6:])
                for k, v in got.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_and_caches_through_convert(arch):
    """Every leaf (the shared block's, without repeat dim) and every cache
    leaf (the f32 wkv state, the compute-dtype ssm state) crosses to the
    JAX tree and back unchanged."""
    jparams = _jax_params(arch)
    params = model_params_from_jax(jparams)
    back = params_from_jax(params_to_jax({k: v[0] for k, v in params.items()}))
    assert sorted(back) == sorted(params)
    for k in params:
        assert torch.equal(back[k][None], params[k]), k
    jmodel = JModel(dataclasses.replace(jget_config(arch, smoke=True),
                                        dtype="bfloat16"))
    jcache = jax.tree.map(np.asarray, jmodel.init_cache(B, 8))
    cache = model_params_from_jax(jcache)
    model = Model(dataclasses.replace(get_config(arch, smoke=True),
                                      dtype="bfloat16"))
    want = model.init_cache(B, 8, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
