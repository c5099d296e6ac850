"""The MoE family of the port (qwen3-moe-30b-a3b, llama4-maverick-400b-a17b)
against the JAX package on the CPU, and the plain flash version at head dim
32, the smoke models' attention.

The JAX smoke models' weights move through ``repro_torch.convert``; inputs
are numpy draws.

* ``moe_ffn`` against ``repro.models.moe.moe_ffn`` (jitted), float32 and
  bfloat16, at the smoke configs' capacity factor 2.0 and at 0.5, where
  tokens are dropped.  The routing is equal: each token's experts, each
  pair's slot and so the set of dropped pairs, against JAX's own top-k and
  cumulative count (the first lines of its ``moe_ffn``); the port's
  gathered expert buffer equals JAX's one-hot dispatch ``xe`` bit for bit.
  y: float32 within 1e-6 of max|y| (measured at most 3.1e-7: the expert
  matmuls sum in another order); bfloat16 at most 1e-3 of the elements
  more than one bf16 ulp apart and max|d| within 1e-2 of max|y|
  (measured: qwen3-moe bit-equal, with ``moe.silu`` rounding as XLA's
  expansion of ``jax.nn.silu`` rounds; llama4 3.1e-4 of the elements and
  9.1e-4, where its shared expert's matmuls add in another order).  aux
  within 1e-6 (measured at most 1.2e-7).
* ``Model.prefill`` (naive and chunked attention: the port's chunked path
  is the flash kernel's plain version at head dim 32), ``decode_step``
  over 24 steps and ``loss`` with the router aux term, for both smoke
  models, against JAX's ``Model``: float32 within 1e-5 of the largest
  value (prefill logits measured at most 1.35e-6), bfloat16 within the
  dense tests' 3e-2 (measured at most 1.92e-2).
* ``param_shapes`` in JAX flatten order and ``count_params`` against
  JAX's exact count; the ``moe/*`` leaves through ``convert`` both ways;
  the serve launcher's loop on qwen3-moe: greedy tokens equal to JAX's.
* the plain flash version at head dim 32 against the JAX oracle at ragged
  lengths (the Pallas kernel in interpret mode: ``test_torch_kernels.py``),
  and both kernel entries taking head dim 32 from metadata alone.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models.transformer import Model as JModel
from repro.models.transformer import count_params as jcount_params
from repro_torch.configs.base import get_config
from repro_torch.convert import (model_params_from_jax, params_from_jax,
                                 params_to_jax)
from repro_torch.kernels import build, dispatch, ref
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.transformer import (Model, block_pattern,
                                            count_params, param_shapes)

from test_torch_dense_variants import (_jax_serve_loop, _jax_shapes, _rel,
                                       _tokens)
from test_torch_slice import one_thread  # noqa: F401  (autouse)

ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
B, S = 2, 64
RTOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: bf16 moe_ffn: the share of y's elements more than one bf16 ulp from
#: JAX's, and max|d| / max|y|
BF16_ULP_SHARE = 1e-3
BF16_RTOL = 1e-2


# -- moe_ffn ---------------------------------------------------------------------


def _ffn_case(arch, dtype, factor):
    """(JAX cfg, port cfg, JAX params, port params, x as numpy f32 (B, S,
    D)): one MoE block's weights from the JAX init, cast to ``dtype`` as
    the JAX ``_cast`` casts a block's leaves, the router too."""
    jcfg = jget_config(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=factor))
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    jdt, tdt = DTYPES[dtype]
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg,
                                                  jnp.float32))
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree)
    p = {k: v.to(tdt) for k, v in model_params_from_jax(tree).items()}
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


@functools.partial(jax.jit, static_argnums=2)
def _jax_routing(jp, x, jcfg):
    """The first lines of the JAX ``moe_ffn``: expert indices, slots and the
    dispatched buffer xe (E, G, C, D)."""
    m = jcfg.moe
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    E, K = m.n_experts, m.top_k
    g = min(m.group_size, T)
    G = T // g
    C = jmoe._capacity(g, K, E, m.capacity_factor)
    xt = x.reshape(G, g, D)
    scores = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(scores, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.reshape(G, g * K, E), axis=1).reshape(
        G, g, K, E) - 1
    pos = jnp.sum(pos * onehot, axis=-1)
    disp = jnp.einsum("gske,gskc->gsec",
                      jax.nn.one_hot(idx, E, dtype=x.dtype),
                      jax.nn.one_hot(pos, C, dtype=x.dtype))
    return idx, pos, jnp.einsum("ygec,ygd->eycd", disp, xt)


@pytest.mark.parametrize("factor", [2.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dtype, factor):
    jcfg, cfg, jp, p, x = _ffn_case(arch, dtype, factor)
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x)[None].to(tdt)
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    g = min(m.group_size, B * S)
    G, C = B * S // g, moe.capacity(g, K, E, m.capacity_factor)

    jidx, jpos, jxe = _jax_routing(jp, jx, jcfg)
    _, _, idx, slots, _ = moe.route(p["router"], tx.reshape(1, G, g, -1), m)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(slots[0].numpy(), np.asarray(jpos))
    dropped = int((slots >= C).sum())
    if factor < 1.0:
        assert dropped > 0
    else:
        assert dropped == 0
    # the gather dispatch fills the buffer as the one-hot einsum does
    group = torch.arange(G).view(1, G, 1, 1)
    rows = (idx * G + group) * C + slots
    rows = torch.where(slots < C, rows, E * G * C)
    xe = moe.dispatch(tx.reshape(1, G, g, -1), rows, E * G * C)
    assert torch.equal(xe.float().view(E, G, C, -1),
                       torch.from_numpy(np.array(jxe.astype(jnp.float32))))

    jy, jaux = jax.jit(jmoe.moe_ffn, static_argnums=2)(jp, jx, jcfg)
    y, aux = moe.moe_ffn(p, tx, cfg)
    assert y.dtype == tdt and y.shape == (1, B, S, cfg.d_model)
    want = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    if dtype == "float32":
        assert _rel(y[0], want) <= 1e-6
    else:
        rel, share = flash_kernel.bf16_gap(y[0], want)
        assert rel <= BF16_RTOL and share <= BF16_ULP_SHARE, (rel, share)
    assert aux.shape == (1,) and aux.dtype == torch.float32
    assert abs(float(aux[0]) - float(jaux)) <= 1e-6


def test_moe_ffn_keeps_the_nodes_apart():
    """Two nodes with their own weights and inputs: each node's output is
    the one-node call's, bit for bit."""
    _, cfg, _, p, x = _ffn_case("qwen3-moe-30b-a3b", "float32", 0.5)
    p2 = {k: torch.cat([v, v.flip(-1)]) for k, v in p.items()}
    x2 = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    y, aux = moe.moe_ffn(p2, x2, cfg)
    for i in range(2):
        yi, auxi = moe.moe_ffn({k: v[i:i + 1] for k, v in p2.items()},
                               x2[i:i + 1], cfg)
        assert torch.equal(y[i:i + 1], yi) and torch.equal(aux[i:i + 1], auxi)


# -- the model -------------------------------------------------------------------


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
    assert _rel(logits[0], jlogits) < RTOL[dtype]
    want = model_params_from_jax(jax.tree.map(np.asarray, jcaches))
    assert sorted(caches) == sorted(want)
    for name, w in want.items():
        assert caches[name].shape == w.shape and caches[name].dtype == w.dtype
        assert _rel(caches[name], w) < RTOL[dtype], name


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """24 decode steps from an empty cache (each step's MoE FFN routes the
    batch's 2 tokens as one group), float32, logits and caches within
    1e-5 of the largest value."""
    jmodel, jparams, model, params = _models(arch)
    steps = 24
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
        assert _rel(logits[0], jlogits) < RTOL["float32"], t
    want = model_params_from_jax(jax.tree.map(np.asarray, jcache))
    for name, w in want.items():
        assert _rel(cache[name], w) < RTOL["float32"], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_router_aux_matches_jax(arch, dtype):
    """The loss with ``router_aux_weight`` times the layers' summed aux
    loss: float32 within 1e-6 relative, bfloat16 within 1e-2; and the aux
    term itself is there (the port's loss differs from its cross-entropy
    by JAX's ``aux_w * aux``, within 1e-6)."""
    jmodel, jparams, model, params = _models(arch, dtype)
    toks = _tokens(2, (B, S + 1), jmodel.cfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jtotal, parts = jax.jit(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = model.loss(params, {k: torch.from_numpy(v)[None].long()
                              for k, v in batch.items()})
    assert got.shape == (1,)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert abs(float(got[0]) - float(jtotal)) <= tol * abs(float(jtotal))
    aux_w = model.cfg.moe.router_aux_weight
    assert float(parts["aux"]) > 0
    if dtype == "float32":
        ce = float(got[0]) - float(jtotal - aux_w * parts["aux"])
        assert abs(ce - aux_w * float(parts["aux"])) <= 1e-6


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_count_match_jax(arch, smoke):
    jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert param_shapes(cfg) == _jax_shapes(jcfg)
    assert count_params(cfg) == jcount_params(jcfg)
    pattern, repeat, tail = block_pattern(cfg)
    want = {"qwen3-moe-30b-a3b": (("moe",), cfg.n_layers, ()),
            "llama4-maverick-400b-a17b": (("dense_global", "moe"),
                                          cfg.n_layers // 2, ())}[arch]
    assert (pattern, repeat, tail) == want


def test_block_pattern_with_a_tail_matches_jax():
    from repro.models.transformer import block_pattern as jblock_pattern
    for n_layers in (1, 3, 5):
        for arch in ARCHS:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      n_layers=n_layers)
            jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                                       n_layers=n_layers)
            assert block_pattern(cfg) == jblock_pattern(jcfg)
            assert param_shapes(cfg) == _jax_shapes(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_leaves_round_trip_through_convert(arch):
    tree = _jax_params(arch)
    params = params_from_jax(tree)
    assert any(k.startswith("stack/p") and "/moe/" in k for k in params)
    back = params_to_jax(params)
    flat = lambda t: {"/".join(k.key for k in path): np.asarray(leaf)
                      for path, leaf in jax.tree_util.tree_flatten_with_path(
                          t)[0]}
    want, got = flat(tree), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_qwen3_moe_serve_loop_tokens_match_jax():
    jmodel, jparams, model, params = _models("qwen3-moe-30b-a3b")
    prompt = _tokens(4, (B, 8), jmodel.cfg.vocab_size)
    want = _jax_serve_loop(jmodel, jparams, jnp.asarray(prompt), 16)
    got, ttft, times = serve.run_request(
        model, params, torch.from_numpy(prompt).long(), 16, lambda: None)
    assert got.shape == (B, 16) and len(times) == 15 and ttft > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_the_moe_smoke_models(arch, capsys):
    rc = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                     "--prompt-len", "4", "--gen-len", "4", "--device", "cpu"])
    assert rc == 0
    assert "[serve] summary " in capsys.readouterr().out


# -- flash at head dim 32 ----------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [200, 300])
def test_flash_plain_dh32_ragged_matches_jax_oracle(s, dtype, causal):
    """Ragged last key blocks at head dim 32, the qwen3-moe smoke model's
    4/2 heads and 4/4: f32 within 2e-6 of the oracle's plain softmax over
    the KV-repeated heads; bf16 within FLASH_BF16_F32P_RTOL of the oracle
    on the same bf16 values in f32 (the plain version rounds P)."""
    for kv in (4, 2):
        rng = np.random.default_rng(s + kv)
        q, k, v = (rng.standard_normal((1, s, h, 32)).astype(np.float32)
                   for h in (4, kv, kv))
        if dtype == "bfloat16":
            q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                       for a in (q, k, v))
        rep = lambda a: jnp.repeat(jnp.asarray(a), 4 // kv, axis=2)
        want = np.array(jref.flash_attention_ref(
            jnp.asarray(q), rep(k), rep(v), causal=causal))
        tdt = DTYPES[dtype][1]
        got = ref.flash_attention_ref(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
        else:
            rel, _ = flash_kernel.bf16_gap(got, torch.from_numpy(want))
            assert rel <= flash_kernel.FLASH_BF16_F32P_RTOL


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_entries_take_head_dim_32(dtype, window, monkeypatch):
    """Both entries pass Dh 32 (the MoE smoke models' 4/2 heads) to their
    library, with and without a window, from metadata alone: the check
    raises nothing and the loader is reached; the launch would be counted
    as "bf16_dh32" / "f32_dh32_window" ..."""
    def loader(name):
        raise RuntimeError(f"kernel loader reached: {name}")

    monkeypatch.setattr(build, "load_library", loader)
    assert 32 in flash_kernel.HEAD_DIMS[dtype]
    q = torch.empty((2, 64, 4, 32), dtype=dtype, device="meta")
    kv = torch.empty((2, 64, 2, 32), dtype=dtype, device="meta")
    lib = "flash" if dtype == torch.float32 else "flash_tc"
    with pytest.raises(RuntimeError, match=f"loader reached: {lib}$"):
        dispatch.flash_attention(q, kv, kv, causal=True, window=window)
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    assert flash_kernel.variant(dtype, 32, window) == (
        f"{name}_dh32" + ("" if window is None else "_window"))
