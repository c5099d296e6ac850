"""The port's dense decoder against the JAX model on identical weights.

The JAX smoke model's node-stacked parameters (initialised by JAX, moved
through ``repro_torch.convert``) go through both forwards in float32 on
the CPU.  Logits and per-node losses agree within 1e-5 relative: the two
frameworks sum matmuls and reductions in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_1_7b as jqwen
from repro.models.transformer import Model as JModel
from repro_torch.configs import qwen3_1_7b as tqwen
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import Model, count_params

N, B, S = 4, 2, 64
RTOL = 1e-5

_VARIANTS = {
    "smoke": {},
    "chunked_loss": {"loss_chunk": 32},
    "tied_geglu_softcap": {"tie_embeddings": True, "mlp_type": "geglu",
                           "attn_logit_softcap": 50.0,
                           "final_logit_softcap": 30.0, "qk_norm": False},
}


def _cfgs(variant):
    kw = dict(_VARIANTS[variant], dtype="float32")
    return (dataclasses.replace(jqwen.SMOKE_CONFIG, **kw),
            dataclasses.replace(tqwen.SMOKE_CONFIG, **kw))


def _setup(variant):
    jcfg, tcfg = _cfgs(variant)
    jmodel = JModel(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jparams = jax.vmap(jmodel.init)(keys)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (N, B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, Model(tcfg), params, batch


def _jax_logits(model, params, batch):
    def one(p, b):
        x, pos, _, _ = model._embed_inputs(p, b)
        h, _, _ = model._run_stack(p, x, pos, mode="train")
        return model._final_logits(p, h)
    return np.asarray(jax.vmap(one)(params, jax.tree.map(jnp.asarray, batch)))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_logits_match_jax(variant):
    jmodel, jparams, model, params, batch = _setup(variant)
    want = _jax_logits(jmodel, jparams, batch)
    got = model.logits(params, torch.from_numpy(batch["tokens"])).numpy()
    assert got.shape == want.shape == (N, B, S, jmodel.cfg.vocab_size)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_loss_matches_jax(variant):
    jmodel, jparams, model, params, batch = _setup(variant)
    want, _ = jax.vmap(jmodel.loss)(jparams, jax.tree.map(jnp.asarray, batch))
    got = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_param_count_matches_jax():
    from repro.models.transformer import count_params as jcount
    for jcfg, tcfg in ((jqwen.SMOKE_CONFIG, tqwen.SMOKE_CONFIG),
                       (jqwen.CONFIG, tqwen.CONFIG)):
        assert count_params(tcfg) == jcount(jcfg)
