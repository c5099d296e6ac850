"""Prefill against token-by-token decode, in bf16, for the JAX model and the
port on the same weights, on the CPU: how far a model's own two serving
paths drift apart at a configuration's full width.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_consistency_reference.py \
        zamba2-1.2b 38 256

takes the arch, its depth and the prompt length (batch 2), draws the JAX
model's weights from PRNGKey(0), carries them to the port through
``repro_torch.convert`` (the port with ``attn_impl="chunked"``, the flash
plain version), and prints each model's max|d| / max(max|logits|, 1)
between the prefill's last logits and the last decode step's: the reading
``chip_smoke.py``'s ``[consistency]`` holds against its bound; then the
port's prefill and decode logits each against JAX's, by the same measure.  Where the
embeddings are untied, the JAX weights are drawn and then held in the
compute dtype: the JAX model rounds every floating leaf to it before use
(``_cast``), so the readings are those of f32 weights at half the memory.
Not a test: at zamba2-1.2b's full depth it takes about 5 minutes and 8 GB,
at rwkv6-3b's 16 layers about 7 minutes and 10 GB.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget_config
from repro.models.transformer import Model as JModel
from repro_torch.configs.base import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models.transformer import Model


def rel(decoded, prefilled):
    d, p = (np.asarray(t, dtype=np.float32) for t in (decoded, prefilled))
    return float(np.abs(d - p).max() / max(np.abs(p).max(), 1.0))


def main(arch, layers, seq, batch=2):
    jcfg = dataclasses.replace(jget_config(arch), n_layers=layers)
    jmodel = JModel(jcfg)
    dt = jnp.dtype(jcfg.dtype)
    cast = (lambda a: a.astype(dt) if jnp.issubdtype(a.dtype, jnp.floating)
            and not jcfg.tie_embeddings else a)
    jparams = jax.jit(lambda key: jax.tree.map(cast, jmodel.init(key)))(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
    pre, _ = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    cache, decode = jmodel.init_cache(batch, seq), jax.jit(jmodel.decode_step)
    for t in range(seq):
        logits, cache = decode(jparams, jnp.asarray(toks[:, t:t + 1]), cache,
                               jnp.full((batch,), t, jnp.int32))
    jpre, jdec = (np.asarray(t.astype(jnp.float32)) for t in (pre, logits))
    print(f"jax  {arch} {layers} layers, prompt {seq} x {batch}: "
          f"{rel(jdec, jpre):.4e}", flush=True)
    model = Model(dataclasses.replace(get_config(arch), n_layers=layers,
                                      attn_impl="chunked"))
    params = model.compute_params(model_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    del jparams
    tt = torch.from_numpy(toks)[None].long()
    pre, _ = model.prefill(params, tt)
    cache = model.init_cache(batch, seq, "cpu")
    for t in range(seq):
        logits, cache = model.decode_step(params, tt[:, :, t:t + 1], cache,
                                          torch.full((batch,), t))
    print(f"port {arch} {layers} layers, prompt {seq} x {batch}: "
          f"{rel(logits[0].float(), pre[0].float()):.4e}; against JAX's: "
          f"prefill {rel(pre[0].float(), jpre):.4e}, decode "
          f"{rel(logits[0].float(), jdec):.4e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
