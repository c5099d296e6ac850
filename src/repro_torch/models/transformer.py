"""The dense decoder of the JAX package's model stack, training forward only.

Parameters are a flat dict ``path -> (n, *shape)`` tensor (n gossip nodes
stacked first), with the JAX package's tree paths ("embed/tok",
"stack/p0/attn/wq", ...) and shapes: the layers of the scanned block
pattern are stacked on a leading ``n_layers`` dim of every "stack/p0"
leaf.  :func:`param_shapes` lists them in the JAX ``tree_flatten`` order,
which is the order the gossip engine packs them in.

Not ported: the other families (MoE, SSM, hybrid, VLM, audio), local /
global layer patterns, prefill / decode and their caches, and ``remat``
(the JAX qwen3-1.7b config asks for ``"dots"``): blocks are not
checkpointed, since the training sequence of the slice is short and its
activations are small next to the CHOCO state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check(cfg) -> None:
    if cfg.family != "dense":
        raise ValueError(f"model family {cfg.family!r} is not ported")


def param_shapes(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, per-node shape) of every parameter, in JAX flatten order."""
    _check(cfg)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, Dh, Ln = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    shapes = {"embed/tok": (V, D), "embed/final_norm": (D,)}
    if not cfg.tie_embeddings:
        shapes["embed/unembed"] = (D, V)
    block = {"ln1": (D,), "ln2": (D,), "attn/wq": (D, H * Dh),
             "attn/wk": (D, KV * Dh), "attn/wv": (D, KV * Dh),
             "attn/wo": (H * Dh, D)}
    if cfg.qk_norm:
        block["attn/q_norm"] = (Dh,)
        block["attn/k_norm"] = (Dh,)
    mlp = (("w_gate", "w_up") if cfg.mlp_type in ("swiglu", "geglu")
           else ("w_up",))
    for name in mlp:
        block[f"mlp/{name}"] = (D, F)
    block["mlp/w_down"] = (F, D)
    for name, shape in block.items():
        shapes[f"stack/p0/{name}"] = (Ln,) + shape
    return sorted(shapes.items(), key=lambda kv: kv[0].split("/"))


def count_params(cfg) -> int:
    """Exact per-node parameter count."""
    return sum(math.prod(shape) for _, shape in param_shapes(cfg))


class Model:
    """Dense decoder over node-stacked parameter dicts."""

    def __init__(self, cfg):
        _check(cfg)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]

    def init(self, n_nodes: int, generator: torch.Generator,
             device) -> Dict[str, torch.Tensor]:
        """Random node-stacked parameters: fan-in-scaled normal weights,
        0.02-scaled normal embeddings, zero norm gains (the JAX package's
        rules, drawn from a torch Generator, so not its values)."""
        params = {}
        for path, shape in param_shapes(self.cfg):
            name = path.rsplit("/", 1)[-1]
            full = (n_nodes,) + shape
            if name == "tok":
                p = torch.randn(full, generator=generator, device=device) * 0.02
            elif len(shape) >= 2:
                p = torch.randn(full, generator=generator, device=device)
                p = p / math.sqrt(shape[-2])
            else:
                p = torch.zeros(full, device=device)
            params[path] = p.to(self.param_dtype)
        return params

    def _block(self, p, x, positions):
        cfg = self.cfg
        p = {k: v.to(x.dtype) for k, v in p.items()}
        sub = lambda pre: {k[len(pre):]: v for k, v in p.items()
                           if k.startswith(pre)}
        nd = x.dim()
        h = L.attention(sub("attn/"),
                        L.rms_norm(x, L.per_node(p["ln1"], nd), cfg.norm_eps),
                        cfg, positions)
        x = x + h
        y = L.rms_norm(x, L.per_node(p["ln2"], nd), cfg.norm_eps)
        return x + L.mlp(sub("mlp/"), y, cfg)

    def hidden(self, params, tokens):
        """Final hidden states (n, B, S, D) in the compute dtype."""
        cfg = self.cfg
        x = L.embed_tokens({"tok": params["embed/tok"]}, tokens, cfg).to(self.dtype)
        B, S = tokens.shape[1:]
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        stack = {k[len("stack/p0/"):]: v for k, v in params.items()
                 if k.startswith("stack/p0/")}
        for layer in range(cfg.n_layers):
            x = self._block({k: v[:, layer] for k, v in stack.items()}, x,
                            positions)
        return x

    def _embed(self, params, dtype):
        """The embed leaves the final projection reads, cast to ``dtype``."""
        proj = "tok" if self.cfg.tie_embeddings else "unembed"
        return {k: params[f"embed/{k}"].to(dtype) for k in ("final_norm", proj)}

    def logits(self, params, tokens):
        """(n, B, S, V) logits, as the JAX model's final projection."""
        h = self.hidden(params, tokens)
        return L.logits_from_hidden(self._embed(params, h.dtype), h, self.cfg)

    def loss(self, params, batch) -> torch.Tensor:
        """Per-node mean cross-entropy, shape (n,)."""
        h = self.hidden(params, batch["tokens"])
        return L.chunked_lm_loss(self._embed(params, h.dtype), h,
                                 batch["labels"], self.cfg)
