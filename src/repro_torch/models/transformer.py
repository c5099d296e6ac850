"""The dense decoder of the JAX package's model stack: the training
forward, the prefill and the single-token decode step with its KV cache.

Parameters are a flat dict ``path -> (n, *shape)`` tensor (n gossip nodes
stacked first), with the JAX package's tree paths ("embed/tok",
"stack/p0/attn/wq", ...) and shapes: the layers of the scanned block
pattern are stacked on a leading ``n_layers`` dim of every "stack/p0"
leaf.  :func:`param_shapes` lists them in the JAX ``tree_flatten`` order,
which is the order the gossip engine packs them in.

The KV cache is ``{"k": (n, L, B, C, KV, Dh), "v": ...}`` in the compute
dtype: the JAX stack's ``caches["stack"]["c0"]`` leaves with the node
dimension first.  A decode step writes its slot in place.  For serving,
:meth:`Model.compute_params` casts the weights to the compute dtype once,
so no call casts them again (the JAX ``_cast`` rounds the same way).

Not ported: the other families (MoE, SSM, hybrid, VLM, audio), local /
global layer patterns, sliding-window and ring-buffer caches, and
``remat`` (the JAX qwen3-1.7b config asks for ``"dots"``): blocks are not
checkpointed, since the training sequence of the slice is short and its
activations are small next to the CHOCO state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.packing import fold_seed

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

    def init(self, n_nodes: int, seed: int, device,
             nodes: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        """Random node-stacked parameters: fan-in-scaled normal weights,
        0.02-scaled normal embeddings, zero norm gains (the JAX package's
        rules, drawn from torch Generators, so not its values).

        Node i draws from its own generator, seeded ``fold_seed(seed, i)``
        (the JAX trainer folds the node index into its key), so a node's
        weights are the same whether all ``n_nodes`` are drawn or, with
        ``nodes``, only some: the per-rank engine draws its own row."""
        nodes = range(n_nodes) if nodes is None else nodes
        gens = [torch.Generator(device=device).manual_seed(fold_seed(seed, i))
                for i in nodes]
        params = {}
        for path, shape in param_shapes(self.cfg):
            name = path.rsplit("/", 1)[-1]
            p = torch.zeros((len(gens),) + shape, dtype=self.param_dtype,
                            device=device)
            if name == "tok" or len(shape) >= 2:
                scale = 0.02 if name == "tok" else 1.0 / math.sqrt(shape[-2])
                for row, gen in zip(p, gens):
                    row.copy_(torch.randn(shape, generator=gen,
                                          device=device) * scale)
            params[path] = p
        return params

    def compute_params(self, params) -> Dict[str, torch.Tensor]:
        """The parameters cast once to the compute dtype, for serving:
        prefill and decode then read them as they are, where a call on
        the f32 parameters casts every weight it reads.  (A tied
        embedding's sqrt(d_model) scale then multiplies the cast table:
        one rounding more than the JAX model, which scales the f32 one.)"""
        return {k: v.to(self.dtype) for k, v in params.items()}

    def init_cache(self, batch: int, max_seq: int, device,
                   n_nodes: int = 1) -> Dict[str, torch.Tensor]:
        """Zeroed KV cache: "k" and "v" of shape (n, L, B, max_seq, KV, Dh)
        in the compute dtype."""
        cfg = self.cfg
        shape = (n_nodes, cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {name: torch.zeros(shape, dtype=self.dtype, device=device)
                for name in ("k", "v")}

    @staticmethod
    def _sub(p, prefix):
        return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}

    def _layers(self, params):
        """Per layer, its "stack/p0" leaves (views) in the compute dtype."""
        stack = self._sub(params, "stack/p0/")
        for layer in range(self.cfg.n_layers):
            yield layer, {k: v[:, layer].to(self.dtype) for k, v in stack.items()}

    def _mlp_residual(self, p, x):
        y = L.rms_norm(x, L.per_node(p["ln2"], x.dim()), self.cfg.norm_eps)
        return x + L.mlp(self._sub(p, "mlp/"), y, self.cfg)

    def _block(self, p, x, positions):
        """One layer's full-sequence pass: (x, (k, v))."""
        h, kv = L.attention(
            self._sub(p, "attn/"),
            L.rms_norm(x, L.per_node(p["ln1"], x.dim()), self.cfg.norm_eps),
            self.cfg, positions)
        return self._mlp_residual(p, x + h), kv

    def _embed_tokens(self, params, tokens):
        return L.embed_tokens({"tok": params["embed/tok"]}, tokens,
                              self.cfg).to(self.dtype)

    def hidden(self, params, tokens, caches=None):
        """Final hidden states (n, B, S, D) in the compute dtype.  With
        ``caches`` (:meth:`init_cache` of length >= S), each layer's k and
        v fill its first S slots."""
        x = self._embed_tokens(params, tokens)
        B, S = tokens.shape[1:]
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for layer, p in self._layers(params):
            x, (k, v) = self._block(p, x, positions)
            if caches is not None:
                caches["k"][:, layer, :, :S] = k
                caches["v"][:, layer, :, :S] = v
        return x

    def _embed(self, params, dtype):
        """The embed leaves the final projection reads, cast to ``dtype``."""
        proj = "tok" if self.cfg.tie_embeddings else "unembed"
        return {k: params[f"embed/{k}"].to(dtype) for k in ("final_norm", proj)}

    def _logits(self, params, h):
        return L.logits_from_hidden(self._embed(params, h.dtype), h, self.cfg)

    def logits(self, params, tokens):
        """(n, B, S, V) logits, as the JAX model's final projection."""
        return self._logits(params, self.hidden(params, tokens))

    def loss(self, params, batch) -> torch.Tensor:
        """Per-node mean cross-entropy, shape (n,)."""
        h = self.hidden(params, batch["tokens"])
        return L.chunked_lm_loss(self._embed(params, h.dtype), h,
                                 batch["labels"], self.cfg)

    def prefill(self, params, tokens):
        """Full-sequence pass over tokens (n, B, S): last-token logits
        (n, B, 1, V) and the KV cache of length S."""
        n, B, S = tokens.shape
        caches = self.init_cache(B, S, tokens.device, n_nodes=n)
        h = self.hidden(params, tokens, caches)
        return self._logits(params, h[:, :, -1:]), caches

    def decode_step(self, params, token, caches, pos):
        """One token per sequence.  token: (n, B, 1); pos: (B,) long
        absolute position, the same for every sequence; caches are
        written in place at slot pos.  Returns (logits (n, B, 1, V),
        caches)."""
        x = self._embed_tokens(params, token)
        for layer, p in self._layers(params):
            h = L.decode_attention(
                self._sub(p, "attn/"),
                L.rms_norm(x, L.per_node(p["ln1"], x.dim()), self.cfg.norm_eps),
                self.cfg, caches["k"][:, layer], caches["v"][:, layer], pos)
            x = self._mlp_residual(p, x + h)
        return self._logits(params, x), caches
