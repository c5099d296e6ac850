"""The dense decoder of the JAX package's model stack: the training
forward, the prefill and the single-token decode step with its KV cache.

Parameters are a flat dict ``path -> (n, *shape)`` tensor (n gossip nodes
stacked first), with the JAX package's tree paths ("embed/tok",
"stack/p0/attn/wq", ...) and shapes.  The stack is the JAX
``block_pattern``: a pattern of block kinds ("dense_global", and
"dense_local" with ``local_global_pattern``) scanned ``repeat`` times,
then a ``tail`` of single blocks.  Pattern position i's leaves
("stack/p{i}/...") carry a leading ``repeat`` dim, tail block i's
("tail/t{i}/...") none; layer r * len(pattern) + i is repeat r of
position i.  :func:`param_shapes` lists them in the JAX ``tree_flatten``
order, which is the order the gossip engine packs them in.

The KV cache is a flat dict of the JAX cache tree's leaves with the node
dimension first, in the compute dtype: "stack/c{i}/k" and ".../v" of
shape (n, repeat, B, C, KV, Dh) and "tail/t{i}/k" of (n, B, C, KV, Dh).
A global layer's cache has C = max_seq slots, a local layer's
C = min(sliding_window, max_seq), a ring buffer: position p lives in slot
p % C.  A decode step writes its slot in place.  For serving,
:meth:`Model.compute_params` casts the weights to the compute dtype once,
so no call casts them again (the JAX ``_cast`` rounds the same way).

Not ported: the other families (MoE, SSM, hybrid, VLM, audio) and
``remat`` (the JAX configs ask for ``"dots"``): blocks are not
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


def block_pattern(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repeat, tail) of the dense stack, as the JAX
    ``block_pattern``: ``pattern`` runs ``repeat`` times, then each block
    of ``tail`` once.  With ``local_global_pattern`` k > 0 the pattern is
    k local layers and one global one, and the layers that do not fill a
    last pattern make the tail."""
    _check(cfg)
    if cfg.local_global_pattern > 0:
        unit = ("dense_local",) * cfg.local_global_pattern + ("dense_global",)
        repeat, rem = divmod(cfg.n_layers, len(unit))
        return unit, repeat, unit[:rem]
    return ("dense_global",), cfg.n_layers, ()


def param_shapes(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, per-node shape) of every parameter, in JAX flatten order."""
    pattern, repeat, tail = block_pattern(cfg)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
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
        for i in range(len(pattern)):
            shapes[f"stack/p{i}/{name}"] = (repeat,) + shape
        for i in range(len(tail)):
            shapes[f"tail/t{i}/{name}"] = shape
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

    def cache_len(self, kind: str, max_seq: int) -> int:
        """Slots of one layer's cache: max_seq, or for a local layer
        min(sliding_window, max_seq) (the JAX ``init_block_cache``)."""
        if kind == "dense_local" and self.cfg.sliding_window:
            return min(self.cfg.sliding_window, max_seq)
        return max_seq

    def init_cache(self, batch: int, max_seq: int, device,
                   n_nodes: int = 1) -> Dict[str, torch.Tensor]:
        """Zeroed KV cache in the compute dtype, the JAX cache tree's
        leaves: "stack/c{i}/k" and "stack/c{i}/v" of shape (n, repeat, B,
        C, KV, Dh) per pattern position i, "tail/t{i}/k" and ".../v" of
        (n, B, C, KV, Dh) per tail block, C from :meth:`cache_len`."""
        cfg = self.cfg
        pattern, repeat, tail = block_pattern(cfg)
        heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {}
        for i, kind in enumerate(pattern):
            shapes[f"stack/c{i}"] = (n_nodes, repeat, batch,
                                     self.cache_len(kind, max_seq)) + heads
        for i, kind in enumerate(tail):
            shapes[f"tail/t{i}"] = (n_nodes, batch,
                                    self.cache_len(kind, max_seq)) + heads
        return {f"{prefix}/{name}": torch.zeros(shape, dtype=self.dtype,
                                                device=device)
                for prefix, shape in shapes.items() for name in ("k", "v")}

    @staticmethod
    def _sub(p, prefix):
        return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}

    def _layers(self, params, caches=None):
        """Per layer in order, (kind, its leaves in the compute dtype, its
        (k, v) cache views (n, B, C, KV, Dh) or None)."""
        pattern, repeat, tail = block_pattern(self.cfg)
        stack = [self._sub(params, f"stack/p{i}/") for i in range(len(pattern))]
        for r in range(repeat):
            for i, kind in enumerate(pattern):
                cache = None if caches is None else tuple(
                    caches[f"stack/c{i}/{name}"][:, r] for name in ("k", "v"))
                yield kind, {k: v[:, r].to(self.dtype)
                             for k, v in stack[i].items()}, cache
        for i, kind in enumerate(tail):
            cache = None if caches is None else tuple(
                caches[f"tail/t{i}/{name}"] for name in ("k", "v"))
            yield kind, {k: v.to(self.dtype) for k, v in
                         self._sub(params, f"tail/t{i}/").items()}, cache

    def _mlp_residual(self, p, x):
        y = L.rms_norm(x, L.per_node(p["ln2"], x.dim()), self.cfg.norm_eps)
        return x + L.mlp(self._sub(p, "mlp/"), y, self.cfg)

    def _block(self, kind, p, x, positions):
        """One layer's full-sequence pass: (x, (k, v))."""
        h, kv = L.attention(
            self._sub(p, "attn/"),
            L.rms_norm(x, L.per_node(p["ln1"], x.dim()), self.cfg.norm_eps),
            self.cfg, positions, local=kind == "dense_local")
        return self._mlp_residual(p, x + h), kv

    def _embed_tokens(self, params, tokens):
        return L.embed_tokens({"tok": params["embed/tok"]}, tokens,
                              self.cfg).to(self.dtype)

    def hidden(self, params, tokens, caches=None):
        """Final hidden states (n, B, S, D) in the compute dtype.  With
        ``caches`` (:meth:`init_cache` of max_seq >= S), each layer keeps
        its k and v of position p in slot p % C: a global layer fills its
        first S slots, a local one of C < S slots the last C positions
        (slot p % C, the slot :meth:`decode_step` reads; the JAX prefill
        keeps ``k[:, -C:]`` in slots 0..C-1, the same when C divides S)."""
        x = self._embed_tokens(params, tokens)
        B, S = tokens.shape[1:]
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for kind, p, cache in self._layers(params, caches):
            x, kv = self._block(kind, p, x, positions)
            if cache is None:
                continue
            C = cache[0].shape[2]
            if C >= S:
                for c, t in zip(cache, kv):
                    c[:, :, :S] = t
            elif kind == "dense_local":
                slots = torch.arange(S - C, S, device=tokens.device) % C
                for c, t in zip(cache, kv):
                    c.index_copy_(2, slots, t[:, :, S - C:])
            else:
                raise ValueError(f"a global layer's cache of {C} slots "
                                 f"cannot hold {S} positions")
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
        (n, B, 1, V) and the KV cache of max_seq S."""
        n, B, S = tokens.shape
        caches = self.init_cache(B, S, tokens.device, n_nodes=n)
        h = self.hidden(params, tokens, caches)
        return self._logits(params, h[:, :, -1:]), caches

    def decode_step(self, params, token, caches, pos):
        """One token per sequence.  token: (n, B, 1); pos: (B,) long
        absolute position, the same for every sequence; caches are
        written in place, at slot pos (global layers) or pos % C (local
        ring buffers).  Returns (logits (n, B, 1, V), caches)."""
        x = self._embed_tokens(params, token)
        for kind, p, (ck, cv) in self._layers(params, caches):
            h = L.decode_attention(
                self._sub(p, "attn/"),
                L.rms_norm(x, L.per_node(p["ln1"], x.dim()), self.cfg.norm_eps),
                self.cfg, ck, cv, pos, local=kind == "dense_local")
            x = self._mlp_residual(p, x + h)
        return self._logits(params, x), caches
