"""The dense stack of the JAX package's model: the training forward, the
prefill and the single-token decode step with its KV cache, for the dense
decoders and the two frontend families, which run the same dense stack
(the JAX ``block_pattern`` gives them its dense kinds):

* "audio" (hubert-xlarge): an encoder over precomputed frame embeddings,
  ``frame_embeds @ in_proj``, bidirectional (``causal=False``), then
  ``final_norm``, ``head`` and the final softcap; its loss is the
  cross-entropy over the frames the batch's ``mask`` marks.  It has no
  token embedding and no decode step (:meth:`Model.decode_step` raises),
  but its prefill returns the caches of every layer, as JAX's does.
* "vlm" (llava-next-mistral-7b): a decoder whose input is an image prefix,
  ``gelu(patch_embeds @ w1) @ w2`` (the ``projector``), then the text's
  token embeddings; positions 0..S-1 run over both.  Its loss is the
  chunked cross-entropy with the image prefix masked out (labels
  zero-padded there, ``valid`` 0), and it decodes text tokens as the dense
  decoders do.

The inputs are the JAX package's batch dicts with the node dimension
first (``frame_embeds``; ``patch_embeds`` and ``tokens``; ``tokens``), or,
for the dense family, a token tensor (n, B, S).

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

The "moe" family (qwen3-moe-30b-a3b, llama4-maverick) runs the same
stack with its "moe" layers' MLP replaced by the MoE FFN
(``models/moe.py``); its caches are the dense ones, and its loss adds the
layers' router aux loss.

Not ported: the other families (SSM, hybrid) and ``remat`` (the
JAX configs ask for ``"dots"``): blocks are not checkpointed, since the
training sequence of the slice is short and its activations are small
next to the CHOCO state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.packing import fold_seed

from . import layers as L
from . import moe as MOE

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the families the port runs, each through the dense stack ("moe" with
#: its MoE blocks in place of some or all of the dense ones)
FAMILIES = ("dense", "moe", "vlm", "audio")


def _check(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"model family {cfg.family!r} is not ported")


def block_pattern(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repeat, tail) of the stack (every family of
    :data:`FAMILIES`), as the JAX ``block_pattern``: ``pattern`` runs
    ``repeat`` times, then each block of ``tail`` once.  With
    ``local_global_pattern`` k > 0 the pattern is k local layers and one
    global one, and the layers that do not fill a last pattern make the
    tail.  The moe family: ("moe",) with ``moe_every`` 1, else
    ``moe_every - 1`` global layers and one "moe" layer."""
    _check(cfg)
    if cfg.family == "moe":
        ev = cfg.moe.moe_every
        if ev == 1:
            return ("moe",), cfg.n_layers, ()
        unit = ("dense_global",) * (ev - 1) + ("moe",)
        repeat, rem = divmod(cfg.n_layers, ev)
        return unit, repeat, unit[:rem]
    if cfg.local_global_pattern > 0:
        unit = ("dense_local",) * cfg.local_global_pattern + ("dense_global",)
        repeat, rem = divmod(cfg.n_layers, len(unit))
        return unit, repeat, unit[:rem]
    return ("dense_global",), cfg.n_layers, ()


def param_shapes(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, per-node shape) of every parameter, in JAX flatten order.
    The audio family has ``in_proj``, ``final_norm`` and ``head`` where the
    others have ``embed/``; the vlm family adds ``projector/w1`` and
    ``projector/w2``; a "moe" block has ``moe/router`` (D, E),
    ``moe/w_gate``, ``moe/w_up`` (E, D, d_expert), ``moe/w_down`` and,
    with shared experts, ``moe/shared/...`` where a dense block has
    ``mlp/...``."""
    pattern, repeat, tail = block_pattern(cfg)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.family == "audio":
        shapes = {"in_proj": (cfg.frontend.embed_dim, D), "final_norm": (D,),
                  "head": (D, V)}
    else:
        shapes = {"embed/tok": (V, D), "embed/final_norm": (D,)}
        if not cfg.tie_embeddings:
            shapes["embed/unembed"] = (D, V)
    if cfg.family == "vlm":
        shapes["projector/w1"] = (cfg.frontend.embed_dim, D)
        shapes["projector/w2"] = (D, D)
    attn = {"ln1": (D,), "ln2": (D,), "attn/wq": (D, H * Dh),
            "attn/wk": (D, KV * Dh), "attn/wv": (D, KV * Dh),
            "attn/wo": (H * Dh, D)}
    if cfg.qk_norm:
        attn["attn/q_norm"] = (Dh,)
        attn["attn/k_norm"] = (Dh,)

    def mlp(prefix, d_ff):
        names = (("w_gate", "w_up") if cfg.mlp_type in ("swiglu", "geglu")
                 else ("w_up",))
        out = {f"{prefix}/{name}": (D, d_ff) for name in names}
        out[f"{prefix}/w_down"] = (d_ff, D)
        return out

    def block(kind):
        if kind != "moe":
            return {**attn, **mlp("mlp", F)}
        m = cfg.moe
        E, Fe = m.n_experts, m.d_expert
        out = {**attn, "moe/router": (D, E), "moe/w_gate": (E, D, Fe),
               "moe/w_up": (E, D, Fe), "moe/w_down": (E, Fe, D)}
        if m.n_shared_experts:
            out.update(mlp("moe/shared", m.n_shared_experts * F))
        return out

    for i, kind in enumerate(pattern):
        for name, shape in block(kind).items():
            shapes[f"stack/p{i}/{name}"] = (repeat,) + shape
    for i, kind in enumerate(tail):
        for name, shape in block(kind).items():
            shapes[f"tail/t{i}/{name}"] = shape
    return sorted(shapes.items(), key=lambda kv: kv[0].split("/"))


def count_params(cfg) -> int:
    """Exact per-node parameter count."""
    return sum(math.prod(shape) for _, shape in param_shapes(cfg))


class Model:
    """The dense stack over node-stacked parameter dicts."""

    def __init__(self, cfg):
        _check(cfg)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]

    def init(self, n_nodes: int, seed: int, device,
             nodes: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        """Random node-stacked parameters: fan-in-scaled normal weights (the
        frontends' projections too), 0.02-scaled normal embeddings, zero
        norm gains (the JAX package's rules, drawn from torch Generators,
        so not its values).

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

    def _ffn_residual(self, kind, p, x):
        """x + the layer's FFN of its second norm: the dense MLP, or the
        MoE FFN of a "moe" layer.  Returns (x, aux (n,) f32 or None)."""
        y = L.rms_norm(x, L.per_node(p["ln2"], x.dim()), self.cfg.norm_eps)
        if kind == "moe":
            f, aux = MOE.moe_ffn(self._sub(p, "moe/"), y, self.cfg)
            return x + f, aux
        return x + L.mlp(self._sub(p, "mlp/"), y, self.cfg), None

    def _block(self, kind, p, x, positions):
        """One layer's full-sequence pass: (x, (k, v), aux or None)."""
        h, kv = L.attention(
            self._sub(p, "attn/"),
            L.rms_norm(x, L.per_node(p["ln1"], x.dim()), self.cfg.norm_eps),
            self.cfg, positions, local=kind == "dense_local")
        x, aux = self._ffn_residual(kind, p, x + h)
        return x, kv, aux

    def _embed_tokens(self, params, tokens):
        return L.embed_tokens({"tok": params["embed/tok"]}, tokens,
                              self.cfg).to(self.dtype)

    def embed_inputs(self, params, batch):
        """The JAX ``_embed_inputs``: (x (n, B, S, D) in the compute dtype,
        labels, valid) of a batch dict, or of a dense model's token tensor
        (n, B, S).

        audio: ``frame_embeds @ in_proj``, the labels ``targets`` and
        ``valid`` the batch's ``mask``.  vlm: ``gelu(patch_embeds @ w1) @
        w2`` (tanh gelu, JAX's default), then the token embeddings; the
        labels, when the batch has them, zero-padded over the image
        prefix, with ``valid`` 0 there and 1 on the text.  dense: the
        token embeddings, ``labels`` and ``valid``."""
        cfg, dt = self.cfg, self.dtype
        if torch.is_tensor(batch):
            batch = {"tokens": batch}
        if cfg.family == "audio":
            x = L.matmul(batch["frame_embeds"].to(dt), params["in_proj"].to(dt))
            return x, batch.get("targets"), batch.get("mask")
        x = self._embed_tokens(params, batch["tokens"])
        labels, valid = batch.get("labels"), batch.get("valid")
        if cfg.family == "vlm":
            vis = L.matmul(F.gelu(L.matmul(
                batch["patch_embeds"].to(dt), params["projector/w1"].to(dt)),
                approximate="tanh"), params["projector/w2"].to(dt))
            x = torch.cat([vis, x], dim=2)
            if labels is not None:
                prefix = vis.shape[:3]                 # (n, B, patches)
                valid = torch.cat([
                    torch.zeros(prefix, dtype=torch.float32, device=x.device),
                    torch.ones(labels.shape, dtype=torch.float32,
                               device=x.device)], dim=2)
                labels = torch.cat([labels.new_zeros(prefix), labels], dim=2)
        return x, labels, valid

    def hidden(self, params, batch, caches=None):
        """Final hidden states (n, B, S, D) in the compute dtype, of a
        batch dict or a token tensor (:meth:`embed_inputs`).  With
        ``caches`` (:meth:`init_cache` of max_seq >= S), each layer keeps
        its k and v of position p in slot p % C: a global layer fills its
        first S slots, a local one of C < S slots the last C positions
        (slot p % C, the slot :meth:`decode_step` reads; the JAX prefill
        keeps ``k[:, -C:]`` in slots 0..C-1, the same when C divides S)."""
        return self._stack(params, self.embed_inputs(params, batch)[0],
                           caches)[0]

    def _stack(self, params, x, caches=None):
        """The layers over the embedded inputs x (n, B, S, D): (x, the sum
        of the MoE layers' aux losses (n,) f32, 0 without MoE layers)."""
        B, S = x.shape[1:3]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        aux_sum = torch.zeros(x.shape[0], dtype=torch.float32,
                              device=x.device)
        for kind, p, cache in self._layers(params, caches):
            x, kv, aux = self._block(kind, p, x, positions)
            if aux is not None:
                aux_sum = aux_sum + aux
            if cache is None:
                continue
            C = cache[0].shape[2]
            if C >= S:
                for c, t in zip(cache, kv):
                    c[:, :, :S] = t
            elif kind == "dense_local":
                slots = torch.arange(S - C, S, device=x.device) % C
                for c, t in zip(cache, kv):
                    c.index_copy_(2, slots, t[:, :, S - C:])
            else:
                raise ValueError(f"a global layer's cache of {C} slots "
                                 f"cannot hold {S} positions")
        return x, aux_sum

    def _embed(self, params, dtype):
        """The leaves the final projection reads, cast to ``dtype``: the
        audio head's, or the embed leaves."""
        if self.cfg.family == "audio":
            return {k: params[k].to(dtype) for k in ("final_norm", "head")}
        proj = "tok" if self.cfg.tie_embeddings else "unembed"
        return {k: params[f"embed/{k}"].to(dtype) for k in ("final_norm", proj)}

    def _logits(self, params, h):
        """The JAX ``_final_logits``: audio's final norm, head and softcap;
        else the final norm and the (tied or untied) unembedding."""
        p = self._embed(params, h.dtype)
        if self.cfg.family == "audio":
            h = L.rms_norm(h, L.per_node(p["final_norm"], h.dim()),
                           self.cfg.norm_eps)
            return L.softcap(L.matmul(h, p["head"]),
                             self.cfg.final_logit_softcap)
        return L.logits_from_hidden(p, h, self.cfg)

    def logits(self, params, batch):
        """(n, B, S, V) logits, as the JAX model's final projection."""
        return self._logits(params, self.hidden(params, batch))

    def loss(self, params, batch) -> torch.Tensor:
        """Per-node mean cross-entropy over the valid positions, shape (n,):
        audio over the full logits, the others in ``loss_chunk`` chunks;
        with MoE layers plus ``router_aux_weight`` times the sum of their
        aux losses (the JAX ``ce + aux_w * aux``)."""
        x, labels, valid = self.embed_inputs(params, batch)
        h, aux = self._stack(params, x)
        if self.cfg.family == "audio":
            return L.cross_entropy(self._logits(params, h), labels, valid)
        ce = L.chunked_lm_loss(self._embed(params, h.dtype), h, labels,
                               self.cfg, valid)
        if self.cfg.moe is None:
            return ce
        return ce + self.cfg.moe.router_aux_weight * aux

    def prefill(self, params, batch):
        """Full-sequence pass over a batch dict or tokens (n, B, S): the
        last position's logits (n, B, 1, V) and the KV cache of max_seq S
        (every family; the audio encoder's too, as JAX builds it)."""
        x = self.embed_inputs(params, batch)[0]
        n, B, S = x.shape[:3]
        caches = self.init_cache(B, S, x.device, n_nodes=n)
        h = self._stack(params, x, caches)[0]
        return self._logits(params, h[:, :, -1:]), caches

    def decode_step(self, params, token, caches, pos):
        """One text token per sequence (dense and vlm).  token: (n, B, 1);
        pos: (B,) long absolute position, the same for every sequence;
        caches are written in place, at slot pos (global layers) or pos % C
        (local ring buffers).  Returns (logits (n, B, 1, V), caches)."""
        if self.cfg.family == "audio":
            raise ValueError(f"{self.cfg.name} is an encoder: it has no "
                             f"decode step")
        x = self._embed_tokens(params, token)
        for kind, p, (ck, cv) in self._layers(params, caches):
            h = L.decode_attention(
                self._sub(p, "attn/"),
                L.rms_norm(x, L.per_node(p["ln1"], x.dim()), self.cfg.norm_eps),
                self.cfg, ck, cv, pos, local=kind == "dense_local")
            x = self._ffn_residual(kind, p, x + h)[0]
        return self._logits(params, x), caches
