"""Neural-net layers of the dense stack, on node-stacked tensors.

Every activation carries the gossip-node dimension first, ``(n, B, S, ...)``,
and every weight ``(n, *shape)``: the n nodes' models run as one batched
computation (a batched matmul per projection).  Each function computes in
the order and dtype of its JAX counterpart in ``src/repro/models/layers.py``.
``attn_impl="chunked"`` attention goes through the flash kernel
(``kernels/dispatch.py``), with the sliding window on local layers.
Local layers decode against a ring-buffer cache.  Not ported: extra
attention masks (``attn_mask``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch


def per_node(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """(n, *wshape) -> (n, 1, ..., 1, *wshape) with ``ndim`` dims in all,
    so a per-node weight broadcasts against an (n, ..., *wshape) tensor."""
    return w.reshape(w.shape[0], *([1] * (ndim - w.dim())), *w.shape[1:])


def rms_norm(x, weight, eps: float):
    """RMSNorm with (1 + weight) gain, computed in f32.  ``weight``
    broadcasts against x."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.to(torch.float32))).to(x.dtype)


def silu(a):
    """a * sigmoid(a) as XLA expands ``jax.nn.silu``: a * (1 / (1 +
    exp(-a))), each operation rounded to a's dtype.  In bf16 this is JAX's
    value bit for bit, where ``F.silu`` (one rounding) puts 3% of a smoke
    expert layer's SwiGLU outputs more than one bf16 ulp from it."""
    return a * torch.reciprocal(1.0 + torch.exp(-a))


def softcap(x, cap: Optional[float]):
    """tanh soft-capping; identity when cap is None."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float, device=None):
    """Inverse RoPE frequencies for a head dim under base theta."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (n, B, S, H, Dh); positions: (B, S) absolute positions."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)       # (Dh/2,)
    ang = positions[..., :, None].to(torch.float32) * inv      # (B, S, Dh/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def matmul(x, w):
    """(n, ..., K) @ (n, K, N) -> (n, ..., N), one batched matmul."""
    lead = x.shape[:-1]
    return torch.matmul(x.reshape(x.shape[0], -1, x.shape[-1]), w).reshape(
        *lead, w.shape[-1])


def _repeat_kv(k, n_rep: int):
    """(n, B, S, KV, Dh) -> (n, B, S, KV*n_rep, Dh)."""
    if n_rep == 1:
        return k
    n, b, s, kv, dh = k.shape
    return k[:, :, :, :, None, :].expand(n, b, s, kv, n_rep, dh).reshape(
        n, b, s, kv * n_rep, dh)


def _qkv(p, x, cfg, positions):
    """Projections, optional qk-norm and RoPE: q (n, B, S, H, Dh), k and v
    (n, B, S, KV, Dh)."""
    n, B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = matmul(x, p["wq"]).reshape(n, B, S, H, Dh)
    k = matmul(x, p["wk"]).reshape(n, B, S, KV, Dh)
    v = matmul(x, p["wv"]).reshape(n, B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, per_node(p["q_norm"], 5), cfg.norm_eps)
        k = rms_norm(k, per_node(p["k_norm"], 5), cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attention(p, x, cfg, positions, *, local: bool = False):
    """Full-sequence self-attention (GQA, optional qk-norm), for training
    and prefill.  x: (n, B, S, D); positions: (B, S), each row 0..S-1.
    ``local`` selects the sliding window (``cfg.sliding_window``): a key
    is kept iff k_pos > q_pos - window, ANDed with the causal mask.
    Returns ``(out, (k, v))``, k and v before the KV repeat, so a prefill
    can fill its cache.

    ``cfg.attn_impl == "chunked"`` runs the flash kernel, which masks by
    index: the same as the JAX ``_chunked_attention``'s mask by position
    for these positions."""
    n, B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.sliding_window if local else None
    q, k, v = _qkv(p, x, cfg, positions)
    if cfg.attn_impl == "chunked":
        out = dispatch.flash_attention(
            q.reshape(n * B, S, H, Dh), k.reshape(n * B, S, KV, Dh),
            v.reshape(n * B, S, KV, Dh), causal=cfg.causal,
            softcap=cfg.attn_logit_softcap, window=window)
        return matmul(out.reshape(n, B, S, H * Dh), p["wo"]), (k, v)
    if cfg.attn_impl != "naive":
        raise ValueError(f"attn_impl {cfg.attn_impl!r} is not ported")
    kr, vr = _repeat_kv(k, H // KV), _repeat_kv(v, H // KV)

    qpos, kpos = positions[:, None, :, None], positions[:, None, None, :]
    if cfg.causal:
        mask = kpos <= qpos                                    # (B, 1, S, S)
    else:
        mask = torch.ones((B, 1, S, S), dtype=torch.bool, device=x.device)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.einsum("nbqhd,nbkhd->nbhqk", q, kr) * (1.0 / math.sqrt(Dh))
    logits = softcap(logits.to(torch.float32), cfg.attn_logit_softcap)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("nbhqk,nbkhd->nbqhd", w, vr).reshape(n, B, S, H * Dh)
    return matmul(out, p["wo"]), (k, v)


def decode_attention(p, x, cfg, cache_k, cache_v, pos, *, local: bool = False):
    """Single-token decode against a KV cache.

    x: (n, B, 1, D); cache_k, cache_v: (n, B, C, KV, Dh), C = max_seq
    (global) or the local layer's ring of min(sliding_window, max_seq)
    slots, written in place at slot ``pos[0]`` (global) or
    ``pos[0] % C`` (``local``); decode steps are batch-synchronous: every
    request shares the position.  pos: (B,) long tensor of absolute
    positions.  A global layer attends slots <= pos, a local one every
    filled slot, min(pos + 1, C) of them.  GQA-native: the query is
    grouped (n, B, 1, KV, rep, Dh) and contracts the cache directly, with
    no repeated KV copy.  Returns the output (n, B, 1, D)."""
    n, B, _, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    C = cache_k.shape[2]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    slot = pos[:1] % C if local else pos[:1]
    cache_k.index_copy_(2, slot, k)
    cache_v.index_copy_(2, slot, v)

    qg = q.reshape(n, B, 1, KV, H // KV, Dh)
    logits = torch.einsum("nbqkrd,nbckd->nbkrqc", qg, cache_k) * (
        1.0 / math.sqrt(Dh))
    logits = softcap(logits.to(torch.float32), cfg.attn_logit_softcap)
    idx = torch.arange(C, device=x.device)[None, :]
    if local:
        mask = idx < torch.clamp_max(pos + 1, C)[:, None]      # filled slots
    else:
        mask = idx <= pos[:, None]
    mask = mask[None, :, None, None, None, :]                  # (1,B,1,1,1,C)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("nbkrqc,nbckd->nbqkrd", w, cache_v).reshape(
        n, B, 1, H * Dh)
    return matmul(out, p["wo"])


def mlp(p, x, cfg):
    """Gated MLP (swiglu / geglu) or plain gelu MLP."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    elif cfg.mlp_type == "geglu":
        h = (F.gelu(matmul(x, p["w_gate"]), approximate="tanh")
             * matmul(x, p["w_up"]))
    else:
        h = F.gelu(matmul(x, p["w_up"]), approximate="tanh")
    return matmul(h, p["w_down"])


def embed_tokens(p, tokens, cfg):
    """Token lookup per node: tok (n, V, D), tokens (n, B, S) -> (n, B, S, D).

    Its backward adds a token's gradient rows in position order, as the
    JAX package's scatter-add does, so a step's gradient is the same in
    every run.  On the CPU that takes ``F.embedding`` over the (n V, D)
    table, whose backward sums serially: advanced indexing's backward
    there (``index_put_`` with accumulate) adds across threads in an order
    that changes from run to run.  On CUDA advanced indexing's backward
    sorts the indices stably and sums each token's rows in order."""
    tok = p["tok"]
    node = torch.arange(tokens.shape[0], device=tokens.device)[:, None, None]
    if tokens.device.type == "cpu":
        x = F.embedding(tokens + node * tok.shape[1], tok.flatten(0, 1))
    else:
        x = tok[node, tokens]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def logits_from_hidden(p, h, cfg):
    """Final norm -> (tied or untied) unembed -> optional logit softcap."""
    h = rms_norm(h, per_node(p["final_norm"], h.dim()), cfg.norm_eps)
    w = p["tok"].transpose(-1, -2) if cfg.tie_embeddings else p["unembed"]
    return softcap(matmul(h, w), cfg.final_logit_softcap)


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits, labels, valid=None):
    """Mean CE per node over the valid positions.  logits (n, ..., V),
    labels (n, ...), valid None or (n, ...) weights (the audio mask, the
    image prefix's zeros) -> (n,): sum(nll valid) / max(sum(valid), 1)."""
    nll = _nll(logits, labels).reshape(logits.shape[0], -1)
    if valid is None:
        return nll.mean(dim=1)
    v = valid.to(torch.float32).reshape(nll.shape)
    return (nll * v).sum(dim=1) / torch.clamp_min(v.sum(dim=1), 1.0)


def chunked_lm_loss(p, h, labels, cfg, valid=None):
    """Per-node cross-entropy over the vocab in sequence chunks, so the
    full (n, B, S, V) logits are never held at once; over the positions
    ``valid`` weights, as :func:`cross_entropy`."""
    if cfg.loss_chunk <= 0 or h.shape[2] % cfg.loss_chunk != 0:
        return cross_entropy(logits_from_hidden(p, h, cfg), labels, valid)
    n, c = h.shape[0], cfg.loss_chunk
    sums, counts = [], []
    for i in range(0, h.shape[2], c):
        nll = _nll(logits_from_hidden(p, h[:, :, i:i + c], cfg),
                   labels[:, :, i:i + c]).reshape(n, -1)
        if valid is None:
            sums.append(nll.sum(dim=1))
            counts.append(nll.shape[1])
        else:
            v = valid[:, :, i:i + c].to(torch.float32).reshape(n, -1)
            sums.append((nll * v).sum(dim=1))
            counts.append(v.sum(dim=1))
    total = torch.stack(sums, dim=1).sum(dim=1)
    if valid is None:
        return total / max(sum(counts), 1)
    return total / torch.clamp_min(torch.stack(counts, dim=1).sum(dim=1), 1.0)
