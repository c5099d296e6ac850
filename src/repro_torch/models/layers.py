"""Neural-net layers of the dense decoder, on node-stacked tensors.

Every activation carries the gossip-node dimension first, ``(n, B, S, ...)``,
and every weight ``(n, *shape)``: the n nodes' models run as one batched
computation (a batched matmul per projection).  Each function computes in
the order and dtype of its JAX counterpart in ``src/repro/models/layers.py``.
Not ported: decode attention, chunked attention, sliding windows.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


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


def _matmul(x, w):
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


def attention(p, x, cfg, positions):
    """Causal self-attention (GQA, optional qk-norm) for the training
    forward.  x: (n, B, S, D); positions: (B, S)."""
    n, B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _matmul(x, p["wq"]).reshape(n, B, S, H, Dh)
    k = _matmul(x, p["wk"]).reshape(n, B, S, KV, Dh)
    v = _matmul(x, p["wv"]).reshape(n, B, S, KV, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, per_node(p["q_norm"], 5), cfg.norm_eps)
        k = rms_norm(k, per_node(p["k_norm"], 5), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k, v = _repeat_kv(k, H // KV), _repeat_kv(v, H // KV)

    qpos, kpos = positions[:, None, :, None], positions[:, None, None, :]
    if cfg.causal:
        mask = kpos <= qpos                                    # (B, 1, S, S)
    else:
        mask = torch.ones((B, 1, S, S), dtype=torch.bool, device=x.device)
    logits = torch.einsum("nbqhd,nbkhd->nbhqk", q, k) * (1.0 / math.sqrt(Dh))
    logits = softcap(logits.to(torch.float32), cfg.attn_logit_softcap)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("nbhqk,nbkhd->nbqhd", w, v).reshape(n, B, S, H * Dh)
    return _matmul(out, p["wo"])


def mlp(p, x, cfg):
    """Gated MLP (swiglu / geglu) or plain gelu MLP."""
    if cfg.mlp_type == "swiglu":
        h = F.silu(_matmul(x, p["w_gate"])) * _matmul(x, p["w_up"])
    elif cfg.mlp_type == "geglu":
        h = (F.gelu(_matmul(x, p["w_gate"]), approximate="tanh")
             * _matmul(x, p["w_up"]))
    else:
        h = F.gelu(_matmul(x, p["w_up"]), approximate="tanh")
    return _matmul(h, p["w_down"])


def embed_tokens(p, tokens, cfg):
    """Token lookup per node: tok (n, V, D), tokens (n, B, S) -> (n, B, S, D)."""
    node = torch.arange(tokens.shape[0], device=tokens.device)[:, None, None]
    x = p["tok"][node, tokens]
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def logits_from_hidden(p, h, cfg):
    """Final norm -> (tied or untied) unembed -> optional logit softcap."""
    h = rms_norm(h, per_node(p["final_norm"], h.dim()), cfg.norm_eps)
    w = p["tok"].transpose(-1, -2) if cfg.tie_embeddings else p["unembed"]
    return softcap(_matmul(h, w), cfg.final_logit_softcap)


def _nll(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits, labels):
    """Mean CE per node.  logits (n, ..., V), labels (n, ...) -> (n,)."""
    return _nll(logits, labels).reshape(logits.shape[0], -1).mean(dim=1)


def chunked_lm_loss(p, h, labels, cfg):
    """Per-node cross-entropy over the vocab in sequence chunks, so the
    full (n, B, S, V) logits are never held at once."""
    if cfg.loss_chunk <= 0 or h.shape[2] % cfg.loss_chunk != 0:
        return cross_entropy(logits_from_hidden(p, h, cfg), labels)
    n, c = h.shape[0], cfg.loss_chunk
    sums, count = [], 0
    for i in range(0, h.shape[2], c):
        nll = _nll(logits_from_hidden(p, h[:, :, i:i + c], cfg),
                   labels[:, :, i:i + c])
        sums.append(nll.reshape(n, -1).sum(dim=1))
        count += nll[0].numel()
    return torch.stack(sums, dim=1).sum(dim=1) / max(count, 1)
