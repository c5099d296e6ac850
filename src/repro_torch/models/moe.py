"""The mixture-of-experts FFN of the "moe" family, the JAX package's
``src/repro/models/moe.py`` on node-stacked tensors.

Tokens are cut into groups of ``g = min(group_size, B * S)``; within a
group each token picks its ``top_k`` experts by the softmax of its f32
router logits, the gates renormalised over its picks; each expert takes at
most C = max(int(g * top_k * capacity_factor / E), top_k) of a group's
(token, pick) pairs, in token-major, pick-minor order, and drops the rest
(the residual carries a dropped token).  The expert SwiGLU runs over an
(E, G, C, D) buffer per node, one batched matmul per projection.

JAX dispatches and combines with one-hot einsums; here a gather fills the
buffer and a gather and one small batched product per token read it
back, with the same values: a dispatched row is an exact copy of its
token, and a token's output is the sum over its picks of its expert rows
times its gates rounded to the compute dtype (JAX's ``oh_c *
gate_vals.astype(x.dtype)``), accumulated in f32 and rounded once.  At
32768 tokens the one-hot tensors would take 335 MB a layer and most of
the einsums' products would be by zero.

The router's top-k is ``ops.topk_rows`` (:func:`pick`), which breaks ties
as ``lax.top_k`` does (the lower expert first).  No kernel: JAX computes
all of this as jnp outside any Pallas kernel.  Each stage (route,
dispatch, experts, combine) runs in a profiler range ``moe.<stage>``,
which costs next to nothing when no profiler runs.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels import ops

from . import layers as L
from .layers import silu


def capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    """Slots per expert per group (the JAX ``_capacity``)."""
    return max(int(group * top_k * factor / n_experts), top_k)


def pick(scores, k: int):
    """The k experts each token picks, (..., k) int64: the largest scores,
    ties to the lower expert, as ``lax.top_k`` picks them."""
    return ops.topk_rows(scores, k)


def route(router, xt, m):
    """xt (n, G, g, D) -> (scores (n, G, g, E) f32, gates (n, G, g, K) f32
    renormalised, expert indices (n, G, g, K) int64, slots (n, G, g, K)
    int64: each pair's place in its expert's buffer, counted over the
    group in token-major, pick-minor order, a slot >= C dropped; counts
    (n, G, E): each expert's pairs in each group)."""
    n, G, g, D = xt.shape
    E, K = m.n_experts, m.top_k
    logits = L.matmul(xt.reshape(n, G * g, D).float(), router.float())
    scores = torch.softmax(logits, dim=-1).view(n, G, g, E)
    idx = pick(scores, K)
    gates = scores.gather(-1, idx)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # a pair's slot: its rank among the group's pairs of its expert, from
    # a stable sort of the pairs by expert (no atomics, no host sync)
    flat = idx.reshape(n * G, g * K)
    order = torch.argsort(flat, dim=1, stable=True)
    by_expert = flat.gather(1, order)
    experts = torch.arange(E, device=xt.device).expand(n * G, E).contiguous()
    starts = torch.searchsorted(by_expert, experts)
    counts = torch.searchsorted(by_expert, experts, right=True) - starts
    ranks = torch.arange(g * K, device=xt.device).expand(n * G, -1) \
        - starts.gather(1, by_expert)
    slots = torch.empty_like(flat).scatter_(1, order, ranks)
    return scores, gates, idx, slots.view(n, G, g, K), counts.view(n, G, E)


def dispatch(xt, rows, n_rows: int):
    """The (n_rows, D) expert buffer: row r holds the token whose pair has
    row r, zeros where no pair does.  xt (n, G, g, D); rows (n, G, g, K),
    n_rows for dropped pairs."""
    n, G, g, D = xt.shape
    K = rows.shape[-1]
    tokens = torch.cat([xt.reshape(n * G * g, D), xt.new_zeros((1, D))])
    src = torch.full((n_rows + 1,), n * G * g, dtype=torch.long,
                     device=xt.device)
    src.scatter_(0, rows.reshape(-1), torch.arange(
        n * G * g, device=xt.device).repeat_interleave(K))
    return tokens.index_select(0, src[:n_rows])


def experts(p, xe):
    """The experts' SwiGLU: xe (n, E, G C, D) -> (n, E, G C, D)."""
    h = silu(torch.matmul(xe, p["w_gate"])) * torch.matmul(xe, p["w_up"])
    return torch.matmul(h, p["w_down"])


def combine(ye, rows, gates, dtype):
    """Each token's sum over its picks of gate (rounded to ``dtype``) times
    its expert row, one batched (1, K) @ (K, D) product per token that
    sums in f32 and rounds once to ``dtype``: ye (n_rows, D), rows and
    gates (n, G, g, K) -> (n, G, g, D).  A dropped pair (row n_rows) reads
    row 0 with a zero weight: it adds nothing."""
    n, G, g, K = rows.shape
    kept = rows < ye.shape[0]
    w = torch.where(kept, gates, 0.0).to(dtype).reshape(n * G * g, 1, K)
    picked = ye.index_select(0, torch.where(kept, rows, 0).reshape(-1))
    return torch.bmm(w, picked.view(n * G * g, K, -1)).view(n, G, g, -1)


def moe_ffn(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (n, B, S, D) -> (y (n, B, S, D), aux (n,) f32), per node the JAX
    ``moe_ffn``.  ``p``: the block's "moe/..." leaves in the compute dtype
    (``router`` (n, D, E), ``w_gate``, ``w_up`` (n, E, D, F), ``w_down``
    (n, E, F, D), and ``shared/...`` with shared experts).  aux is the
    switch load-balance loss E * sum_e density_e * router_prob_e."""
    m = cfg.moe
    if cfg.mlp_type != "swiglu":
        raise ValueError(f"the MoE experts are SwiGLU, got mlp_type "
                         f"{cfg.mlp_type!r}")
    n, B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    T = B * S
    g = min(m.group_size, T)
    if T % g:
        raise ValueError(f"tokens {T} not divisible by group {g}")
    G = T // g
    C = capacity(g, K, E, m.capacity_factor)
    xt = x.reshape(n, G, g, D)
    with record_function("moe.route"):
        scores, gates, idx, slots, counts = route(p["router"], xt, m)
    # pair -> (node, expert, group, slot) row; dropped pairs past the end
    node = torch.arange(n, device=x.device).view(n, 1, 1, 1)
    group = torch.arange(G, device=x.device).view(1, G, 1, 1)
    rows = ((node * E + idx) * G + group) * C + slots
    n_rows = n * E * G * C
    rows = torch.where(slots < C, rows, n_rows)
    with record_function("moe.dispatch"):
        xe = dispatch(xt, rows, n_rows).view(n, E, G * C, D)
    with record_function("moe.experts"):
        ye = experts(p, xe).reshape(n_rows, D)
    with record_function("moe.combine"):
        y = combine(ye, rows, gates, x.dtype).reshape(n, B, S, D)
    density = counts.sum(dim=1).float() / T / K
    router_prob = scores.reshape(n, T, E).mean(dim=1)
    aux = E * (density * router_prob).sum(dim=1)
    if m.n_shared_experts:
        # the shared expert: the JAX ``mlp`` of the block's SwiGLU, with
        # its silu expanded as XLA expands it (layers.silu)
        h = silu(L.matmul(x, p["shared/w_gate"])) * L.matmul(
            x, p["shared/w_up"])
        y = y + L.matmul(h, p["shared/w_down"])
    return y, aux
