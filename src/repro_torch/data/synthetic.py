"""Synthetic data, sharded across gossip nodes: LM token streams, the
frontend families' batches (audio frames, image patches before text) and
the logistic-regression problems of the paper's §5.3.

The generator is numpy's ``default_rng`` with the same draws in the same
order as the JAX package's ``TokenStream``, ``make_lm_batch_fn`` and
``make_logreg``, so the two give identical batches, frames, patches,
features, labels and shards bit for bit, the Dirichlet skew
(``skew_alpha``, ``data/partition.py``) included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.data.partition import (dirichlet_class_shares,
                                        dirichlet_shards, mean_tv_distance)


@dataclasses.dataclass
class TokenStream:
    """Synthetic Zipf-distributed token stream.

    ``heterogeneity``: 0.0 = iid across nodes; 1.0 = fully sorted (each
    node samples its own vocabulary slice), the paper's ``sorted`` setting.

    ``skew_alpha``: when set, per-node vocabulary ownership is drawn from a
    seeded Dirichlet(alpha) over the vocabulary instead of the slice mask
    (alpha -> inf: IID; alpha -> 0: near-disjoint slices).  It takes
    precedence over ``heterogeneity``.
    """
    vocab_size: int
    seq_len: int
    batch_per_node: int
    n_nodes: int
    heterogeneity: float = 0.0
    seed: int = 0
    skew_alpha: Optional[float] = None

    def node_probs(self) -> np.ndarray:
        """Per-node token sampling distributions, ``(n_nodes, vocab_size)``;
        the Dirichlet draw takes its own ``default_rng(seed)`` stream, apart
        from the token stream's."""
        V = self.vocab_size
        base_p = 1.0 / np.arange(1, V + 1)
        probs = np.tile(base_p, (self.n_nodes, 1))
        if self.skew_alpha is not None:
            shares = dirichlet_class_shares(
                V, self.n_nodes, self.skew_alpha,
                np.random.default_rng(self.seed))
            probs = probs * (shares.T * self.n_nodes)
        elif self.heterogeneity > 0:
            h = self.heterogeneity
            slice_size = V // self.n_nodes
            for i in range(self.n_nodes):
                mask = np.zeros(V)
                lo = i * slice_size
                # the last node absorbs the V % n_nodes remainder
                hi = (i + 1) * slice_size if i < self.n_nodes - 1 else V
                mask[lo:hi] = 1.0
                probs[i] = base_p * ((1 - h) + h * V * mask)
        return probs / probs.sum(axis=1, keepdims=True)

    def skew_tv(self) -> float:
        """Mean TV distance of the per-node token distributions from their
        average (0: IID)."""
        return mean_tv_distance(self.node_probs())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        probs = self.node_probs()
        V = self.vocab_size
        while True:
            toks = np.empty((self.n_nodes, self.batch_per_node,
                             self.seq_len + 1), np.int32)
            for i in range(self.n_nodes):
                toks[i] = rng.choice(V, size=(self.batch_per_node,
                                              self.seq_len + 1),
                                     p=probs[i]).astype(np.int32)
            yield {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _audio_batches(cfg, seq_len, batch_per_node, n_nodes, seed):
    """The JAX audio batches: N(0, 1) frame embeddings (n, B, S, E) f32,
    uniform targets (n, B, S) int32 and a mask (n, B, S) f32 marking 8% of
    the frames, from one ``default_rng(seed)``; IID, so skew_tv 0."""
    rng = np.random.default_rng(seed)
    shape = (n_nodes, batch_per_node, seq_len)
    while True:
        emb = rng.standard_normal(
            shape + (cfg.frontend.embed_dim,)).astype(np.float32)
        tgt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        mask = (rng.random(shape) < 0.08).astype(np.float32)
        yield {"frame_embeds": emb, "targets": tgt, "mask": mask}


def _vlm_batches(cfg, texts, batch_per_node, n_nodes, seed):
    """The JAX vlm batches: N(0, 1) patch embeddings (n, B, P, E) f32 from
    ``default_rng(seed)``, then a text of S - P tokens from ``texts`` (S - P
    - 1 token steps; the last label repeated as the last token and the
    last label), the labels over the text only."""
    rng = np.random.default_rng(seed)
    fe = cfg.frontend
    for b in texts:
        emb = rng.standard_normal(
            (n_nodes, batch_per_node, fe.n_tokens, fe.embed_dim)
        ).astype(np.float32)
        yield {"patch_embeds": emb,
               "tokens": np.concatenate([b["tokens"], b["labels"][..., -1:]],
                                        -1),
               "labels": np.concatenate([b["labels"], b["labels"][..., -1:]],
                                        -1)}


def make_lm_batch_fn(cfg, seq_len: int, batch_per_node: int, n_nodes: int,
                     heterogeneity: float = 0.0, seed: int = 0,
                     skew_alpha: Optional[float] = None,
                     node: Optional[int] = None):
    """Returns next_batch() -> the family's batch dict of numpy arrays,
    node dimension first, with a ``skew_tv`` attribute: dense
    {"tokens", "labels"} (n, B, S) int32 (``TokenStream.skew_tv``); audio
    {"frame_embeds", "targets", "mask"} (skew_tv 0); vlm {"patch_embeds"
    (n, B, P, E), "tokens", "labels" (n, B, S - P)}, seq_len counting the
    P image positions.  With ``node``, only that node's row, (1, ...): one
    rank's batch of the per-rank engine.  All n rows are still drawn, so
    the row is bit-equal to the stacked engine's."""
    if cfg.family == "audio":
        stream, skew_tv = _audio_batches(cfg, seq_len, batch_per_node,
                                         n_nodes, seed), 0.0
    else:
        vlm = cfg.family == "vlm"
        # vlm: the text's S - P tokens come from S - P - 1 token steps
        steps = seq_len - cfg.frontend.n_tokens - 1 if vlm else seq_len
        ts = TokenStream(cfg.vocab_size, steps, batch_per_node, n_nodes,
                         heterogeneity, seed, skew_alpha)
        stream, skew_tv = iter(ts), ts.skew_tv()
        if vlm:
            stream = _vlm_batches(cfg, stream, batch_per_node, n_nodes, seed)
    if node is None:
        def next_batch():
            return next(stream)
    else:
        rows = slice(node, node + 1)

        def next_batch():
            return {k: v[rows] for k, v in next(stream).items()}
    next_batch.skew_tv = skew_tv
    return next_batch


# ---------------------------------------------------------------------------
# logistic regression (paper §5.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LogRegProblem:
    A: torch.Tensor           # (m, d) f32 features, rows of unit norm
    b: torch.Tensor           # (m,) f32 labels in {-1, +1}
    node_index: torch.Tensor  # (n_nodes, m_per_node) int64 sample ids
    reg: float

    @property
    def d(self) -> int:
        return self.A.shape[1]

    def full_loss(self, x: torch.Tensor) -> torch.Tensor:
        """f(x) = mean log(1 + exp(-b a.x)) + reg/2 ||x||^2 over all m."""
        z = self.b * (self.A @ x)
        return (torch.mean(torch.log1p(torch.exp(-z)))
                + 0.5 * self.reg * torch.sum(x * x))

    def make_grad_fn(self, batch_size: int = 1):
        """``grad_fn(X (n, d), batch (n, bs)) -> (n, d)``: node i's
        minibatch gradient at its own x_i, the minibatch being positions
        ``batch[i]`` in node i's shard (Algorithm 2 line 2).
        ``grad_fn.draw(n, generator)`` draws the positions uniformly."""
        A, b, idx, reg = self.A, self.b, self.node_index, self.reg
        m_per = idx.shape[1]

        def grad_fn(X, batch):
            rows = idx.gather(1, batch)                        # (n, bs)
            a = A[rows]                                        # (n, bs, d)
            bb = b[rows]
            z = bb * torch.bmm(a, X[:, :, None])[..., 0]
            g = -(bb * torch.sigmoid(-z))[..., None] * a
            return torch.mean(g, dim=1) + reg * X

        def draw(n, generator):
            return torch.randint(0, m_per, (n, batch_size),
                                 generator=generator, device=generator.device)

        grad_fn.draw = draw
        return grad_fn


def make_logreg(name: str, n_nodes: int, *, sorted_assignment: bool = False,
                seed: int = 0, m: Optional[int] = None,
                d: Optional[int] = None, skew_alpha: Optional[float] = None,
                device="cuda") -> LogRegProblem:
    """Synthetic stand-ins matched to the paper's dataset statistics, the
    JAX package's draws in its order:
    epsilon: m=400k (reduced default 8k), d=2000, dense;
    rcv1:    m=20242 (reduced default 8k), d=47236 (reduced 4724), 0.15%
    dense.  ``sorted_assignment`` shards by label (the paper's sorted
    setting), ``skew_alpha`` by a Dirichlet(alpha) over the binary labels
    (``data/partition.py``; the two are mutually exclusive), else a random
    permutation.  The tensors go to ``device``."""
    rng = np.random.default_rng(seed)
    if name == "epsilon":
        m = m or 8_000
        d = d or 2_000
        density = 1.0
    elif name == "rcv1":
        m = m or 8_000
        d = d or 4_724
        density = 0.0015 * 10       # keep ~7 nnz/row at reduced d
    else:
        raise ValueError(name)
    # w_true scaled so margins a_i . w are O(3) after row normalisation
    w_true = rng.standard_normal(d) * 3.0
    A = rng.standard_normal((m, d)).astype(np.float32)
    if density < 1.0:
        A *= (rng.random((m, d)) < density)
        A *= 1.0 / np.sqrt(max(density, 1e-6))
    A /= np.maximum(np.linalg.norm(A, axis=1, keepdims=True), 1e-8)
    logits = A @ w_true + 0.3 * rng.standard_normal(m)
    b = np.where(logits > 0, 1.0, -1.0).astype(np.float32)
    m_per = m // n_nodes
    if skew_alpha is not None:
        if sorted_assignment:
            raise ValueError("skew_alpha and sorted_assignment are "
                             "mutually exclusive")
        node_index = dirichlet_shards(b.astype(np.int64), n_nodes,
                                      skew_alpha, seed=seed)
    else:
        order = np.argsort(b) if sorted_assignment else rng.permutation(m)
        node_index = order[: m_per * n_nodes].reshape(n_nodes, m_per)
    return LogRegProblem(A=torch.from_numpy(A).to(device),
                         b=torch.from_numpy(b).to(device),
                         node_index=torch.from_numpy(node_index).to(device),
                         reg=1.0 / m)
