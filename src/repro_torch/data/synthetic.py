"""Synthetic LM token streams, sharded across gossip nodes.

The generator is numpy's ``default_rng`` with the same draws in the same
order as the JAX package's ``TokenStream``, so the two give identical
batches bit for bit.  Not ported: the Dirichlet skew (``skew_alpha``),
the audio / VLM batch makers and the logistic-regression datasets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Synthetic Zipf-distributed token stream.

    ``heterogeneity``: 0.0 = iid across nodes; 1.0 = fully sorted (each
    node samples its own vocabulary slice), the paper's ``sorted`` setting.
    """
    vocab_size: int
    seq_len: int
    batch_per_node: int
    n_nodes: int
    heterogeneity: float = 0.0
    seed: int = 0

    def node_probs(self) -> np.ndarray:
        """Per-node token sampling distributions, ``(n_nodes, vocab_size)``."""
        V = self.vocab_size
        base_p = 1.0 / np.arange(1, V + 1)
        probs = np.tile(base_p, (self.n_nodes, 1))
        if self.heterogeneity > 0:
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


def make_lm_batch_fn(cfg, seq_len: int, batch_per_node: int, n_nodes: int,
                     heterogeneity: float = 0.0, seed: int = 0):
    """Returns next_batch() -> {"tokens", "labels"}: (n, B, S) int32 numpy."""
    if cfg.family != "dense":
        raise ValueError(f"batches for family {cfg.family!r} are not ported")
    stream = iter(TokenStream(cfg.vocab_size, seq_len, batch_per_node,
                              n_nodes, heterogeneity, seed))
    return lambda: next(stream)
