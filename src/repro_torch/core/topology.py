"""Gossip topologies and mixing matrices W (paper Def. 1, Table 1).

W is symmetric and doubly stochastic with spectral gap
delta = 1 - |lambda_2(W)| in (0, 1].  The port builds the ring with the
paper's uniform weights (w_ij = 1/(deg+1), Metropolis-Hastings in
general) and exposes delta, rho = 1 - delta and beta = ||I - W||_2.

Only the ring is ported; ``make_topology`` refuses every other name.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    W: np.ndarray                             # (n, n) mixing matrix
    neighbors: Tuple[Tuple[int, ...], ...]    # adjacency incl. self

    @property
    def n(self) -> int:
        return self.W.shape[0]

    @property
    def delta(self) -> float:
        """Spectral gap 1 - |lambda_2|."""
        eig = np.sort(np.abs(np.linalg.eigvalsh(self.W)))[::-1]
        return float(1.0 - (eig[1] if len(eig) > 1 else 0.0))

    @property
    def rho(self) -> float:
        return 1.0 - self.delta

    @property
    def beta(self) -> float:
        """||I - W||_2."""
        return float(np.linalg.norm(np.eye(self.n) - self.W, ord=2))

    def validate(self, atol=1e-10):
        W = self.W
        if not np.allclose(W, W.T, atol=atol):
            raise ValueError("W not symmetric")
        if not np.allclose(W.sum(0), 1.0, atol=atol):
            raise ValueError("W not doubly stochastic")
        if not np.all(W >= -atol):
            raise ValueError("W has negative entries")
        return self


def spectral_gap(W: np.ndarray) -> float:
    """delta = 1 - |lambda_2| for a (possibly non-symmetric) stochastic W."""
    eig = np.sort(np.abs(np.linalg.eigvals(np.asarray(W, np.float64))))[::-1]
    return float(1.0 - (eig[1] if len(eig) > 1 else 0.0))


def beta_norm(W: np.ndarray) -> float:
    """beta = ||I - W||_2 (Theorem 2's second spectral quantity)."""
    n = W.shape[0]
    return float(np.linalg.norm(np.eye(n) - np.asarray(W, np.float64), ord=2))


def _from_adjacency(name: str, adj: np.ndarray) -> Topology:
    """Uniform / Metropolis-Hastings weights from a 0/1 adjacency (no self-loops)."""
    n = adj.shape[0]
    deg = adj.sum(1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    for i in range(n):
        W[i, i] = 1.0 - W[i].sum()
    nbrs = tuple(tuple(sorted(set(np.nonzero(adj[i])[0].tolist() + [i])))
                 for i in range(n))
    return Topology(name, W, nbrs).validate()


def ring(n: int) -> Topology:
    """Ring; uniform averaging 1/3 (self + 2 neighbours).  delta = O(1/n^2)."""
    if n == 1:
        return Topology("ring", np.ones((1, 1)), ((0,),))
    if n == 2:
        W = np.array([[0.5, 0.5], [0.5, 0.5]])
        return Topology("ring", W, ((0, 1), (0, 1))).validate()
    adj = np.zeros((n, n), dtype=int)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[i, (i - 1) % n] = 1
    return _from_adjacency("ring", adj)


def make_topology(name: str, n: int) -> Topology:
    """Build a topology by name at n nodes (only ``ring`` is ported)."""
    if name != "ring":
        raise ValueError(f"topology {name!r} is not ported; the port has "
                         f"only 'ring'")
    return ring(n)
