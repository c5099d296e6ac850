"""Gossip topologies and mixing matrices W (paper Def. 1, Table 1).

W is symmetric and doubly stochastic with spectral gap
delta = 1 - |lambda_2(W)| in (0, 1].  The port builds the ring with the
paper's uniform weights (w_ij = 1/(deg+1), Metropolis-Hastings in
general) and exposes delta, rho = 1 - delta and beta = ||I - W||_2.

Every symmetric graph of the JAX package's registry is ported: ring,
torus, fully_connected, chain, star and hypercube.  The directed graphs
(``directed_ring``, ``random_digraph``) need the push-sum engine, which
is not ported; ``make_topology`` refuses them.
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


def torus2d(rows: int, cols: int) -> Topology:
    """2-d torus; uniform averaging 1/5.  delta = O(1/n)."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=int)

    def nid(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = nid(r, c)
            for (dr, dc) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                adj[i, nid(r + dr, c + dc)] = 1
    np.fill_diagonal(adj, 0)
    return _from_adjacency("torus2d", adj)


def fully_connected(n: int) -> Topology:
    """Complete graph, W = (1/n) 11^T.  delta = 1."""
    W = np.full((n, n), 1.0 / n)
    nbrs = tuple(tuple(range(n)) for _ in range(n))
    return Topology("fully_connected", W, nbrs).validate()


def chain(n: int) -> Topology:
    """Path graph 0-1-...-(n-1): delta = O(1/n^2) like the ring, without
    the wraparound edge."""
    adj = np.zeros((n, n), dtype=int)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1
    return _from_adjacency("chain", adj)


def star(n: int) -> Topology:
    """Hub and spokes: node 0 connects to all others (constant diameter,
    a congested hub)."""
    adj = np.zeros((n, n), dtype=int)
    adj[0, 1:] = adj[1:, 0] = 1
    return _from_adjacency("star", adj)


def hypercube(n: int) -> Topology:
    """m-dimensional hypercube on n = 2^m nodes: log-degree, log-diameter,
    delta = O(1/log n)."""
    m = int(np.log2(n))
    if 2 ** m != n:
        raise ValueError(f"hypercube topology needs n = 2^m nodes, got n={n}; "
                         f"use n={2 ** m} or n={2 ** (m + 1)}, or another "
                         f"topology")
    adj = np.zeros((n, n), dtype=int)
    for i in range(n):
        for b in range(m):
            adj[i, i ^ (1 << b)] = 1
    return _from_adjacency("hypercube", adj)


def _square_factors(n: int) -> Tuple[int, int]:
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def _torus_factors(n: int) -> Tuple[int, int]:
    """Most-square rows x cols factorization, refusing the degenerate 1 x n
    strip: a "torus" on prime n is a ring with doubled edges, whose
    spectral gap is the ring's O(1/n^2), not the torus's O(1/n), so the
    Theorem-2 stepsize would be computed for the wrong graph."""
    rows, cols = _square_factors(n)
    if rows == 1 and n > 1:
        raise ValueError(
            f"torus topology needs a non-trivial rows x cols factorization, "
            f"but n={n} only factors as 1x{n} — a degenerate strip with "
            f"ring-grade spectral gap O(1/n^2), not the torus O(1/n). "
            f"Use a composite node count (e.g. n={n - 1} or n={n + 1}) or "
            f"topology='ring'.")
    return rows, cols


_TOPOLOGIES = {
    "ring": ring,
    "torus": lambda n: torus2d(*_torus_factors(n)),
    "fully_connected": fully_connected,
    "chain": chain,
    "star": star,
    "hypercube": hypercube,
}

#: the registry's names (the launcher's ``--topology`` choices)
SYMMETRIC_TOPOLOGIES = tuple(_TOPOLOGIES)
#: the JAX registry's directed (column-stochastic) graphs: they need the
#: push-sum engine, which the port does not have
DIRECTED_TOPOLOGIES = ("directed_ring", "random_digraph")


def make_topology(name: str, n: int) -> Topology:
    """Build a registered symmetric topology by name at n nodes (the JAX
    registry's names: ``torus`` builds ``torus2d``)."""
    if name in DIRECTED_TOPOLOGIES:
        raise ValueError(f"topology {name!r} is directed and needs the "
                         f"push-sum engine, which is not ported")
    if name not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; have "
                         f"{sorted(_TOPOLOGIES)}")
    return _TOPOLOGIES[name](n)
