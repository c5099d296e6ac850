"""Gossip topologies and mixing matrices W (paper Def. 1, Table 1).

W is symmetric and doubly stochastic with spectral gap
delta = 1 - |lambda_2(W)| in (0, 1].  The port builds the ring with the
paper's uniform weights (w_ij = 1/(deg+1), Metropolis-Hastings in
general) and exposes delta, rho = 1 - delta and beta = ||I - W||_2.

Every graph of the JAX package's registry is ported: the symmetric
ring, torus, fully_connected, chain, star and hypercube, and the directed
``directed_ring`` and ``random_digraph``.  A :class:`DirectedTopology`
carries a *column*-stochastic A (1^T A = 1^T, so the node sum is
conserved); it runs only through the push-sum engine
(``comm/pushsum.py``), which de-biases x / w.
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


@dataclasses.dataclass(frozen=True)
class DirectedTopology:
    """Column-stochastic mixing over a directed graph.

    ``A[i, j]`` is the weight node j pushes to node i: column j splits j's
    mass over its out-neighbours and itself, so columns sum to 1 and the
    total mass 1^T x is conserved, while rows in general do not sum to 1
    (the reason the symmetric engines cannot run it)."""
    name: str
    A: np.ndarray                               # (n, n) column-stochastic
    out_neighbors: Tuple[Tuple[int, ...], ...]  # per column, incl. self

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def directed(self) -> bool:
        return True

    @property
    def delta(self) -> float:
        """1 - |lambda_2(A)|: the push-sum consensus rate."""
        return spectral_gap(self.A)

    @property
    def beta(self) -> float:
        return beta_norm(self.A)

    def validate(self, atol=1e-10):
        A = self.A
        if not np.allclose(A.sum(0), 1.0, atol=atol):
            raise ValueError("A not column-stochastic")
        if not np.all(A >= -atol):
            raise ValueError("A has negative entries")
        if not np.all(np.diag(A) > atol):
            raise ValueError("push-sum needs self-loops (A_jj > 0)")
        return self


def directed_ring(n: int) -> DirectedTopology:
    """Directed cycle: every node pushes half its mass to its successor,
    A = (I + P) / 2 with P the cyclic shift (column- and row-stochastic,
    not symmetric)."""
    if n == 1:
        return DirectedTopology("directed_ring", np.ones((1, 1)), ((0,),))
    A = 0.5 * np.eye(n)
    for j in range(n):
        A[(j + 1) % n, j] = 0.5
    nbrs = tuple((j, (j + 1) % n) for j in range(n))
    return DirectedTopology("directed_ring", A, nbrs).validate()


def random_digraph(n: int, extra_edge_prob: float = 0.3,
                   seed: int = 0) -> DirectedTopology:
    """Strongly connected random digraph: the directed ring's j -> j+1
    edges plus i.i.d. extra directed edges, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's loop order.
    Column j splits j's unit mass uniformly over {j} and its
    out-neighbours, so A is column- but not row-stochastic."""
    if n == 1:
        return DirectedTopology("random_digraph", np.ones((1, 1)), ((0,),))
    rng = np.random.default_rng(seed)
    out = [{(j + 1) % n} for j in range(n)]
    for j in range(n):
        for i in range(n):
            if i != j and i != (j + 1) % n and rng.random() < extra_edge_prob:
                out[j].add(i)
    A = np.zeros((n, n))
    for j in range(n):
        share = 1.0 / (1 + len(out[j]))
        A[j, j] = share
        for i in out[j]:
            A[i, j] = share
    nbrs = tuple(tuple(sorted(out[j] | {j})) for j in range(n))
    return DirectedTopology("random_digraph", A, nbrs).validate()


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

#: the registry's symmetric graphs
SYMMETRIC_TOPOLOGIES = tuple(_TOPOLOGIES)
_TOPOLOGIES.update({"directed_ring": directed_ring,
                    "random_digraph": lambda n: random_digraph(n)})
#: the registry's directed (column-stochastic) graphs: they need the
#: push-sum engine; the symmetric choco and plain engines refuse them
DIRECTED_TOPOLOGIES = ("directed_ring", "random_digraph")
#: every registry name (the launcher's ``--topology`` choices)
TOPOLOGIES = SYMMETRIC_TOPOLOGIES + DIRECTED_TOPOLOGIES


def is_directed(name: str) -> bool:
    """True for the column-stochastic (push-sum-only) topology names."""
    return name in DIRECTED_TOPOLOGIES


def make_topology(name: str, n: int):
    """Build a registered topology by name at n nodes (the JAX registry's
    names: ``torus`` builds ``torus2d``; a directed name a
    :class:`DirectedTopology`)."""
    if name not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; have "
                         f"{sorted(_TOPOLOGIES)}")
    return _TOPOLOGIES[name](n)
