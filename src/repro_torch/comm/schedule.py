"""Topology-compiled gossip schedules.

A :class:`GossipSchedule` decomposes the mixing matrix as

    W = diag(self_weights) + sum_r  weight_r * P_r

where every ``P_r`` is a (partial) permutation.  With the n gossip nodes
stacked on a leading ``(n, ...)`` dimension on one device, a round is an
index gather over that dimension: node ``dst`` reads row ``src`` for
every ``(src, dst)`` pair of the round (:meth:`GossipRound.sources`).
With one process per node, a round is at most one send and one receive
per rank (:meth:`GossipRound.peers`), the counterpart of the JAX
engine's ``ppermute`` over the round's ``perm``.  A node that a partial
round skips receives zeros, as ``ppermute`` hands it.

Decompositions, as in the JAX package (``src/repro/comm/schedule.py``):

* ring            -- 2 shift rounds (+1 / -1); 1 for n == 2
* torus2d         -- 2 shift rounds per grid axis
* hypercube       -- log2(n) dimension-exchange rounds (i <-> i ^ 2^b)
* fully_connected -- n - 1 shift rounds
* anything else   -- greedy edge coloring of the support of W: each color
  class is a matching, shipped as one symmetric-swap round (star: n - 1
  rounds, chain: 2)

Every decomposition is validated against W.  A time-varying sequence is
one schedule per graph (:func:`compile_schedules`), cycled round by
round.  Pure Python + numpy: compiled once per trainer, never on the hot
path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import Topology, _square_factors

#: entries of W below this are structural zeros (no edge)
_EDGE_TOL = 1e-12


@dataclasses.dataclass(frozen=True)
class GossipRound:
    """One synchronous exchange: a (partial) permutation plus
    per-destination weights.

    ``weight`` is the uniform receive weight when every destination
    applies the same one; otherwise ``weights[i]`` is node i's (0 for a
    node that receives nothing)."""
    perm: Tuple[Tuple[int, int], ...]
    weight: Optional[float] = None
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if (self.weight is None) == (self.weights is None):
            raise ValueError("a round has either a uniform weight or "
                             "per-node weights")

    def sources(self, n: int) -> Tuple[int, ...]:
        """``src`` for every destination: the gather index of this round,
        -1 for a node that receives nothing."""
        src = [-1] * n
        for s, d in self.perm:
            src[d] = s
        return tuple(src)

    def peers(self, rank: int) -> Tuple[Optional[int], Optional[int]]:
        """``(dst, src)`` of node ``rank`` in this round: the node it sends
        its payload to and the node whose payload it receives, each None
        where the round has no such pair."""
        dst = [d for s, d in self.perm if s == rank]
        src = [s for s, d in self.perm if d == rank]
        return (dst[0] if dst else None), (src[0] if src else None)


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """Static decomposition of one mixing matrix into permutation rounds."""
    name: str
    n: int
    rounds: Tuple[GossipRound, ...]
    self_weights: Tuple[float, ...]          # diag(W), per node
    self_weight: Optional[float] = None      # uniform diag(W), when it is

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def mixing_matrix(self) -> np.ndarray:
        """Reconstruct W from the rounds (used to validate compilation)."""
        W = np.diag(np.asarray(self.self_weights, dtype=np.float64))
        for rnd in self.rounds:
            recv = round_recv_vec(rnd, self.n)
            for src, dst in rnd.perm:
                W[dst, src] += recv[dst]
        return W


def round_recv_vec(rnd: GossipRound, n: int) -> np.ndarray:
    """Per-destination receive weight of one round as an (n,) vector."""
    vec = np.zeros(n, dtype=np.float64)
    for src, dst in rnd.perm:
        vec[dst] = rnd.weight if rnd.weight is not None else rnd.weights[dst]
    return vec


def _uniform(values) -> Optional[float]:
    vals = list(values)
    if not vals:
        return None
    first = float(vals[0])
    return first if all(float(v) == first for v in vals) else None


def _make_round(perm, weights_by_dst, n: int) -> GossipRound:
    """Round from explicit per-destination weights; collapses to a uniform
    scalar when every destination weight is identical."""
    w = _uniform(weights_by_dst.values())
    if w is not None:
        return GossipRound(perm=tuple(perm), weight=w)
    vec = [0.0] * n
    for dst, wd in weights_by_dst.items():
        vec[dst] = float(wd)
    return GossipRound(perm=tuple(perm), weights=tuple(vec))


def _ring_rounds(W: np.ndarray) -> list:
    n = W.shape[0]
    if n < 2:
        return []
    fwd = tuple((i, (i + 1) % n) for i in range(n))
    rounds = [_make_round(fwd, {(i + 1) % n: W[(i + 1) % n, i]
                                for i in range(n)}, n)]
    if n > 2:
        bwd = tuple((i, (i - 1) % n) for i in range(n))
        rounds.append(_make_round(bwd, {(i - 1) % n: W[(i - 1) % n, i]
                                        for i in range(n)}, n))
    return rounds


def _torus_rounds(W: np.ndarray, grid: Tuple[int, int]) -> list:
    """Two shift rounds per grid axis, in the axis order of ``grid``."""
    rows, cols = grid
    nid = lambda r, c: (r % rows) * cols + (c % cols)
    rounds = []
    for axis_size, step in ((rows, lambda r, c, d: nid(r + d, c)),
                            (cols, lambda r, c, d: nid(r, c + d))):
        if axis_size < 2:
            continue
        for d in (1, -1):
            if axis_size == 2 and d == -1:
                continue          # both directions are the same single edge
            perm = tuple((nid(r, c), step(r, c, d))
                         for r in range(rows) for c in range(cols))
            rounds.append(_make_round(
                perm, {dst: W[dst, src] for src, dst in perm}, rows * cols))
    return rounds


def _hypercube_rounds(W: np.ndarray) -> list:
    n = W.shape[0]
    m = int(np.log2(n))
    rounds = []
    for b in range(m):
        perm = tuple((i, i ^ (1 << b)) for i in range(n))
        rounds.append(_make_round(perm, {dst: W[dst, src]
                                         for src, dst in perm}, n))
    return rounds


def _fully_connected_rounds(W: np.ndarray) -> list:
    n = W.shape[0]
    rounds = []
    for s in range(1, n):
        perm = tuple((i, (i + s) % n) for i in range(n))
        rounds.append(_make_round(perm, {(i + s) % n: W[(i + s) % n, i]
                                         for i in range(n)}, n))
    return rounds


def _edge_coloring_rounds(W: np.ndarray) -> list:
    """Proper greedy edge coloring of the support of W.  Every color class
    is a matching, shipped as one symmetric-swap round (each matched node
    sends to and receives from its partner); the other nodes receive
    nothing in it.  Greedy needs at most 2 * max_degree - 1 colors."""
    n = W.shape[0]
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if abs(W[i, j]) > _EDGE_TOL]
    colors: list = []                       # color -> list of (i, j)
    used = [set() for _ in range(n)]        # node -> colors already incident
    for i, j in edges:
        c = 0
        while c in used[i] or c in used[j]:
            c += 1
        while len(colors) <= c:
            colors.append([])
        colors[c].append((i, j))
        used[i].add(c)
        used[j].add(c)
    rounds = []
    for matching in colors:
        perm, weights = [], {}
        for i, j in matching:
            perm += [(i, j), (j, i)]
            weights[j] = W[j, i]
            weights[i] = W[i, j]
        rounds.append(_make_round(tuple(perm), weights, n))
    return rounds


def compile_schedule(topo: Topology) -> GossipSchedule:
    """Compile one symmetric Topology into permutation rounds.

    A torus walks the grid ``_square_factors(n)`` (the port's mesh is
    always Nx1, so no pod axis sets another).  The family's structured
    decomposition is tried first and validated against W; on a mismatch (a
    hand-built W reusing a family name) greedy edge coloring, exact by
    construction, takes over."""
    W = np.asarray(topo.W, dtype=np.float64)
    n = W.shape[0]
    if not np.allclose(W, W.T, atol=1e-10):
        raise ValueError("the schedule compiler needs a symmetric W; "
                         "directed mixing needs the push-sum engine, which "
                         "is not ported")
    structured = {
        "ring": lambda: _ring_rounds(W),
        "torus2d": lambda: _torus_rounds(W, _square_factors(n)),
        "hypercube": lambda: _hypercube_rounds(W),
        "fully_connected": lambda: _fully_connected_rounds(W),
    }
    candidates = [structured[topo.name]] if topo.name in structured else []
    candidates.append(lambda: _edge_coloring_rounds(W))
    diag = tuple(float(W[i, i]) for i in range(n))
    last_err = None
    for build in candidates:
        try:
            rounds = build()
        except (IndexError, ValueError):
            # a hand-built W under a family name can break the structured
            # decomposition's index arithmetic; edge coloring always applies
            continue
        sched = GossipSchedule(name=topo.name, n=n, rounds=tuple(rounds),
                               self_weights=diag, self_weight=_uniform(diag))
        err = float(np.max(np.abs(sched.mixing_matrix() - W))) if n else 0.0
        if err <= 1e-9:
            return sched
        last_err = err
    raise ValueError(f"schedule compilation failed for {topo.name!r} "
                     f"(n={n}): reconstruction error {last_err}")


def compile_schedules(topos: Sequence[Topology]
                      ) -> Tuple[GossipSchedule, ...]:
    """Compile a (time-varying) sequence of topologies over one node set;
    the exchange cycles through them round by round."""
    scheds = tuple(compile_schedule(t) for t in topos)
    if not scheds:
        raise ValueError("need at least one topology")
    if len({s.n for s in scheds}) != 1:
        raise ValueError(f"time-varying schedules must share n, "
                         f"got {[s.n for s in scheds]}")
    return scheds
