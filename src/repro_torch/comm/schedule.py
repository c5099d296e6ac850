"""Topology-compiled gossip schedules.

A :class:`GossipSchedule` decomposes the mixing matrix as

    W = diag(self_weights) + sum_r  weight_r * P_r

where every ``P_r`` is a permutation.  With the n gossip nodes stacked
on a leading ``(n, ...)`` dimension on one device, a round is an index
gather over that dimension: node ``dst`` reads row ``src`` for every
``(src, dst)`` pair of the round.

Only the ring decomposition (2 shift rounds, 1 for n == 2) is ported.
Pure Python + numpy: compiled once per trainer, never on the hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class GossipRound:
    """One synchronous exchange: a permutation plus per-destination weights.

    ``weight`` is the uniform receive weight when every destination
    applies the same one; otherwise ``weights[i]`` is node i's."""
    perm: Tuple[Tuple[int, int], ...]
    weight: Optional[float] = None
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if (self.weight is None) == (self.weights is None):
            raise ValueError("a round has either a uniform weight or "
                             "per-node weights")

    def sources(self, n: int) -> Tuple[int, ...]:
        """``src`` for every destination: the gather index of this round.
        Raises for a partial permutation (a node that receives nothing)."""
        src = [-1] * n
        for s, d in self.perm:
            src[d] = s
        if min(src) < 0:
            raise ValueError("partial permutation rounds are not ported")
        return tuple(src)


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


def compile_schedule(topo: Topology) -> GossipSchedule:
    """Compile a ring Topology into permutation rounds, validated against W."""
    if topo.name != "ring":
        raise ValueError(f"schedule compilation for {topo.name!r} is not "
                         f"ported; the port has only 'ring'")
    W = np.asarray(topo.W, dtype=np.float64)
    n = W.shape[0]
    diag = tuple(float(W[i, i]) for i in range(n))
    sched = GossipSchedule(name=topo.name, n=n, rounds=tuple(_ring_rounds(W)),
                           self_weights=diag, self_weight=_uniform(diag))
    err = float(np.max(np.abs(sched.mixing_matrix() - W))) if n else 0.0
    if err > 1e-9:
        raise ValueError(f"schedule compilation failed for {topo.name!r} "
                         f"(n={n}): reconstruction error {err}")
    return sched
