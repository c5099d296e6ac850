"""CHOCO-Gossip consensus stepsize (paper Theorem 2).

Only the static stepsize rules are ported here; the matrix simulators of
Algorithms 1 and 5 are not.
"""
from __future__ import annotations

import dataclasses

from .compression import Compressor
from .topology import Topology


def theorem2_stepsize(delta: float, beta: float, omega: float) -> float:
    """Consensus stepsize gamma* of Theorem 2 (eq. 20)."""
    num = delta * delta * omega
    den = (16 * delta + delta ** 2 + 4 * beta ** 2
           + 2 * delta * beta ** 2 - 8 * delta * omega)
    return float(num / den)


@dataclasses.dataclass(frozen=True)
class GammaSpec:
    """Deferred Theorem-2 stepsize: (delta, beta) fixed by the mixing
    matrix, omega supplied per packed bucket by the gossip engine (each
    bucket is an independent CHOCO-Gossip instance).  ``omega_scale``
    multiplies every bucket's omega before the formula."""
    delta: float
    beta: float
    omega_scale: float = 1.0

    def value(self, omega: float) -> float:
        """gamma* for one bucket's Assumption-1 omega."""
        return theorem2_stepsize(self.delta, self.beta,
                                 omega * self.omega_scale)


def auto_stepsize(topo: Topology, compressor: Compressor, d: int) -> float:
    """Theorem-2 stepsize from a topology + compressor (conservative)."""
    return theorem2_stepsize(topo.delta, topo.beta, compressor.omega(d))
