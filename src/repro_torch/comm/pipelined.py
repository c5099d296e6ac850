"""The pipelined CHOCO engine's Theorem-2 stepsize: the tau = 1 delay
surrogate of the JAX package (``src/repro/comm/pipelined.py:59-68``).

The pipelined exchange (``comm/gossip.py``, ``pipelined=True``) compresses
the pre-update iterate and integrates each round's payload one round late:

    q_t         = Q(x_t - x_hat_t)
    x_{t+1}     = x_t + gamma (s_t - x_hat_t)
    x_hat_{t+1} = x_hat_t + q_t
    s_{t+1}     = s_t + sum_j w_ij q_{t,j}

which is the bounded-staleness recursion with a deterministic delay of 1
on every edge.  Its gamma comes from that delay process, as the JAX
trainer derives it (``src/repro/train/trainer.py:238-249``): (delta,
beta) of the delay-averaged mixing matrix ``E_eff = (W + I) / 2`` (each
edge delivers its weight at the freshness phi = E[1 / (1 + d)] = 1/2, the
rest folds into the diagonal) and omega scaled by the same 1/2
(``StalenessProcess.effective_omega``).  Only this surrogate is ported:
the rest of ``StalenessProcess`` comes with the processes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.comm.schedule import GossipSchedule, round_recv_vec
from repro_torch.core.topology import beta_norm, spectral_gap

#: phi = E[1 / (1 + d)] at the deterministic delay d = 1
PIPELINE_FRESHNESS = 0.5
#: the staleness fold of omega: omega_eff = omega * phi
PIPELINE_OMEGA_SCALE = PIPELINE_FRESHNESS


def pipeline_mixing_matrix(schedule: GossipSchedule) -> np.ndarray:
    """E_eff of the delay-1 process, built edge by edge as the JAX
    ``StalenessProcess.expected_matrix`` builds it (so its spectrum is the
    same to the last bit): diag(W), then per round and edge phi times the
    receive weight off the diagonal and the rest on it."""
    phi = PIPELINE_FRESHNESS
    E = np.diag(np.asarray(schedule.self_weights, dtype=np.float64))
    for rnd in schedule.rounds:
        recv = round_recv_vec(rnd, schedule.n)
        for src, dst in rnd.perm:
            E[dst, src] += phi * recv[dst]
            E[dst, dst] += (1.0 - phi) * recv[dst]
    return E


def pipeline_delta_beta(schedule: GossipSchedule) -> Tuple[float, float]:
    """(delta, beta) of E_eff, for the pipelined engine's gamma."""
    E = pipeline_mixing_matrix(schedule)
    return spectral_gap(E), beta_norm(E)


def pipeline_omega(omega: float) -> float:
    """The compression quality the pipelined gamma reads: omega / 2."""
    return omega * PIPELINE_OMEGA_SCALE
