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
trainer derives it (``src/repro/train/trainer.py:238-249``): the
:class:`~repro_torch.comm.stochastic.StalenessProcess` with tau = 1 and
``delay_probs=(0, 1)``, whose expected matrix is ``(W + I) / 2`` (each
edge delivers its weight at the freshness phi = 1/2) and whose
``effective_omega`` is omega / 2.
"""
from __future__ import annotations

from repro_torch.comm.schedule import GossipSchedule
from repro_torch.comm.stochastic import StalenessProcess


def pipeline_delay_process(schedule: GossipSchedule) -> StalenessProcess:
    """The delay process the pipelined engine's gamma is derived from: a
    delay of exactly 1 on every edge of ``schedule``."""
    return StalenessProcess(schedule, max_staleness=1, delay_probs=(0.0, 1.0))
