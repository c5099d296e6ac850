"""CHOCO-Gossip (paper Algorithm 1 and its memory-efficient Algorithm 5)
as matrix simulators, and the Theorem-2 stepsize.

State per node i: the local x_i and the public copy x_hat_i.  Over the
node-stacked X, Xhat in R^{n x d}:

    Q_t   = Q(X - Xhat)                 (row-wise compression)
    Xhat' = Xhat + Q_t
    X'    = X + gamma (W - I) Xhat'

Theorem 2: with gamma* = delta^2 omega / (16 d + d^2 + 4 b^2 + 2 d b^2 -
8 d w) (d = delta, b = beta, w = omega) the Lyapunov error contracts by
(1 - delta^2 omega / 82) per round.

The mixing products ``W @ X`` are ``torch.matmul`` (the JAX package
leaves them to XLA, outside any Pallas kernel); the compression runs the
port's kernels on the card (``Compressor.apply``).  A stochastic
compressor's draw per round comes from ``draws(t)`` when the caller
injects it, else from an explicit ``torch.Generator``.  Not ported: the
stale, pipelined and push-sum simulators (they come with their engines).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .compression import Compressor
from .topology import Topology


class GossipState(NamedTuple):
    x: torch.Tensor        # (n, d) local iterates
    x_hat: torch.Tensor    # (n, d) public copies


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


def theorem2_rate(delta: float, omega: float) -> float:
    """Per-round contraction factor  (1 - delta^2 omega / 82)."""
    return 1.0 - delta * delta * omega / 82.0


def auto_stepsize(topo: Topology, compressor: Compressor, d: int) -> float:
    """Theorem-2 stepsize from a topology + compressor (conservative)."""
    return theorem2_stepsize(topo.delta, topo.beta, compressor.omega(d))


def mixing(W, like: torch.Tensor) -> torch.Tensor:
    """W as an f32 tensor on ``like``'s device."""
    return torch.as_tensor(W, dtype=torch.float32).to(like.device)


def round_draw(compressor: Compressor, X: torch.Tensor, t: int,
               generator: Optional[torch.Generator],
               draws: Optional[Callable[[int], object]]):
    """The compressor's draw for round t of a simulator: None for a
    deterministic compressor, ``draws(t)`` when injected, else one made
    by ``generator``."""
    if not compressor.stochastic:
        return None
    if draws is not None:
        return draws(t)
    if generator is None:
        raise ValueError(f"{compressor.name} is stochastic: pass a "
                         f"torch.Generator or the draws")
    return compressor.draw(X, generator)


def consensus_error(X: torch.Tensor, xbar: torch.Tensor) -> torch.Tensor:
    """(1/n) sum_i ||x_i - xbar||^2, as plotted in the paper's Figs. 2-3."""
    return torch.mean(torch.sum((X - xbar) ** 2, dim=-1))


def init_state(x0: torch.Tensor) -> GossipState:
    """Algorithm-1 state at t=0: local iterates x0, public copies zero."""
    return GossipState(x=x0, x_hat=torch.zeros_like(x0))


def choco_gossip_round(state: GossipState, W: torch.Tensor, gamma: float,
                       compressor: Compressor, rand=None) -> GossipState:
    """One synchronous CHOCO-Gossip round (Algorithm 1, lines 2-7);
    ``rand`` is a stochastic compressor's draw."""
    q = compressor.apply(state.x - state.x_hat, rand)
    x_hat = state.x_hat + q
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    x = state.x + gamma * (W - eye) @ x_hat
    return GossipState(x=x, x_hat=x_hat)


def _run(round_fn, state, x0, steps, compressor, generator, draws):
    xbar = torch.mean(x0, dim=0, keepdim=True)
    errs = []
    for t in range(steps):
        state = round_fn(state, round_draw(compressor, state.x, t, generator,
                                           draws))
        errs.append(consensus_error(state.x, xbar))
    return state, torch.stack(errs) if errs else x0.new_zeros((0,))


def run_choco_gossip(x0: torch.Tensor, W, gamma: float,
                     compressor: Compressor, steps: int, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Callable[[int], object]] = None):
    """Run ``steps`` rounds of Algorithm 1 from x0 (n, d); returns (final
    state, per-round consensus errors (steps,))."""
    W = mixing(W, x0)
    return _run(lambda st, r: choco_gossip_round(st, W, gamma, compressor, r),
                init_state(x0), x0, steps, compressor, generator, draws)


# ---------------------------------------------------------------------------
# Memory-efficient variant (Algorithm 5): each node keeps x_i, x_hat_i and
# s_i = sum_j w_ij x_hat_j, the layout of the gossip engine.
# ---------------------------------------------------------------------------

class EfficientGossipState(NamedTuple):
    x: torch.Tensor        # (n, d)
    x_hat: torch.Tensor    # (n, d)   own public copy only
    s: torch.Tensor        # (n, d)   weighted neighbour aggregate


def init_efficient_state(x0: torch.Tensor) -> EfficientGossipState:
    """Algorithm-5 state at t=0: x0 plus zeroed x_hat and aggregate s."""
    return EfficientGossipState(x=x0, x_hat=torch.zeros_like(x0),
                                s=torch.zeros_like(x0))


def choco_gossip_round_efficient(state: EfficientGossipState, W: torch.Tensor,
                                 gamma: float, compressor: Compressor,
                                 rand=None) -> EfficientGossipState:
    """Algorithm 5: q_i = Q(x_i - x_hat_i); x_hat_i += q_i;
    s_i += sum_j w_ij q_j;  x_i += gamma (s_i - x_hat_i).  ``W @ q``
    stands in for the neighbour exchange."""
    q = compressor.apply(state.x - state.x_hat, rand)
    x_hat = state.x_hat + q
    s = state.s + W @ q
    x = state.x + gamma * (s - x_hat)
    return EfficientGossipState(x=x, x_hat=x_hat, s=s)


def run_choco_gossip_efficient(x0: torch.Tensor, W, gamma: float,
                               compressor: Compressor, steps: int, *,
                               generator: Optional[torch.Generator] = None,
                               draws: Optional[Callable[[int], object]] = None):
    """Run ``steps`` rounds of Algorithm 5; returns (final state,
    per-round consensus errors (steps,))."""
    W = mixing(W, x0)
    return _run(lambda st, r: choco_gossip_round_efficient(
        st, W, gamma, compressor, r), init_efficient_state(x0), x0, steps,
        compressor, generator, draws)
