"""CHOCO-SGD (paper Algorithm 2, memory-efficient Algorithm 6) as a matrix
simulator, and the stepsize schedules of Theorem 4 and of the
experiments (§5.3: eta_t = m a / (t + b)).

Per node i and round t:

    g_i      = grad F_i(x_i, xi_i)              (local stochastic gradient)
    x_i'     = x_i - eta_t g_i                  (SGD half-step)
    q_i      = Q(x_i' - x_hat_i)                (compressed publication)
    x_hat_i += q_i ;  s_i += sum_j w_ij q_j     (neighbour exchange)
    x_i      = x_i' + gamma (s_i - x_hat_i)     (gossip mixing)

A gradient function takes the node-stacked iterates and one minibatch
per node, ``grad_fn(X (n, d), batch (n, bs)) -> (n, d)``, and draws its
minibatches with ``grad_fn.draw(n, generator)``
(``data/synthetic.py:LogRegProblem.make_grad_fn``).  Each step's draws
(the minibatches and a stochastic compressor's draw) come from
``draws(t) -> (batch, rand)`` when the caller injects them, else from an
explicit ``torch.Generator``.  The schedules compute in float32, as the
JAX package's do.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .choco_gossip import mixing, round_draw, theorem2_stepsize
from .compression import Compressor


class ChocoSGDState(NamedTuple):
    x: torch.Tensor        # (n, d) local models
    x_hat: torch.Tensor    # (n, d) public copies
    s: torch.Tensor        # (n, d) weighted neighbour aggregate
    t: int                 # step


def init_state(x0: torch.Tensor) -> ChocoSGDState:
    """Algorithm-2 state at t=0: iterates x0, zero public copies and
    zero aggregates."""
    return ChocoSGDState(x=x0, x_hat=torch.zeros_like(x0),
                         s=torch.zeros_like(x0), t=0)


def choco_sgd_step(state: ChocoSGDState, W: torch.Tensor, grad_fn,
                   compressor: Compressor, eta: float, gamma: float, batch,
                   rand=None) -> ChocoSGDState:
    """One CHOCO-SGD round (Algorithm 6, matrix form)."""
    G = grad_fn(state.x, batch.to(state.x.device))
    x_half = state.x - eta * G
    q = compressor.apply(x_half - state.x_hat, rand)
    x_hat = state.x_hat + q
    s = state.s + W @ q
    x = x_half + gamma * (s - x_hat)
    return ChocoSGDState(x=x, x_hat=x_hat, s=s, t=state.t + 1)


# --- stepsize schedules -----------------------------------------------------

def experiment_lr_schedule(m: int, a: float, b: float) -> Callable[[int], float]:
    """Paper §5.3: eta_t = m * a / (t + b), in float32."""
    def eta(t):
        return float(np.float32(m * a) / (np.float32(t) + np.float32(b)))
    return eta


def theorem4_lr_schedule(mu: float, a: float) -> Callable[[int], float]:
    """Theorem 4: eta_t = 4 / (mu (a + t)), in float32."""
    def eta(t):
        return float(np.float32(4.0) / (np.float32(mu) * (
            np.float32(a) + np.float32(t))))
    return eta


def theorem4_a(delta: float, omega: float, kappa: float) -> float:
    """Theorem 4's stepsize shift a = max(410 / (delta^2 omega), 16 kappa):
    large enough that the first steps do not outrun the consensus
    contraction."""
    return max(410.0 / (delta * delta * omega), 16.0 * kappa)


def auto_gamma(delta: float, beta: float, omega: float) -> float:
    """Theorem-2 consensus stepsize (used by Theorem 4)."""
    return theorem2_stepsize(delta, beta, omega)


# --- the run loop -----------------------------------------------------------

def run_choco_sgd(x0: torch.Tensor, W, grad_fn, compressor: Compressor,
                  lr_fn, gamma: float, steps: int, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Callable[[int], tuple]] = None,
                  eval_fn=None):
    """Run CHOCO-SGD from x0 (n, d); returns (final state, metric trace
    (steps,)): ``eval_fn(xbar)`` (e.g. the full loss) on the node average
    after each step, zeros without ``eval_fn``, as in the JAX package."""
    W = mixing(W, x0)
    state, trace = init_state(x0), []
    if draws is None and generator is None:
        raise ValueError("pass a torch.Generator or the draws")
    for t in range(steps):
        if draws is not None:
            batch, rand = draws(t)
        else:
            batch = grad_fn.draw(x0.shape[0], generator)
            rand = round_draw(compressor, state.x, t, generator, None)
        state = choco_sgd_step(state, W, grad_fn, compressor, lr_fn(t),
                               gamma, batch, rand)
        trace.append(eval_fn(torch.mean(state.x, dim=0))
                     if eval_fn is not None else x0.new_zeros(()))
    return state, torch.stack(trace) if trace else x0.new_zeros((0,))
