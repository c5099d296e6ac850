"""The gossip and decentralized-SGD schemes the paper compares CHOCO
against, as matrix simulators.

Gossip (consensus) baselines, §3.2-3.3:

* (E-G)  exact gossip,             Xiao & Boyd 2004
* (Q1-G) direct quantization,      Aysal et al. 2008   -- loses the average
* (Q2-G) difference quantization,  Carli et al. 2007   -- noise does not vanish

Optimization baselines, §5.3:

* plain decentralized SGD (Algorithm 3)
* DCD-SGD and ECD-SGD (Tang et al. 2018a)
* centralized mini-batch SGD

All in the (n, d) matrix form of Appendix B, with the draws of
``core/choco_sgd.py``: a step takes its minibatch (and a stochastic
compressor's draw) as arguments; the run functions make them from a
``torch.Generator`` or take them injected.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .choco_gossip import consensus_error, mixing, round_draw
from .compression import Compressor

# ---------------------------------------------------------------------------
# Consensus baselines
# ---------------------------------------------------------------------------


def _minus_eye(W: torch.Tensor) -> torch.Tensor:
    return W - torch.eye(W.shape[0], dtype=W.dtype, device=W.device)


def exact_gossip_round(X: torch.Tensor, W: torch.Tensor,
                       gamma: float = 1.0) -> torch.Tensor:
    """(E-G): X' = X + gamma (W - I) X."""
    return X + gamma * _minus_eye(W) @ X


def q1_gossip_round(X: torch.Tensor, W: torch.Tensor, compressor: Compressor,
                    rand=None, gamma: float = 1.0) -> torch.Tensor:
    """(Q1-G): X' = X + gamma (W Q(X) - X).  Does not preserve the
    average, so it converges only to a neighbourhood."""
    QX = compressor.apply(X, rand)
    return X + gamma * (W @ QX - X)


def q2_gossip_round(X: torch.Tensor, W: torch.Tensor, compressor: Compressor,
                    rand=None, gamma: float = 1.0) -> torch.Tensor:
    """(Q2-G): X' = X + gamma (W - I) Q(X).  Preserves the average, but
    the compression noise ||Q(x)|| does not vanish."""
    QX = compressor.apply(X, rand)
    return X + gamma * _minus_eye(W) @ QX


def run_gossip_baseline(scheme: str, x0: torch.Tensor, W,
                        compressor: Optional[Compressor], steps: int,
                        gamma: float = 1.0, *,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Callable[[int], object]] = None):
    """Run a consensus baseline ("exact", "q1" or "q2"); returns (X_final,
    per-round consensus errors (steps,))."""
    if scheme not in ("exact", "q1", "q2"):
        raise ValueError(scheme)
    W = mixing(W, x0)
    xbar = torch.mean(x0, dim=0, keepdim=True)
    X, errs = x0, []
    for t in range(steps):
        if scheme == "exact":
            X = exact_gossip_round(X, W, gamma)
        else:
            rand = round_draw(compressor, X, t, generator, draws)
            step = q1_gossip_round if scheme == "q1" else q2_gossip_round
            X = step(X, W, compressor, rand, gamma)
        errs.append(consensus_error(X, xbar))
    return X, torch.stack(errs) if errs else x0.new_zeros((0,))


# ---------------------------------------------------------------------------
# Decentralized SGD baselines: grad_fn(X (n, d), batch (n, bs)) -> (n, d)
# ---------------------------------------------------------------------------

def plain_dsgd_step(X: torch.Tensor, W: torch.Tensor, grad_fn, eta: float,
                    batch) -> torch.Tensor:
    """Algorithm 3: local SGD step, then exact averaging with neighbours."""
    G = grad_fn(X, batch.to(X.device))
    return W @ (X - eta * G)


class DCDState(NamedTuple):
    x: torch.Tensor        # (n, d) local models == public replicas


def dcd_sgd_step(state: DCDState, W: torch.Tensor, grad_fn,
                 compressor: Compressor, eta: float, batch,
                 rand=None) -> DCDState:
    """DCD-SGD (difference compression, Tang et al. 2018a, Alg. 1):

        x_i^{t+1/2} = sum_j w_ij x_j^t - eta g_i
        z_i         = x_i^{t+1/2} - x_i^t
        x_i^{t+1}   = x_i^t + Q(z_i)

    Needs a high-precision Q; diverges under aggressive compression
    (paper Figs. 5-6)."""
    G = grad_fn(state.x, batch.to(state.x.device))
    x_half = W @ state.x - eta * G
    z = x_half - state.x
    return DCDState(x=state.x + compressor.apply(z, rand))


class ECDState(NamedTuple):
    x: torch.Tensor        # (n, d) local models
    x_tilde: torch.Tensor  # (n, d) extrapolated public replicas
    t: int                 # step


def ecd_sgd_step(state: ECDState, W: torch.Tensor, grad_fn,
                 compressor: Compressor, eta: float, batch,
                 rand=None) -> ECDState:
    """ECD-SGD (extrapolation compression, Tang et al. 2018a, Alg. 2),
    with theta_t = (t + 2) / 2:

        x_i^{t+1/2}   = sum_j w_ij xt_j^t - eta g_i
        z_i           = (1 - theta_t) xt_i^t + theta_t x_i^{t+1/2}
        xt_i^{t+1}    = (1 - 1/theta_t) xt_i^t + (1/theta_t) Q(z_i)

    The scalars are float32, as in the JAX package."""
    G = grad_fn(state.x_tilde, batch.to(state.x_tilde.device))
    x_half = W @ state.x_tilde - eta * G
    theta = (np.float32(state.t) + np.float32(2.0)) / np.float32(2.0)
    z = float(np.float32(1.0) - theta) * state.x_tilde + float(theta) * x_half
    qz = compressor.apply(z, rand)
    inv = np.float32(1.0) / theta
    x_tilde = (float(np.float32(1.0) - inv) * state.x_tilde
               + float(inv) * qz)
    return ECDState(x=x_half, x_tilde=x_tilde, t=state.t + 1)


def centralized_sgd_step(x: torch.Tensor, grad_fn, n: int, eta: float,
                         batch) -> torch.Tensor:
    """Centralized mini-batch SGD: one model, the mean of n workers'
    gradients."""
    X = x.expand(n, *x.shape)
    G = grad_fn(X, batch.to(x.device))
    return x - eta * torch.mean(G, dim=0)
