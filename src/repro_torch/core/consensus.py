"""Blackbox averaging interface (paper Algorithm 4 / Assumption 3).

An averaging scheme is a map h: (X, Y) -> (X', Y') that (i) preserves
the average of X and (ii) contracts the Lyapunov function
Psi(X, Y) = ||X - Xbar||_F^2 + ||X - Y||_F^2 by (1 - p).  Exact gossip
satisfies it with p = gamma delta; CHOCO-Gossip with p = delta^2 omega /
82 (Theorem 2).  Decentralized SGD with any such h converges (Theorem
19).  Not ported: ``stochastic_choco_averaging`` (it needs the stochastic
topology processes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .choco_gossip import theorem2_rate, theorem2_stepsize
from .compression import Compressor


@dataclasses.dataclass(frozen=True)
class AveragingScheme:
    """h(X, Y, rand=None) -> (X', Y') plus its contraction parameter p;
    ``rand`` is a stochastic compressor's draw."""
    name: str
    h: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    p: float


def _minus_eye(W: torch.Tensor) -> torch.Tensor:
    return W - torch.eye(W.shape[0], dtype=W.dtype, device=W.device)


def exact_averaging(W: torch.Tensor, delta: float,
                    gamma: float = 1.0) -> AveragingScheme:
    """Uncompressed gossip X <- X + gamma (W - I) X; p = gamma delta."""
    def h(X, Y, rand=None):
        Xn = X + gamma * _minus_eye(W) @ X
        return Xn, Xn
    return AveragingScheme("exact", h, p=gamma * delta)


def choco_averaging(W: torch.Tensor, delta: float, beta: float,
                    compressor: Compressor, d: int,
                    gamma: Optional[float] = None) -> AveragingScheme:
    """CHOCO-Gossip (Algorithm 1) as an AveragingScheme, Y playing x_hat;
    gamma defaults to Theorem 2's for (delta, beta) and the compressor's
    omega at dimension d."""
    omega = compressor.omega(d)
    if gamma is None:
        gamma = theorem2_stepsize(delta, beta, omega)

    def h(X, Y, rand=None):
        Yn = Y + compressor.apply(X - Y, rand)
        Xn = X + gamma * _minus_eye(W) @ Yn
        return Xn, Yn

    return AveragingScheme("choco", h, p=1.0 - theorem2_rate(delta, omega))
