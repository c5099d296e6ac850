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
injects it, else from an explicit ``torch.Generator``.  The pipelined
recursion (the matrix twin of the pipelined engine, ``comm/pipelined.py``)
the bounded-staleness simulator (the matrix twin of the stale replica
engine, JAX ``core/choco_gossip.py:194-262``) and the push-sum simulator
(the matrix twin of the push-sum engine, ``comm/pushsum.py``; JAX
``core/choco_gossip.py:339-394``) are here too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
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


# ---------------------------------------------------------------------------
# Pipelined CHOCO-Gossip: the x-update reads the carry, the round-(t-1)
# pair, so this round's payload lands one round late (the pipelined
# engine's recursion; JAX ``choco_pipelined_round``).
# ---------------------------------------------------------------------------

class PipelinedGossipState(NamedTuple):
    x: torch.Tensor        # (n, d) local iterates
    x_hat: torch.Tensor    # (n, d) public copies through round t-1
    s: torch.Tensor        # (n, d) W-weighted aggregate through round t-1


def init_pipelined_state(x0: torch.Tensor) -> PipelinedGossipState:
    """Pipelined-recursion state at t=0 (zero EF state, like Algorithm 5)."""
    return PipelinedGossipState(x=x0, x_hat=torch.zeros_like(x0),
                                s=torch.zeros_like(x0))


def choco_pipelined_round(state: PipelinedGossipState, W: torch.Tensor,
                          gamma: float, compressor: Compressor,
                          rand=None) -> PipelinedGossipState:
    """One pipelined round: q = Q(x - x_hat) before the update,
    x' = x + gamma (s - x_hat) from the carry, x_hat' = x_hat + q,
    s' = s + W q (this round's payload lands at t + 1)."""
    q = compressor.apply(state.x - state.x_hat, rand)
    x = state.x + gamma * (state.s - state.x_hat)
    return PipelinedGossipState(x=x, x_hat=state.x_hat + q,
                                s=state.s + W @ q)


def run_choco_pipelined_gossip(x0: torch.Tensor, W, gamma: float,
                               compressor: Compressor, steps: int, *,
                               generator: Optional[torch.Generator] = None,
                               draws: Optional[Callable[[int], object]] = None):
    """Run ``steps`` pipelined rounds from x0 (n, d); returns (final
    state, per-round consensus errors (steps,))."""
    W = mixing(W, x0)
    return _run(lambda st, r: choco_pipelined_round(
        st, W, gamma, compressor, r), init_pipelined_state(x0), x0, steps,
        compressor, generator, draws)


# ---------------------------------------------------------------------------
# Bounded-staleness CHOCO-Gossip: each edge's update reads both endpoints'
# public copies as of d rounds ago (d <= tau, drawn per edge by the
# process), x_hat^(t-d) = x_hat - (the last d increments); a ring of the
# last tau global q's rebuilds every stale copy, and the engine's
# replicas are rows of the global state (JAX ``choco_stale_round``).
# ---------------------------------------------------------------------------

class StaleGossipState(NamedTuple):
    x: torch.Tensor        # (n, d) local iterates
    x_hat: torch.Tensor    # (n, d) public copies (fresh)
    ring: torch.Tensor     # (tau, n, d): ring[j] = the global q of j rounds ago


def init_stale_state(x0: torch.Tensor, max_staleness: int
                     ) -> StaleGossipState:
    """Zero public copies and a zero depth-``max_staleness`` ring."""
    return StaleGossipState(
        x=x0, x_hat=torch.zeros_like(x0),
        ring=torch.zeros((max_staleness,) + tuple(x0.shape), dtype=x0.dtype,
                         device=x0.device))


def choco_stale_round(state: StaleGossipState, process, gamma: float,
                      compressor: Compressor, seed: int = 0, t: int = 0,
                      rand=None, sample=None) -> StaleGossipState:
    """One bounded-staleness round under ``process`` (a
    ``comm.stochastic.StalenessProcess``):

        q = Q(x - x_hat);  x_hat += q;  ring <- [q, ring[:-1]]
        per round r, destination i, with d the delay of its edge:
        x_i += gamma v_r[i] (x_hat^(t-d)[src_r(i)] - x_hat^(t-d)[i])

    ``seed`` is the exchange seed, whose edge delays of gossip round t
    are drawn unless ``sample`` gives them; ``rand`` a stochastic
    compressor's draw."""
    x = state.x
    dev = x.device
    tau = int(state.ring.shape[0])
    q = compressor.apply(x - state.x_hat, rand)
    x_hat = state.x_hat + q
    ring = (torch.cat([q[None], state.ring[:-1]], dim=0) if tau
            else state.ring)
    if sample is None:
        sample = process.edge_delays(seed, t)
    dvecs = process.round_delays(sample)
    acc = torch.zeros_like(x)
    for r, src in enumerate(process.round_src):
        src = torch.tensor(src, device=dev)
        v = torch.tensor(np.asarray(process.round_recv[r], np.float32),
                         device=dev)[:, None]
        d = torch.from_numpy(dvecs[r]).to(dev)
        diff = x_hat[src, :] - x_hat
        for j in range(tau):
            m = (d > j).to(torch.float32)[:, None]
            diff = diff - m * (ring[j][src, :] - ring[j])
        acc = acc + v * diff
    return StaleGossipState(x=x + gamma * acc, x_hat=x_hat, ring=ring)


def run_choco_stale_gossip(x0: torch.Tensor, process, gamma: float,
                           compressor: Compressor, steps: int, *,
                           seed: int = 0,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[Callable[[int], object]] = None,
                           samples: Optional[Callable[[int], object]] = None):
    """``steps`` bounded-staleness rounds with the trainer's seed plumbing
    (exchange seed ``fold_seed(seed, step)``, gossip round 0).
    ``draws(step)`` / ``generator`` give a stochastic compressor's draws,
    ``samples(step)`` the edge delays of each step instead of the seed's.
    Returns (final state, per-step consensus errors)."""
    from repro_torch.comm.packing import fold_seed
    xbar = torch.mean(x0, dim=0, keepdim=True)
    st = init_stale_state(x0, process.max_staleness)
    errs = []
    for step in range(steps):
        rand = round_draw(compressor, st.x, step, generator, draws)
        st = choco_stale_round(
            st, process, gamma, compressor, fold_seed(seed, step), t=0,
            rand=rand, sample=None if samples is None else samples(step))
        errs.append(consensus_error(st.x, xbar))
    return st, torch.stack(errs) if errs else x0.new_zeros((0,))


# ---------------------------------------------------------------------------
# Directed push-sum (column-stochastic A): the matrix twin of
# comm/pushsum.py.  Neither x nor the weight w converges alone; the
# de-biased ratio z = x / w does, because 1^T A = 1^T conserves both sums
# (JAX ``core/choco_gossip.py:339-394``).
# ---------------------------------------------------------------------------

class PushSumState(NamedTuple):
    x: torch.Tensor        # (n, d) biased iterates
    x_hat: torch.Tensor    # (n, d) public copies (error feedback)
    s: torch.Tensor        # (n, d) A-weighted aggregate of the q's
    w: torch.Tensor        # (n, 1) push-sum weights, init 1


def init_pushsum_state(x0: torch.Tensor) -> PushSumState:
    """Push-sum state at t=0: x0, zero EF state, a unit weight column."""
    return PushSumState(x=x0, x_hat=torch.zeros_like(x0),
                        s=torch.zeros_like(x0),
                        w=torch.ones((x0.shape[0], 1), dtype=x0.dtype,
                                     device=x0.device))


def pushsum_gossip_round(state: PushSumState, A: torch.Tensor, gamma: float,
                         compressor: Compressor, rand=None) -> PushSumState:
    """One compressed push-sum round:

        q = Q(x - x_hat);  x_hat += q;  s += A q;  x += gamma (s - x_hat)
        w += gamma (A w - w)                     (exact: the scalars ship raw)

    With Q the identity it is lazy push-sum, x' = ((1-gamma) I + gamma A)
    x.  ``A @ q`` stands in for the directed rounds of the engine;
    ``rand`` is a stochastic compressor's draw."""
    q = compressor.apply(state.x - state.x_hat, rand)
    x_hat = state.x_hat + q
    s = state.s + A @ q
    x = state.x + gamma * (s - x_hat)
    w = state.w + gamma * (A @ state.w - state.w)
    return PushSumState(x=x, x_hat=x_hat, s=s, w=w)


def pushsum_debias(state: PushSumState) -> torch.Tensor:
    """z = x / w, the quantity that converges to the initial average."""
    return state.x / state.w


def run_pushsum_gossip(x0: torch.Tensor, A, gamma: float,
                       compressor: Compressor, steps: int, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Callable[[int], object]] = None):
    """Run ``steps`` push-sum rounds from x0 (n, d); returns (final state,
    per-round consensus errors of the de-biased estimate x / w against
    the initial average)."""
    A = mixing(A, x0)
    xbar = torch.mean(x0, dim=0, keepdim=True)
    st = init_pushsum_state(x0)
    errs = []
    for t in range(steps):
        st = pushsum_gossip_round(
            st, A, gamma, compressor,
            round_draw(compressor, st.x, t, generator, draws))
        errs.append(consensus_error(pushsum_debias(st), xbar))
    return st, torch.stack(errs) if errs else x0.new_zeros((0,))
