"""Stochastic topology processes: per-step distributions over mixing
matrices, the port of ``src/repro/comm/stochastic.py:71-443``.

A :class:`TopologyProcess` generalises a compiled static schedule to a
distribution over mixing matrices with three consumers: the gossip
exchanges (``comm/gossip.py``), which replay its *sampled* rounds; the
matrix simulator (:func:`choco_process_round`), and the trainer, which
takes the Theorem-2 stepsize at the *expected* matrix's (delta, beta).

* :class:`MatchingProcess`: each gossip round samples ONE round of the
  compiled schedule (uniform, or weighted by its largest receive weight),
  its receive weights scaled by ``1 / p_r``, so that E[W_t] = W exactly.
  A step ships one round's payload instead of R.
* :class:`LinkFailureProcess`: each undirected edge of the schedule drops
  with probability p, both directions together, its weight folded back
  into both endpoints' self weight: E[W_t] = (1 - p) W + p I.
* :class:`StalenessProcess` (JAX ``comm/async_gossip.py:104-307``):
  bounded staleness.  Each undirected edge draws a delay d in {0..tau}
  per gossip round (both directions share it) from ``delay_probs``
  (uniform by default; ``straggler_edges`` take ``straggler_delay_probs``,
  by default the point mass at tau).  Every round ships; the delay only
  selects how stale a pair of public copies the update reads.  Its
  stepsize surrogate is the per-edge expected matrix (an edge delivers
  its weight at its freshness phi_e = E[1 / (1 + d_e)]) and
  ``omega * min phi_e``.

The sampler.  JAX draws every sample from ``fold_in(exchange_key,
SAMPLE_SALT + t)`` with threefry, which the port cannot match, so the
port draws from ``packing.fold_seed(exchange_seed, SAMPLE_SALT + t)``: a
63-bit integer whose top 24 bits are a uniform u in [0, 1), exact in f32.
The matching round is the inverse CDF of u over the f32 cumulative
``probs``, as JAX's ``round_index`` takes it; the link-failure mask keeps
edge e where ``uniform(fold_seed(z, e)) < f32(1 - p)``; edge e's delay is
the inverse CDF of ``uniform(fold_seed(z, e))`` over its f32 cumulative
delay table, as JAX's ``edge_delays`` takes it.  All are drawn on the
host from integers, so picking a round, a mask or a delay never reads the
device.  Every node, every engine and the simulator draw the same sample
from the same seed with no byte on the wire: the JAX determinism contract
(``:47-53``).  The parity tests hand JAX's samples to the engines instead
(their ``samples`` hook).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.packing import fold_seed
from repro_torch.comm.schedule import (GossipRound, GossipSchedule,
                                       compile_schedule, round_recv_vec)
from repro_torch.core.topology import Topology, beta_norm, spectral_gap

#: fold salt separating topology sampling from compressor randomness
#: (the JAX package's value)
SAMPLE_SALT = 0x70C0

_MATCHING_SAMPLERS = ("uniform", "weighted")
#: the processes the port runs (``--topology-process``)
PROCESS_KINDS = ("matching", "linkfail", "staleness")


def uniform_of(z: int) -> float:
    """The uniform in [0, 1) of a 63-bit sample integer: its top 24 bits
    times 2^-24, a value exact in f32."""
    return (z >> 39) * 2.0 ** -24


def _round_matrix(rnd: GossipRound, n: int,
                  scale: float = 1.0) -> np.ndarray:
    """Off-diagonal contribution of one round, scaled."""
    M = np.zeros((n, n), dtype=np.float64)
    for src, dst in rnd.perm:
        w = rnd.weight if rnd.weight is not None else rnd.weights[dst]
        M[dst, src] += w * scale
    return M


class TopologyProcess:
    """Base: a per-step distribution over n x n mixing matrices.
    ``sample(seed, t)`` is THE determinism contract: every engine and the
    simulator derive the sample of gossip round t from it alone."""

    kind: str = "abstract"
    schedule: GossipSchedule

    @property
    def n(self) -> int:
        return self.schedule.n

    @staticmethod
    def sample_seed(seed: int, t: int) -> int:
        return fold_seed(seed, SAMPLE_SALT + t)

    def sample(self, seed: int, t: int):
        raise NotImplementedError

    def sample_matrix(self, seed: int, t: int, sample=None) -> torch.Tensor:
        raise NotImplementedError

    def expected_matrix(self) -> np.ndarray:
        raise NotImplementedError

    def expected_delta_beta(self) -> Tuple[float, float]:
        """(delta, beta) of the EXPECTED mixing matrix, the Theorem-2
        stepsize's under stochastic mixing (Koloskova et al. 2020)."""
        E = self.expected_matrix()
        return spectral_gap(E), beta_norm(E)

    def effective_omega(self, omega: float) -> float:
        """Assumption-1 omega as the stepsize sees it: the compressor's own
        for matching and link failures."""
        return omega


def _index_schedule_edges(schedule: GossipSchedule):
    """Canonical undirected-edge indexing of a compiled schedule's support:
    ``(edges, round_edge_ids, round_recv)``, the canonical ``(min, max)``
    pairs in first-seen order, per round the edge id feeding each
    destination (-1 where the round skips it) and the round's receive
    weights.  Both directions of a link map to ONE edge id."""
    n = schedule.n
    edges = {}
    round_edge_ids = []
    round_recv = []
    for rnd in schedule.rounds:
        ids = np.full(n, -1, dtype=np.int32)
        for src, dst in rnd.perm:
            e = (min(src, dst), max(src, dst))
            if e not in edges:
                edges[e] = len(edges)
            ids[dst] = edges[e]
        round_edge_ids.append(tuple(int(v) for v in ids))
        round_recv.append(tuple(round_recv_vec(rnd, n)))
    return (tuple(sorted(edges, key=edges.get)), tuple(round_edge_ids),
            tuple(round_recv))


@dataclasses.dataclass(frozen=True, eq=False)
class MatchingProcess(TopologyProcess):
    """Randomized matchings: one edge-coloured round per gossip round.

    Round r is drawn with probability ``probs[r]`` and its receive weights
    are scaled by ``1 / probs[r]``; what a node does not receive goes to
    its self weight.  ``uniform``: p_r = 1/R; ``weighted``: p_r in
    proportion to the round's largest receive weight.  A sampler whose
    scaled weights exceed 1 (a negative self weight) raises at build time
    with the binding round."""
    schedule: GossipSchedule
    sampler: str = "uniform"

    def __post_init__(self):
        if self.sampler not in _MATCHING_SAMPLERS:
            raise ValueError(f"unknown matching sampler {self.sampler!r}; "
                             f"have {_MATCHING_SAMPLERS}")
        R = self.schedule.n_rounds
        if R == 0:
            raise ValueError("matching process needs a schedule with at "
                             "least one round (n >= 2)")
        n = self.schedule.n
        recv = np.stack([round_recv_vec(r, n) for r in self.schedule.rounds])
        if self.sampler == "uniform":
            probs = np.full(R, 1.0 / R)
        else:
            mass = recv.max(axis=1)
            probs = mass / mass.sum()
        scaled = recv / probs[:, None]
        worst = float(scaled.max())
        if worst > 1.0 + 1e-9:
            r_bad = int(np.unravel_index(np.argmax(scaled), scaled.shape)[0])
            raise ValueError(
                f"matching sampler {self.sampler!r} infeasible for "
                f"{self.schedule.name!r}: round {r_bad} scales a receive "
                f"weight to {worst:.3f} > 1 (self weight would go negative); "
                f"try sampler='weighted' or a topology with fewer rounds")
        object.__setattr__(self, "probs", tuple(float(p) for p in probs))
        object.__setattr__(self, "branch_recv",
                           tuple(tuple(row) for row in scaled))
        object.__setattr__(self, "branch_self",
                           tuple(tuple(1.0 - row) for row in scaled))
        srcs, sends = [], []
        for rnd in self.schedule.rounds:
            sv = np.arange(n)
            mv = np.zeros(n)
            for src, dst in rnd.perm:
                sv[dst] = src
                mv[src] = 1.0
            srcs.append(tuple(int(v) for v in sv))
            sends.append(tuple(mv))
        object.__setattr__(self, "round_src", tuple(srcs))
        object.__setattr__(self, "round_send", tuple(sends))
        # the inverse CDF's f32 thresholds, as JAX compares them
        object.__setattr__(self, "_cum", tuple(
            float(c) for c in np.cumsum(np.asarray(self.probs))[:-1]
            .astype(np.float32)))

    kind = "matching"

    @property
    def n_rounds(self) -> int:
        return self.schedule.n_rounds

    def round_index(self, seed: int, t: int) -> int:
        """The sampled round of gossip round t, the same on every node: the
        round whose f32 cumulative interval holds the sample's uniform."""
        u = uniform_of(self.sample_seed(seed, t))
        return sum(u >= c for c in self._cum)

    sample = round_index

    def branch_matrices(self) -> np.ndarray:
        """(R, n, n) stack of the per-branch sampled mixing matrices."""
        mats = []
        for r, rnd in enumerate(self.schedule.rounds):
            M = _round_matrix(rnd, self.n, scale=1.0 / self.probs[r])
            mats.append(np.diag(np.asarray(self.branch_self[r])) + M)
        return np.stack(mats)

    def sample_matrix(self, seed: int, t: int, sample=None) -> torch.Tensor:
        """The f32 matrix of gossip round t (of round ``sample`` if given)."""
        r = self.round_index(seed, t) if sample is None else int(sample)
        return torch.from_numpy(self.branch_matrices()[r].astype(np.float32))

    def expected_matrix(self) -> np.ndarray:
        return np.einsum("r,rij->ij", np.asarray(self.probs),
                         self.branch_matrices())


@dataclasses.dataclass(frozen=True, eq=False)
class LinkFailureProcess(TopologyProcess):
    """I.i.d. Bernoulli link failures over a compiled schedule: each
    undirected edge drops with probability ``drop_prob`` per gossip round,
    both directions together, and each endpoint's lost receive weight is
    folded into its self weight, so every sample stays row-stochastic,
    symmetric and nonnegative; E[W_t] = (1 - p) W + p I."""
    schedule: GossipSchedule
    drop_prob: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got "
                             f"{self.drop_prob} (p = 1 never mixes)")
        edges, round_edge_ids, round_recv = _index_schedule_edges(
            self.schedule)
        object.__setattr__(self, "n_edges", len(edges))
        object.__setattr__(self, "_edges", edges)
        object.__setattr__(self, "round_edge_ids", round_edge_ids)
        object.__setattr__(self, "round_recv", round_recv)
        object.__setattr__(self, "_keep", float(np.float32(
            1.0 - self.drop_prob)))

    kind = "linkfail"

    def edge_mask(self, seed: int, t: int) -> np.ndarray:
        """(max(n_edges, 1),) f32 keep-mask (1 = link up) of gossip round
        t: the same on every node."""
        z = self.sample_seed(seed, t)
        return np.array([uniform_of(fold_seed(z, e)) < self._keep
                         for e in range(max(self.n_edges, 1))],
                        dtype=np.float32)

    sample = edge_mask

    def round_masks(self, mask) -> list:
        """Per round, the (n,) f32 per-destination keep values."""
        mask = np.asarray(mask, dtype=np.float32)
        out = []
        for ids in self.round_edge_ids:
            idx = np.asarray(ids)
            out.append(np.where(idx >= 0, mask[np.clip(idx, 0, None)],
                                np.float32(0.0)).astype(np.float32))
        return out

    def round_weights(self, mask) -> list:
        """Per round, the (n,) f32 receive weights the mask leaves:
        ``f32(recv_r) * mask_r``, the JAX engine's ``wv``."""
        return [np.asarray(recv, dtype=np.float32) * rm
                for recv, rm in zip(self.round_recv, self.round_masks(mask))]

    def sample_matrix(self, seed: int, t: int, sample=None) -> torch.Tensor:
        """The f32 matrix of gossip round t (of edge mask ``sample`` if
        given), built in JAX's order of f32 operations."""
        n = self.n
        mask = self.edge_mask(seed, t) if sample is None else sample
        rmasks = [torch.from_numpy(m) for m in self.round_masks(mask)]
        W = torch.zeros((n, n))
        recv_total = torch.zeros(n)
        for rnd, rm, recv in zip(self.schedule.rounds, rmasks,
                                 self.round_recv):
            M = torch.zeros((n, n))
            for src, dst in rnd.perm:
                w = (rnd.weight if rnd.weight is not None
                     else rnd.weights[dst])
                M[dst, src] += w * rm[dst]
            W = W + M
            recv_total = recv_total + torch.tensor(recv,
                                                   dtype=torch.float32) * rm
        return W + torch.diag(1.0 - recv_total)

    def expected_matrix(self) -> np.ndarray:
        W = np.asarray(self.schedule.mixing_matrix())
        p = self.drop_prob
        return (1.0 - p) * W + p * np.eye(self.n)


@dataclasses.dataclass(frozen=True, eq=False)
class StalenessProcess(TopologyProcess):
    """Bounded-staleness delays over a compiled schedule's edges.

    Each undirected edge draws a delay ``d in {0..max_staleness}`` per
    gossip round from ``delay_probs`` (``delay_probs[k]`` = P(d = k);
    None: uniform), both directions one draw.  ``straggler_edges`` names
    links (node pairs of the schedule's support) whose delays come from
    ``straggler_delay_probs`` instead (None: the point mass at
    max_staleness, a maximally slow link).  ``max_staleness = 0`` keeps
    every edge fresh: the link-failure engine at p = 0."""
    schedule: GossipSchedule
    max_staleness: int = 1
    delay_probs: Optional[Tuple[float, ...]] = None
    straggler_edges: Optional[Tuple[Tuple[int, int], ...]] = None
    straggler_delay_probs: Optional[Tuple[float, ...]] = None

    kind = "staleness"

    def _normalize_probs(self, probs, what: str) -> Tuple[float, ...]:
        """A delay law over {0..tau}, checked and normalised."""
        tau = self.max_staleness
        arr = np.asarray(probs, dtype=np.float64)
        if arr.shape != (tau + 1,):
            raise ValueError(
                f"{what} needs max_staleness + 1 = {tau + 1} "
                f"entries (P(d=0..{tau})), got shape {arr.shape}")
        if arr.min() < 0 or arr.sum() <= 0:
            raise ValueError(f"{what} must be nonnegative with "
                             f"positive mass, got {tuple(arr)}")
        return tuple(float(p) for p in arr / arr.sum())

    def __post_init__(self):
        tau = self.max_staleness
        if tau < 0:
            raise ValueError(f"max_staleness must be >= 0, got {tau}")
        if self.schedule.n_rounds == 0:
            raise ValueError("staleness process needs a schedule with at "
                             "least one round (n >= 2)")
        if self.delay_probs is None:
            probs = tuple(1.0 / (tau + 1) for _ in range(tau + 1))
        else:
            probs = self._normalize_probs(self.delay_probs, "delay_probs")
        object.__setattr__(self, "delay_probs", probs)
        edges, round_edge_ids, round_recv = _index_schedule_edges(
            self.schedule)
        object.__setattr__(self, "n_edges", len(edges))
        object.__setattr__(self, "_edges", edges)
        object.__setattr__(self, "round_edge_ids", round_edge_ids)
        object.__setattr__(self, "round_recv", round_recv)
        if self.straggler_delay_probs is not None \
                and self.straggler_edges is None:
            raise ValueError("straggler_delay_probs given without "
                             "straggler_edges")
        # each edge's law: the global one, straggler rows overridden
        table = np.tile(np.asarray(probs), (max(len(edges), 1), 1))
        if self.straggler_edges is not None:
            if self.straggler_delay_probs is None:
                sprobs = tuple(0.0 for _ in range(tau)) + (1.0,)
            else:
                sprobs = self._normalize_probs(self.straggler_delay_probs,
                                               "straggler_delay_probs")
            object.__setattr__(self, "straggler_delay_probs", sprobs)
            canon = []
            edge_pos = {e: k for k, e in enumerate(edges)}
            for a, b in self.straggler_edges:
                e = (min(int(a), int(b)), max(int(a), int(b)))
                if e not in edge_pos:
                    raise ValueError(
                        f"unknown straggler edge {a}-{b}: the schedule's "
                        f"edge support is {list(edges)}")
                canon.append(e)
                table[edge_pos[e]] = np.asarray(sprobs)
            object.__setattr__(self, "straggler_edges", tuple(canon))
        object.__setattr__(self, "edge_delay_probs",
                           tuple(tuple(float(p) for p in row)
                                 for row in table))
        # the inverse CDF's f32 thresholds per edge, as JAX compares them
        object.__setattr__(self, "_cum", tuple(
            tuple(float(c) for c in row) for row in
            np.cumsum(np.asarray(self.edge_delay_probs), axis=1)[:, :-1]
            .astype(np.float32)))
        n = self.schedule.n
        srcs = []
        for rnd in self.schedule.rounds:
            sv = np.arange(n)
            for src, dst in rnd.perm:
                sv[dst] = src
            srcs.append(tuple(int(v) for v in sv))
        object.__setattr__(self, "round_src", tuple(srcs))

    @property
    def mean_delay(self) -> float:
        """E[d] under ``delay_probs``."""
        return float(sum(k * p for k, p in enumerate(self.delay_probs)))

    @property
    def freshness(self) -> float:
        """phi = E[1 / (1 + d)] of the global law: the share of a fresh
        exchange an edge delivers per round on average."""
        return float(sum(p / (1.0 + k)
                         for k, p in enumerate(self.delay_probs)))

    @property
    def edge_freshness(self) -> Tuple[float, ...]:
        """phi_e of each edge under its own law."""
        return tuple(float(sum(p / (1.0 + k) for k, p in enumerate(row)))
                     for row in self.edge_delay_probs)

    def edge_delays(self, seed: int, t: int) -> np.ndarray:
        """(max(n_edges, 1),) int32 delays of gossip round t, the same on
        every node: edge e's uniform ``uniform(fold_seed(z, e))`` through
        the inverse CDF of its f32 cumulative law."""
        z = self.sample_seed(seed, t)
        return np.array([sum(uniform_of(fold_seed(z, e)) >= c for c in cum)
                         for e, cum in enumerate(self._cum)], dtype=np.int32)

    sample = edge_delays

    def round_delays(self, delays) -> list:
        """Per round, the (n,) int32 delay of each destination's edge (0
        where the round skips the node: its zero weight drops the term)."""
        delays = np.asarray(delays, dtype=np.int32)
        out = []
        for ids in self.round_edge_ids:
            idx = np.asarray(ids)
            out.append(np.where(idx >= 0, delays[np.clip(idx, 0, None)],
                                0).astype(np.int32))
        return out

    def round_weights(self, delays) -> list:
        """Per round, the (n,) f32 receive weights: every link delivers,
        late or not, so they are ``f32(recv_r)`` whatever the delays."""
        return [np.asarray(recv, dtype=np.float32) for recv in self.round_recv]

    def sample_matrix(self, seed: int, t: int, sample=None) -> torch.Tensor:
        raise NotImplementedError(
            "a bounded-staleness step mixes SNAPSHOTS from up to tau steps "
            "back — it is not a single (n, n) matrix on the current "
            "iterates.  Use core.choco_gossip.choco_stale_round (the "
            "delay-expanded simulator) for parity checks, and "
            "expected_matrix() for the delay-averaged theory surrogate.")

    def expected_matrix(self) -> np.ndarray:
        """The delay-averaged matrix, edge by edge: each edge delivers its
        weight at its freshness phi_e, the rest folds into the
        destination's diagonal (one global law: phi W + (1 - phi) I)."""
        phis = self.edge_freshness
        E = np.diag(np.asarray(self.schedule.self_weights,
                               dtype=np.float64))
        for r, rnd in enumerate(self.schedule.rounds):
            recv = round_recv_vec(rnd, self.n)
            for src, dst in rnd.perm:
                e = self.round_edge_ids[r][dst]
                phi = phis[e] if e >= 0 else 1.0
                E[dst, src] += phi * recv[dst]
                E[dst, dst] += (1.0 - phi) * recv[dst]
        return E

    def effective_omega(self, omega: float) -> float:
        """omega * min phi_e: a delay-d edge reads a snapshot d increments
        old, which scales the compression-error term by 1 / (1 + d) (the
        point mass at tau gives omega / (1 + tau)); the slowest edge
        governs."""
        return omega * min(self.edge_freshness)


# ---------------------------------------------------------------------------
# constructors + matrix simulators
# ---------------------------------------------------------------------------

def make_topology_process(kind: str, schedule: GossipSchedule, *,
                          matching_sampler: str = "uniform",
                          edge_drop_prob: float = 0.1,
                          max_staleness: int = 1,
                          delay_probs=None,
                          straggler_edges=None,
                          straggler_delay_probs=None) -> TopologyProcess:
    """Named-process registry mirrored by ``--topology-process``."""
    if kind == "matching":
        return MatchingProcess(schedule, sampler=matching_sampler)
    if kind == "linkfail":
        return LinkFailureProcess(schedule, drop_prob=edge_drop_prob)
    if kind == "staleness":
        return StalenessProcess(schedule, max_staleness=max_staleness,
                                delay_probs=delay_probs,
                                straggler_edges=straggler_edges,
                                straggler_delay_probs=straggler_delay_probs)
    raise ValueError(f"unknown topology process {kind!r}; "
                     f"have ('matching', 'linkfail', 'staleness')")


def process_from_topology(kind: str, topo: Topology, **kw) -> TopologyProcess:
    """Compile ``topo`` and build the named process over it."""
    return make_topology_process(kind, compile_schedule(topo), **kw)


class ProcessGossipState:
    """Matrix-simulator state of the replica engine: x (n, d) iterates;
    refs: matching, the (R, n, d) per-round own references H_r (node i's
    round-r source replica is row src_r(i) of H_r); link failures, the
    single (n, d) public copy x_hat."""

    def __init__(self, x: torch.Tensor, refs: torch.Tensor):
        self.x = x
        self.refs = refs


def init_process_state(x0: torch.Tensor,
                       process: TopologyProcess) -> ProcessGossipState:
    """Zero references in the process's layout."""
    if process.kind == "matching":
        R = process.schedule.n_rounds
        refs = torch.zeros((R,) + tuple(x0.shape), dtype=x0.dtype,
                           device=x0.device)
    else:
        refs = torch.zeros_like(x0)
    return ProcessGossipState(x0, refs)


def choco_process_round(state: ProcessGossipState, process: TopologyProcess,
                        gamma: float, compressor, seed: int = 0, t: int = 0,
                        rand=None, sample=None) -> ProcessGossipState:
    """One round of the process algorithm, the matrix twin of the replica
    engine.  ``seed`` is the exchange seed, whose sample of gossip round t
    is drawn unless ``sample`` (a round index or an edge mask) is given;
    ``rand`` is a stochastic compressor's draw.

    matching:  r ~ probs;  q = Q(x - H_r);  H_r += send_r . q;
               x += gamma * v_r . (H_r[src_r] - H_r)
    linkfail:  q = Q(x - x_hat);  x_hat += q;  m ~ edge mask;
               x += gamma * (W_m - I) x_hat
    """
    x = state.x
    dev = x.device
    if sample is None:
        sample = process.sample(seed, t)
    if process.kind == "matching":
        H = state.refs.clone()
        r = int(sample)
        q = compressor.apply(x - H[r], rand)
        send = torch.tensor(process.round_send[r], dtype=torch.float32,
                            device=dev)[:, None]
        Hr = H[r] + send * q
        H[r] = Hr
        src = torch.tensor(process.round_src[r], device=dev)
        v = torch.tensor(process.branch_recv[r], dtype=torch.float32,
                         device=dev)[:, None]
        x = x + gamma * v * (Hr[src, :] - Hr)
        return ProcessGossipState(x, H)
    if process.kind == "linkfail":
        x_hat = state.refs + compressor.apply(x - state.refs, rand)
        W = process.sample_matrix(seed, t, sample).to(dev)
        eye = torch.eye(process.n, dtype=W.dtype, device=dev)
        x = x + gamma * (W - eye) @ x_hat
        return ProcessGossipState(x, x_hat)
    raise ValueError(process.kind)


def run_choco_gossip_process(x0: torch.Tensor, process: TopologyProcess,
                             gamma: float, compressor, steps: int, *,
                             seed: int = 0,
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[Callable[[int], object]] = None,
                             samples: Optional[Callable[[int], object]] = None):
    """``steps`` single-round exchanges under the process, the trainer's
    seed plumbing (exchange seed ``fold_seed(seed, step)``, gossip round
    0).  ``draws(step)`` / ``generator`` give a stochastic compressor's
    draws, ``samples(step)`` the sample of each step instead of the
    seed's.  Returns (final state, per-step consensus errors)."""
    from repro_torch.core.choco_gossip import consensus_error, round_draw
    xbar = torch.mean(x0, dim=0, keepdim=True)
    st = init_process_state(x0, process)
    errs = []
    for step in range(steps):
        rand = round_draw(compressor, st.x, step, generator, draws)
        st = choco_process_round(
            st, process, gamma, compressor, fold_seed(seed, step), t=0,
            rand=rand, sample=None if samples is None else samples(step))
        errs.append(consensus_error(st.x, xbar))
    return st, torch.stack(errs) if errs else x0.new_zeros((0,))
