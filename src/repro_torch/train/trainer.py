"""Decentralized trainer: CHOCO-SGD and its exact baselines with the n
gossip nodes on one device, or one node per process.

One train step (Algorithm 2, the JAX package's serial ``train_step``):

    per-node gradient   (one batched forward/backward over the nodes held)
 -> local optimizer half-step x^{t+1/2}
 -> exchange (comm/gossip.py), by ``mode``: ``choco``, the CHOCO gossip
    of the compressed deltas; ``plain``, exact neighbour averaging (D-SGD);
    ``allreduce``, the exact average over all nodes

Without a ``group`` the trainer holds all n nodes, stacked, and runs the
stacked exchange.  With a ``group`` (``launch/mesh.py:NodeGroup``) it is
one rank of n, holds node ``group.rank`` only, as ``(1, size)`` buffers
(so every bucket routine is the stacked engine's), and runs the per-rank
exchange; the step's metrics cross the ranks in a small all-reduce of
host floats.

State lives in the gossip engine's bucket space: the parameters x, the
public copies x_hat, the neighbour aggregates s and the optimizer's
moments are lists of node-stacked ``(n, bucket.size)`` buffers, and the
model reads its parameters as views into the x buffers.  So the gradient
comes back in bucket layout, the optimizer and the exchange run on whole
buckets, and nothing is packed or unpacked per step.  x and the moments
are f32; x_hat and s are in ``ChocoConfig.state_dtype`` (f32 or bf16).
Under choco the bucket spec is built from leaves of that dtype, as the
JAX engine builds it from the x_hat leaves, and x keeps its layout in
f32.  The exact modes never read x_hat and s: where the JAX state keeps
them as zeros, this one leaves them unallocated (None), which saves two
copies of the parameters.

The pipelined step (``ChocoConfig.pipeline_gossip``, the JAX trainer's
``pipelined_step``, ``src/repro/train/trainer.py:560-605``) runs in two
phases with no data dependency between them:

1. the exchange on the pre-gradient iterate: a copy G of x_k goes
   through the pipelined exchange, G = x_k + gamma (s_k - x_hat_k), and
   x_hat and s advance;
2. the gradient at x_k (the model reads x itself) and the optimizer's
   half-step, which the optimizer leaves in the gradient's buffers
   (``keep_params``), so x_k stays;

then the merge ``x_{k+1} = G + (x_half - x_k)``, in that association.  On
the card the stacked engine issues phase 2 on the current stream, then
phase 1 on a side CUDA stream that waits only for x_k, and the merge
after an event of the side stream: the exchange runs beside what is left
of the forward, backward and optimizer passes (top_k's host syncs then
wait on the side stream alone).  Issued in that order, the exchange's
temporaries are allocated once phase 2's activations are freed on the
host's side; issued first from a host thread of its own, the side stream
hid more of top_k's exchange but raised the step's peak by 5 to 7 GiB.
Nothing on the side stream writes x, and the side stream's temporaries
are made and freed there.  G is one more f32 copy of x.  The per-rank
engine and the CPU run the phases one after the other, with the same
arithmetic.

The slice: the choco, plain and allreduce modes, every symmetric
topology of the JAX registry and time-varying sequences of them, f32
or bf16 EF state, every compressor of the JAX package (with the exact
small-leaf bucket) and the Theorem-2 gamma under choco, the packed and
the per-leaf engine, each serial or pipelined, the sgd,
momentum and AdamW local steps, naive attention (the flash kernel has no
backward), and checkpoints in the JAX package's sharded format
(``save_checkpoint``, ``restore_checkpoint`` with its elastic restore,
``consensus_warmup``).
Under a stochastic topology process (``ChocoConfig.topology_process``
"matching", "linkfail" or "staleness", ``comm/stochastic.py``) the choco
exchange is the replica engine and x_hat and s are lists of bucket
lists, as the JAX ``TrainState`` holds lists of trees: matching keeps the
R per-round own references in x_hat and the R source replicas in s, link
failures one x_hat and R replicas in s (R the schedule's rounds), bounded
staleness (``max_staleness`` tau, the straggler links) the public copy
and its depth-tau ring of own increments in x_hat (1 + tau) and the R
replicas, then the R receive rings, in s (R (1 + tau)); the plain mode
averages with the sampled matrix and keeps none (staleness refuses it).
Gamma is then the scalar Theorem-2 value at the expected matrix's
(delta, beta) and the process's effective omega.  A fixed gamma is not
ported.

The push-sum mode (``mode="pushsum"``, JAX ``comm/pushsum.py``) runs the
directed graphs (``directed_ring``, ``random_digraph``; a symmetric graph
too, through its symmetric schedule) on the packed engine only, with one
schedule, no topology process and no pipelining, as the JAX trainer:
the state adds the weight column ``TrainState.psw`` ((n, 1) f32, ones);
the gradient is taken at the de-biased z = x / w (a copy of x for the
length of the gradient) but is the gradient with respect to z, not
through the division; the optimizer's half-step updates x, and the
push-sum exchange (``make_pushsum_exchange``) takes (x, x_hat, s, w).
Gamma is the scalar Theorem-2 value at A's (delta, beta) and the worst
bucket's omega.

Gamma follows the JAX trainer: the packed engine takes per-bucket
Theorem-2 values (``GammaSpec``), the per-leaf engine one scalar at
``compressor.omega(1 << 20)``; the pipelined engine reads (delta, beta)
and omega / 2 of its delay-1 surrogate, a ``StalenessProcess`` with
``delay_probs=(0, 1)`` (``comm/pipelined.py``).

Checkpoints hold the JAX ``TrainState``'s leaves under its flat keys
(``params__embed__tok``, ``x_hat__...``, ``s__...``, ``opt__mu__...``,
``opt__nu__...``, ``opt__count``, ``step``, ``key``, and under push-sum
``psw``), node-stacked with
the JAX shapes and dtypes, so each package restores the other's: a save
unpacks each leaf from the buckets and streams it to disk node row by
node row; a restore packs the leaves into zeroed buckets, so the padding
stays zero.  The exact modes write the zero x_hat and s leaves the JAX
state holds (from the host) and drop them on restore.  The JAX ``key``
(threefry, two uint32 words) and the port's ``TrainState.seed`` are one
number: the port writes ``[seed >> 32, seed & 0xffffffff]``, what
``jax.random.PRNGKey(seed)`` holds, and reads a key back as that seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed

from repro_torch.comm.gossip import (_pack_align, make_allreduce_exchange,
                                     make_choco_exchange,
                                     make_dist_allreduce_exchange,
                                     make_dist_choco_exchange,
                                     make_dist_plain_exchange,
                                     make_dist_process_exchange,
                                     make_plain_exchange,
                                     make_process_exchange)
from repro_torch.comm.packing import (bucket_omega_worst, fold_seed,
                                      leaf_route, make_bucket_spec,
                                      pack_leaves, unpack_leaves)
from repro_torch.comm.pipelined import pipeline_delay_process
from repro_torch.comm.pushsum import (debias, make_dist_pushsum_exchange,
                                      make_pushsum_exchange)
from repro_torch.checkpoint.checkpointing import (LegacyStore, Leaf, Part,
                                                  ShardStore, flat_key,
                                                  save_sharded, storage_tensor)
from repro_torch.checkpoint.elastic import (consensus_warmup_rounds,
                                            elastic_ratio, mean_rows,
                                            source_rows)
from repro_torch.checkpoint.manifest import (ElasticRestoreError, LeafSpec,
                                             Manifest, read_manifest,
                                             storage_dtype, validate_tree)
from repro_torch.comm.schedule import (compile_directed_schedule,
                                       compile_schedules)
from repro_torch.comm.stochastic import PROCESS_KINDS, make_topology_process
from repro_torch.configs.base import (STATE_DTYPES, ChocoConfig,
                                      parse_delay_probs,
                                      parse_straggler_edges, parse_topology)
from repro_torch.core.choco_gossip import GammaSpec, theorem2_stepsize
from repro_torch.core.compression import make_compressor
from repro_torch.core.topology import is_directed, make_topology
from repro_torch.models.transformer import Model, param_shapes
from repro_torch.optim.sgd import OptState

#: the exchange modes of the JAX trainer, all of which the port runs
MODES = ("choco", "plain", "allreduce", "pushsum")
#: the modes that compress (and keep the EF state x_hat and s)
_COMPRESSED = ("choco", "pushsum")

#: fingerprint entries of JAX ``ChocoConfig`` settings the port does not
#: have, at the JAX defaults a port run stands for
_UNPORTED_FINGERPRINT = {"pack_align": None, "small_leaf_threshold": 8192}
#: the fingerprint entries whose change re-mixes the EF state (the JAX
#: restore's compression and packing fingerprint)
_COMPRESSION_KEYS = ("compressor", "compressor_config", "packed_gossip",
                     "pack_align", "pipeline_gossip", "exact_small_leaves",
                     "small_leaf_threshold")
#: salts the warmup's draws apart from every training step's, as the JAX
#: trainer folds 0x5EED into its key
WARMUP_SALT = 0x5EED
_WORD = (1 << 32) - 1


def key_words(seed: int) -> Tuple[int, int]:
    """The JAX key of ``seed``: ``jax.random.PRNGKey(seed)``'s two words."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a 64-bit JAX key")
    return (seed >> 32) & _WORD, seed & _WORD


def seed_of_key(words) -> int:
    """The seed whose JAX key is ``words`` (the inverse of key_words)."""
    hi, lo = (int(w) for w in words)
    return (hi << 32) | lo


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    return dev


@dataclasses.dataclass
class TrainState:
    x: List[torch.Tensor]                 # parameters x_i, in bucket space
    x_hat: Optional[list]                 # public copies (None off choco;
                                          #   under matching R lists)
    s: Optional[list]                     # weighted neighbour aggregates
                                          #   (None off choco; under a
                                          #   process the R replicas)
    opt: OptState                         # the optimizer's moments
    step: int = 0
    seed: int = 0                # salts the compressors' draws every step;
                                 #   the checkpoint's JAX key (key_words)
    psw: Optional[torch.Tensor] = None    # push-sum's (n, 1) f32 weight
                                          #   column; None off push-sum


@dataclasses.dataclass
class DecentralizedTrainer:
    model: Model
    choco: ChocoConfig
    n_nodes: int
    optimizer: object
    lr_fn: Callable[[int], float]
    device: object = "cuda"
    #: this process's rank in the per-rank engine; None: all nodes here
    group: Optional[object] = None
    mode: str = "choco"          # choco | plain | allreduce | pushsum

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r} is not a mode; choose "
                             f"from {', '.join(MODES)}")
        if self.model.cfg.attn_impl != "naive":
            raise ValueError(
                f"attn_impl={self.model.cfg.attn_impl!r} cannot train: the "
                f"flash-attention kernel has no backward yet; use \"naive\"")
        if self.group is None:
            self.device = resolve_device(self.device)
            self.nodes = tuple(range(self.n_nodes))
        else:                   # the exchange checks the group's size
            self.device = self.group.device
            self.nodes = (self.group.rank,)
        names = parse_topology(self.choco.topology)
        self._check_pushsum(names)
        # as in the JAX trainer: choco and push-sum compress
        self.compressor = (make_compressor(self.choco.compressor,
                                           **self.choco.comp_dict())
                           if self.mode in _COMPRESSED else None)
        # as on a JAX mesh without a pod axis (the port's is always Nx1)
        self.topologies = tuple(make_topology(name, self.n_nodes)
                                for name in names)
        self.schedules = (
            (compile_directed_schedule(self.topologies[0]),)
            if any(map(is_directed, names))
            else compile_schedules(self.topologies))
        if (len(self.schedules) > 1
                and self.choco.gossip_steps % len(self.schedules) != 0):
            raise ValueError(
                f"topology={self.choco.topology!r} is a time-varying "
                f"sequence of {len(self.schedules)} graphs: gossip_steps "
                f"must be a multiple of the sequence length so every graph "
                f"runs each SGD step (got {self.choco.gossip_steps})")
        if self.choco.pipeline_gossip:
            # the JAX trainer's rules (src/repro/train/trainer.py:203-224)
            if self.mode != "choco":
                raise ValueError(
                    f"pipeline_gossip hides the COMPRESSED exchange behind "
                    f"the backward pass via the error-feedback recursion; "
                    f"mode={self.mode!r} has no (x_hat, s) carry to "
                    f"double-buffer; it requires mode='choco'")
            if len(self.schedules) > 1:
                raise ValueError(
                    f"pipeline_gossip needs one static schedule: a payload "
                    f"compressed under graph W_k but integrated a step "
                    f"later under W_{{k+1}} breaks the recursion (got "
                    f"time-varying topology={self.choco.topology!r})")
        self.process = self._make_process()
        if self.choco.state_dtype not in STATE_DTYPES:
            raise ValueError(f"state_dtype={self.choco.state_dtype!r} is not "
                             f"ported; choose from {', '.join(STATE_DTYPES)}")
        # the EF state's dtype under choco and push-sum; the exact modes
        # allocate no EF state and pack the parameters' own dtype
        self.state_dtype = (getattr(torch, self.choco.state_dtype)
                            if self.mode in _COMPRESSED
                            else self.model.param_dtype)
        self.paths = [p for p, _ in param_shapes(self.model.cfg)]
        shapes = dict(param_shapes(self.model.cfg))
        spec_of = lambda exact: make_bucket_spec(
            [torch.empty(shapes[p], dtype=self.state_dtype, device="meta")
             for p in self.paths],
            align=_pack_align(self.compressor), exact_small_leaves=exact,
            routes=[leaf_route(p) for p in self.paths])
        # the JAX process and push-sum engines pack without exact buckets
        # (their gamma still takes the omega of the trainer's spec, exact
        # buckets and all)
        unexact = ((self.process is not None and self.mode == "choco")
                   or self.mode == "pushsum")
        self.spec = spec_of(self.choco.exact_small_leaves and not unexact)
        dist = self.group is not None
        kw = dict(spec=self.spec, schedules=self.schedules,
                  gossip_steps=self.choco.gossip_steps)
        if self.mode == "allreduce":
            self.gamma = 1.0             # the JAX trainer's, off choco
            self.exchange = (
                make_dist_allreduce_exchange(spec=self.spec, n=self.n_nodes,
                                             group=self.group)
                if dist else make_allreduce_exchange(spec=self.spec,
                                                     n=self.n_nodes))
        elif self.mode == "plain":
            self.gamma = 1.0
            kw["process"] = self.process
            self.exchange = (make_dist_plain_exchange(**kw, group=self.group)
                             if dist else make_plain_exchange(**kw))
        elif self.mode == "pushsum":
            # the JAX trainer's scalar at A's (delta, beta) and the worst
            # omega of its own spec (exact buckets and all), no GammaSpec
            omega = bucket_omega_worst(
                spec_of(self.choco.exact_small_leaves), self.compressor)
            self.gamma = theorem2_stepsize(
                min(t.delta for t in self.topologies),
                max(t.beta for t in self.topologies), omega)
            pkw = dict(spec=self.spec, schedule=self.schedules[0],
                       compressor=self.compressor, gamma=self.gamma,
                       gossip_steps=self.choco.gossip_steps)
            self.exchange = (make_dist_pushsum_exchange(**pkw,
                                                        group=self.group)
                             if dist else make_pushsum_exchange(**pkw))
        elif self.process is not None:
            # the JAX trainer's: the scalar at the expected (delta, beta),
            # omega the worst bucket's of its own spec (no GammaSpec)
            packed = self.choco.packed_gossip
            delta, beta = self.process.expected_delta_beta()
            omega = (bucket_omega_worst(spec_of(self.choco.exact_small_leaves),
                                        self.compressor) if packed
                     else self.compressor.omega(1 << 20))
            self.gamma = theorem2_stepsize(
                delta, beta, self.process.effective_omega(omega))
            pkw = dict(spec=self.spec, process=self.process,
                       compressor=self.compressor, gamma=self.gamma,
                       gossip_steps=self.choco.gossip_steps, packed=packed)
            self.exchange = (make_dist_process_exchange(**pkw,
                                                        group=self.group)
                             if dist else make_process_exchange(**pkw))
        else:
            # Theorem-2 consensus stepsize: the scalar worst case for
            # logging, and per-bucket values (each bucket at its own omega)
            # for the packed engine, the scalar for the per-leaf one; a
            # time-varying sequence takes the worst (delta, beta), the
            # pipelined engine its tau = 1 surrogate's
            packed = self.choco.packed_gossip
            pipelined = self.choco.pipeline_gossip
            omega_scale = 1.0
            if pipelined:
                surrogate = pipeline_delay_process(self.schedules[0])
                delta, beta = surrogate.expected_delta_beta()
                omega_scale = surrogate.effective_omega(1.0)
            else:
                delta = min(t.delta for t in self.topologies)
                beta = max(t.beta for t in self.topologies)
            omega = (bucket_omega_worst(self.spec, self.compressor) if packed
                     else self.compressor.omega(1 << 20))
            self.gamma = theorem2_stepsize(delta, beta, omega * omega_scale)
            kw.update(compressor=self.compressor, packed=packed,
                      pipelined=pipelined,
                      gamma=(GammaSpec(delta=delta, beta=beta,
                                       omega_scale=omega_scale)
                             if packed else self.gamma))
            self.exchange = (make_dist_choco_exchange(**kw, group=self.group)
                             if dist else make_choco_exchange(**kw))

    def _check_pushsum(self, names) -> None:
        """The JAX trainer's and exchange's rules for directed graphs and
        the push-sum mode (``src/repro/train/trainer.py:85-98``,
        ``src/repro/comm/gossip.py:961-969``)."""
        directed = [n for n in names if is_directed(n)]
        if directed and self.mode != "pushsum":
            raise ValueError(
                f"topology={self.choco.topology!r} is directed "
                f"(column-stochastic): the symmetric {self.mode!r} engine "
                f"would average with a non-row-stochastic matrix and "
                f"converge to a Perron-biased point, not the mean.  Directed "
                f"graphs require the push-sum engine: mode='pushsum' "
                f"(comm/pushsum.py, de-biased x/w).")
        if self.mode != "pushsum":
            return
        if len(names) != 1:
            raise ValueError(
                f"push-sum runs one directed schedule; time-varying "
                f"sequences are not supported (got topology="
                f"{self.choco.topology!r})")
        if not self.choco.packed_gossip:
            raise ValueError("the push-sum engine is packed-only (the weight "
                             "scalar rides in-band with the bucket payloads); "
                             "per-leaf push-sum is not implemented")

    def _make_process(self):
        """The topology process over the compiled schedule, with the JAX
        trainer's and exchange's refusals, or None."""
        kind = self.choco.topology_process
        c = self.choco
        stragglers = c.straggler_edges is not None \
            or c.straggler_delay_probs is not None
        if kind is None:
            if stragglers:
                raise ValueError(
                    "straggler edges model per-edge DELAYS - they require "
                    "topology_process='staleness', got no topology process")
            return None
        if kind not in PROCESS_KINDS:
            raise ValueError(f"unknown topology process {kind!r}; have "
                             f"('matching', 'linkfail', 'staleness')")
        if self.mode not in ("choco", "plain"):
            raise ValueError(
                f"topology processes run on the choco/plain engines only; "
                f"mode={self.mode!r} (the push-sum engine handles directed "
                f"graphs itself, allreduce has no gossip graph)")
        if self.choco.pipeline_gossip:
            raise ValueError(
                f"pipeline_gossip is itself a deterministic delay-1 "
                f"staleness process; stacking topology_process={kind!r} on "
                f"top would compound two delay models with no Theorem-2 "
                f"gamma for the composite - run one or the other")
        if len(self.schedules) > 1:
            raise ValueError(
                "a topology process already IS the per-step mixing "
                "distribution; combining it with a time-varying schedule "
                "sequence is ambiguous - pass one or the other")
        if kind == "staleness" and self.mode != "choco":
            raise ValueError(
                f"topology_process='staleness' runs on the compressed "
                f"choco engine only (mode={self.mode!r}): the stale "
                f"snapshots are reconstructed from rings of compressed "
                f"increments - the plain engine ships fresh iterates "
                f"with no increment stream to ring-buffer")
        edges = sprobs = None
        if stragglers:
            if kind != "staleness":
                raise ValueError(
                    f"straggler edges model per-edge DELAYS - they require "
                    f"topology_process='staleness', got {kind!r}")
            if c.straggler_edges is None:
                raise ValueError("straggler_delay_probs given without "
                                 "straggler_edges")
            edges = parse_straggler_edges(c.straggler_edges)
            if c.straggler_delay_probs is not None:
                sprobs = parse_delay_probs(c.straggler_delay_probs)
        return make_topology_process(
            kind, self.schedules[0], matching_sampler=c.matching_sampler,
            edge_drop_prob=c.edge_drop_prob, max_staleness=c.max_staleness,
            straggler_edges=edges, straggler_delay_probs=sprobs)

    def ef_layout(self) -> Tuple[Optional[int], Optional[int]]:
        """How many bucket lists x_hat and s hold: None for one (the static
        engine), a count for a list of that many (the replica engine:
        matching (R, R), link failures (None, R), bounded staleness
        (1 + tau, R (1 + tau)): the public copy and the own ring, then the
        R replicas and the R receive rings); (None, None) too under
        push-sum and in the exact modes, which allocate none."""
        if self.process is None or self.mode != "choco":
            return None, None
        R = self.process.schedule.n_rounds
        if self.process.kind == "staleness":
            depth = 1 + self.process.max_staleness
            return depth, R * depth
        return (R if self.process.kind == "matching" else None), R

    def effective_staleness(self) -> int:
        """The staleness bound the state's layout depends on: tau under
        the staleness process, else 0 (JAX ``_effective_staleness``)."""
        return (self.choco.max_staleness
                if self.choco.topology_process == "staleness" else 0)

    # -- state ----------------------------------------------------------------

    def state_from_params(self, params: Dict[str, torch.Tensor],
                          seed: int = 0) -> TrainState:
        """Training state from node-stacked parameters ``path -> (n, ...)``
        of the nodes this trainer holds (e.g.
        ``repro_torch.convert.params_from_jax``; one rank holds one row):
        x packed into buckets, the optimizer's moments zero, and under
        choco and push-sum x_hat and s zero (None in the exact modes);
        under push-sum the weight column w ones."""
        leaves = [params[p].to(self.device) for p in self.paths]
        if leaves[0].shape[0] != len(self.nodes):
            raise ValueError(f"params hold {leaves[0].shape[0]} nodes, the "
                             f"trainer {len(self.nodes)}")
        x = pack_leaves(self.spec, leaves, dtype=self.model.param_dtype)
        del leaves
        zeros = lambda: ([torch.zeros_like(b, dtype=self.state_dtype)
                          for b in x] if self.mode in _COMPRESSED else None)
        listed = lambda count: (zeros() if count is None
                                else [zeros() for _ in range(count)])
        n_hat, n_s = self.ef_layout()
        psw = (torch.ones((len(self.nodes), 1), dtype=torch.float32,
                          device=self.device)
               if self.mode == "pushsum" else None)
        return TrainState(x=x, x_hat=listed(n_hat), s=listed(n_s),
                          opt=self.optimizer.init(x), seed=seed, psw=psw)

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh state from the model's random init under ``seed``."""
        return self.state_from_params(
            self.model.init(self.n_nodes, seed, self.device, self.nodes),
            seed=seed)

    def params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Node-stacked parameter views ``path -> (n, ...)`` into state.x."""
        return dict(zip(self.paths, unpack_leaves(self.spec, state.x)))

    # -- step -----------------------------------------------------------------

    def batch_to_device(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def step(self, state: TrainState, batch,
             draws: Optional[Callable[[int, int], torch.Tensor]] = None,
             samples: Optional[Callable[[int], object]] = None
             ) -> Dict[str, float]:
        """One training step, in place on ``state``.  ``draws(t, b)``
        optionally injects the choco compressor's draw for gossip round t,
        bucket b (``comm/packing.py:draw`` says what each one draws) for
        the nodes this trainer holds; under a topology process
        ``samples(t)`` injects the sample of gossip round t (a round index
        or an edge mask) instead of the one the step's seed draws.  On the
        per-rank engine the metrics
        add this rank's ``wire_bytes`` (counted: the payloads it sent) and
        ``wire_bytes_modelled`` (the ring all-reduce's bytes, a model, in
        allreduce mode)."""
        sent = (None if self.group is None else
                (self.group.bytes_sent, self.group.bytes_modelled))
        if self.mode == "choco" and self.choco.pipeline_gossip:
            losses, grad_sq, lr = self._pipelined_step(state, batch, draws)
        else:
            losses, grads = self._gradient(state, batch)
            with torch.no_grad():
                grad_sq = sum(torch.sum(torch.square(g)) for g in grads)
                lr = self.lr_fn(state.step)
                state.opt = self.optimizer.update(state.x, grads, state.opt,
                                                  lr)
                del grads          # frees a state-sized copy for the exchange
                seed = fold_seed(state.seed, state.step)
                if self.mode == "pushsum":
                    self.exchange(state.x, state.x_hat, state.s, state.psw,
                                  seed=seed, draws=draws)
                else:
                    self.exchange(state.x, state.x_hat, state.s, seed=seed,
                                  draws=draws, **self._sampled(samples))
        state.step += 1
        losses = losses.detach()
        if self.group is None:
            return {"loss": float(losses.mean()), "lr": lr,
                    "grad_norm": float(torch.sqrt(grad_sq)),
                    "node_loss_spread": float(losses.max() - losses.min())}
        # the JAX trainer's global norm and loss spread, across the ranks
        loss = float(losses[0])
        total, sq = self.group.all_reduce_host(
            [loss, float(grad_sq)], torch.distributed.ReduceOp.SUM)
        top, neg_low = self.group.all_reduce_host(
            [loss, -loss], torch.distributed.ReduceOp.MAX)
        return {"loss": total / self.n_nodes, "lr": lr,
                "grad_norm": math.sqrt(sq), "node_loss_spread": top + neg_low,
                "wire_bytes": self.group.bytes_sent - sent[0],
                "wire_bytes_modelled": self.group.bytes_modelled - sent[1]}

    def _sampled(self, samples) -> dict:
        """The exchange's ``samples`` keyword, under a process only."""
        return {} if self.process is None else {"samples": samples}

    def _gradient(self, state: TrainState, batch):
        """(per-node losses, gradients in bucket layout) at state.x, or
        under push-sum at z = x / w: the gradient with respect to z (the
        JAX trainer's, not through the division, which would scale node
        i's step by 1/w_i), z a copy of x freed on return."""
        at = state.x
        if self.mode == "pushsum":
            with torch.no_grad():
                at = [debias(b, state.psw) for b in state.x]
        for b in at:
            b.requires_grad_(True)
        losses = self.model.loss(
            dict(zip(self.paths, unpack_leaves(self.spec, at))), batch)
        grads = list(torch.autograd.grad(losses.sum(), at))     # (n,) losses
        for b in at:
            b.requires_grad_(False)
        # detached: the graph behind losses holds its leaves (z under
        # push-sum, a state-sized copy) as long as losses lives
        return losses.detach(), grads

    def _side_stream(self):
        """The stacked engine's side CUDA stream for the pipelined
        exchange (None on the CPU and per rank: the phases run in turn)."""
        if self.group is not None or self.device.type != "cuda":
            return None
        if getattr(self, "_stream", None) is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _pipelined_step(self, state: TrainState, batch, draws):
        """The two phases and the merge of the module docstring, in place
        on ``state`` (its step not advanced).  Returns (losses, the
        squared gradient norm, lr)."""
        side = self._side_stream()
        main = None if side is None else torch.cuda.current_stream(
            self.device)
        with torch.no_grad():
            g_bufs = [torch.empty_like(b) for b in state.x]
            x_ready = None if side is None else main.record_event()

        @torch.no_grad()
        def phase1():
            for g, b in zip(g_bufs, state.x):
                g.copy_(b)
            self.exchange(g_bufs, state.x_hat, state.s,
                          seed=fold_seed(state.seed, state.step), draws=draws)

        if side is None:                       # phase 1, then phase 2
            phase1()
        losses, halves = self._gradient(state, batch)
        with torch.no_grad():
            grad_sq = sum(torch.sum(torch.square(g)) for g in halves)
            lr = self.lr_fn(state.step)
            state.opt = self.optimizer.update(state.x, halves, state.opt, lr,
                                              keep_params=True)
            if side is not None:
                # phase 1 on the side stream, issued after phase 2 so that
                # its host syncs block nothing the main stream waits for
                side.wait_event(x_ready)
                with torch.cuda.stream(side):
                    phase1()
                main.wait_event(side.record_event())
            for x, half, g in zip(state.x, halves, g_bufs):
                torch.add(g, half.sub_(x), out=x)     # G + (x_half - x_k)
            del halves, g_bufs
        return losses, grad_sq, lr

    # -- checkpoints ------------------------------------------------------------

    def fingerprint(self) -> dict:
        """The manifest's fingerprint, with the JAX trainer's keys (a mesh
        of ``n x 1`` with the gossip on "data"; the features the port lacks
        at their JAX defaults), so each package tells a resume from an
        elastic restore in the other's checkpoints as in its own."""
        c = self.choco
        return {"mesh": {"data": self.n_nodes, "model": 1},
                "gossip_axes": ["data"], "n_nodes": self.n_nodes,
                "topology": c.topology, "gossip_steps": int(c.gossip_steps),
                "mode": self.mode, "compressor": c.compressor,
                "compressor_config": c.comp_dict(),
                "exact_small_leaves": bool(c.exact_small_leaves),
                "packed_gossip": bool(c.packed_gossip),
                "pipeline_gossip": bool(c.pipeline_gossip),
                "state_dtype": c.state_dtype,
                "topology_process": c.topology_process,
                "edge_drop_prob": float(c.edge_drop_prob),
                "matching_sampler": c.matching_sampler,
                "max_staleness": self.effective_staleness(),
                "straggler_edges": c.straggler_edges,
                "straggler_delay_probs": c.straggler_delay_probs,
                **_UNPORTED_FINGERPRINT}

    def _moments(self) -> Tuple[bool, bool]:
        """Whether the optimizer keeps a first and a second moment."""
        probe = self.optimizer.init([])
        return probe.mu is not None, probe.nu is not None

    def _groups(self, state: Optional[TrainState] = None
                ) -> List[Tuple[str, str, Optional[List[torch.Tensor]]]]:
        """(key prefix, dtype name, the state's buffers or None) of each
        node-stacked leaf group, in the JAX tree's order; a list of R
        bucket lists (the replica engine's x_hat or s) is R groups,
        ``x_hat__0`` to ``x_hat__{R-1}``, the JAX list's flat keys."""
        has_mu, has_nu = self._moments()
        x_dt = _dtype_name(self.model.param_dtype)
        get = lambda name: None if state is None else getattr(state, name)
        groups = [("params", x_dt, get("x"))]
        for name, count in zip(("x_hat", "s"), self.ef_layout()):
            bufs = get(name)
            if count is None:
                groups.append((name, self.choco.state_dtype, bufs))
            else:
                groups += [(f"{name}__{r}", self.choco.state_dtype,
                            None if bufs is None else bufs[r])
                           for r in range(count)]
        if has_mu:
            groups.append(("opt__mu", x_dt, None if state is None
                           else state.opt.mu))
        if has_nu:
            groups.append(("opt__nu", x_dt, None if state is None
                           else state.opt.nu))
        return groups

    def _leaf_order(self) -> List[Tuple[str, object]]:
        """(path, slot) of each parameter in the JAX tree's (sorted) order."""
        slots = dict(zip(self.paths, self.spec.slots))
        return [(p, slots[p]) for p in
                sorted(self.paths, key=lambda p: tuple(p.split("/")))]

    def state_leaf_specs(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """``{flat key: (global shape, dtype)}`` of the JAX TrainState this
        trainer's state stands for (the JAX ``tree_leaf_specs`` of its
        ``state_shape()``): the restore's target."""
        specs = {}
        for prefix, dtype, _ in self._groups():
            for path, slot in self._leaf_order():
                specs[flat_key(prefix, path)] = ((self.n_nodes,) + slot.shape,
                                                 dtype)
        specs.update({"opt__count": ((), "int32"), "step": ((), "int32"),
                      "key": ((2,), "uint32")})
        if self.mode == "pushsum":
            specs["psw"] = ((self.n_nodes, 1), "float32")
        return specs

    def _leaves(self, state: TrainState) -> Iterator[Leaf]:
        """The state's leaves with the node rows this trainer holds, each
        row a view into its bucket (zeros made on the host for the exact
        modes' x_hat and s); the scalars on the stacked engine and rank 0."""
        def rows(bufs, slot, dtype):
            for r, node in enumerate(self.nodes):
                data = (np.zeros((1,) + slot.shape,
                                 np.dtype(storage_dtype(dtype)))
                        if bufs is None else bufs[slot.bucket][
                            r:r + 1, slot.offset:slot.offset + slot.size
                        ].view((1,) + slot.shape))
                yield Part([node] + [0] * len(slot.shape),
                           [node + 1] + list(slot.shape), data)

        for prefix, dtype, bufs in self._groups(state):
            for path, slot in self._leaf_order():
                yield Leaf(flat_key(prefix, path), (self.n_nodes,) + slot.shape,
                           dtype, rows(bufs, slot, dtype))
        first = self.group is None or self.group.rank == 0
        for key, dtype, value in (
                ("opt__count", "int32", state.opt.count),
                ("step", "int32", state.step),
                ("key", "uint32", key_words(state.seed))):
            arr = np.asarray(value, dtype=np.dtype(dtype))
            yield Leaf(key, arr.shape, dtype,
                       [Part([0] * arr.ndim, list(arr.shape), arr)]
                       if first else [])
        if state.psw is not None:
            # node-sharded like the parameters (JAX P(gossip, None))
            yield Leaf("psw", (self.n_nodes, 1), "float32",
                       [Part([node, 0], [node + 1, 1], state.psw[r:r + 1])
                        for r, node in enumerate(self.nodes)])

    def save_checkpoint(self, path: str, state: TrainState,
                        metadata: Optional[dict] = None,
                        keep_last: Optional[int] = None) -> str:
        """Save the whole state (x, x_hat and s, which Theorem 2 needs
        across restarts, and the optimizer's moments) as a sharded
        checkpoint in the JAX format.  On the per-rank engine every rank
        writes its own row, then, after a barrier, rank 0 the manifest.
        ``keep_last``: then delete all but the newest ``keep_last``
        checkpoints beside ``path``, never ``path``."""
        dist = self.group is not None
        return save_sharded(
            path, self._leaves(state), step=state.step,
            fingerprint=self.fingerprint(), metadata=metadata or {},
            keep_last=keep_last,
            process_index=self.group.rank if dist else 0,
            process_count=self.group.size if dist else 1,
            barrier=self.group.barrier if dist else None)

    def restore_checkpoint(self, path: str
                           ) -> Tuple[TrainState, Manifest, int]:
        """Restore a sharded checkpoint (the port's or the JAX package's),
        reading only the node rows this trainer holds.  Returns (state,
        manifest, warmup rounds), deciding as the JAX trainer does:

        * same node count, and under choco and push-sum the same graph and
          compression fingerprint: resume-exact, 0 rounds;
        * under push-sum anything else raises ``ElasticRestoreError``, as
          in JAX: the weight column holds conserved mass, 1^T w = n;
        * another node count: rows remapped by the elastic policy (a
          resize it cannot map fails first), x_hat and s zero, and the
          warmup rounds of the new graph's spectral gap;
        * same count, another graph or compression: x_hat and s zero, and
          the warmup rounds;
        * the exact modes: 0 rounds."""
        man = read_manifest(path)
        fp, mine = man.fingerprint, self.fingerprint()
        n_old = man.n_nodes
        same_nodes = n_old is None or n_old == self.n_nodes
        same = (fp.get("topology", mine["topology"]) == mine["topology"]
                and fp.get("topology_process") == mine["topology_process"]
                and fp.get("max_staleness", 0) == self.effective_staleness()
                and all(fp.get(k, mine[k]) == mine[k]
                        for k in _COMPRESSION_KEYS))
        if self.mode == "pushsum" and not (same_nodes and same):
            raise ElasticRestoreError(
                f"elastic restore is not supported for push-sum: the weight "
                f"column w encodes conserved mass (1^T w = n) that a node-"
                f"count or graph change would corrupt (checkpoint "
                f"n_nodes={n_old}, topology={fp.get('topology')!r} -> "
                f"n_nodes={self.n_nodes}, topology={self.choco.topology!r})")
        exact = same_nodes and (self.mode != "choco" or same)
        remap = None
        if not same_nodes:
            elastic_ratio(n_old, self.n_nodes)     # fail fast on a bad resize
            remap = (n_old, self.n_nodes)
        reset = () if exact else ("x_hat", "s")
        expected = self.state_leaf_specs()
        validate_tree(man.leaves, expected, node_remap=remap,
                      reset_prefixes=reset)
        with ShardStore(path) as store:
            state = self._read_state(store, man.leaves, remap, reset)
        if exact or self.mode != "choco":
            return state, man, 0
        # the warmup contracts at the graph it runs on: the process's
        # expected eigengap, as the JAX trainer takes it
        delta = (self.process.expected_delta_beta()[0]
                 if self.process is not None
                 else min(t.delta for t in self.topologies))
        return state, man, consensus_warmup_rounds(delta)

    def restore_legacy(self, path: str) -> TrainState:
        """Restore a legacy flat npz (the JAX ``save_pytree`` format: whole
        leaves, bf16 widened to f32) with this trainer's node count,
        reading only the node rows this trainer holds."""
        expected = self.state_leaf_specs()
        leaves = {k: LeafSpec(tuple(shape), dtype, storage_dtype(dtype))
                  for k, (shape, dtype) in expected.items()}
        with LegacyStore(path, expected) as store:
            return self._read_state(store, leaves, None, ())

    def _read_state(self, store, leaves: Dict[str, LeafSpec], remap, reset
                    ) -> TrainState:
        """The state read from ``store`` (``read_region`` of a
        ``ShardStore``; ``leaves``: the saved leaf specs, validated) into
        zeroed buckets on this trainer's device: node rows remapped by
        ``remap`` = (n_old, n_new), the groups in ``reset`` left zero."""
        def row(key, slot, node):
            leaf = leaves[key]
            rows = [store.read_region(key, [i] + [0] * len(slot.shape),
                                      [i + 1] + list(slot.shape),
                                      leaf.storage)
                    for i in ((node,) if remap is None
                              else source_rows(node, *remap))]
            if len(rows) == 1:
                return storage_tensor(rows[0], leaf.dtype)
            # the shrink's strided mean, in f32
            mean = mean_rows([storage_tensor(a, leaf.dtype).float().numpy()
                              for a in rows])
            return torch.from_numpy(mean).to(getattr(torch, leaf.dtype))

        def read(prefix, dtype):
            bufs = [torch.zeros((len(self.nodes), b.size), dtype=dtype,
                                device=self.device)
                    for b in self.spec.buckets]
            if prefix.split("__", 1)[0] in reset:
                return bufs
            for path, slot in self._leaf_order():
                key = flat_key(prefix, path)
                for r, node in enumerate(self.nodes):
                    bufs[slot.bucket][r, slot.offset:slot.offset + slot.size] \
                        = row(key, slot, node).reshape(-1)
            return bufs

        def scalar(key):
            return store.read_region(key, [0] * len(leaves[key].shape),
                                     list(leaves[key].shape),
                                     leaves[key].storage)

        has_mu, has_nu = self._moments()
        f32 = self.model.param_dtype
        choco = self.mode in _COMPRESSED
        state_dt = getattr(torch, self.choco.state_dtype)

        def ef(name, count):
            if not choco:
                return None
            if count is None:
                return read(name, state_dt)
            return [read(f"{name}__{r}", state_dt) for r in range(count)]
        n_hat, n_s = self.ef_layout()
        return TrainState(
            x=read("params", f32), x_hat=ef("x_hat", n_hat),
            s=ef("s", n_s),
            opt=OptState(mu=read("opt__mu", f32) if has_mu else None,
                         nu=read("opt__nu", f32) if has_nu else None,
                         count=int(scalar("opt__count"))),
            step=int(scalar("step")), seed=seed_of_key(scalar("key")),
            psw=None if self.mode != "pushsum" else torch.from_numpy(
                np.concatenate([store.read_region("psw", [node, 0],
                                                  [node + 1, 1], "float32")
                                for node in self.nodes])).to(self.device))

    def consensus_warmup(self, state: TrainState, rounds: int,
                         draws: Optional[Callable[[int, int, int],
                                                  torch.Tensor]] = None,
                         samples: Optional[Callable[[int, int],
                                                    object]] = None
                         ) -> TrainState:
        """``rounds`` calls of the choco exchange on the current x with no
        gradient step, in place: they rebuild x_hat and s under the current
        mixing matrix and gamma after an elastic restore (under a process,
        through the replica engine).  The draws are salted with
        WARMUP_SALT apart from every training step's, as the JAX trainer
        salts its warmup; ``draws(r, t, b)`` injects round r's draw for
        gossip round t, bucket b, and ``samples(r, t)`` its sample."""
        if rounds <= 0 or self.mode != "choco":
            return state
        base = fold_seed(state.seed, WARMUP_SALT)
        for r in range(rounds):
            self.exchange(state.x, state.x_hat, state.s,
                          seed=fold_seed(base, r),
                          draws=None if draws is None
                          else (lambda t, b, r=r: draws(r, t, b)),
                          **self._sampled(
                              None if samples is None
                              else (lambda t, r=r: samples(r, t))))
        return state
