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
moments are lists of node-stacked ``(n, bucket.size)`` f32 buffers, and
the model reads its parameters as views into the x buffers.  So the
gradient comes back in bucket layout, the optimizer and the exchange run
on whole buckets, and nothing is packed or unpacked per step.  The exact
modes never read x_hat and s: where the JAX state keeps them as zeros,
this one leaves them unallocated (None), which saves two copies of the
parameters.

The slice: the choco, plain and allreduce modes, every symmetric
topology of the JAX registry and time-varying sequences of them, f32
state, every compressor of the JAX package (with the exact small-leaf
bucket) and the Theorem-2 gamma under choco, the sgd, momentum and
AdamW local steps, naive attention (the flash kernel has no backward).
The push-sum mode with the directed topologies, the processes and a
fixed gamma are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed

from repro_torch.comm.gossip import (_pack_align, make_allreduce_exchange,
                                     make_choco_exchange,
                                     make_dist_allreduce_exchange,
                                     make_dist_choco_exchange,
                                     make_dist_plain_exchange,
                                     make_plain_exchange)
from repro_torch.comm.packing import (bucket_omega_worst, fold_seed,
                                      leaf_route, make_bucket_spec,
                                      pack_leaves, unpack_leaves)
from repro_torch.comm.schedule import compile_schedules
from repro_torch.configs.base import ChocoConfig, parse_topology
from repro_torch.core.choco_gossip import GammaSpec, theorem2_stepsize
from repro_torch.core.compression import make_compressor
from repro_torch.core.topology import make_topology
from repro_torch.models.transformer import Model, param_shapes
from repro_torch.optim.sgd import OptState

#: the exchange modes of the JAX trainer that the port runs
MODES = ("choco", "plain", "allreduce")


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
    x_hat: Optional[List[torch.Tensor]]   # public copies (None off choco)
    s: Optional[List[torch.Tensor]]       # weighted neighbour aggregates
                                          #   (None off choco)
    opt: OptState                         # the optimizer's moments
    step: int = 0
    seed: int = 0                # salts the compressors' draws every step


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
    mode: str = "choco"          # choco | plain | allreduce

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r} is not ported; choose from "
                             f"{', '.join(MODES)} (push-sum is not ported)")
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
        # as in the JAX trainer: only choco compresses
        self.compressor = (make_compressor(self.choco.compressor,
                                           **self.choco.comp_dict())
                           if self.mode == "choco" else None)
        # as on a JAX mesh without a pod axis (the port's is always Nx1)
        self.topologies = tuple(make_topology(name, self.n_nodes)
                                for name in names)
        self.schedules = compile_schedules(self.topologies)
        if (len(self.schedules) > 1
                and self.choco.gossip_steps % len(self.schedules) != 0):
            raise ValueError(
                f"topology={self.choco.topology!r} is a time-varying "
                f"sequence of {len(self.schedules)} graphs: gossip_steps "
                f"must be a multiple of the sequence length so every graph "
                f"runs each SGD step (got {self.choco.gossip_steps})")
        self.paths = [p for p, _ in param_shapes(self.model.cfg)]
        shapes = dict(param_shapes(self.model.cfg))
        self.spec = make_bucket_spec(
            [torch.empty(shapes[p], dtype=self.model.param_dtype,
                         device="meta") for p in self.paths],
            align=_pack_align(self.compressor),
            exact_small_leaves=self.choco.exact_small_leaves,
            routes=[leaf_route(p) for p in self.paths])
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
            self.exchange = (make_dist_plain_exchange(**kw, group=self.group)
                             if dist else make_plain_exchange(**kw))
        else:
            # Theorem-2 consensus stepsize: the scalar worst case for
            # logging, and per-bucket values (each bucket at its own omega)
            # for the engine; a time-varying sequence takes the worst
            # (delta, beta).
            delta = min(t.delta for t in self.topologies)
            beta = max(t.beta for t in self.topologies)
            self.gamma = theorem2_stepsize(
                delta, beta, bucket_omega_worst(self.spec, self.compressor))
            kw.update(compressor=self.compressor,
                      gamma=GammaSpec(delta=delta, beta=beta))
            self.exchange = (make_dist_choco_exchange(**kw, group=self.group)
                             if dist else make_choco_exchange(**kw))

    # -- state ----------------------------------------------------------------

    def state_from_params(self, params: Dict[str, torch.Tensor],
                          seed: int = 0) -> TrainState:
        """Training state from node-stacked parameters ``path -> (n, ...)``
        of the nodes this trainer holds (e.g.
        ``repro_torch.convert.params_from_jax``; one rank holds one row):
        x packed into buckets, the optimizer's moments zero, and under
        choco x_hat and s zero (None in the exact modes)."""
        leaves = [params[p].to(self.device) for p in self.paths]
        if leaves[0].shape[0] != len(self.nodes):
            raise ValueError(f"params hold {leaves[0].shape[0]} nodes, the "
                             f"trainer {len(self.nodes)}")
        x = pack_leaves(self.spec, leaves)
        del leaves
        zeros = lambda: ([torch.zeros_like(b) for b in x]
                         if self.mode == "choco" else None)
        return TrainState(x=x, x_hat=zeros(), s=zeros(),
                          opt=self.optimizer.init(x), seed=seed)

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
             draws: Optional[Callable[[int, int], torch.Tensor]] = None
             ) -> Dict[str, float]:
        """One training step, in place on ``state``.  ``draws(t, b)``
        optionally injects the choco compressor's draw for gossip round t,
        bucket b (``comm/packing.py:draw`` says what each one draws) for
        the nodes this trainer holds.  On the per-rank engine the metrics
        add this rank's ``wire_bytes`` (counted: the payloads it sent) and
        ``wire_bytes_modelled`` (the ring all-reduce's bytes, a model, in
        allreduce mode)."""
        for b in state.x:
            b.requires_grad_(True)
        losses = self.model.loss(self.params(state), batch)     # (n,)
        grads = list(torch.autograd.grad(losses.sum(), state.x))
        with torch.no_grad():
            grad_sq = sum(torch.sum(torch.square(g)) for g in grads)
            lr = self.lr_fn(state.step)
            for b in state.x:
                b.requires_grad_(False)
            state.opt = self.optimizer.update(state.x, grads, state.opt, lr)
            del grads                  # frees a state-sized copy for the exchange
            sent = (None if self.group is None else
                    (self.group.bytes_sent, self.group.bytes_modelled))
            self.exchange(state.x, state.x_hat, state.s,
                          seed=fold_seed(state.seed, state.step),
                          draws=draws)
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
