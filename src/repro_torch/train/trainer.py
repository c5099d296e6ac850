"""Decentralized trainer: CHOCO-SGD with the n gossip nodes on one device.

One train step (Algorithm 2, the JAX package's serial ``train_step``):

    per-node gradient   (one batched forward/backward over all n nodes)
 -> local optimizer half-step x^{t+1/2}
 -> CHOCO gossip exchange of the compressed deltas (comm/gossip.py)

State lives in the gossip engine's bucket space: the parameters x, the
public copies x_hat, the neighbour aggregates s and the momentum are
lists of node-stacked ``(n, bucket.size)`` f32 buffers, and the model
reads its parameters as views into the x buffers.  So the gradient comes
back in bucket layout, the optimizer and the exchange run on whole
buckets, and nothing is packed or unpacked per step.

The slice: CHOCO mode, a static ring, f32 state, QSGD or SignNorm
compression, the Theorem-2 gamma.  Other topologies and compressors
raise; the other modes, processes and a fixed gamma are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.comm.gossip import make_choco_exchange
from repro_torch.comm.packing import (bucket_omega_worst, fold_seed,
                                      leaf_route, make_bucket_spec,
                                      pack_leaves, unpack_leaves)
from repro_torch.comm.schedule import compile_schedule
from repro_torch.configs.base import ChocoConfig, parse_topology
from repro_torch.core.choco_gossip import GammaSpec, theorem2_stepsize
from repro_torch.core.compression import make_compressor
from repro_torch.core.topology import make_topology
from repro_torch.models.transformer import Model, param_shapes


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
    x: List[torch.Tensor]        # parameters x_i, in bucket space
    x_hat: List[torch.Tensor]    # public copies
    s: List[torch.Tensor]        # weighted neighbour aggregates
    mu: List[torch.Tensor]       # momentum
    step: int = 0
    seed: int = 0                # salts the QSGD dither of every step


@dataclasses.dataclass
class DecentralizedTrainer:
    model: Model
    choco: ChocoConfig
    n_nodes: int
    optimizer: object
    lr_fn: Callable[[int], float]
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        names = parse_topology(self.choco.topology)
        if len(names) != 1:
            raise ValueError("time-varying topology sequences are not ported")
        self.compressor = make_compressor(self.choco.compressor,
                                          **self.choco.comp_dict())
        self.topology = make_topology(names[0], self.n_nodes)
        self.schedules = (compile_schedule(self.topology),)
        self.paths = [p for p, _ in param_shapes(self.model.cfg)]
        shapes = dict(param_shapes(self.model.cfg))
        self.spec = make_bucket_spec(
            [torch.empty(shapes[p], dtype=self.model.param_dtype,
                         device="meta") for p in self.paths],
            routes=[leaf_route(p) for p in self.paths])
        # Theorem-2 consensus stepsize: the scalar worst case for logging,
        # and per-bucket values (each bucket at its own omega) for the engine
        delta, beta = self.topology.delta, self.topology.beta
        self.gamma = theorem2_stepsize(
            delta, beta, bucket_omega_worst(self.spec, self.compressor))
        self.exchange = make_choco_exchange(
            spec=self.spec, schedules=self.schedules,
            compressor=self.compressor, gamma=GammaSpec(delta=delta, beta=beta),
            gossip_steps=self.choco.gossip_steps)

    # -- state ----------------------------------------------------------------

    def state_from_params(self, params: Dict[str, torch.Tensor],
                          seed: int = 0) -> TrainState:
        """Training state from node-stacked parameters ``path -> (n, ...)``
        (e.g. ``repro_torch.convert.params_from_jax``): x packed into
        buckets, x_hat, s and momentum zero."""
        leaves = [params[p].to(self.device) for p in self.paths]
        if leaves[0].shape[0] != self.n_nodes:
            raise ValueError(f"params hold {leaves[0].shape[0]} nodes, the "
                             f"trainer {self.n_nodes}")
        x = pack_leaves(self.spec, leaves)
        del leaves
        zeros = lambda: [torch.zeros_like(b) for b in x]
        return TrainState(x=x, x_hat=zeros(), s=zeros(),
                          mu=self.optimizer.init(x), seed=seed)

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh state from the model's random init under ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.state_from_params(
            self.model.init(self.n_nodes, gen, self.device), seed=seed)

    def params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Node-stacked parameter views ``path -> (n, ...)`` into state.x."""
        return dict(zip(self.paths, unpack_leaves(self.spec, state.x)))

    # -- step -----------------------------------------------------------------

    def batch_to_device(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def step(self, state: TrainState, batch,
             dither: Optional[Callable[[int, int], torch.Tensor]] = None
             ) -> Dict[str, float]:
        """One CHOCO-SGD step, in place on ``state``.  ``dither(t, b)``
        optionally injects QSGD's dither for gossip round t, bucket b."""
        for b in state.x:
            b.requires_grad_(True)
        losses = self.model.loss(self.params(state), batch)     # (n,)
        grads = list(torch.autograd.grad(losses.sum(), state.x))
        with torch.no_grad():
            grad_norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                       for g in grads))
            lr = self.lr_fn(state.step)
            for b in state.x:
                b.requires_grad_(False)
            self.optimizer.update(state.x, grads, state.mu, lr)
            del grads                  # frees a state-sized copy for the exchange
            self.exchange(state.x, state.x_hat, state.s,
                          seed=fold_seed(state.seed, state.step),
                          dither=dither)
        state.step += 1
        losses = losses.detach()
        return {"loss": float(losses.mean()), "lr": lr,
                "grad_norm": float(grad_norm),
                "node_loss_spread": float(losses.max() - losses.min())}
