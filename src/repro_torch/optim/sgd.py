"""Local optimizer half-step and learning-rate schedule.

CHOCO-SGD's local step (Algorithm 2, line 3) is momentum SGD here, as in
the JAX launcher's default.  The optimizer works on lists of
node-stacked bucket buffers and updates them in place (x becomes
x^{t+1/2}), which saves a full copy of the parameters.  Each update is
elementwise, so the bucket layout gives the same numbers as a per-leaf
update.  Not ported: plain SGD, AdamW, weight decay, Nesterov, and the
paper-decay and constant schedules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class MomentumSGD:
    """Heavy-ball momentum:  mu = beta mu + g;  x = x - lr mu."""
    beta: float = 0.9
    name: str = "momentum"

    def init(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """Zero first moments, one per parameter buffer."""
        return [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               mu: List[torch.Tensor], lr: float) -> None:
        """In place: ``mu`` and ``params`` (to the half-step).  ``grads``
        entries are released as they are consumed."""
        for i, (p, m) in enumerate(zip(params, mu)):
            m.mul_(self.beta).add_(grads[i])
            grads[i] = None
            p.sub_(m * lr)


def make_optimizer(name: str, **kw):
    """Optimizer factory; only ``momentum`` is ported."""
    if name != "momentum":
        raise ValueError(f"optimizer {name!r} is not ported; the port has "
                         f"only 'momentum'")
    return MomentumSGD(**kw)


def cosine_schedule(lr0: float, warmup: int, total: int):
    """Linear warmup then cosine decay to zero over ``total`` steps,
    evaluated in float32 like the JAX package's schedule."""
    def lr(step: int) -> float:
        t = torch.tensor(float(step), dtype=torch.float32)
        if step < warmup:
            return float(lr0 * t / max(warmup, 1))
        prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return float(lr0 * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return lr
