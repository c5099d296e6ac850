"""Local optimizer half-steps and learning-rate schedules.

CHOCO-SGD's local step is plain SGD in the paper (Algorithm 2, line 3);
momentum SGD (the JAX launcher's default) and AdamW are the optional
local optimizers of the JAX package (``src/repro/optim/sgd.py``), with
its defaults and its ``OptState(mu, nu, count)``.  The optimizers work
on lists of node-stacked bucket buffers and update them in place (x
becomes x^{t+1/2}), which saves a full copy of the parameters.  Each
update is elementwise, so the bucket layout gives the per-leaf numbers.
Each update also reuses the gradient's buffer as its scratch (the
gradient is released as it is consumed), so a step makes few passes over
the state and at most one temporary of a bucket's size.

Every scalar is a float32 value, as in the JAX package: Python floats
multiply f32 tensors in f32, and AdamW's bias corrections
``1 - b ** count`` are computed on f32 scalar tensors (bc2 divides on the
buffers' device: a CPU scalar divisor would become a reciprocal multiply
on the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    mu: Optional[List[torch.Tensor]]  # first moment (momentum / Adam m); None for SGD
    nu: Optional[List[torch.Tensor]]  # second moment (AdamW only); None otherwise
    count: int                        # updates taken


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[List[torch.Tensor]], OptState]
    #: update(params, grads, state, lr) -> new state; ``params`` (and the
    #: moments) are updated in place to the half-step, and each ``grads``
    #: entry is used as scratch and released (set to None)
    update: Callable[..., OptState]


def _decayed(d: torch.Tensor, p: torch.Tensor,
             weight_decay: float) -> torch.Tensor:
    """``d + weight_decay * p``, in place on ``d``."""
    return d.add_(p * weight_decay) if weight_decay else d


def sgd(weight_decay: float = 0.0) -> Optimizer:
    """Plain SGD:  x = x - lr (g + wd x)."""
    def init(params):
        return OptState(mu=None, nu=None, count=0)

    @torch.no_grad()
    def update(params, grads, state, lr):
        for i, p in enumerate(params):
            g, grads[i] = grads[i], None
            p.sub_(_decayed(g, p, weight_decay).mul_(lr))
        return state._replace(count=state.count + 1)

    return Optimizer("sgd", init, update)


def momentum_sgd(beta: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    """Heavy-ball (optionally Nesterov) momentum SGD:  mu = beta mu + g;
    x = x - lr (d + wd x), d = g + beta mu (Nesterov) or mu."""
    def init(params):
        return OptState(mu=[torch.zeros_like(p) for p in params], nu=None,
                        count=0)

    @torch.no_grad()
    def update(params, grads, state, lr):
        for i, (p, m) in enumerate(zip(params, state.mu)):
            g, grads[i] = grads[i], None
            m.mul_(beta).add_(g)
            if nesterov:
                g.add_(m * beta)                 # d = g + beta mu
            elif weight_decay:
                g.copy_(m)                       # d = mu
            else:                                # lr mu in one pass
                p.sub_(torch.mul(m, lr, out=g))
                continue
            p.sub_(_decayed(g, p, weight_decay).mul_(lr))
        return state._replace(count=state.count + 1)

    return Optimizer("momentum", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments and bias correction:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
    x = x - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd x),
    bc = 1 - b ** count in f32, as the JAX package computes them.

    Each bucket takes seven elementwise operations, about 19 bucket-sized
    reads and writes against the 32 of JAX's formula taken op by op:
    ``lerp_`` for m, ``mul_`` + ``addcmul_`` for v, the denominator in
    the gradient's buffer (``div``, the root, ``add_``) and one
    ``addcdiv_`` for x at the f32 step size lr / bc1.  Each is the JAX
    formula rounded elsewhere (held to JAX within a bound,
    ``tests/test_torch_optim_data.py``).  Weight decay scales x by
    1 - lr wd first."""
    def init(params):
        return OptState(mu=[torch.zeros_like(p) for p in params],
                        nu=[torch.zeros_like(p) for p in params], count=0)

    @torch.no_grad()
    def update(params, grads, state, lr):
        count = state.count + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        c = f32(float(count))
        bc1, bc2 = 1 - f32(b1) ** c, 1 - f32(b2) ** c
        step = float(f32(lr) / bc1)
        bc2 = bc2.to(params[0].device)
        for i, (p, m, v) in enumerate(zip(params, state.mu, state.nu)):
            g, grads[i] = grads[i], None
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            den = torch.div(v, bc2, out=g).sqrt_().add_(eps)
            if weight_decay:
                p.mul_(1 - lr * weight_decay)
            p.addcdiv_(m, den, value=-step)
        return OptState(mu=state.mu, nu=state.nu, count=count)

    return Optimizer("adamw", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    """Optimizer factory by name: sgd | momentum | adamw."""
    makers = {"sgd": sgd, "momentum": momentum_sgd, "adamw": adamw}
    if name not in makers:
        raise ValueError(f"optimizer {name!r}: choose from "
                         f"{', '.join(makers)}")
    return makers[name](**kw)


# -- schedules ---------------------------------------------------------------
# Each returns lr(step: int) -> float, the float32 value the JAX schedule
# computes at that step.

def paper_decay_schedule(m: int, a: float, b: float):
    """eta_t = m a / (t + b)   (paper §5.3, Table 4)."""
    def lr(step: int) -> float:
        t = torch.tensor(float(step), dtype=torch.float32)
        # a true f32 division (a Python scalar over a tensor would
        # multiply by the tensor's reciprocal)
        return float(torch.tensor(m * a, dtype=torch.float32) / (t + b))
    return lr


def constant_schedule(lr0: float):
    """Constant learning rate."""
    value = float(torch.tensor(lr0, dtype=torch.float32))
    return lambda step: value


def cosine_schedule(lr0: float, warmup: int, total: int):
    """Linear warmup then cosine decay to zero over ``total`` steps."""
    def lr(step: int) -> float:
        t = torch.tensor(float(step), dtype=torch.float32)
        if step < warmup:
            return float(lr0 * t / max(warmup, 1))
        prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return float(lr0 * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return lr
