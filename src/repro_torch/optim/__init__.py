"""Per-node optimizers and LR schedules for the decentralized trainer."""
from .sgd import (Optimizer, OptState, sgd, momentum_sgd, adamw, make_optimizer,
                  paper_decay_schedule, constant_schedule, cosine_schedule)
