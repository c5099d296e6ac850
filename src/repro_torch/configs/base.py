"""Model and CHOCO configuration for the port.

``ModelConfig`` keeps the JAX package's field names and defaults for the
dense decoder; the MoE / SSM / hybrid / frontend sub-configs, the input
shapes, the other architectures, sliding windows, local / global layer
patterns, chunked attention and ``remat`` are not ported.  ``ChocoConfig``
keeps only the settings of the static packed CHOCO path: the stochastic
processes, staleness, pipelining, push-sum, bf16 EF state, the per-leaf
engine, the kernel-backend switch, a fixed consensus gamma, the exact
small-leaf bucket and the packing knobs (alignment 128) are not ported.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    causal: bool = True
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    mlp_type: str = "swiglu"                # swiglu | geglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"                 # compute dtype
    param_dtype: str = "float32"
    loss_chunk: int = 0                     # 0 = unchunked cross-entropy
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """Load the named arch's ModelConfig (or its SMOKE_CONFIG)."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def parse_topology(spec: str) -> Tuple[str, ...]:
    """Comma-separated topology spec -> name tuple."""
    return tuple(t.strip() for t in spec.split(",") if t.strip())


@dataclasses.dataclass(frozen=True)
class ChocoConfig:
    """Settings of the static packed CHOCO path."""
    compressor: str = "sign"        # qsgd | sign
    comp_kwargs: tuple = ()
    topology: str = "ring"          # only "ring" is ported
    gossip_steps: int = 1

    def comp_dict(self):
        return dict(self.comp_kwargs)
