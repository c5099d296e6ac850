"""Model and CHOCO configuration for the port.

``ModelConfig`` keeps the JAX package's field names and defaults for the
dense decoder, ``attn_impl`` included (``"chunked"`` is the hand-written
flash-attention kernel, forward only, which tiles K by 128 as the Pallas
kernel does; the JAX jnp scan's ``attn_chunk`` has no counterpart); the
MoE / SSM / hybrid / frontend sub-configs, the other architectures,
sliding windows, local / global layer patterns and ``remat`` are not
ported.  ``INPUT_SHAPES`` keeps the one JAX input shape the port serves,
``prefill_32k``.  ``ChocoConfig``
keeps the settings of the static packed engine (its choco, plain and
all-reduce modes) and the data skew, with the JAX package's defaults:
the stochastic processes, staleness, pipelining, push-sum, bf16 EF
state, the per-leaf engine and the kernel-backend switch are not
ported.
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
    attn_impl: str = "naive"                # naive | chunked (flash kernel,
                                            # never materialises S x S)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES = {
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
}


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
    compressor: str = "top_k"       # compression.make_compressor name
    comp_kwargs: tuple = (("fraction", 0.01),)
    # a symmetric registry name (ring, torus, fully_connected, chain, star,
    # hypercube) or a comma-separated time-varying sequence of them
    # ("ring,hypercube"); the directed graphs need push-sum (not ported)
    topology: str = "ring"
    gossip_steps: int = 1
    # leaves of at most 8192 elements gossip uncompressed, in exact
    # buckets (off for paper-faithful runs)
    exact_small_leaves: bool = False
    # Dirichlet(alpha) non-IID data shards (data/partition.py); None: the
    # launcher's --heterogeneity slices.  A data knob: the trainer's state
    # and exchange do not read it; it takes effect where the batches are
    # made, by passing it to make_lm_batch_fn(skew_alpha=), as the
    # launcher does
    data_skew_alpha: Optional[float] = None

    def comp_dict(self):
        return dict(self.comp_kwargs)
