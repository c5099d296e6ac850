"""Model and CHOCO configuration for the port.

``ModelConfig`` keeps the JAX package's field names and defaults for the
dense decoder, ``attn_impl`` included (``"chunked"`` is the hand-written
flash-attention kernel, forward only, which tiles K by 128 as the Pallas
kernel does; the JAX jnp scan's ``attn_chunk`` has no counterpart), and
the local / global layers: ``sliding_window`` (the local layers' window)
and ``local_global_pattern`` (k > 0: k local layers to 1 global).  The
dense architectures are qwen3-1.7b, gemma2-9b, gemma-7b and yi-9b; the
frontend families ("audio": hubert-xlarge's bidirectional encoder over
precomputed frame embeddings; "vlm": llava-next-mistral-7b's decoder
behind a patch projector) carry ``FrontendConfig``; the "moe" family
(qwen3-moe-30b-a3b, llama4-maverick-400b-a17b) carries ``MoEConfig``; the
"ssm" family (rwkv6-3b, ``SSMConfig`` of kind "rwkv6") and the "hybrid"
one (zamba2-1.2b: a Mamba2 stack, ``SSMConfig`` of kind "mamba2", with
one weight-shared attention block, ``HybridConfig``).  ``n_params`` is
the JAX package's analytic count.  ``remat`` is not ported.
``INPUT_SHAPES`` keeps the one JAX input shape
the port serves, ``prefill_32k``.  ``ChocoConfig``
keeps the settings of the static engines (the packed and the per-leaf
engine, serial or pipelined; the choco, plain, all-reduce and push-sum
modes), the EF-state dtype (f32 or bf16), the data skew and the
stochastic topology processes (matching, link failures and bounded
staleness with its straggler links), with the JAX package's defaults:
the kernel-backend switch is not ported.  ``parse_straggler_edges`` and
``parse_delay_probs`` are the port's own copies of the JAX parsers
(torch-free, so the launcher checks its flags before torch is imported).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The MoE FFN of the "moe" family (qwen3-moe-30b-a3b, llama4-maverick):
    the JAX package's fields and defaults but ``combine_seq_shard``, a
    sharding constraint with nothing to constrain on one card."""
    n_experts: int
    top_k: int
    d_expert: int                  # hidden size of each expert FFN
    capacity_factor: float = 1.25
    group_size: int = 512          # dispatch group (tokens)
    moe_every: int = 1             # 1 = every layer is MoE; 2 = alternate dense/MoE
    n_shared_experts: int = 0      # always-on shared expert(s) (llama4)
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The recurrent mixer of the "ssm" and "hybrid" families."""
    kind: str = "mamba2"           # mamba2 | rwkv6
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # SSM head dim (mamba2 P / rwkv head size)
    chunk: int = 128               # SSD chunk length (mamba2)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: mamba backbone + one weight-shared attention block
    applied every `shared_every` positions."""
    shared_every: int = 6


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: the batch carries precomputed embeddings
    of this shape (the JAX package's carve-out)."""
    kind: str                       # "vision" | "audio"
    n_tokens: int                   # patches / frames per example
    embed_dim: int                  # frontend output dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
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
    sliding_window: Optional[int] = None    # window for local layers
    local_global_pattern: int = 0           # k>0: alternate k local : 1 global
    rope_theta: float = 10_000.0
    mlp_type: str = "swiglu"                # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None         # moe only
    ssm: Optional[SSMConfig] = None         # ssm and hybrid only
    hybrid: Optional[HybridConfig] = None   # hybrid only
    frontend: Optional[FrontendConfig] = None   # vlm and audio only
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

    def n_params(self) -> int:
        """The JAX package's analytic parameter count (embeddings, blocks,
        head), an estimate beside ``transformer.count_params``'s exact
        one: the same formula, branch for branch."""
        D, F, V, Hd = self.d_model, self.d_ff, self.vocab_size, self.resolved_head_dim
        H, KV, L = self.n_heads, self.n_kv_heads, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * Hd + 2 * D * KV * Hd + H * Hd * D
        mlp = 3 * D * F if self.mlp_type in ("swiglu", "geglu") else 2 * D * F
        per_layer = attn + mlp + 2 * D
        if self.family == "moe":
            m = self.moe
            expert = 3 * D * m.d_expert
            moe_layer = attn + m.n_experts * expert + D * m.n_experts + 2 * D \
                + m.n_shared_experts * 3 * D * self.d_ff
            n_moe = L // m.moe_every
            total_blocks = (L - n_moe) * per_layer + n_moe * moe_layer
        elif self.family == "ssm" and self.ssm.kind == "rwkv6":
            # timemix (r, k, v, g, o: ~5 D^2) + channelmix (~2 D F)
            total_blocks = L * (5 * D * D + 2 * D * F + 2 * D)
        elif self.family in ("ssm", "hybrid"):
            di = self.ssm.expand * D
            mamba = D * (2 * di + 2 * self.ssm.d_state * (di // self.ssm.head_dim)) \
                + di * D + di * self.ssm.d_conv
            if self.family == "hybrid":
                n_shared = L // (self.hybrid.shared_every + 1) if self.hybrid else 0
                total_blocks = (L - n_shared) * (mamba + 2 * D) + (attn + mlp + 2 * D)
            else:
                total_blocks = L * (mamba + 2 * D)
        else:
            total_blocks = L * per_layer
        proj = 0
        if self.frontend is not None and self.frontend.kind == "vision":
            proj = self.frontend.embed_dim * D + D * D
        if self.family == "audio":
            emb = self.frontend.embed_dim * D + V * D   # in-proj + class head
        return emb + total_blocks + proj + D


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


#: the error-feedback state dtypes the port runs (``ChocoConfig.state_dtype``)
STATE_DTYPES = ("float32", "bfloat16")


def parse_topology(spec: str) -> Tuple[str, ...]:
    """Comma-separated topology spec -> name tuple."""
    return tuple(t.strip() for t in spec.split(",") if t.strip())


def parse_straggler_edges(spec: str) -> Tuple[Tuple[int, int], ...]:
    """Comma-separated edge spec -> node-pair tuple ("0-1,2-3" ->
    ((0, 1), (2, 3))), each pair as (min, max).  Syntax only (integers,
    the 'a-b' form, no self-edge, no negative id): that the edge is one
    of the schedule's is checked by ``StalenessProcess``."""
    out = []
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        halves = part.split("-")
        if len(halves) != 2:
            raise ValueError(f"straggler edge {part!r} is not of the "
                             f"form 'a-b'")
        try:
            a, b = int(halves[0]), int(halves[1])
        except ValueError:
            raise ValueError(f"straggler edge {part!r} has non-integer "
                             f"node ids") from None
        if a < 0 or b < 0:
            raise ValueError(f"straggler edge {part!r} has negative "
                             f"node ids")
        if a == b:
            raise ValueError(f"straggler edge {part!r} is a self-edge")
        out.append((min(a, b), max(a, b)))
    if not out:
        raise ValueError(f"empty straggler edge spec {spec!r}")
    return tuple(out)


def parse_delay_probs(spec: str) -> Tuple[float, ...]:
    """Comma-separated probability list ("0.1,0.2,0.7" -> floats).
    Syntax, signs and mass only: the arity against max_staleness is the
    consumer's check (the launcher, ``StalenessProcess``)."""
    try:
        probs = tuple(float(p.strip())
                      for p in spec.split(",") if p.strip())
    except ValueError:
        raise ValueError(f"delay probs {spec!r} must be a comma-"
                         f"separated float list") from None
    if not probs:
        raise ValueError(f"empty delay-probs spec {spec!r}")
    if min(probs) < 0 or sum(probs) <= 0:
        raise ValueError(f"delay probs must be nonnegative with positive "
                         f"mass, got {probs}")
    return probs


@dataclasses.dataclass(frozen=True)
class ChocoConfig:
    """Settings of the static CHOCO engines."""
    compressor: str = "top_k"       # compression.make_compressor name
    comp_kwargs: tuple = (("fraction", 0.01),)
    # a symmetric registry name (ring, torus, fully_connected, chain, star,
    # hypercube) or a comma-separated time-varying sequence of them
    # ("ring,hypercube"); or a directed one (directed_ring, random_digraph),
    # which runs under the push-sum mode only
    topology: str = "ring"
    gossip_steps: int = 1
    # leaves of at most 8192 elements gossip uncompressed, in exact
    # buckets (off for paper-faithful runs)
    exact_small_leaves: bool = False
    # True: the bucketed engine (one payload per bucket); False: the
    # per-leaf engine (one payload per leaf, JAX's reference engine)
    packed_gossip: bool = True
    # the pipelined engine: the exchange runs on the pre-gradient iterate
    # and its payload lands in the next step's update (choco, one static
    # graph); on the card the exchange runs on a side CUDA stream
    pipeline_gossip: bool = False
    # dtype of the error-feedback states x_hat and s, one of STATE_DTYPES
    # (bf16 halves their memory and the sparse and dense payloads; x stays
    # f32)
    state_dtype: str = "float32"
    # Dirichlet(alpha) non-IID data shards (data/partition.py); None: the
    # launcher's --heterogeneity slices.  A data knob: the trainer's state
    # and exchange do not read it; it takes effect where the batches are
    # made, by passing it to make_lm_batch_fn(skew_alpha=), as the
    # launcher does
    data_skew_alpha: Optional[float] = None
    # a stochastic topology process over the compiled schedule
    # (comm/stochastic.py): None (the static graph), "matching" (one
    # sampled round per gossip round), "linkfail" (i.i.d. link drops) or
    # "staleness" (each link's payload up to max_staleness rounds late;
    # choco only); one graph, the choco or plain mode, not pipelined
    topology_process: Optional[str] = None
    # drop probability of each undirected link per gossip round (linkfail)
    edge_drop_prob: float = 0.1
    # "uniform" or "weighted" round probabilities (matching)
    matching_sampler: str = "uniform"
    # the staleness bound tau (staleness): each link's delay is drawn
    # uniformly from {0..tau}; tau = 0 is the always-fresh replica engine
    max_staleness: int = 1
    # slow links ("0-1,2-3") whose delays come from straggler_delay_probs
    # ("P(d=0),...,P(d=tau)"; default the point mass at tau) instead of
    # the uniform law (staleness only)
    straggler_edges: Optional[str] = None
    straggler_delay_probs: Optional[str] = None

    def comp_dict(self):
        return dict(self.comp_kwargs)
