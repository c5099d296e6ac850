"""Llama-4 Maverick 400B-A17B — MoE 128 routed experts top-1 + 1 shared
expert, MoE interleaved every other layer; the multimodal frontend is not
modelled (text backbone only, as in the JAX package)
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    mlp_type="swiglu", rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192, moe_every=2,
                  n_shared_experts=1, capacity_factor=1.25, group_size=512),
    loss_chunk=512,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-maverick-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=256,
    mlp_type="swiglu",
    moe=MoEConfig(n_experts=4, top_k=1, d_expert=128, moe_every=2,
                  n_shared_experts=1, capacity_factor=2.0, group_size=64),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
