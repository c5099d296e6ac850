"""Qwen3-30B-A3B — MoE, 128 experts top-8, every layer MoE, QK-norm GQA
[hf:Qwen/Qwen3-30B-A3B].  d_ff=768 is the per-expert hidden size."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    qk_norm=True, mlp_type="swiglu", rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, moe_every=1,
                  capacity_factor=1.25, group_size=512),
    loss_chunk=512,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab_size=256,
    qk_norm=True, mlp_type="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, moe_every=1,
                  capacity_factor=2.0, group_size=64),
    source="hf:Qwen/Qwen3-30B-A3B",
)
