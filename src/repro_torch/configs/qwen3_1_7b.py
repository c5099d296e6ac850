"""Qwen3-1.7B — dense decoder with QK-norm and GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, mlp_type="swiglu", rope_theta=1_000_000.0,
    loss_chunk=512,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-1.7b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    qk_norm=True, mlp_type="swiglu",
    source="hf:Qwen/Qwen3-8B",
)
