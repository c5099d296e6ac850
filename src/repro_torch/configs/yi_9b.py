"""Yi-9B — llama-arch dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    mlp_type="swiglu", rope_theta=10_000.0,
    loss_chunk=512,
    source="arXiv:2403.04652",
)

SMOKE_CONFIG = ModelConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    mlp_type="swiglu",
    source="arXiv:2403.04652",
)
