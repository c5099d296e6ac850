"""Zamba2-1.2B — hybrid: Mamba2 backbone + one weight-SHARED attention block
applied every 6th position [arXiv:2411.15242].  38 blocks total:
(5 mamba + 1 shared-attn) x 6 + 2 tail mamba."""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    mlp_type="swiglu",
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    hybrid=HybridConfig(shared_every=6),
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    mlp_type="swiglu",
    ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2, head_dim=64, chunk=32),
    hybrid=HybridConfig(shared_every=2),
    source="arXiv:2411.15242",
)
