"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay linear attention
[arXiv:2404.05892].  40 heads of size 64 (d_model 2560)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    loss_chunk=512,
    source="arXiv:2404.05892",
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    source="arXiv:2404.05892",
)
