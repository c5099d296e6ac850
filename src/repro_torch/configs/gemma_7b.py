"""Gemma 7B — GeGLU, head_dim=256 (16 MHA heads), huge GeGLU FFN, tied
embeddings [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    mlp_type="geglu", tie_embeddings=True,
    loss_chunk=512,
    source="arXiv:2403.08295",
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-7b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    mlp_type="geglu", tie_embeddings=True,
    source="arXiv:2403.08295",
)
