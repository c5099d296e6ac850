"""Gemma-2 9B — alternating local(4096-window)/global attention, logit
softcaps, GeGLU, tied embeddings [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    mlp_type="geglu", tie_embeddings=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sliding_window=4096, local_global_pattern=1,
    loss_chunk=512,
    source="arXiv:2408.00118",
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-9b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    mlp_type="geglu", tie_embeddings=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sliding_window=16, local_global_pattern=1,
    source="arXiv:2408.00118",
)
