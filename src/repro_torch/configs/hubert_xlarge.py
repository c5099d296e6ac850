"""HuBERT-XLarge — encoder-only audio transformer (same arch as wav2vec2)
[arXiv:2106.07447].  The conv feature extractor is a stub: the batch
carries 512-dim frame embeddings; the model is the 48-layer bidirectional
encoder + the masked-prediction head over 504 cluster classes.  No
autoregressive decode."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    causal=False, mlp_type="gelu",
    frontend=FrontendConfig(kind="audio", n_tokens=0, embed_dim=512),
    source="arXiv:2106.07447",
)

SMOKE_CONFIG = ModelConfig(
    name="hubert-xlarge-smoke", family="audio",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=64,
    causal=False, mlp_type="gelu",
    frontend=FrontendConfig(kind="audio", n_tokens=0, embed_dim=128),
    source="arXiv:2106.07447",
)
