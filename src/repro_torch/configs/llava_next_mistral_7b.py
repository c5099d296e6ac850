"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].  The vision tower (CLIP ViT-L) is
a stub: the batch carries 1024-dim patch embeddings for 5 anyres tiles x
576 patches = 2880 image tokens; the model is the 2-layer MLP projector +
the Mistral-7B decoder."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    mlp_type="swiglu", rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", n_tokens=2880, embed_dim=1024),
    loss_chunk=512,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE_CONFIG = ModelConfig(
    name="llava-next-smoke", family="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    mlp_type="swiglu",
    frontend=FrontendConfig(kind="vision", n_tokens=16, embed_dim=64),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
