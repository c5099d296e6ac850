"""PyTorch/CUDA port of the CHOCO-SGD system, beside the JAX package.

Imports torch and numpy only, never JAX or ``repro``.  Entry points run
on CUDA unless the caller passes ``device="cpu"`` / ``--device cpu``.
The ported slices are the static packed CHOCO-SGD trainer (ring, f32
state, every compressor of the JAX package, the exact small-leaf bucket)
on the dense qwen3-1.7b decoder, and serving that decoder; their kernels
(the gossip kernels, the top-k mask, flash attention) are hand-written
CUDA in ``kernels/csrc/``.
"""
