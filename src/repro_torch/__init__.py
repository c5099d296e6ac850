"""PyTorch/CUDA port of the CHOCO-SGD system, beside the JAX package.

Imports torch and numpy only, never JAX or ``repro``.  Entry points run
on CUDA unless the caller passes ``device="cpu"`` / ``--device cpu``.
The ported slice is the static packed CHOCO-SGD trainer (ring, f32
state, QSGD / SignNorm gossip) on the dense qwen3-1.7b decoder; its four
hot-path kernels are hand-written CUDA in ``kernels/csrc/``.
"""
