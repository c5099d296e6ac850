"""PyTorch/CUDA port of the CHOCO-SGD system, beside the JAX package.

Imports torch and numpy only, never JAX or ``repro``.  Entry points run
on CUDA unless the caller passes ``device="cpu"`` / ``--device cpu``.
The ported slices are the static packed trainer in its choco, plain
(D-SGD) and all-reduce modes (every symmetric topology and time-varying
sequences of them, f32 state, every compressor of the JAX package, the
exact small-leaf bucket, the sgd, momentum and AdamW local steps, the
Dirichlet data skew) on the dense qwen3-1.7b decoder, stacked on one
device or one process per node; the paper's algorithms as matrix
simulators (``core/``) with the logistic-regression data; and serving
that decoder.  Their kernels (the
gossip kernels, the top-k mask, flash attention, the collective probe)
are hand-written CUDA in ``kernels/csrc/``.
"""
