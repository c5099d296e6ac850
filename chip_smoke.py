#!/usr/bin/env python3
"""On-card check of the PyTorch port (``src/repro_torch``): run with

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA device.  It

1. builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together;
2. holds each gossip kernel against its plain PyTorch version on the card, at the
   bucket lengths of the full-width run and at an odd length: QSGD codes
   (int8 and int16), sign codes and dequantize bit-equal, the EF update
   (in place, as the exchange calls it, with the ring's and star's
   per-node weight vectors) within 0 ulp (kernel and plain
   version round every operation separately), the bf16-state EF update
   (x f32, x_hat, s and the payloads bf16; the ring's uniform weights
   and chain's per-node ones) bit-equal too, also at gemma-7b's
   tied-embedding bucket, (4, 786,432,000), the largest bucket a path
   gives it (``[train-archs]``), and times kernel, plain
   version, the bytes bound and,
   for dequantize, the one PyTorch call that computes the same function.
   QSGD is checked twice at each length: with inv_norm = 1/||x|| per node
   row, as the trainer calls it (codes of -1, 0 or 1 at these lengths),
   and with inv_norm = 0.999/max|x|, which reaches every level up to s;
   The collective-layer probe kernel is held bit-equal to its plain version
   at the JAX probe's (8, 128) block, its wrapper's host path is split
   step by step, and it is timed in turns with its plain version and
   ``torch.mul(x, 2)`` in one loop; the per-leaf engine's QSGD codes
   (f32 and bf16 rows) at one node's embedding leaf as it compresses,
   75 x 4 rows of 4,194,304, the pipelined order of both EF updates at
   (4, 311,164,928), and the topology-process engine's replica update
   (``replica_update``: the matching form, and the ring form at tau 0,
   link failures, with the ring's 2 replicas; f32 state, bf16 state with
   bf16 payloads and with f32 payloads) at (4, 311,164,928), and its ring
   form under bounded staleness in the same three cases (tau 1 there, tau 2 and 3 at an odd length
   and at one a multiple of 4, every delay in range), each
   bit-equal and timed beside its plain version and its bounds;
3. holds the top-k mask kernel against its plain version, bit for bit in
   mask and thresholds: at the tile shape of one node's embedding bucket
   (2,430,976 x 128) with k = 2 and 13, at C = 1024, and with planted
   ties; times kernel, plain version, the bytes bound and, as a
   yardstick, ``torch.topk(x.abs(), k, dim=1)``; then drives its public
   op, ``ops.block_topk_compress_vector``, on one node's embedding bucket
   and at an odd length, against the plain version;
4. trains qwen3-1.7b at its published widths, depth cut to 2 layers, 4
   nodes on a ring, through ``DecentralizedTrainer``, at the uncut
   model's launcher default of sequence 512 and batch 4 per node: 3 steps
   each with QSGD (s=16), SignNorm, top_k and block_top_k (fraction
   0.01), checking finite losses and that each kernel launched steps x
   gossip_steps x buckets times on its path and not at all off it, then
   profiles one more step of each; then ``[topology]``: the top_k run
   again on a star (per-node self weights, partial rounds), printed
   beside the ring's ms/step and peak memory; then ``[state-bf16]``, the
   top_k and QSGD runs again with bf16 EF state (x_hat and s), printed
   beside the f32 state's ms/step and peak memory and the predicted
   peak; then ``[per-leaf]``, the top_k and QSGD runs through the per-leaf
   engine (one payload and one EF launch per leaf), beside the packed
   runs, and ``[pipelined]``, the same two through the pipelined engine
   with bf16 EF state (f32 state runs out of memory beside the step's
   copy of x), beside the bf16 serial runs, with the side stream's busy
   time, the share of it beside the main stream's and the device's idle
   share from the profiled step's trace; then ``[process]``, the top_k
   and QSGD runs with bf16 EF state under the topology processes
   (matching; link failures at p = 0.1) through the replica engine, beside
   the ``[state-bf16]`` static runs: ms per step over steps 2-3, the peak
   beside its prediction, the idle share, launches per step and the wire
   bytes per node per step; then ``[stale]``, the same two under bounded
   staleness (tau 1, the uniform law) beside the static and link-failure
   runs (3 nodes, never a narrower model, if 4 run out of memory); then
   ``[pushsum]``, the same two in push-sum mode on the directed ring and
   top_k on random_digraph (f32 EF state, bf16 if f32 runs out of
   memory), beside the static runs of the same state dtype: ms per step
   over steps 2-3, the peak beside its reckoning and what is live at it
   (one more step under the allocator's memory history), the idle share,
   launches per step (codes, dequantize and the EF update once per
   bucket), the wire bytes per node per step beside the static run's
   (half of it plus 4 on the directed ring), and the weight column's mass
   1^T w = n within 1e-3 relative and its spread max w / min w; then
   ``[modes]``, the same
   cell through the same code in the paper's three modes: CHOCO-SGD top_k
   with plain SGD on Dirichlet(0.1) token shards, exact D-SGD (plain) with
   momentum and the all-reduce baseline with AdamW, checking finite
   losses and the launches (the EF update per bucket per step under
   choco, no kernel in the exact modes); then ``[checkpoint]``: the same
   cell with top_k 0.01, bf16 EF state and plain SGD, 3 steps
   uninterrupted against 1 step, a save (``checkpoint/``, the JAX
   package's sharded format), a restore into a fresh trainer and 2 steps,
   every buffer of x, x_hat and s, the step and the seed bit-equal; it
   prints the disk's free space first (and halves the node count, never
   the width, if two checkpoints would not fit), the save and restore
   seconds and GB/s, the bytes on disk beside the reckoned 4 x params x
   (4 + 2 + 2), and the first step after the restore;
5. runs the training launcher (``repro_torch.launch.train.main``) for a
   --smoke run with --compressor top_k --fraction 0.05, one with
   --mode plain --optimizer adamw --data-skew-alpha 0.5, the first
   with --state-dtype bfloat16, a QSGD run with --gossip-engine
   per-leaf --pipeline-gossip, a top_k run with --topology-process
   matching, a QSGD run with --topology-process linkfail
   --edge-drop-prob 0.1 and a top_k run with --topology-process staleness
   --max-staleness 2 --straggler-edges 0-1, then the first with
   --simulate-devices 4 (4 ranks on the card, the per-rank engine), also
   under matching and under that staleness,
   checking its engine line, its probe record and rank 0's launches;
6. holds small float32 training runs on the card against the same runs on
   the CPU (the plain versions), step by step: SignNorm, top_k,
   block_top_k, identity with the exact small-leaf bucket, and rand_k and
   randomized gossip fed the same draws on both devices, on the ring;
   top_k on torus, chain, star and the time-varying pair "ring,star";
   plain on star, allreduce with plain SGD and QSGD under AdamW; top_k on
   the ring and QSGD on chain with bf16 EF state; QSGD per leaf, top_k
   per leaf on star with bf16 state, sign pipelined and QSGD per leaf
   pipelined with bf16 state; ``[per-leaf] small``, the per-leaf exchange
   alone (serial and pipelined, f32 and bf16 state, a leaf of two block
   rows) on the card against the CPU, every payload bit-equal, x_hat
   bit-equal where the scales are, one codes, dequantize and EF launch
   per leaf; ``[process] small``, the replica exchange alone (matching
   and link failures, packed and per leaf, f32 and bf16 state, ring,
   chain and star, top_k, rand_k and QSGD) on the card against the CPU:
   the samples equal, x and
   every reference and replica bit-equal, one replica-update launch per
   unit per gossip round; ``[stale] small``, the stale exchange alone
   over 3 calls (packed and per leaf, f32 and bf16, ring, chain and star,
   tau 0 to 3, top_k, rand_k and QSGD, a straggler link) the same way,
   every ring slot bit-equal; then ``[checkpoint]``
   at that size, QSGD s=16 and top_k, f32 and bf16 EF state: a card
   checkpoint restored on the CPU and a CPU checkpoint on the card, bit
   for bit, and elastic restores 4 -> 8 and 4 -> 2 nodes on the card,
   with the consensus distance and ||x - x_hat|| before and after the
   warmup and its launches (codes, dequantize and the EF update per
   bucket per round for QSGD; the EF update for top_k);
   then the per-rank engine (``[dist]``), one process per gossip node, 4
   ranks sharing the card: the small phase holds the per-rank exchange
   alone bit-equal to the stacked exchange on the card, and 3 per-rank
   steps of the f32 smoke decoder to the ``[small]`` rules
   against the stacked trainer on the card (top_k, QSGD with 2 gossip
   rounds, sign); the full-width phase trains qwen3-1.7b widths (2
   layers) with top_k 0.01 at sequence 512 x batch 4 per node for 3 steps,
   checking finite losses, each rank's launches (the probe kernel once,
   the EF update per bucket per round) and that each rank sent exactly
   the spec's payload bytes, and prints ms/step beside the stacked
   engine's, each rank's peak memory, the wire bytes, the transport and
   the probe record; on star and chain the small phase holds the
   per-rank exchange bit-equal to the stacked one and each rank's bytes
   sent to its own sends times the payload bytes, and so with bf16 EF
   state (top_k on the ring, QSGD on chain); plain (ring; star, 2
   rounds) and allreduce hold the exchange alone bit-equal (allreduce:
   within 1e-6, its sum runs in gloo's order), 3 steps to the ``[small]``
   rules, each rank's bytes by formula (plain's counted; allreduce's a
   ring model, none counted) and no launch, the probe included;
   the full-width plain mode's bytes are printed as computed; the
   per-leaf and pipelined exchanges (ring, star, chain; f32 and bf16
   state) bit-equal per rank and stacked, each rank's bytes its sends
   times the per-leaf (or per-bucket) payload bytes; each rank
   restores its row of a stacked checkpoint and the stacked engine
   restores the 4 ranks' checkpoint, bit for bit (bf16 EF state, top_k);
   the per-rank replica exchange (``[process] small per rank``: matching
   on chain, link failures on ring and star) bit-equal to the stacked one
   on the card, each rank's bytes its payload bytes times the rounds it
   shipped, and the per-rank stale exchange (``[stale] small per rank``,
   in the same ranks) likewise over 3 calls; ``[pushsum] small``, the
   push-sum exchange alone over 3 calls (directed_ring and
   random_digraph, QSGD, sign and top_k, f32 and bf16 state) on the card
   against the CPU, x, x_hat, s and w bit-equal (QSGD and sign within
   the norms' summation order) and the codes,
   dequantize and EF launches counted; per rank (4 ranks on the card)
   bit-equal to the stacked exchange, each rank's bytes its payload
   bytes plus 4 for w per round it sends in; and the launcher with
   --mode pushsum --topology random_digraph;
   then ``[sim]``, the paper's algorithms as matrix simulators on the card
   against the CPU: CHOCO-Gossip at the quickstart's sizes (ring 25, d
   2000: exact, QSGD(127), top 1%) and CHOCO-SGD (QSGD(16), top 1%) with
   exact D-SGD on the epsilon stand-in at m = 400,000, d = 2,000, ring 9,
   each run free on both devices and again round by round, the CPU
   making each round from the card's state (x, x_hat and s held; QSGD
   levels and top-k selections counted where they move); and pipelined
   CHOCO-Gossip at ring 25, d 2000 (exact and QSGD(127)), card against
   CPU; and CHOCO-Gossip under matching and link failures (the replica
   simulator) at ring 25, d 2000, exact and top 1%, each round held
   against the CPU's repeat of it, with the final consensus errors, and
   under bounded staleness (tau 2, the stale simulator) the same way;
   and the push-sum simulator on the directed ring of 25 nodes at d 2000
   (exact and QSGD(127)) the same way, its de-biased consensus error
   printed;
7. holds the flash-attention kernels against their plain version: the
   bf16 tensor-core kernel (``csrc/flash_attention_sm90.cu``; the build
   phase checks that the SASS of all ten instances, Dh 32, 64, 80, 128 and
   256 with and without a window, holds wgmma and TMA loads) at the
   full-width prefill layer shape (32768 tokens, 16/8 heads, causal), at
   qwen3-moe-30b-a3b's (32768 tokens, 32/4 heads, causal), at
   an odd length (1000), at 2048, at Dh 64 with a softcap and non-causal,
   at gemma2-9b's global layer (Dh 256, softcap 50) and local layer (the
   same with the 4096-token window), gemma-7b's layer (16/16 heads), Dh
   256 at an odd length with a window of 300 and non-causal, and with a
   window at Dh 64 and 128, causal and not, each to contract (a)
   (``FLASH_BF16_RTOL``, ``FLASH_BF16_ULP_SHARE``) and its plain version
   to contract (b) against the f32-P result; the f32 3xTF32 tensor-core
   kernel (``csrc/flash_attention.cu``; the build phase checks that its
   ten instances' SASS holds wgmma) within 1e-5 of max|out| at Dh 64
   with a softcap (non-causal and causal), at 2048, at an odd length
   (1000), with a window at Dh 64 and 128 (causal with a softcap,
   non-causal), and at Dh 256: gemma2-9b's global and local layers and
   gemma-7b's with dtype float32 (S 32768), an odd length with a window
   and non-causal; and times the bf16 kernel at the qwen3 and qwen3-moe
   prefill layers and the three 32768-token Dh 256 layers, the f32 one at
   the three f32 Dh 256 layers, its plain version,
   ``scaled_dot_product_attention`` (the library yardstick, which the
   port never calls; at the local layer with the window as a boolean
   mask, where a backend takes it) and the bounds, and the f32 kernel at
   the qwen3 layer's shape, held within 1e-5 there too, beside SDPA on
   the same f32 inputs and SDPA's own distance to the plain version;
8. prefills qwen3-1.7b at full width and full depth (28 layers) through
   ``Model.prefill`` with ``attn_impl="chunked"``: one prompt of 32768
   tokens (the ``prefill_32k`` shape, its batch of 32 cut to 1 for one
   card), twice, checking 28 flash launches per call, finite logits and
   the cache shapes, then profiles one more call, which must attribute
   28 launches and their device time to the tensor-core kernel (a launch
   the profiler lacks must be one whose kernel record it dropped: a
   launch call with no kernel event in its trace);
9. holds the full-width prefill's last-token logits (prompt 256, batch 2)
   against a decode loop over the same tokens (the JAX consistency
   test's bound, and the same argmax), and times and profiles one
   full-width decode step at batch 8;
10. serves the full-width model through the serve launcher
   (``repro_torch.launch.serve.main``, batch 8, prompt 32, 32 generated
   tokens, 2 requests): TTFT and per-token latency, no flash launch; then
   holds the f32 smoke model's prefill plus 8 decode steps on the card
   against the same on the CPU, and measures where the card's f32
   prefill differs from the CPU's on the prefill test's inputs
   (``prefill_budget``: the flash kernel against its plain version,
   chunked and naive attention on the card against the CPU), holding the
   test's bounds;
11. serves gemma2-9b at full width and depth (42 layers, local layers of
   a 4096-token window alternating with global ones, head dim 256, bf16,
   weights from seed 0 drawn in f32, cast, the draw freed): its
   ``prefill_32k`` prefill (batch 1) twice, 42 flash launches a call, 21
   of them windowed, none of the f32 kernel, the global caches (1, 21, 1,
   32768, 8, 256) and the local rings (1, 21, 1, 4096, 8, 256), the peak
   device memory and a profiled call split into flash / matmul / other;
   then caches of 32768 + 8 slots filled through ``Model.hidden`` and 8
   decode steps past position 32768 (finite logits, the global caches'
   new slots written, the local rings written over: they wrap);
   ``[consistency]`` at its full width (prompt 256, batch 2); the serve
   launcher at ``--arch gemma2-9b``; and ``[dense small]``: the gemma2-9b,
   gemma-7b and yi-9b smoke models in f32, chunked and naive (yi-9b's
   chunked path at head dim 32), and gemma2-9b's and gemma-7b's chunked at
   the full configs' head dim 256 (the f32 kernel's Dh 256 instances),
   prefill of 24 plus 40 decode steps (the smoke window of 16 wraps),
   card against CPU;
12. runs the frontends: ``[flash-dh80]``, both flash kernels at
   hubert-xlarge's layer (16/16 heads, head dim 80, non-causal) at 32768
   frames and at 8 x 1500 (30 s of audio at 50 frames a second), each
   held to its contract and timed beside its plain version, SDPA and the
   bound; ``[frontend] hubert``, hubert-xlarge at full width and depth (48
   layers, bf16, weights from seed 0, frames from numpy): ``Model.prefill``
   of one 32768-frame sequence twice (48 ``bf16_dh80`` launches a call,
   the caches (1, 48, 1, 32768, 16, 80), wall ms, peak memory, a profiled
   call's flash ms), then of 8 x 1500 frames, held against the same model
   through the plain flash version on the card (``FRONTEND_BF16_RTOL``;
   layer 0's caches bit-equal), and the smoke encoder at head dim 80 in
   f32 through the f32 kernel, card against CPU; ``[frontend] llava``,
   llava-next-mistral-7b at full width and depth (32 layers, bf16):
   ``Model.prefill`` of 2880 patch embeddings and 29888 text tokens twice
   (32 ``bf16_dh128`` launches a call), then the serve launcher at
   ``--arch llava-next-mistral-7b`` (batch 1, prompt 32, 16 tokens, 2
   requests);
13. runs the MoE family: ``[flash-dh32]``, both flash kernels at head dim
   32 (the MoE and yi-9b smoke models'), causal and not, with and without
   a window, held to their contracts, and timed at qwen3-moe-30b-a3b's
   32/4 heads over 32768 tokens beside the plain version, SDPA and the
   bound; ``[prefill-moe]``, qwen3-moe-30b-a3b at its published widths
   with 8 of its 48 layers (bf16, weights from seed 0): ``Model.prefill``
   of 32768 tokens twice (8 ``bf16_dh128`` launches a call), a profiled
   call split by the stages of ``models/moe.py`` (flash, the experts'
   matmuls and the rest of their SwiGLU, the router, the gather and
   scatter, the rest), then 4 decode steps past the prompt; ``[moe-small]``,
   the qwen3-moe and llama4 smoke models in f32 and bf16, chunked and
   naive, prefill of 24 plus 40 decode steps card against CPU (bf16 on the
   CPU's expert picks, the card's own picks differing in at most
   ``MOE_PICK_MISMATCH_SHARE`` of the tokens), and the serve launcher at
   its qwen3-moe smoke;
14. ``[prefill-gemma2-f32]``: gemma2-9b at its published widths with
   ``dtype="float32"``, 8 of its 42 layers (4 local, 4 global; weights
   from seed 0): ``Model.prefill`` of 32768 tokens twice (4 ``f32_dh256``
   and 4 ``f32_dh256_window`` launches a call, counted by the wrappers and
   by the profiler, the call split into flash, matmul and other, the
   peak), the same prefill against the plain flash version on the card
   (logits and every cache leaf within 1e-5 of max|want|), then 4 decode
   steps past the prompt;
15. ``[train-archs]``: gemma-7b at its published widths with 1 of its 28
   layers, 4 nodes on the ring, top_k 0.01, bf16 EF state, plain SGD,
   sequence 512 x batch 4 per node, 3 steps through
   ``DecentralizedTrainer`` (ms a step, the peak, wire bytes per node per
   step, one EF launch per bucket a step); the gemma2-9b, gemma-7b, yi-9b,
   hubert-xlarge and llava-next-mistral-7b smoke models, f32 and bf16
   compute, top_k and QSGD, 2 steps each card against CPU; the training
   launcher at ``--arch gemma2-9b`` and ``hubert-xlarge``;
16. ``[flash-instances]``: every instance of both flash kernels (each
   dtype, head dim and window) at one common causal case, (1, 8192,
   16/8), window 1024, through the FLASH_CASES check (``[kernel]
   flash_attention instance <variant>`` lines): held to its contract and
   timed beside its plain version, SDPA in its dtype and the bound;
17. prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Each phase prints ``[phase] <name> <seconds> s`` as it ends (the host's
clock), and the detail JSON line carries the seconds under ``phases_s``.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the repository's ``src/`` beside it, it exits non-zero and prints no result.
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# At full width and sequence 512 the backward pass leaves the caching
# allocator's blocks fragmented; on an 80 GB card the exchange's 4.6 GiB
# buffers then no longer fit unless segments can grow in place.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

N_NODES = 4
STEPS = 3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32_TC_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
#: TF32 products per f32 product in the f32 flash kernel (3xTF32)
TF32_TERMS = 3
ODD_LENGTH = 1_000_003
GOSSIP_KERNELS = ("qsgd_codes_kernel", "qsgd_leaf_codes_kernel",
                  "sign_codes_kernel", "dequantize_kernel", "ef_update_kernel",
                  "ef_update_bf16_kernel", "replica_matching_kernel",
                  "replica_stale_kernel")
#: [state-bf16]: the compressors of the full-width runs with bf16 EF state
STATE_BF16_COMPRESSORS = ("top_k", "qsgd")
#: columns of the bf16 EF update's plain version per call, when it is held
#: and timed over a whole buffer (its exact FMA runs in f64)
EF_BF16_PLAIN_CHUNK = 1 << 25
#: one node's tied-embedding bucket of gemma-7b (256000 x 3072), the
#: largest the bf16 EF update gets ([train-archs]): at 4 nodes its last
#: rows start past 2^31 elements
EF_BF16_WIDE = 786_432_000
#: the bf16 tensor-core flash kernel (the prefill's) and the f32 one
FLASH_KERNELS = ("flash_tc_kernel", "flash_attention_kernel")
#: one node's embedding bucket, 311,164,928 elements, as (R, 128) tiles
EMBED_TILES = (2_430_976, 128)
#: (label, shape, k, ties): the top-k mask kernel's cases; the first is
#: timed.  k = 2 is ceil(0.01 * 128), 13 the JAX tests' value.
TOPK_CASES = (
    ("embedding bucket", EMBED_TILES, 2, False),
    ("embedding bucket", EMBED_TILES, 13, False),
    ("C = 1024", (100_000, 1024), 13, False),
    ("C = 1024", (100_000, 1024), 100, False),
    ("planted ties", (100_000, 128), 13, True),
    ("planted ties", (50_000, 256), 2, True),
)
TRAIN_COMPRESSORS = ("qsgd", "sign", "top_k", "block_top_k")
#: [per-leaf] and [pipelined]: the compressors of their full-width runs
ENGINE_COMPRESSORS = ("top_k", "qsgd")
#: [pipelined]: the EF state of its full-width runs.  With f32 state the
#: pipelined step's copy of x and the exchange's temporaries, beside the
#: activations and gradients, overflow the 80 GB card (QSGD: out of memory
#: asking 4.64 GiB with 73.98 GiB allocated, in its first step), so the
#: full-width phase runs with bf16 state; the width is not cut
PIPELINED_STATE = "bfloat16"
#: one node's embedding leaf as the per-leaf engine compresses it: 75 rows
#: of BLOCK_COMPRESS_SIZE (311,164,928 elements, zero-padded)
EMBED_LEAF_ROWS = 75
#: (label, N, S, H, KV, Dh, dtype, causal, softcap, window); the first is
#: qwen3-1.7b's full-width prefill layer, and the first one that is timed.
#: Drawn in this order from one generator, so each case keeps its inputs
#: from run to run.
FLASH_CASES = (
    ("prefill layer", 1, 32768, 16, 8, 128, "bfloat16", True, None, None),
    ("odd length", 2, 1000, 16, 8, 128, "bfloat16", True, None, None),
    ("f32 softcap", 2, 512, 8, 8, 64, "float32", False, 50.0, None),
    ("S 2048", 1, 2048, 16, 8, 128, "bfloat16", True, None, None),
    ("Dh 64 softcap", 2, 512, 8, 8, 64, "bfloat16", False, 50.0, None),
    ("non-causal", 2, 1000, 16, 8, 128, "bfloat16", False, None, None),
    ("f32 S 2048", 1, 2048, 16, 8, 128, "float32", True, None, None),
    ("f32 odd length", 2, 1000, 16, 8, 128, "float32", True, None, None),
    ("f32 Dh 64 softcap causal", 2, 512, 8, 8, 64, "float32", True, 50.0,
     None),
    # gemma2-9b's global and local (window 4096) layers, gemma-7b's (MHA)
    ("gemma2 global layer", 1, 32768, 16, 8, 256, "bfloat16", True, 50.0,
     None),
    ("gemma2 local layer", 1, 32768, 16, 8, 256, "bfloat16", True, 50.0,
     4096),
    ("gemma-7b layer", 1, 32768, 16, 16, 256, "bfloat16", True, None, None),
    ("Dh 256 odd length window", 2, 1000, 16, 8, 256, "bfloat16", True, None,
     300),
    ("Dh 256 non-causal", 2, 1000, 16, 8, 256, "bfloat16", False, 50.0, None),
    ("non-causal window", 2, 1000, 16, 8, 128, "bfloat16", False, None, 300),
    ("Dh 256 non-causal window", 2, 1000, 16, 8, 256, "bfloat16", False,
     None, 300),
    ("Dh 64 window softcap", 2, 1000, 8, 4, 64, "bfloat16", True, 50.0, 100),
    ("f32 Dh 64 window softcap", 2, 1000, 8, 8, 64, "float32", True, 50.0,
     300),
    ("f32 Dh 128 window softcap", 2, 1000, 16, 8, 128, "float32", True, 50.0,
     300),
    ("f32 non-causal window", 2, 1000, 8, 4, 64, "float32", False, None, 100),
    # qwen3-moe-30b-a3b's full-width layer: 32/4 heads (GQA 8) at Dh 128
    ("qwen3-moe layer", 1, 32768, 32, 4, 128, "bfloat16", True, None, None),
    # the f32 kernel at Dh 256: gemma2-9b's global and local layers and
    # gemma-7b's with dtype float32, an odd length with a window, non-causal
    ("f32 gemma2 global layer", 1, 32768, 16, 8, 256, "float32", True, 50.0,
     None),
    ("f32 gemma2 local layer", 1, 32768, 16, 8, 256, "float32", True, 50.0,
     4096),
    ("f32 gemma-7b layer", 1, 32768, 16, 16, 256, "float32", True, None,
     None),
    ("f32 Dh 256 odd length window", 2, 1000, 16, 8, 256, "float32", True,
     None, 300),
    ("f32 Dh 256 non-causal", 2, 1000, 16, 8, 256, "float32", False, 50.0,
     None),
)
#: the FLASH_CASES timed beside the plain version, SDPA and the bound, each
#: a record of its own: the first stands for the qwen3-1.7b layer (the
#: ``flash_attention`` entry), the gemma2 layers for the Dh 256 variants
#: (bf16 and f32), the qwen3-moe layer for [prefill-moe]'s bf16_dh128
#: launches
FLASH_TIMED = ("prefill layer", "gemma2 global layer", "gemma2 local layer",
               "gemma-7b layer", "qwen3-moe layer", "f32 gemma2 global layer",
               "f32 gemma2 local layer", "f32 gemma-7b layer")
#: [decode-32k]: decode steps that continue gemma2-9b's 32768-token
#: prefill, past its global caches' prompt slots and around its local rings
DECODE_PAST_STEPS = 8
#: [dense small]: (arch, attn_impl[, head_dim]) of the smoke models held
#: card against CPU (yi-9b's chunked path runs the f32 kernel at head dim
#: 32; gemma2's and gemma-7b's at the full configs' head dim 256, the f32
#: kernel's Dh 256 instances)
DENSE_SMALL = (("gemma2-9b", "chunked"), ("gemma2-9b", "naive"),
               ("gemma-7b", "chunked"), ("gemma-7b", "naive"),
               ("yi-9b", "chunked"), ("yi-9b", "naive"),
               ("gemma2-9b", "chunked", 256), ("gemma-7b", "chunked", 256))
PREFILL_CALLS = 2
#: the f32 prefill test's cache tolerance, atol (rtol 1e-5), from
#: ``prefill_budget``'s measurements
PREFILL_CACHE_ATOL = 4e-5
#: [flash-dh80]: hubert-xlarge's attention layer (16/16 heads at Dh 80,
#: bidirectional) in both dtypes, at a 32768-frame sequence (the
#: prefill_32k length) and at its 30 s batch, 8 x 1500 frames (50 frames a
#: second; 1500 leaves a ragged last tile); all timed, drawn from a
#: generator of their own (seed 8), so FLASH_CASES keep their inputs
FLASH_DH80_CASES = (
    ("hubert layer", 1, 32768, 16, 16, 80, "bfloat16", False, None, None),
    ("hubert 30 s", 8, 1500, 16, 16, 80, "bfloat16", False, None, None),
    ("f32 hubert layer", 1, 32768, 16, 16, 80, "float32", False, None, None),
    ("f32 hubert 30 s", 8, 1500, 16, 16, 80, "float32", False, None, None),
)
FLASH_DH80_TIMED = tuple(case[0] for case in FLASH_DH80_CASES)
#: [prefill-moe]: qwen3-moe-30b-a3b at its published widths with its depth
#: cut from 48 to this many layers: each layer holds 623M parameters (128
#: experts of 3 x 2048 x 768), so 8 layers and the embeddings are 5.6B,
#: drawn in f32 (22.4 GB) and cast to bf16 (11.2 GB); 48 would be 61 GB in
#: bf16 and 122 GB as drawn
MOE_LAYERS = 8
#: [prefill-moe]: decode steps past its 32768-token prompt
MOE_DECODE_STEPS = 4
#: [moe-small]: (arch, dtype, attn_impl) of the MoE smoke models held card
#: against CPU (chunked: through the head-dim-32 flash kernels)
MOE_SMALL = tuple((arch, dtype, impl)
                  for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
                  for dtype in ("float32", "bfloat16")
                  for impl in ("chunked", "naive"))
#: [moe-small] bf16: the card's logits against the CPU's, max|d| within
#: this of max|logit| (the port's bf16 model tolerance): the devices' bf16
#: matmuls sum in other orders and round their outputs, and 40 decode
#: steps carry the differences
SMALL_BF16_RTOL = 3e-2
#: [moe-small] bf16: the largest share of tokens whose own expert picks on
#: the card may differ from the CPU's (the card replays the CPU's): a
#: bf16 ulp flips near-tied picks in at most 1 of 352 on an H100, where a
#: routing fault would flip most
MOE_PICK_MISMATCH_SHARE = 0.02
#: the serve launcher at the qwen3-moe smoke model: the JAX launcher's
#: defaults, 2 requests
SERVE_MOE_ARGS = ("--smoke", "--batch", "8", "--prompt-len", "32",
                  "--gen-len", "32", "--requests", "2")
#: [flash-dh32]: both kernels at head dim 32 (the qwen3-moe, llama4 and
#: yi-9b smoke models'), causal and not, with and without a window, at
#: ragged lengths; the first two, qwen3-moe-30b-a3b's 32/4 heads at the
#: smoke head dim over a 32768-token sequence, are timed.  Drawn from a
#: generator of their own (seed 9)
FLASH_DH32_CASES = (
    ("qwen3-moe heads Dh 32", 1, 32768, 32, 4, 32, "bfloat16", True, None,
     None),
    ("f32 qwen3-moe heads Dh 32", 1, 32768, 32, 4, 32, "float32", True,
     None, None),
    ("Dh 32 odd length", 2, 1000, 4, 2, 32, "bfloat16", True, None, None),
    ("Dh 32 non-causal softcap", 2, 1000, 8, 2, 32, "bfloat16", False, 50.0,
     None),
    ("Dh 32 window", 2, 1000, 4, 2, 32, "bfloat16", True, None, 300),
    ("Dh 32 non-causal window", 1, 200, 4, 4, 32, "bfloat16", False, None,
     129),
    ("f32 Dh 32 odd length", 2, 1000, 4, 2, 32, "float32", True, None, None),
    ("f32 Dh 32 non-causal softcap", 2, 1000, 8, 2, 32, "float32", False,
     50.0, None),
    ("f32 Dh 32 window", 2, 1000, 4, 2, 32, "float32", True, None, 300),
    ("f32 Dh 32 non-causal window", 1, 200, 4, 4, 32, "float32", False,
     None, 129),
)
FLASH_DH32_TIMED = tuple(case[0] for case in FLASH_DH32_CASES[:2])
#: [frontend] hubert: the long sequence and the 30 s batch (batch, frames)
HUBERT_LONG = (1, 32768)
HUBERT_BATCH = (8, 1500)
#: [frontend] llava: 2880 image tokens (5 anyres tiles x 576 patches) and
#: the text that makes the prefill_32k length
LLAVA_TEXT = 32768 - 2880
#: the frontends' full-width bf16 prefill through the kernel against the
#: same model through the plain flash version on the card: logits and
#: every cache leaf within this of max|want| (the port's bf16 model
#: tolerance, tests/test_torch_frontends.py)
FRONTEND_BF16_RTOL = 3e-2
#: [frontend] hubert small: the card's f32 caches against the CPU's, atol
#: (rtol 1e-5): tests/test_torch_cuda.py's frontend test read 5.2e-05 in
#: the layer-0 k cache at position 261 of 300 (the rotary angle's ulps
#: grow with the position), above PREFILL_CACHE_ATOL's 200 positions
HUBERT_SMALL_CACHE_ATOL = 1e-4
#: the serve launcher at llava-next-mistral-7b: one short request pair
SERVE_LLAVA_ARGS = ("--batch", "1", "--prompt-len", "32", "--gen-len", "16",
                    "--requests", "2")
#: [prefill-gemma2-f32]: gemma2-9b at its published widths in f32 with its
#: depth cut from 42 to this many layers, 4 local and 4 global: 2.50B
#: parameters, 10.0 GB in f32; the global caches at 32768 tokens 4 x 537
#: MB, the local rings 4 x 67 MB.  42 layers would be 37 GB of weights and
#: 12.7 GB of caches: they fit, but a call would take about 20 s
GEMMA2_F32_LAYERS = 8
#: [prefill-gemma2-f32]: decode steps past its 32768-token prompt
GEMMA2_F32_DECODE_STEPS = 4
#: [prefill-gemma2-f32]: the prefill through the f32 kernel against the
#: same model through the plain flash version on the card, logits and
#: every cache leaf within this of max|want| (the f32 kernel's contract)
PREFILL_F32_RTOL = 1e-5
#: [train-archs]: the full-width run, gemma-7b at its published widths
#: (arXiv:2403.08295) with depth 28 cut to 1, 4 nodes on the ring, top_k
#: 0.01, bf16 EF state, plain SGD, sequence 512 x batch 4 per node.  Per
#: node its leaves are 786.4M (the tied embedding) + 276.8M = 1.063B
#: parameters; at 12 B an element over 4 nodes (f32 x and gradient, bf16
#: x_hat and s) 51 GB, and 8.5 GB of bf16 compute copy
TRAIN_ARCH_FULL = ("gemma-7b", 1)
#: [train-archs]: the archs the launcher trains beside qwen3-1.7b, each
#: smoke model TRAIN_ARCHS_STEPS steps card against CPU per compute dtype
#: and compressor (TRAIN_ARCHS_COMPRESSORS)
TRAIN_ARCHS = ("gemma2-9b", "gemma-7b", "yi-9b", "hubert-xlarge",
               "llava-next-mistral-7b")
TRAIN_ARCHS_STEPS = 2
TRAIN_ARCHS_COMPRESSORS = (("top_k", (("fraction", 0.05),)),
                           ("qsgd", (("s", 16),)))
#: [train-archs]: the archs the launcher runs on the card (--smoke)
TRAIN_ARCHS_LAUNCHER = ("gemma2-9b", "hubert-xlarge")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


#: seconds of each phase of this run, in order
PHASES = {}


@contextlib.contextmanager
def phase(name):
    """Time one phase of the script on the host's clock and print
    ``[phase] <name> <seconds> s`` when it ends."""
    t0 = time.perf_counter()
    yield
    PHASES[name] = time.perf_counter() - t0
    print(f"[phase] {name} {PHASES[name]:.1f} s", flush=True)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_interleaved_ms(fns, rounds, per_round):
    """Mean device ms per call of each of ``fns``, timed in turns in one
    loop: each round times ``per_round`` calls of each between CUDA
    events, the order reversed every other round, so what drifts over the
    loop falls on all of them alike.  Returns (the means, each one's share
    of the rounds in which it was the fastest)."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total = [0.0] * len(fns)
    wins = [0] * len(fns)
    for r in range(rounds):
        order = list(range(len(fns)))[::(-1 if r % 2 else 1)]
        ms = [0.0] * len(fns)
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_round):
                fns[i]()
            end.record()
            end.synchronize()
            ms[i] = start.elapsed_time(end) / per_round
            total[i] += ms[i]
        wins[ms.index(min(ms))] += 1
    return [t / rounds for t in total], [w / rounds for w in wins]


def bound_ms(tensors_in, tensors_out, flops, flops_per_s=F32_FLOPS_PER_S):
    """Least time for the work: the larger of bytes / HBM rate (each input
    read once, each output written once) and flops / the card's peak rate
    for the inputs' type (f32 outside the tensor cores by default)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors_in + tensors_out)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def check_kernels(lengths, dev):
    """Each kernel against its plain version at each (n, length); bit
    equality is required.  Returns per-kernel timing records at the
    largest length and the max error seen per kernel."""
    import torch
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    records, max_err = {}, {}

    def compare(name, pairs, length):
        """pairs: (kernel output, plain output or row -> plain row), held
        one node row at a time so the check adds little memory."""
        err, same = 0.0, True
        for got, want in pairs:
            for i in range(got.shape[0]):
                w = want[i] if torch.is_tensor(want) else want(i)
                same = same and torch.equal(got[i], w)
                err = max(err, float((got[i].double() - w.double()).abs().max()))
        check(same, f"{name} at length {length}: kernel and plain version "
              f"differ (max abs {err})")
        max_err[name] = max(max_err.get(name, 0.0), err)

    def report(name, length, ms, plain_ms, lib_ms, bound):
        bms, by = bound
        print(f"[kernel] {name} n={N_NODES} len={length}: bit-equal; "
              f"{ms:.3f} ms (bound {bms:.3f} ms, {by}), plain {plain_ms:.3f} ms"
              + (f", library {lib_ms:.3f} ms" if lib_ms is not None else ""),
              flush=True)
        if length in (max(lengths), EF_BF16_WIDE):
            key = name if length == max(lengths) else f"{name}_len{length}"
            records[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bms, bound_by=by,
                                 shape=[N_NODES, length])

    for length in lengths:
        reps = 5 if length > 50_000_000 else 20
        shape = (N_NODES, length)
        x = torch.randn(shape, generator=gen, device=dev)
        xi = torch.rand(shape, generator=gen, device=dev)
        norm = torch.sqrt(torch.sum(torch.square(x), dim=1))
        inv = 1.0 / norm
        inv_full = 0.999 / x.abs().amax(dim=1)
        for s in (16, 255):
            suffix = "" if s <= 127 else "_int16"
            full = dispatch.qsgd_codes(x, xi, inv_full, s)
            compare("qsgd_codes" + suffix,
                    [(full, ref.qsgd_codes_ref(x, xi, inv_full, s))], length)
            top = int(full.abs().amax())
            check(top >= s - 1, f"qsgd_codes s={s} at length {length}: max "
                  f"|code| {top} with inv = 0.999/max|x|, expected >= {s - 1}")
            full_scale = 1.0 / (inv_full * s)
            compare("dequantize" + suffix,
                    [(dispatch.dequantize(full, full_scale),
                      ref.dequantize_ref(full, full_scale))], length)
            print(f"[kernel] qsgd_codes{suffix} s={s} len={length}, inv = "
                  f"0.999/max|x|: bit-equal, max |code| {top}; dequantize of "
                  f"those codes bit-equal", flush=True)
            del full
            codes = dispatch.qsgd_codes(x, xi, inv, s)
            compare("qsgd_codes" + suffix,
                    [(codes, ref.qsgd_codes_ref(x, xi, inv, s))], length)
            report("qsgd_codes" + suffix, length,
                   time_ms(lambda: dispatch.qsgd_codes(x, xi, inv, s), reps),
                   time_ms(lambda: ref.qsgd_codes_ref(x, xi, inv, s), reps),
                   None, bound_ms([x, xi, inv], [codes], 7 * x.numel()))
            scale = norm / (s * 8.0)
            dense = dispatch.dequantize(codes, scale)
            compare("dequantize" + suffix,
                    [(dense, ref.dequantize_ref(codes, scale))], length)
            report("dequantize" + suffix, length,
                   time_ms(lambda: dispatch.dequantize(codes, scale), reps),
                   time_ms(lambda: ref.dequantize_ref(codes, scale), reps),
                   time_ms(lambda: torch.mul(codes, scale[:, None]), reps),
                   bound_ms([codes, scale], [dense], x.numel()))
            del codes, dense
        signs = dispatch.sign_codes(x)
        compare("sign_codes", [(signs, ref.sign_codes_ref(x))], length)
        report("sign_codes", length,
               time_ms(lambda: dispatch.sign_codes(x), reps),
               time_ms(lambda: ref.sign_codes_ref(x), reps), None,
               bound_ms([x], [signs], x.numel()))
        del signs, xi
        ins = [x] + [torch.randn(shape, generator=gen, device=dev)
                     for _ in range(4)]
        gamma = 1.956e-05
        # per-node weights: star's at n = 4 (self 0.25 at the hub, 0.75 at
        # a leaf; receive 0.25), and the ring's uniform 1/3 as a filled
        # vector
        node = lambda w: torch.tensor(w, dtype=torch.float32, device=dev)
        w_star = (node((0.25, 0.75, 0.75, 0.75)), node((0.25,) * N_NODES))
        w_ring = (node((1 / 3,) * N_NODES), node((1 / 3,) * N_NODES))
        # the plain version first, so its temporaries are freed before the
        # in-place copies below are made
        plain_ms = time_ms(lambda: ref.ef_update_ref(*ins, *w_star, gamma),
                           reps)
        for w in (w_ring, w_star):
            # in place, as the exchange calls it: x_half, x_hat and s
            # updated; the plain version row by row (elementwise, so the
            # same numbers)
            inplace = [t.clone() for t in ins[:3]]
            dispatch.ef_bucket_update(*inplace, *ins[3:], *w, gamma)
            plain_row = lambda j, w=w: (lambda i: ref.ef_update_ref(
                *[t[i:i + 1] for t in ins], *[v[i:i + 1] for v in w],
                gamma)[j][0])
            compare("ef_update", [(o, plain_row(j))
                                  for j, o in enumerate(inplace)], length)
        # timed with star's weights on the same buffers, which each call
        # updates again
        report("ef_update", length,
               time_ms(lambda: dispatch.ef_bucket_update(*inplace, *ins[3:],
                                                         *w_star, gamma), reps),
               plain_ms, None, bound_ms(ins + list(w_star), inplace,
                                        8 * x.numel()))
        del inplace
        check_ef_bf16(x, [t.to(torch.bfloat16) for t in ins[1:]], gamma,
                      length, reps, compare, report)
        del ins, x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # the bf16-state EF update at the largest bucket a path gives it:
    # gemma-7b's tied embedding ([train-archs]), its last rows starting
    # past 2^31 elements in
    shape = (N_NODES, EF_BF16_WIDE)
    x = torch.randn(shape, generator=gen, device=dev)
    check_ef_bf16(x, [torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(4)],
                  1.956e-05, EF_BF16_WIDE, 3, compare, report)
    del x
    torch.cuda.empty_cache()
    return records, max_err


def check_ef_bf16(x, rest, gamma, length, reps, compare, report):
    """The bf16-state EF update (``ef_update_bf16``) at one length: x f32
    and ``rest``, x_hat, s, q_self, q_nbr, bf16; the ring's uniform
    weights (bf16-valued, the weighted sum in bf16) and chain's per-node
    self weights (2/3 and 1/3: the sum in f32, and its FMA recomputation
    for x differs from s' in some elements), in place, bit for bit against
    ``ref.ef_update_bf16_ref`` (row by row, in column chunks: its exact
    FMA runs in f64).  Timed with chain's weights; the plain version is
    timed over the whole buffers in column chunks of EF_BF16_PLAIN_CHUNK."""
    import torch
    from repro_torch.kernels import dispatch, ref
    dev = x.device
    bf = torch.bfloat16
    node = lambda w: torch.tensor(w, dtype=torch.float32, device=dev)
    third = node((1 / 3,) * N_NODES).to(bf).float()
    w_ring = (third, third, True)
    w_chain = (node((2 / 3, 1 / 3, 1 / 3, 2 / 3)), third, False)
    cols = range(0, length, EF_BF16_PLAIN_CHUNK)

    def plain(w):
        for c in cols:
            part = slice(c, c + EF_BF16_PLAIN_CHUNK)
            ref.ef_update_bf16_ref(x[:, part], *[t[:, part] for t in rest],
                                   w[0], w[1], gamma, w[2])
    plain_ms = time_ms(lambda: plain(w_chain), max(2, reps // 4))
    for w in (w_ring, w_chain):
        inplace = [x.clone(), rest[0].clone(), rest[1].clone()]
        dispatch.ef_bucket_update(*inplace, *rest[2:], *w[:2], gamma, w[2])
        for j, out in enumerate(inplace):
            pairs = []
            for c in cols:
                part = slice(c, c + EF_BF16_PLAIN_CHUNK)
                pairs.append((out[:, part], lambda i, j=j, part=part, w=w:
                              ref.ef_update_bf16_ref(
                                  x[i:i + 1, part],
                                  *[t[i:i + 1, part] for t in rest],
                                  w[0][i:i + 1], w[1][i:i + 1], gamma,
                                  w[2])[j][0]))
            compare("ef_update_bf16", pairs, length)
        if w is w_ring:
            del inplace
    report("ef_update_bf16", length,
           time_ms(lambda: dispatch.ef_bucket_update(
               *inplace, *rest[2:], *w_chain[:2], gamma, False), reps),
           plain_ms, None, bound_ms([x] + rest + list(w_chain[:2]), inplace,
                                    10 * x.numel()))
    del inplace, rest
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def topk_input(shape, ties, gen, dev):
    """Gaussian rows, or small integers (every magnitude repeats) with every
    third row one magnitude throughout and half of every fifth row zero."""
    import torch
    if not ties:
        return torch.randn(shape, generator=gen, device=dev)
    x = torch.randint(-3, 4, shape, generator=gen, device=dev).float()
    x[::3] = 1.0
    x[1::5, shape[1] // 2:] = 0.0
    return x


def check_topk(dev):
    """The top-k mask kernel against its plain version in TOPK_CASES: mask
    and thresholds bit-equal.  Returns the timing record of the first case
    and the max abs difference of mask or thresholds over every case."""
    import torch
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(8)
    record, max_err = None, 0.0
    for label, shape, k, ties in TOPK_CASES:
        x = topk_input(shape, ties, gen, dev)
        mask, thresh = dispatch.block_topk_mask(x, k)
        want_mask, want_thresh = ref.block_topk_mask_ref(x, k)
        same = torch.equal(mask, want_mask) and torch.equal(thresh, want_thresh)
        err = max(float((mask - want_mask).abs().max()),
                  float((thresh - want_thresh).abs().max()))
        max_err = max(max_err, err)
        kept = mask.sum(dim=1)
        print(f"[kernel] block_topk_mask {label} {shape} k={k}: mask and "
              f"thresholds bit-equal: {same} (max abs difference {err}); "
              f"kept per row {int(kept.min())}..{int(kept.max())}", flush=True)
        check(same, f"block_topk_mask {label} {shape} k={k}: kernel and "
              f"plain version differ")
        check(bool((kept >= min(k, shape[1])).all()),
              f"block_topk_mask {label}: a row kept fewer than k")
        if record is None:
            reps = 20
            rows, cols = shape
            # 4 B read and 4 B written per element, 4 B per row's threshold;
            # per element |x|, the max, and a compare and an add in each of
            # the 24 rounds, the final compare: 51 operations
            bms, by = bound_ms([x], [mask, thresh], 51 * x.numel())
            mag = x.abs()
            record = dict(
                ms=time_ms(lambda: dispatch.block_topk_mask(x, k), reps),
                plain_ms=time_ms(lambda: ref.block_topk_mask_ref(x, k), 3),
                library_ms=time_ms(lambda: torch.topk(mag, k, dim=1), reps),
                bound_ms=bms, bound_by=by, shape=list(shape), k=k)
            print(f"[kernel] block_topk_mask {shape} k={k}: {record['ms']:.3f} "
                  f"ms (bound {bms:.3f} ms, {by}), plain "
                  f"{record['plain_ms']:.3f} ms, torch.topk(|x|, k, dim=1) "
                  f"{record['library_ms']:.3f} ms (exactly k per row, ties "
                  f"broken; the kernel keeps ties)", flush=True)
            del mag
        del x, mask, thresh, want_mask, want_thresh
        torch.cuda.empty_cache()
    return record, max_err


def topk_selection_cuda_vs_cpu(dev):
    """The trainer's top-k selection (plain PyTorch, no kernel) on tied
    inputs, on the card against the CPU: the same indices in the same
    order (torch.topk alone breaks ties differently, and differently on
    the two devices).  Cases: TopK's ``topk_rows`` at three k, BlockTopK's
    ``block_topk_select`` at block 128, and the oversized-bucket form,
    ``block_topk_select`` at block MAX_BUCKET_ELEMS with a ragged tail."""
    import torch
    from repro_torch.comm.packing import MAX_BUCKET_ELEMS
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(10)
    x = topk_input((N_NODES, 70_001), True, gen, dev)
    xc = x.cpu()
    for k in (1, 700, 5000):
        same = torch.equal(ops.topk_rows(x, k).cpu(), ops.topk_rows(xc, k))
        print(f"[select] topk_rows {tuple(x.shape)} k={k}, tied: card and "
              f"CPU indices equal: {same}", flush=True)
        check(same, f"topk_rows k={k}: the card and the CPU select differently")
    big = topk_input((N_NODES, MAX_BUCKET_ELEMS + 70_001), True, gen, dev)
    # the trainer's budget there at fraction 0.01, ceil(k / n_blocks) per row
    d = big.shape[1]
    k_bucket, n_blocks = -(-d // 100), -(-d // MAX_BUCKET_ELEMS)
    kb = -(-k_bucket // n_blocks)
    for t, block, k in ((x, 128, 2), (big, MAX_BUCKET_ELEMS, kb)):
        v, i = ops.block_topk_select(t, k, block=block)
        cv, ci = ops.block_topk_select(t.cpu(), k, block=block)
        same = torch.equal(v.cpu(), cv) and torch.equal(i.cpu(), ci)
        print(f"[select] block_topk_select {tuple(t.shape)} block={block} "
              f"k={k}, tied: card and CPU values and indices equal: {same}",
              flush=True)
        check(same, f"block_topk_select block={block}: the card and the CPU "
              f"select differently")
    del x, big
    torch.cuda.empty_cache()


def topk_ops_path(dev):
    """The mask kernel's public op, ``ops.block_topk_compress_vector``, on
    one node's embedding bucket (311,164,928 elements) with k = 2 and at
    the odd length with k = 13; the launch count is read before the
    outputs are held against the plain version on the card."""
    import torch
    from repro_torch.kernels import dispatch, ops, ref
    gen = torch.Generator(device=dev).manual_seed(9)
    cases = [(EMBED_TILES[0] * EMBED_TILES[1], 2), (ODD_LENGTH, 13)]
    inputs = [torch.randn((d,), generator=gen, device=dev) for d, _ in cases]
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    outs = [ops.block_topk_compress_vector(x, k)
            for x, (_, k) in zip(inputs, cases)]
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    check(counts["block_topk_mask"] == len(cases)
          and sum(counts.values()) == len(cases), f"ops path counts {counts}")
    for x, (d, k), got in zip(inputs, cases, outs):
        xt, _ = ops._to_tiles(x)
        mask, _ = ref.block_topk_mask_ref(xt, k)
        want = ops._from_tiles(xt * mask, d)
        check(got.shape == (d,) and torch.equal(got, want),
              f"block_topk_compress_vector at {d}: kernel path and plain "
              f"version differ")
        kept = int((got != 0).sum())
        print(f"[ops] block_topk_compress_vector d={d} k={k}: bit-equal to "
              f"the plain version; {kept} nonzero of {d} "
              f"({kept / -(-d // 128):.3f} per 128-lane row)", flush=True)
        del xt, mask, want
    del inputs, outs
    torch.cuda.empty_cache()
    return counts


def stream_busy(prof):
    """Per CUDA stream of a profiled window: the union of its kernels',
    copies' and fills' intervals, in us, from the profiler's trace."""
    spans = {}
    for e in trace_events(prof):
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            stream = (e.get("args") or {}).get("stream")
            spans.setdefault(stream, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("name", "")))
    return {k: (_merge([(a, b) for a, b, _ in v]), [n for _, _, n in v])
            for k, v in spans.items()}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(intervals):
    return sum(b - a for a, b in intervals)


def _intersect(u, v):
    out, i, j = [], 0, 0
    while i < len(u) and j < len(v):
        a, b = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        if a < b:
            out.append([a, b])
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_report(prof, wall_ms):
    """The side stream (the one that ran the EF update) against the
    other streams of a profiled pipelined step: each one's busy ms, the
    ms both were busy at once, the side stream's share of its busy time
    hidden under the others', and the device's busy ms and idle share
    from the union of all streams."""
    busy = stream_busy(prof)
    side = [k for k, (_, names) in busy.items()
            if any("ef_update" in n for n in names)]
    check(len(side) == 1, f"[pipelined] the EF update ran on streams {side}, "
          f"expected one side stream")
    side = side[0]
    others = _merge([iv for k, (ivs, _) in busy.items() if k != side
                     for iv in ivs])
    both = _intersect(busy[side][0], others)
    union = _merge([iv for ivs, _ in busy.values() for iv in ivs])
    side_ms, main_ms = _length(busy[side][0]) / 1e3, _length(others) / 1e3
    both_ms = _length(both) / 1e3
    return {"side_stream": side, "streams": sorted(map(str, busy)),
            "side_busy_ms": side_ms, "main_busy_ms": main_ms,
            "overlap_ms": both_ms,
            "side_hidden_share": both_ms / side_ms if side_ms else 0.0,
            "device_busy_ms": _length(union) / 1e3,
            "device_idle_share": 1.0 - _length(union) / 1e3 / wall_ms}


def trace_events(prof):
    """The profiler's chrome trace of a profiled window, as its event
    list."""
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as fh:
            return json.load(fh).get("traceEvents", [])


def launch_audit(prof, ours, wrapper, listed, window_us):
    """Where the profiler lost launches that the wrappers counted: the
    kernel events of ``ours`` in the chrome trace (against ``listed``, the
    count ``key_averages`` gave), by stream; the first and last of them
    and of all kernels, against the profiled window's start (the trace's
    first CPU event; ``window_us`` its wall length); and the launch calls
    (runtime or driver, matched by correlation id) that have no kernel
    event, with where they fell in the window.  ``explained``: the trace
    and key_averages agree, and the launches they lack are no more than
    the launch calls without a kernel event (the profiler dropped those
    kernels' records).  Printed and returned."""
    events = trace_events(prof)
    kernels = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "kernel"),
                     key=lambda e: float(e["ts"]))
    mine = [e for e in kernels if any(k in e.get("name", "") for k in ours)]
    cpu = [float(e["ts"]) for e in events if e.get("ph") == "X"
           and e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
    t0 = min(cpu) if cpu else min((float(e["ts"]) for e in kernels), default=0)
    seen = {(e.get("args") or {}).get("correlation") for e in kernels}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
                and "aunch" in e.get("name", "")]
    lost = [[e.get("name"), round(float(e["ts"]) - t0, 1)] for e in launches
            if (e.get("args") or {}).get("correlation") not in seen]
    by_stream = collections.Counter((e.get("args") or {}).get("stream")
                                    for e in mine)
    span = lambda es: ([round(float(es[0]["ts"]) - t0, 1),
                        round(float(es[-1]["ts"]) + float(es[-1].get("dur", 0))
                              - t0, 1)] if es else None)
    audit = {"wrapper": wrapper, "key_averages": listed,
             "trace": len(mine), "by_stream": {str(k): v for k, v in
                                              by_stream.items()},
             "ours_first_last_us": span(mine),
             "all_first_last_us": span(kernels), "window_us": window_us,
             "launch_calls": len(launches),
             "launch_calls_without_kernel": lost[:20],
             "n_launch_calls_without_kernel": len(lost),
             "last_without_kernel_us": max((t for _, t in lost), default=None),
             "explained": len(mine) == listed
             and 0 <= wrapper - listed <= len(lost)}
    print(f"[profile] launch audit: the wrappers counted {wrapper} launches "
          f"of {list(ours)}, key_averages listed {listed}, the trace holds "
          f"{len(mine)} such kernel events {dict(by_stream)}; ours span "
          f"{audit['ours_first_last_us']} us and all kernels "
          f"{audit['all_first_last_us']} us of a {window_us:.1f} us window; "
          f"{len(lost)} of {len(launches)} launch calls have no kernel event "
          f"(the last {audit['last_without_kernel_us']} us into the window; "
          f"the first: {lost[:5]}); explained by those: "
          f"{audit['explained']}", flush=True)
    return audit


#: tiny launches the profiler's warm-up step makes before the profiled
#: call: in chip_smoke.py's runs the profiler dropped the kernel records of
#: up to ~60 launches at the start of a window it opened (launch calls with
#: no kernel event, all in its first ~3 ms), once one of hubert's flash
#: launches; the warm-up step takes that loss
PROFILER_WARMUP_LAUNCHES = 256


def profiled(fn):
    """(the profiler, wall ms) of one call of ``fn`` under torch.profiler
    (CPU and CUDA), its active step after one warm-up step of
    PROFILER_WARMUP_LAUNCHES tiny launches, whose records the profiler
    discards."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(PROFILER_WARMUP_LAUNCHES):
            x.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def is_matmul(kernel_name):
    """Whether a kernel is a library matrix product (cuBLAS, CUTLASS)."""
    return any(k in kernel_name.lower() for k in ("gemm", "nvjet", "xmma",
                                                  "cutlass", "matmul"))


def profile_call(label, fn, ours, show=True, streams=False, audit=False):
    """One more call of ``fn`` under torch.profiler: device time by kernel,
    grouped into the port's kernels (names in ``ours``), matmuls and
    everything else; printed unless ``show`` is False.  ``streams``: also
    read the trace for the pipelined step's side stream
    (:func:`overlap_report`).  The launches of ``ours`` that the profiler
    lists are held against the wrappers' counts over the same call; where
    they differ (or with ``audit``), :func:`launch_audit` reads the trace
    for the missing ones."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels import dispatch
    before = sum(dispatch.launch_counts().values())
    prof, wall = profiled(fn)
    wrapper = sum(dispatch.launch_counts().values()) - before
    dev_us = lambda e: (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    # the device's events but the annotations spanning them (the schedule's
    # "ProfilerStep#1", record_function ranges), whose time is the kernels'
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("ProfilerStep")]
    kernels = [(dev_us(e) / 1e3, e.key) for e in events if dev_us(e) > 0]
    if not kernels:
        print(f"[profile] {label}: the profiler recorded no device time",
              flush=True)
        return None
    groups = {"port kernels": 0.0, "matmul": 0.0, "other": 0.0}
    # device ms and launches of each of ours, by the name it is matched on
    by_kernel = {k: [0.0, 0] for k in ours}
    for e in events:
        for k in ours:
            if k in e.key:
                by_kernel[k][0] += dev_us(e) / 1e3
                by_kernel[k][1] += e.count
    for ms, name in kernels:
        if any(k in name for k in ours):
            groups["port kernels"] += ms
        elif is_matmul(name):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    launches = sum(e.count for e in events if dev_us(e) > 0)
    # busy and wall of the same profiled call; the profiler's own host
    # cost is in the wall time, so the share errs towards idle
    idle = 1.0 - busy / wall
    # the host side: where the CPU spends the step (runtime calls such as
    # synchronisations and allocations show here, not on the device)
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)[:6]
    if show:
        print(f"[profile] {label}: wall {wall:.3f} ms (profiled), device busy "
              f"{busy:.3f} ms in {launches} kernel launches, device idle "
              f"share {idle:.4f}; " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in groups.items()), flush=True)
        for ms, name in sorted(kernels, reverse=True)[:12]:
            print(f"[profile] {ms:9.3f} ms  {name[:110]}", flush=True)
        for ms, name, count in host:
            print(f"[profile] host {ms:9.3f} ms  {name[:80]} (x{count})",
                  flush=True)
    out = {"wall_ms": wall, "device_busy_ms": busy, "launches": launches,
           "device_idle_share": idle, "by_kernel": by_kernel,
           "kernel_names": {e.key: [dev_us(e) / 1e3, e.count] for e in events
                            if dev_us(e) > 0},
           "host_top": [[ms, name, count] for ms, name, count in host],
           "wrapper_launches": wrapper, **groups}
    listed = sum(c for _, c in by_kernel.values())
    if audit or listed != wrapper:
        out["launch_audit"] = launch_audit(prof, ours, wrapper, listed,
                                           wall * 1e3)
    if streams:
        ov = overlap_report(prof, wall)
        out["streams"] = ov
        print(f"[profile] {label}: side stream {ov['side_stream']} busy "
              f"{ov['side_busy_ms']:.3f} ms, the other streams "
              f"{ov['main_busy_ms']:.3f} ms, both at once "
              f"{ov['overlap_ms']:.3f} ms ({ov['side_hidden_share']:.4f} of "
              f"the side stream's); device busy (union) "
              f"{ov['device_busy_ms']:.3f} ms of {wall:.3f}, idle share "
              f"{ov['device_idle_share']:.4f} (streams {ov['streams']})",
              flush=True)
    return out


def memory_at_peak(label, fn, top=8):
    """One more call of ``fn`` under the caching allocator's memory
    history: replays its allocations and frees from the memory allocated
    before the call, finds the moment of the most memory allocated, and
    prints the blocks live then that the call allocated, grouped by the
    innermost frame in the port's code, largest first.  Returns
    ``{"before_gib", "peak_gib", "max_allocated_gib", "live": [[gib,
    where], ...]}``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=200_000,
                                             stacks="python")
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    cur = peak = before
    live, at_peak = {}, {}
    for ev in trace:
        if ev["action"] == "alloc":
            cur += ev["size"]
            live[ev["addr"]] = ev
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_requested":
            cur -= ev["size"]
            live.pop(ev["addr"], None)

    def where(ev):
        frames = ev.get("frames") or []
        ours = [f for f in frames if "repro_torch" in f["filename"]]
        f = (ours or frames or [{"filename": "?", "line": 0, "name": "?"}])[0]
        return (f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} "
                f"({f['name']})")
    groups = {}
    for ev in at_peak.values():
        groups[where(ev)] = groups.get(where(ev), 0) + ev["size"]
    gib = 2 ** 30
    rows = sorted(((v / gib, k) for k, v in groups.items()), reverse=True)
    out = {"before_gib": before / gib, "peak_gib": peak / gib,
           "max_allocated_gib": torch.cuda.max_memory_allocated() / gib,
           "live": [[g, k] for g, k in rows[:top]]}
    print(f"[memory] {label}: {out['before_gib']:.3f} GiB allocated before "
          f"the step, peak {out['peak_gib']:.3f} GiB by the replayed trace "
          f"({out['max_allocated_gib']:.3f} by the allocator's count); "
          f"allocated in the step and live at the peak: " + "; ".join(
              f"{g:.3f} GiB at {k}" for g, k in rows[:top]), flush=True)
    return out


def train_full_width(compressor, dev, topology="ring", mode="choco",
                     optimizer="momentum", lr=0.1, skew=None,
                     state_dtype="float32", packed=True, pipelined=False,
                     process=None, drop=0.1, tau=1, n_nodes=N_NODES,
                     memory_trace=False, arch="qwen3-1.7b", layers=2):
    """Full-width ``arch`` (qwen3-1.7b, 2 layers), ``n_nodes`` nodes, on
    ``topology`` (1 gossip round per step), in ``mode`` with the
    ``optimizer`` local step at ``lr``, on Dirichlet(``skew``) token
    shards where given, with the EF state x_hat and s in ``state_dtype``,
    through the packed or the per-leaf engine (``packed``), serial or
    pipelined, or under the topology ``process`` (link failures at
    ``drop``, bounded staleness at ``tau``): STEPS steps, then
    one profiled step (with the pipelined engine, its trace read for the
    side stream's overlap with the main stream's work), and with
    ``memory_trace`` one more under :func:`memory_at_peak`."""
    import torch
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model, count_params
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    kw = {"qsgd": (("s", 16),), "sign": ()}.get(compressor,
                                                 (("fraction", 0.01),))
    torch.cuda.reset_peak_memory_stats()
    tr = DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=compressor, comp_kwargs=kw,
                                            topology=topology,
                                            data_skew_alpha=skew,
                                            state_dtype=state_dtype,
                                            packed_gossip=packed,
                                            pipeline_gossip=pipelined,
                                            topology_process=process,
                                            edge_drop_prob=drop,
                                            max_staleness=tau),
        n_nodes=n_nodes, optimizer=make_optimizer(optimizer),
        lr_fn=cosine_schedule(lr, warmup=STEPS // 10 + 1, total=STEPS),
        device=dev, mode=mode)
    state = tr.init_state(seed=0)
    engine = (("packed" if packed else "per-leaf")
              + (" pipelined" if pipelined else "")
              + (f" {process}" if process else "")
              + (f" tau={tau}" if process == "staleness" else ""))
    flat = lambda bufs: [b for item in bufs for b in (
        item if isinstance(item, list) else [item])]
    compressed = mode in ("choco", "pushsum")
    if compressed:
        check({b.dtype for b in flat(state.x_hat) + flat(state.s)}
              == {getattr(torch, state_dtype)},
              f"[train] the EF state is not {state_dtype}")
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # the launcher's default sequence for the uncut model
    seq = min(full.n_layers * 64, 512)
    batches = make_lm_batch_fn(cfg, seq, 4, n_nodes, 1.0,
                               skew_alpha=tr.choco.data_skew_alpha)
    label = compressor if compressed else "none"
    skew_tv = None if skew is None else batches.skew_tv
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} seq={seq} batch=4 "
          f"params={count_params(cfg) / 1e6:.1f}M nodes={n_nodes} "
          f"mode={mode} optimizer={optimizer} lr={lr} "
          f"topology={topology} rounds={tr.schedules[0].n_rounds} "
          f"compressor={label} state_dtype={state_dtype} engine={engine} "
          f"buckets={tr.spec.n_buckets} leaves={len(tr.paths)} "
          f"gamma={tr.gamma:.3e}"
          + ("" if skew is None else
             f" data_skew_alpha={skew} skew_tv={skew_tv:.6f}"), flush=True)
    dispatch.reset_launch_counts()
    losses, step_ms, samples = [], [], []
    for _ in range(STEPS):
        batch = tr.batch_to_device(batches())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets = tr.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(mets["loss"])
        if process:
            samples.append([s_ if isinstance(s_, int) else s_.tolist()
                            for s_ in tr.exchange.last_samples])
        print(f"[train] step {state.step} loss {mets['loss']:.4f} "
              f"lr {mets['lr']:.4f} ({step_ms[-1]:.1f} ms)", flush=True)
    counts = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    retries = torch.cuda.memory_stats()["num_alloc_retries"]
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    # a payload per bucket, or per leaf
    units = tr.spec.n_buckets if packed else len(tr.paths)
    unit = "buckets" if packed else "leaves"
    expected = STEPS * tr.choco.gossip_steps * units
    # sparse payloads decode by scatter: no dequantize launch on their path;
    # the exact modes launch no kernel; push-sum launches choco's (one
    # decode per bucket serves every receiver of the stacked engine)
    choco = compressed
    bf16 = state_dtype == "bfloat16"
    ef = ("replica_update" if process else
          ("ef_update_bf16" if bf16 else "ef_update")
          + ("_pipelined" if pipelined else ""))
    on_path = {k: False for k in counts}
    on_path.update({"qsgd_codes" if packed else "qsgd_leaf_codes":
                    choco and compressor == "qsgd",
                    "sign_codes": choco and compressor == "sign",
                    "dequantize": choco and compressor in ("qsgd", "sign"),
                    ef: choco})
    for name, used in on_path.items():
        want = expected if used else 0
        print(f"[train] {mode} {label} {engine}: {name} launches "
              f"{counts[name]} (expected {want}: {STEPS} steps x "
              f"{tr.choco.gossip_steps} gossip_steps x {units} {unit} on its "
              f"path, else 0)", flush=True)
        check(counts[name] == want, f"{name}: {counts[name]} launches, "
              f"expected {want}")
    print(f"[train] {mode} {label} {optimizer} {state_dtype} state {engine}: "
          f"losses {losses}; ms/step "
          f"{step_ms} (first step included); peak device memory {peak:.2f} "
          f"GiB over the steps, {init_peak:.2f} GiB at init; allocator "
          f"retries (cache flushed to fit an allocation) so far {retries}",
          flush=True)
    batch = tr.batch_to_device(batches())
    profile = profile_call(f"one {mode} {label} {optimizer} {engine} step on "
                           f"the {topology}", lambda: tr.step(state, batch),
                           GOSSIP_KERNELS, streams=pipelined)
    memory = None
    if memory_trace:
        batch = tr.batch_to_device(batches())
        memory = memory_at_peak(f"one {mode} {label} step on the {topology}",
                                lambda: tr.step(state, batch))
    wire = wire_per_node_step(tr)
    rounds = tr.schedules[0].n_rounds
    mass = spread = None
    if mode == "pushsum":
        # the weight column's mass 1^T w, conserved, and its spread
        mass = float(state.psw.double().sum())
        spread = float(state.psw.max() / state.psw.min())
    del state, tr
    torch.cuda.empty_cache()
    return counts, {"topology": topology, "mode": mode,
                    "state_dtype": state_dtype, "engine": engine,
                    "units": units,
                    "optimizer": optimizer, "lr": lr, "skew_alpha": skew,
                    "skew_tv": skew_tv, "losses": losses,
                    "ms_per_step": step_ms, "peak_gib": peak,
                    "init_peak_gib": init_peak, "alloc_retries": retries,
                    "profile": profile, "process": process,
                    "samples": samples,
                    "wire_bytes_per_node_step": wire,
                    "rounds": rounds, "memory": memory,
                    "psw_mass": mass, "psw_spread": spread}


def wire_per_node_step(tr):
    """Bytes node 0 puts on the wire per step, computed from the spec: its
    payload bytes per bucket (or leaf) times the payloads it sends per
    step (the static engine and link failures: every schedule round node
    0 sends in; matching: the sampled round, which on the ring it always
    sends in; push-sum: every round, the first payload 4 bytes longer for
    w), for the exchange's gossip rounds; None in the exact modes."""
    from repro_torch.comm.packing import bucket_wire_nbytes, leaf_wire_nbytes
    from repro_torch.comm.pushsum import W_BYTES
    if tr.mode not in ("choco", "pushsum"):
        return None
    per = (bucket_wire_nbytes(tr.spec, tr.compressor)
           if tr.choco.packed_gossip
           else leaf_wire_nbytes(tr.spec, tr.compressor))
    rounds = tr.schedules[0].rounds
    sends = sum(r.peers(0)[0] is not None for r in rounds)
    if tr.process is not None and tr.process.kind == "matching":
        sends = 1
    w_bytes = W_BYTES if tr.mode == "pushsum" else 0
    return (sum(per) + w_bytes) * sends * tr.choco.gossip_steps


def state_bf16_full_width(dev, f32_runs):
    """[state-bf16]: the training cell (2 layers, ring, 4 nodes) with bf16
    EF state under top_k 0.01 and QSGD s=16, each printed beside the f32
    state's run of this call (``f32_runs``): ms/step, and the peak beside
    the prediction, 4 bytes less per parameter per node (x_hat and s at 2
    bytes each instead of 4)."""
    from repro_torch.configs.qwen3_1_7b import CONFIG
    from repro_torch.models.transformer import count_params
    saved = N_NODES * count_params(dataclasses.replace(CONFIG, n_layers=2)) * 4
    runs = {}
    for comp in STATE_BF16_COMPRESSORS:
        runs[comp] = train_full_width(comp, dev, state_dtype="bfloat16")
        rec, f32 = runs[comp][1], f32_runs[comp][1]
        rec["predicted_peak_gib"] = f32["peak_gib"] - saved / 2 ** 30
        print(f"[state-bf16] {comp}: ms/step {rec['ms_per_step']} against "
              f"the f32 state's {f32['ms_per_step']} (first step included); "
              f"peak {rec['peak_gib']:.3f} GiB against {f32['peak_gib']:.3f} "
              f"GiB, predicted {rec['predicted_peak_gib']:.3f} GiB (x_hat "
              f"and s save {saved} bytes = {saved / 2 ** 30:.3f} GiB); "
              f"allocator retries {rec['alloc_retries']}", flush=True)
    return runs


#: [modes]: (label, mode, compressor, optimizer, lr, data skew alpha) of the
#: full-width runs: CHOCO-SGD top_k 0.01 with Algorithm 2's own local step
#: on skewed data, exact D-SGD with the launcher's default local step, and
#: the all-reduce baseline with AdamW
MODES_RUNS = (("choco_top_k_sgd_skew", "choco", "top_k", "sgd", 0.1, 0.1),
              ("plain_momentum", "plain", "top_k", "momentum", 0.1, None),
              ("allreduce_adamw", "allreduce", "top_k", "adamw", 1e-3, None))


def modes_full_width(dev):
    """[modes]: MODES_RUNS at full width through ``train_full_width``,
    each printed beside the others: ms/step, peak memory, allocator
    retries, skew_tv; the launch counts are checked there."""
    runs = {}
    for label, mode, comp, opt, lr, skew in MODES_RUNS:
        runs[label] = train_full_width(comp, dev, mode=mode, optimizer=opt,
                                       lr=lr, skew=skew)
    for label, (counts, rec) in runs.items():
        print(f"[modes] {label}: ms/step {rec['ms_per_step']} (first step "
              f"included); peak {rec['peak_gib']:.3f} GiB; allocator retries "
              f"{rec['alloc_retries']}; skew_tv {rec['skew_tv']}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return runs


def engines_full_width(dev, by_path, state_bf16):
    """[per-leaf] and [pipelined]: the training cell (2 layers, ring, 4
    nodes, top_k 0.01 and QSGD s=16) through the per-leaf engine (f32
    state) and through the packed pipelined engine (PIPELINED_STATE), each
    printed beside the packed serial run of this call with the same state
    dtype: ms per step, peak memory, launches per step per kernel; the
    pipelined runs with their side stream's overlap and the device's idle
    share from the profiled step."""
    runs = {}
    for comp in ENGINE_COMPRESSORS:
        counts, rec = train_full_width(comp, dev, packed=False)
        base = by_path[comp][1]
        per_step = {k: v // STEPS for k, v in counts.items() if v}
        print(f"[per-leaf] {comp}: ms/step {rec['ms_per_step']} against the "
              f"packed engine's {base['ms_per_step']} (first step included); "
              f"peak {rec['peak_gib']:.3f} GiB against {base['peak_gib']:.3f} "
              f"GiB; launches per step {per_step} ({rec['units']} leaves x "
              f"1 round)", flush=True)
        runs[f"per_leaf_{comp}"] = (counts, rec)
    for comp in ENGINE_COMPRESSORS:
        counts, rec = train_full_width(comp, dev, pipelined=True,
                                       state_dtype=PIPELINED_STATE)
        base = (by_path if PIPELINED_STATE == "float32"
                else state_bf16)[comp][1]
        prof, serial_prof = rec["profile"] or {}, base["profile"] or {}
        ov = prof.get("streams", {})
        print(f"[pipelined] {comp} ({PIPELINED_STATE} state): ms/step "
              f"{rec['ms_per_step']} against the serial engine's "
              f"{base['ms_per_step']} (first step included); peak "
              f"{rec['peak_gib']:.3f} GiB against {base['peak_gib']:.3f} GiB; "
              f"profiled step {prof.get('wall_ms', float('nan')):.3f} ms "
              f"against {serial_prof.get('wall_ms', float('nan')):.3f}; side "
              f"stream busy {ov.get('side_busy_ms', float('nan')):.3f} ms, "
              f"{ov.get('side_hidden_share', float('nan')):.4f} of it beside "
              f"the main stream's work; device idle share "
              f"{ov.get('device_idle_share', float('nan')):.4f} against "
              f"{serial_prof.get('device_idle_share', float('nan')):.4f}",
              flush=True)
        runs[f"pipelined_{comp}"] = (counts, rec)
    return runs


#: [per-leaf] small: leaf shapes of the exchange held card against CPU,
#: the last above BLOCK_COMPRESS_SIZE (two block rows per node)
LEAF_SMALL_SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000),
                     ((1 << 22) + 1000,))
#: (compressor, comp_kwargs, state dtype, exact_small_leaves, pipelined)
LEAF_SMALL_RUNS = (("qsgd", (("s", 16),), "float32", False, False),
                   ("qsgd", (("s", 255),), "bfloat16", True, False),
                   ("sign", (), "bfloat16", False, False),
                   ("top_k", (("fraction", 0.05),), "float32", False, False),
                   ("qsgd", (("s", 16),), "bfloat16", False, True),
                   ("sign", (), "float32", True, True))


def leaf_exchange_cuda_vs_cpu(dev):
    """[per-leaf] small: the per-leaf exchange alone (serial and
    pipelined), one round on the ring, on the card and on the CPU from the
    same inputs and the same QSGD dither (made on the CPU): every leaf's
    payload bit-equal (codes, values and indices; the QSGD and sign scales
    within 1e-6 relative: the norms sum in another order on the card),
    x_hat bit-equal where the scales are and the state is bf16 (f32: within
    1e-6 of its magnitude), x and s likewise; one codes, dequantize and EF
    launch per leaf (the EF alone for top_k and the exact leaves' none)."""
    import torch
    from repro_torch.comm import gossip, packing, schedule
    from repro_torch.core import topology
    from repro_torch.core.compression import make_compressor
    from repro_torch.kernels import dispatch
    sched = schedule.compile_schedule(topology.make_topology("ring", N_NODES))
    report = {}
    for name, kw, sdt, exact, pipelined in LEAF_SMALL_RUNS:
        comp = make_compressor(name, **dict(kw))
        dtype = getattr(torch, sdt)
        spec = packing.make_bucket_spec(
            [torch.empty(sh, dtype=dtype, device="meta")
             for sh in LEAF_SMALL_SHAPES], exact_small_leaves=exact,
            small_leaf_threshold=4224)
        gen = torch.Generator().manual_seed(41)
        bufs = [[(torch.randn((N_NODES, b.size), generator=gen) * sc).to(
            torch.float32 if part == 0 else dtype) for b in spec.buckets]
            for part, sc in enumerate((1.0, 0.5, 0.1))]
        for buf, b in zip(bufs[0], spec.buckets):      # zero padding
            mask = torch.zeros(b.size, dtype=torch.bool)
            for sl in spec.bucket_slots(b.index):
                mask[sl.offset:sl.offset + sl.size] = True
            for part in bufs:
                part[b.index][:, ~mask] = 0
        xi = {u: torch.rand((N_NODES * packing.leaf_rows(sl.size)[0],
                             packing.leaf_rows(sl.size)[1]), generator=gen)
              for u, sl in enumerate(spec.slots)} if comp.stochastic else {}
        runs = {}
        for device in (dev, torch.device("cpu")):
            ex = gossip.make_choco_exchange(spec=spec, schedules=(sched,),
                                            compressor=comp, gamma=0.3,
                                            packed=False, pipelined=pipelined)
            state = [[b.to(device) for b in part] for part in bufs]
            payloads = []
            compress = gossip.compress_rows

            def record(*a, **k):
                out = compress(*a, **k)
                payloads.append(out)
                return out
            gossip.compress_rows = record
            dispatch.reset_launch_counts()
            try:
                ex(*state, draws=(lambda t, u: xi[u]) if xi else None)
            finally:
                gossip.compress_rows = compress
            torch.cuda.synchronize()
            runs[device.type] = (payloads, [[b.cpu() for b in part]
                                            for part in state],
                                 dispatch.launch_counts())
        (pc, sc_, counts), (pp, sp, _) = runs["cuda"], runs["cpu"]
        scales_equal, worst = True, 0.0
        for a, b in zip(pc, pp):
            check(type(a) is type(b), f"[per-leaf] {name}: payload types")
            for f in dataclasses.fields(a):
                ta, tb = getattr(a, f.name), getattr(b, f.name)
                if not torch.is_tensor(ta):
                    continue
                ta = ta.cpu()
                if f.name == "scale":
                    rel = float(((ta - tb).abs() / tb.abs().clamp_min(
                        1e-30)).max())
                    worst = max(worst, rel)
                    scales_equal = scales_equal and torch.equal(ta, tb)
                    check(rel <= 1e-6, f"[per-leaf] {name}: scales differ "
                          f"by {rel}")
                else:
                    same = torch.equal(ta.view(torch.int16) if ta.dtype
                                       == torch.bfloat16 else ta,
                                       tb.view(torch.int16) if tb.dtype
                                       == torch.bfloat16 else tb)
                    check(same, f"[per-leaf] {name} {sdt}: payload field "
                          f"{f.name} differs card against CPU")
        diffs = []
        for tag, a_part, b_part in zip(("x", "x_hat", "s"), sc_, sp):
            d = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(a_part, b_part))
            diffs.append(d)
            exact_state = scales_equal and (sdt == "bfloat16"
                                            or tag == "x_hat")
            top = max(float(b.float().abs().max()) for b in b_part)
            check(d == 0.0 if exact_state else d <= 1e-6 * max(top, 1.0),
                  f"[per-leaf] {name} {sdt}: {tag} differs by {d} card "
                  f"against CPU")
        leaves = [sl for sl in spec.slots
                  if not spec.buckets[sl.bucket].exact]
        n_exact = len(spec.slots) - len(leaves)
        ef = ("ef_update_bf16" if sdt == "bfloat16" else "ef_update") + (
            "_pipelined" if pipelined else "")
        want = {k: 0 for k in counts}
        want[ef] = len(spec.slots)
        if name in ("qsgd", "sign"):
            want["qsgd_leaf_codes" if name == "qsgd" else "sign_codes"] = \
                len(leaves)
            want["dequantize"] = len(leaves)
        check(counts == want, f"[per-leaf] {name}: launches {counts}, "
              f"expected {want}")
        label = (f"{name}{dict(kw).get('s', '')} {sdt}"
                 f"{' exact_small_leaves' if exact else ''}"
                 f"{' pipelined' if pipelined else ''}")
        print(f"[per-leaf] small {label}, {len(spec.slots)} leaves "
              f"({n_exact} exact, one of 2 block rows per node): payloads "
              f"card against CPU bit-equal (scales bit-equal: {scales_equal}"
              f", max relative {worst:.3e}); max |d| x {diffs[0]:.3e}, x_hat "
              f"{diffs[1]:.3e}, s {diffs[2]:.3e}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        report[label] = {"scales_bit_equal": scales_equal,
                         "scale_max_rel": worst, "max_dx": diffs[0],
                         "max_dx_hat": diffs[1], "max_ds": diffs[2],
                         "launches": counts}
    return report


def check_engine_kernels(dev):
    """The kernel variants of the per-leaf and pipelined engines, each at
    the shape the full-width path gives it, against its plain version:
    the per-leaf QSGD codes (f32 and bf16 rows) at one node's embedding
    leaf as it compresses, EMBED_LEAF_ROWS x N_NODES rows of
    BLOCK_COMPRESS_SIZE (s = 16, the norm of each row); the pipelined EF
    updates (f32 state; bf16 state) at the embedding bucket, (4,
    311,164,928), in place, with star's weights.  Each timed beside its
    plain version and its bytes bound; returns their records and errors."""
    import torch
    from repro_torch.comm.packing import BLOCK_COMPRESS_SIZE
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    records, errs = {}, {}
    rows, C = EMBED_LEAF_ROWS * N_NODES, BLOCK_COMPRESS_SIZE
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((rows, C), generator=gen, device=dev) * 0.01).to(dtype)
        xi = torch.rand((rows, C), generator=gen, device=dev)
        norm = x.float().square().sum(dim=1).sqrt()
        codes = dispatch.qsgd_leaf_codes(x, xi, norm, 16)
        same = all(torch.equal(codes[i:i + 16], ref.qsgd_leaf_codes_ref(
            x[i:i + 16], xi[i:i + 16], norm[i:i + 16], 16))
            for i in range(0, rows, 16))
        check(same, f"[kernel] qsgd_leaf_codes {dtype}: kernel and plain "
              f"version differ")
        ms = time_ms(lambda: dispatch.qsgd_leaf_codes(x, xi, norm, 16), 5)
        plain = time_ms(lambda: ref.qsgd_leaf_codes_ref(x, xi, norm, 16), 2)
        bms, by = bound_ms([x, xi, norm], [codes], 6 * x.numel())
        name = "qsgd_leaf_codes" + ("" if dtype == torch.float32 else "_bf16")
        print(f"[kernel] {name} rows={rows} len={C} (one node's embedding "
              f"leaf x {N_NODES} nodes): bit-equal; {ms:.3f} ms (bound "
              f"{bms:.3f} ms, {by}), plain {plain:.3f} ms", flush=True)
        records[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                             bound_ms=bms, bound_by=by, shape=[rows, C])
        errs[name] = 0.0
        del x, xi, codes
        torch.cuda.empty_cache()
    length = 311_164_928
    shape = (N_NODES, length)
    node = lambda w: torch.tensor(w, dtype=torch.float32, device=dev)
    w = (node((0.25, 0.75, 0.75, 0.75)), node((0.25,) * N_NODES))
    gamma = 1.956e-05
    for bf16 in (False, True):
        sd = torch.bfloat16 if bf16 else torch.float32
        x = torch.randn(shape, generator=gen, device=dev)
        rest = [(torch.randn(shape, generator=gen, device=dev) * sc).to(sd)
                for sc in (0.5, 0.1, 0.3, 0.6)]
        inplace = [x.clone(), rest[0].clone(), rest[1].clone()]
        dispatch.ef_bucket_update(*inplace, *rest[2:], *w, gamma, False, True)
        chunk = EF_BF16_PLAIN_CHUNK
        for c in range(0, length, chunk):
            part = slice(c, c + chunk)
            ins = [x[:, part]] + [t[:, part] for t in rest]
            want = (ref.ef_update_bf16_ref(*ins, *w, gamma, False, True) if bf16
                    else ref.ef_update_ref(*ins, *w, gamma, True))
            for g, wt in zip(inplace, want):
                check(torch.equal(g[:, part], wt), f"[kernel] pipelined EF "
                      f"({sd}) differs from its plain version")
        name = "ef_update_bf16_pipelined" if bf16 else "ef_update_pipelined"
        ms = time_ms(lambda: dispatch.ef_bucket_update(
            *inplace, *rest[2:], *w, gamma, False, True), 5)

        def plain():
            for c in range(0, length, chunk):
                part = slice(c, c + chunk)
                ins = [x[:, part]] + [t[:, part] for t in rest]
                if bf16:
                    ref.ef_update_bf16_ref(*ins, *w, gamma, False, True)
                else:
                    ref.ef_update_ref(*ins, *w, gamma, True)
        plain_ms = time_ms(plain, 2)
        bms, by = bound_ms([x] + rest + list(w), inplace,
                           (10 if bf16 else 8) * x.numel())
        print(f"[kernel] {name} n={N_NODES} len={length}: bit-equal; "
              f"{ms:.3f} ms (bound {bms:.3f} ms, {by}), plain {plain_ms:.3f} "
              f"ms", flush=True)
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=bms, bound_by=by,
                             shape=[N_NODES, length])
        errs[name] = 0.0
        del x, rest, inplace
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return records, errs


#: the launcher's --smoke runs on the card: (label, extra flags); the
#: first is the choco path, the second the exact mode with the new flags,
#: the third the choco path with bf16 EF state
LAUNCHER_RUNS = (("launcher_smoke", ["--compressor", "top_k", "--fraction",
                                     "0.05"]),
                 ("launcher_plain_adamw_skew", ["--mode", "plain",
                                                "--optimizer", "adamw",
                                                "--data-skew-alpha", "0.5"]),
                 ("launcher_state_bf16", ["--compressor", "top_k",
                                          "--fraction", "0.05",
                                          "--state-dtype", "bfloat16"]),
                 ("launcher_per_leaf_pipelined",
                  ["--gossip-engine", "per-leaf", "--pipeline-gossip",
                   "--compressor", "qsgd", "--qsgd-s", "16"]),
                 ("launcher_matching", ["--topology-process", "matching",
                                        "--compressor", "top_k",
                                        "--fraction", "0.05"]),
                 ("launcher_linkfail", ["--topology-process", "linkfail",
                                        "--edge-drop-prob", "0.1",
                                        "--compressor", "qsgd",
                                        "--qsgd-s", "16"]))
#: the per-rank launcher runs: (label, extra flags)
LAUNCHER_PER_RANK_RUNS = (("launcher_per_rank_rank0", []),
                          ("launcher_per_rank_matching_rank0",
                           ["--topology-process", "matching"]))
#: the bounded-staleness launcher runs' flags, stacked and per rank
STALE_LAUNCHER_FLAGS = ["--topology-process", "staleness", "--max-staleness",
                        "2", "--straggler-edges", "0-1"]
#: the bounded-staleness launcher runs: (label, extra flags, per rank)
STALE_LAUNCHER_RUNS = (("launcher_staleness", STALE_LAUNCHER_FLAGS + [
                           "--compressor", "top_k", "--fraction", "0.05"],
                        False),
                       ("launcher_per_rank_staleness_rank0",
                        STALE_LAUNCHER_FLAGS, True))


def run_launcher(extra, arch="qwen3-1.7b"):
    """The user's entry point, --smoke, on the card, at ``arch`` (qwen3-1.7b)
    with ``extra`` flags:
    finite losses, and under choco per bucket (per leaf with
    --gossip-engine per-leaf) per step the EF update (its pipelined order
    with --pipeline-gossip) and, with QSGD, the codes and dequantize
    kernels; no kernel in the exact modes."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import main
    argv = ["--arch", arch, "--smoke", "--mesh", f"{N_NODES}x1",
            "--steps", str(STEPS), "--device", "cuda", *extra]
    dispatch.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    counts = dispatch.launch_counts()
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"launcher returned {rc}")
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    check(losses and all(math.isfinite(v) for v in losses),
          f"launcher losses {losses}")
    per_leaf = "gossip_engine=per-leaf" in out
    units = int(out.split("leaves=" if per_leaf else "buckets=")[1].split()[0])
    want = (STEPS * units
            if "mode=choco" in out or "mode=pushsum" in out else 0)
    ef = ("ef_update_bf16" if "state_dtype=bfloat16" in out else "ef_update"
          ) + ("_pipelined" if "--pipeline-gossip" in extra else "")
    if "--topology-process" in extra:
        ef = "replica_update"
        check(" process=" in out and "expected_delta=" in out,
              "launcher: no process in the header")
    expected = {k: 0 for k in counts}
    expected[ef] = want
    if "qsgd" in extra:
        expected["qsgd_leaf_codes" if per_leaf else "qsgd_codes"] = want
        expected["dequantize"] = want
    check(counts == expected, f"launcher launch counts {counts}, expected "
          f"{expected}")
    if "--data-skew-alpha" in extra:
        check("skew_tv=" in out, "launcher: no skew_tv in the header")
    print(f"[launcher] {' '.join(extra)}: launches {counts}", flush=True)
    return counts


def run_launcher_per_rank(extra=()):
    """The user's entry point with --simulate-devices (and ``extra``
    flags): the launcher builds the kernels, spawns N_NODES ranks on the
    card and rank 0 prints.  Checks the engine line, the probe record,
    finite losses and rank 0's launches: the probe kernel once, the EF
    update (under a process the replica update) per bucket per step."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-1.7b", "--smoke", "--mesh", f"{N_NODES}x1",
            "--simulate-devices", str(N_NODES), "--compressor", "top_k",
            "--fraction", "0.05", "--steps", str(STEPS), *extra]
    ef = "replica_update" if "--topology-process" in extra else "ef_update"
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    r = subprocess.run(argv, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    out = r.stdout
    print(out, end="", flush=True)
    check(r.returncode == 0, f"per-rank launcher exited {r.returncode}:\n"
          f"{r.stderr[-4000:]}")
    check("engine=per-rank" in out and f"nodes={N_NODES}" in out,
          "per-rank launcher: no engine=per-rank line")
    check("probe CollectiveProbe(" in out and "intact=True" in out,
          "per-rank launcher: no intact probe record")
    losses = [float(line.split("loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("[train] step")]
    check(losses and all(math.isfinite(v) for v in losses),
          f"per-rank launcher losses {losses}")
    line = [s for s in out.splitlines()
            if s.startswith("[train] kernel launches on rank 0 ")]
    check(len(line) == 1, "per-rank launcher: no launches line")
    counts = json.loads(line[0].split(" rank 0 ")[1])
    want = STEPS * int(out.split("buckets=")[1].split()[0])
    check(counts[ef] == want and counts["probe_scale"] == 1
          and sum(counts.values()) == want + 1,
          f"per-rank launcher: rank 0 launches {counts}, expected {want} "
          f"{ef} and one probe_scale")
    print(f"[launcher] per-rank {' '.join(extra)}, {N_NODES} ranks on the "
          f"card: {wall:.1f} s from start to exit; rank 0 launches {counts}",
          flush=True)
    return counts


#: (compressor, comp_kwargs, exact_small_leaves, topology, gossip_steps,
#: mode, optimizer, lr) of the [small] runs: every compressor on the ring,
#: then top_k on the other graphs (per-node self weights and partial rounds
#: on chain and star) and on a time-varying pair whose two W differ; then
#: the exact modes (plain on star, 2 rounds; allreduce with plain SGD) and
#: the kernels' path under AdamW (QSGD, at AdamW's lr)
SMALL_RUNS = (("sign", (), False, "ring", 1, "choco", "momentum", 0.1),
              ("top_k", (("fraction", 0.05),), False, "ring", 1, "choco",
               "momentum", 0.1),
              ("block_top_k", (("fraction", 0.05),), False, "ring", 1,
               "choco", "momentum", 0.1),
              ("identity", (), True, "ring", 1, "choco", "momentum", 0.1),
              ("rand_k", (("fraction", 0.05),), False, "ring", 1, "choco",
               "momentum", 0.1),
              ("randomized_gossip", (("p", 0.5),), False, "ring", 1, "choco",
               "momentum", 0.1),
              ("top_k", (("fraction", 0.05),), False, "torus", 1, "choco",
               "momentum", 0.1),
              ("top_k", (("fraction", 0.05),), False, "chain", 1, "choco",
               "momentum", 0.1),
              ("top_k", (("fraction", 0.05),), False, "star", 1, "choco",
               "momentum", 0.1),
              ("top_k", (("fraction", 0.05),), False, "ring,star", 2, "choco",
               "momentum", 0.1),
              ("none", (), False, "star", 2, "plain", "momentum", 0.1),
              ("none", (), False, "ring", 1, "allreduce", "sgd", 0.1),
              ("qsgd", (("s", 16),), False, "ring", 1, "choco", "adamw",
               1e-3),
              # bf16 EF state: uniform weights on the ring, per-node self
              # weights (the weighted sum in f32) on chain
              ("top_k", (("fraction", 0.05),), False, "ring", 1, "choco",
               "momentum", 0.1, "bfloat16"),
              ("qsgd", (("s", 16),), False, "chain", 2, "choco", "momentum",
               0.1, "bfloat16"),
              # the per-leaf and the pipelined engines (the pipelined step's
              # exchange on the side stream on the card, in turn on the CPU)
              ("qsgd", (("s", 16),), False, "ring", 1, "choco", "momentum",
               0.1, "float32", "per-leaf"),
              ("top_k", (("fraction", 0.05),), True, "star", 1, "choco",
               "momentum", 0.1, "bfloat16", "per-leaf"),
              ("sign", (), False, "ring", 2, "choco", "momentum", 0.1,
               "float32", "pipelined"),
              ("qsgd", (("s", 16),), False, "ring", 1, "choco", "momentum",
               0.1, "bfloat16", "per-leaf-pipelined"))


def small_draws(tr, step):
    """The stochastic compressors' draws for one step (per bucket, or per
    leaf on the per-leaf engine), made on the CPU from a seed, so the card
    and the CPU run get the same ones."""
    import torch
    from repro_torch.comm import packing
    if tr.compressor is None or not tr.compressor.stochastic:
        return None
    if not tr.choco.packed_gossip:
        def leaf(t, u):
            R, C = packing.leaf_rows(tr.spec.slots[u].size)
            return packing.leaf_draw(
                tr.compressor, torch.empty((N_NODES * R, C)), R,
                packing.fold_seed(step, 7919 * t + u))
        return leaf

    def draws(t, b):
        bucket = tr.spec.buckets[b]
        like = torch.empty((N_NODES, bucket.size))
        return packing.draw(tr.compressor, bucket, tr.spec.bucket_slots(b),
                            like, packing.fold_seed(step, 7919 * t + b))
    return draws


def small_cuda_vs_cpu(dev):
    """The smoke decoder in float32, 3 steps on the card and on the CPU from
    the same weights, per SMALL_RUNS (every compressor on the ring; top_k
    on torus, chain, star and the pair "ring,star" with 2 gossip rounds;
    plain on star, allreduce, QSGD under AdamW): losses within 1e-5
    relative.  SignNorm keeps its x within 1e-5.  The others: x within
    1e-5 + 1e-5 max|x|.  A
    summation-order difference in a gradient could move a top-k selection
    at the k-th magnitude, which would move x_hat there by a whole delta
    (> 1e-4) and x by gamma times at most twice the largest |x_hat|.  Such
    coordinates are counted and reported.  None may move for the
    sparsifiers, QSGD, identity and randomized gossip: at these seeds no
    run on an H100 has moved one, so one that moves is a difference to
    look into.
    SignNorm flips a code where x - x_hat lies within rounding of zero;
    every run on an H100 so far moved 2 such coordinates of x_hat, and the
    limit allows one per node per step, its x being held to 1e-5 anyway.
    The exact modes have no x_hat: every coordinate of x is held.  Runs
    with bf16 EF state round the delta x - x_hat to bf16, where a
    summation-order difference may flip a rounding and move x_hat by one
    bf16 step: they may move 1 in 10^5 coordinates, under the same bound
    on x.  Launches: per step, bucket and round one EF update (the
    bf16-state one with bf16 state), and the codes and dequantize
    kernels of QSGD and sign, under choco; none in the exact modes."""
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer

    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    params = Model(cfg).init(N_NODES, 1, "cpu")
    report, launches = {}, {k: 0 for k in kernel_names()}
    for comp, kw, exact, topology, steps_k, mode, opt, lr, *extra in SMALL_RUNS:
        sdt = extra[0] if extra else "float32"
        engine = extra[1] if len(extra) > 1 else "packed"
        packed = not engine.startswith("per-leaf")
        pipelined = engine.endswith("pipelined")
        runs = {}
        for device in (dev, "cpu"):
            tr = DecentralizedTrainer(
                model=Model(cfg), choco=ChocoConfig(
                    compressor=comp, comp_kwargs=kw, exact_small_leaves=exact,
                    topology=topology, gossip_steps=steps_k,
                    state_dtype=sdt, packed_gossip=packed,
                    pipeline_gossip=pipelined),
                n_nodes=N_NODES, optimizer=make_optimizer(opt),
                lr_fn=cosine_schedule(lr, 1, STEPS), device=device, mode=mode)
            state = tr.state_from_params(params)
            batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
            dispatch.reset_launch_counts()
            losses = [tr.step(state, tr.batch_to_device(batches()),
                              draws=small_draws(tr, j))["loss"]
                      for j in range(STEPS)]
            counts = dispatch.launch_counts()
            runs[str(device)] = (losses, [b.cpu() for b in state.x],
                                 None if state.x_hat is None
                                 else [b.cpu() for b in state.x_hat], counts)
        (lc, xc, hc, counts), (lp, xp, hp, _) = runs[str(dev)], runs["cpu"]
        units = (tr.spec.n_buckets if packed else
                 [tr.spec.buckets[sl.bucket].exact for sl in tr.spec.slots])
        per_kernel = STEPS * steps_k * (units if packed else len(units))
        # exact leaves of the per-leaf engine ship uncompressed
        coded = STEPS * steps_k * (units if packed else units.count(False))
        choco = mode == "choco"
        want = {k: 0 for k in counts}
        want[("ef_update" if sdt == "float32" else "ef_update_bf16")
             + ("_pipelined" if pipelined else "")] = (
            per_kernel if choco else 0)
        if choco and comp in ("qsgd", "sign"):
            want["qsgd_leaf_codes" if comp == "qsgd" and not packed
                 else f"{comp}_codes"] = want["dequantize"] = coded
        check(counts == want, f"[small] {mode} {comp} {topology}: launches "
              f"{counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        check(any(b.exact for b in tr.spec.buckets) == exact,
              f"[small] {comp}: exact buckets")
        gammas = (tr.exchange.bucket_gammas if choco and packed
                  else [tr.gamma] * tr.spec.n_buckets if choco
                  else [0.0] * tr.spec.n_buckets)
        moved, dx, dx_moved, total = hold_small(
            "[small]", comp, gammas, (lc, xc, hc), (lp, xp, hp),
            bf16=sdt == "bfloat16")
        what = comp if choco else mode
        if sdt != "float32":
            what += f" {sdt}-state"
        if engine != "packed":
            what += f" {engine}"
        print(f"[small] smoke f32 {what}{' exact_small_leaves' if exact else ''}"
              f" {opt} lr {lr} on {topology}, gossip_steps {steps_k}, {STEPS} "
              f"steps: CUDA losses {lc} vs CPU {lp}; max |x_cuda - "
              f"x_cpu| = {dx:.3e}; moved selections {moved} of {total} "
              f"coordinates (max |dx| there {dx_moved:.3e}); launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        key = what if topology == "ring" else f"{what}@{topology}"
        if opt != "momentum":
            key += f"+{opt}"
        report[key] = {"losses_cuda": lc, "losses_cpu": lp, "max_dx": dx,
                       "moved": moved, "coordinates": total}
    report["launches"] = launches
    return report


def hold_small(label, comp, gammas, got, want, bf16=False):
    """The ``[small]`` rules of ``small_cuda_vs_cpu`` for one run ``got`` =
    (losses, x buffers, x_hat buffers or None in the exact modes) against
    ``want``, buffers on the CPU (``bf16``: the EF state is bf16).
    Returns (moved coordinates, max |dx|, max |dx| at the moved ones,
    coordinates)."""
    import numpy as np
    import torch
    (lc, xc, hc), (lp, xp, hp) = got, want
    if hc is None:
        hc = hp = [None] * len(xc)
    moved, dx_moved = 0, 0.0
    for a, b, ha, hb, g in zip(xc, xp, hc, hp, gammas):
        d = (a - b).abs()
        # the moved selections: none without x_hat (the exact modes)
        at = ((ha.float() - hb.float()).abs() > 1e-4 if ha is not None
              else torch.zeros_like(d, dtype=torch.bool))
        moved += int(at.sum())
        rest = float(d[~at].max()) if (~at).any() else 0.0
        check(rest <= 1e-5 + 1e-5 * float(b.abs().max()),
              f"{label} {comp}: iterates differ by {rest} off the moved "
              f"selections")
        if at.any():
            dx_moved = max(dx_moved, float(d[at].max()))
            check(dx_moved <= 1e-5 + 2 * g * float(hb.float().abs().max()),
                  f"{label} {comp}: a moved selection shifted x by {dx_moved}")
    dx = max(float((a - b).abs().max()) for a, b in zip(xc, xp))
    check(np.allclose(lc, lp, rtol=1e-5, atol=0),
          f"{label} {comp}: losses differ: {lc} against {lp}")
    if comp == "sign":
        check(dx <= 1e-5, f"{label} {comp}: iterates differ by {dx}")
    limit = (N_NODES * STEPS if comp == "sign" else
             sum(b.numel() for b in xp) // 100_000 if bf16 else 0)
    check(moved <= limit, f"{label} {comp}: {moved} coordinates moved "
          f"(limit {limit})")
    return moved, dx, dx_moved, sum(b.numel() for b in xp)


#: (compressor, comp_kwargs, gossip_steps) of the [dist] small phase
DIST_SMALL = (("top_k", (("fraction", 0.05),), 1), ("qsgd", (("s", 16),), 2),
              ("sign", (), 1))
#: the graphs with partial rounds and per-node self weights in the [dist]
#: small phase, the (compressor, comp_kwargs, gossip_steps) run on them,
#: and each node's sends per gossip round there
DIST_TOPOLOGIES = ("star", "chain")
DIST_TOPOLOGY_RUNS = (("top_k", (("fraction", 0.05),), 1),
                      ("qsgd", (("s", 16),), 2))
SENDS_PER_ROUND = {"ring": (2, 2, 2, 2), "star": (3, 1, 1, 1),
                   "chain": (1, 2, 2, 1)}
#: the exact modes of the [dist] small phase: (mode, topology, gossip_steps)
DIST_MODE_RUNS = (("plain", "ring", 1), ("plain", "star", 2),
                  ("allreduce", "ring", 1))
#: the bf16-state exchanges of the [dist] small phase: (compressor,
#: comp_kwargs, gossip_steps, topology)
DIST_BF16_RUNS = (("top_k", (("fraction", 0.05),), 1, "ring"),
                  ("qsgd", (("s", 16),), 2, "chain"))
#: the per-leaf and pipelined exchanges of the [dist] small phase:
#: (compressor, comp_kwargs, gossip_steps, topology, state dtype, packed,
#: pipelined)
DIST_ENGINE_RUNS = (("qsgd", (("s", 16),), 2, "ring", "float32", False, False),
                    ("top_k", (("fraction", 0.05),), 1, "star", "bfloat16",
                     False, False),
                    ("qsgd", (("s", 16),), 1, "ring", "float32", True, True),
                    ("sign", (), 2, "chain", "bfloat16", False, True))
#: the [dist] small phase's checkpoint exchange between the per-rank and
#: the stacked engine: (compressor, comp_kwargs, gossip_steps, topology),
#: with bf16 EF state
DIST_CKPT = DIST_BF16_RUNS[0]
#: the full-width [dist] phase's compressor and, per node, sequence and batch
DIST_FULL = ("top_k", (("fraction", 0.01),), 1)
DIST_SEQ, DIST_BATCH = 512, 4
DIST_TIMEOUT_S = 300.0


def _dist_trainer(comp, kw, steps_k, cfg, dev, group=None, topology="ring",
                  mode="choco", state_dtype="float32", n_nodes=N_NODES,
                  packed=True, pipelined=False):
    from repro_torch.configs.base import ChocoConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import cosine_schedule, momentum_sgd
    from repro_torch.train.trainer import DecentralizedTrainer
    return DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                                            topology=topology,
                                            gossip_steps=steps_k,
                                            state_dtype=state_dtype,
                                            packed_gossip=packed,
                                            pipeline_gossip=pipelined),
        n_nodes=n_nodes, optimizer=momentum_sgd(),
        lr_fn=cosine_schedule(0.1, warmup=STEPS // 10 + 1, total=STEPS),
        device=dev, group=group, mode=mode)


def exact_wire_bytes(mode, topology, steps_k, rank, spec):
    """(counted, modelled) bytes of node ``rank`` per exchange call in an
    exact mode: under plain, its sends per call x the f32 buckets' bytes
    (4 per padded element), counted by ``NodeGroup.sendrecv``; under
    allreduce nothing through ``sendrecv``, and 2 (n - 1) / n of those
    bytes by the ring model of ``NodeGroup.all_reduce`` (a reduce-scatter,
    then an all-gather; what the transport sends is not observed)."""
    nbytes = sum(4 * b.size for b in spec.buckets)
    if mode == "allreduce":
        return 0, 2 * (N_NODES - 1) * nbytes // N_NODES
    return steps_k * SENDS_PER_ROUND[topology][rank] * nbytes, 0


def _dist_group(rank, store):
    from repro_torch.launch.env import file_rendezvous
    from repro_torch.launch.mesh import make_node_group
    return make_node_group(N_NODES, "cuda",
                           file_rendezvous(store, rank, N_NODES),
                           timeout_s=DIST_TIMEOUT_S)


def _small_cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                               dtype="float32")


def _exchange_inputs(spec):
    """Node-stacked (x_half, x_hat, s) for the exchange alone: normal draws
    on the CPU from seed 17, x_hat and s in the buckets' dtype (x f32)."""
    import torch
    gen = torch.Generator().manual_seed(17)
    return [[(torch.randn((N_NODES, b.size), generator=gen) * scale).to(
        torch.float32 if part == 0 else b.dtype) for b in spec.buckets]
        for part, scale in enumerate((1.0, 0.5, 0.1))]


def _dist_small_rank(rank, store, out_dir):
    """One rank of the [dist] small phase: per DIST_MODE_RUNS and
    DIST_SMALL run, the exchange alone on its row of ``_exchange_inputs``
    (seed 23), then STEPS steps of the smoke decoder in f32 from node
    ``rank``'s weights; the exact modes' launches are counted apart."""
    import torch
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import close_node_group
    from repro_torch.models.transformer import Model
    group = _dist_group(rank, store)
    cfg = _small_cfg()
    params = Model(cfg).init(N_NODES, 1, "cpu", nodes=(rank,))
    dispatch.reset_launch_counts()
    out = {}
    # the exact modes first, so their builds would be the first to probe
    for mode, topology, steps_k in DIST_MODE_RUNS:
        tr = _dist_trainer("top_k", (), steps_k, cfg, group.device, group,
                           topology, mode)
        bufs = [[b[rank:rank + 1].to(group.device) for b in part]
                for part in _exchange_inputs(tr.spec)]
        before = (group.bytes_sent, group.bytes_modelled)
        tr.exchange(*bufs, seed=23)
        sent = (group.bytes_sent - before[0],
                group.bytes_modelled - before[1])
        state = tr.state_from_params(params)
        batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0, node=rank)
        mets = [tr.step(state, tr.batch_to_device(batches()))
                for _ in range(STEPS)]
        out[(mode, topology)] = {
            "exchange": [b.cpu() for b in bufs[0]], "sent": sent,
            "losses": [m["loss"] for m in mets],
            "wire_bytes": [(m["wire_bytes"], m["wire_bytes_modelled"])
                           for m in mets],
            "x": [b.cpu() for b in state.x]}
    torch.cuda.synchronize()
    out["exact_launches"] = dispatch.launch_counts()
    for comp, kw, steps_k in DIST_SMALL:
        tr = _dist_trainer(comp, kw, steps_k, cfg, group.device, group)
        bufs = [[b[rank:rank + 1].to(group.device) for b in part]
                for part in _exchange_inputs(tr.spec)]
        tr.exchange(*bufs, seed=23)
        exchanged = [[b.cpu() for b in part] for part in bufs]
        state = tr.state_from_params(params)
        batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0, node=rank)
        losses = [tr.step(state, tr.batch_to_device(batches()))["loss"]
                  for _ in range(STEPS)]
        out[comp] = {"exchange": exchanged, "losses": losses,
                     "x": [b.cpu() for b in state.x],
                     "x_hat": [b.cpu() for b in state.x_hat]}
    for topology in DIST_TOPOLOGIES:
        for comp, kw, steps_k in DIST_TOPOLOGY_RUNS:
            tr = _dist_trainer(comp, kw, steps_k, cfg, group.device, group,
                               topology)
            bufs = [[b[rank:rank + 1].to(group.device) for b in part]
                    for part in _exchange_inputs(tr.spec)]
            before = group.bytes_sent
            tr.exchange(*bufs, seed=29)
            out[(topology, comp)] = {
                "exchange": [[b.cpu() for b in part] for part in bufs],
                "sent": group.bytes_sent - before, "sends": tr.exchange.sends,
                "payload_bytes": tr.exchange.payload_bytes}
    for comp, kw, steps_k, topology in DIST_BF16_RUNS:
        tr = _dist_trainer(comp, kw, steps_k, cfg, group.device, group,
                           topology, state_dtype="bfloat16")
        bufs = [[b[rank:rank + 1].to(group.device) for b in part]
                for part in _exchange_inputs(tr.spec)]
        before = group.bytes_sent
        tr.exchange(*bufs, seed=31)
        out[("bf16", topology, comp)] = {
            "exchange": [[b.cpu() for b in part] for part in bufs],
            "sent": group.bytes_sent - before, "sends": tr.exchange.sends,
            "payload_bytes": tr.exchange.payload_bytes}
    for run in DIST_ENGINE_RUNS:
        comp, kw, steps_k, topology, sdt, packed, pipelined = run
        tr = _dist_trainer(comp, kw, steps_k, cfg, group.device, group,
                           topology, state_dtype=sdt, packed=packed,
                           pipelined=pipelined)
        bufs = [[b[rank:rank + 1].to(group.device) for b in part]
                for part in _exchange_inputs(tr.spec)]
        before = group.bytes_sent
        tr.exchange(*bufs, seed=37)
        out[("engine",) + run] = {
            "exchange": [[b.cpu() for b in part] for part in bufs],
            "sent": group.bytes_sent - before, "sends": tr.exchange.sends,
            "payload_bytes": tr.exchange.payload_bytes}
    torch.cuda.synchronize()
    out["launches"] = dispatch.launch_counts()
    out["transport"] = group.describe()
    # [checkpoint]: this rank's row of the stacked engine's checkpoint, and
    # the ranks' own checkpoint, for the stacked engine to restore
    comp, kw, steps_k, topology = DIST_CKPT
    tr = _dist_trainer(comp, kw, steps_k, cfg, group.device, group, topology,
                       state_dtype="bfloat16")
    got, _, warmup = tr.restore_checkpoint(os.path.join(out_dir,
                                                        "ckpt_stacked"))
    state = tr.state_from_params(params)
    batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0, node=rank)
    for _ in range(2):
        tr.step(state, tr.batch_to_device(batches()))
    tr.save_checkpoint(os.path.join(out_dir, "ckpt_ranks"), state)
    out["checkpoint"] = {"restored": _host_state(got), "warmup": warmup,
                         "saved": _host_state(state)}
    torch.save(out, os.path.join(out_dir, f"small{rank}.pt"))
    close_node_group()


def dist_small(dev):
    """The per-rank engine, 4 ranks on the one card, against the stacked
    engine on the card, from the same weights and seeds (each node draws
    its own dither in both): per DIST_SMALL run, the exchange alone on the
    same inputs bit-equal, and STEPS trainer steps held to the [small]
    rules (``hold_small``); on star and chain (DIST_TOPOLOGY_RUNS), the
    exchange alone bit-equal and each rank's bytes sent equal to its own
    sends times one payload's bytes.  The exact modes (DIST_MODE_RUNS):
    the exchange alone bit-equal under plain and within 1e-6 under
    allreduce (the sum runs in another order), STEPS steps to the [small]
    rules, each rank's bytes per call and per step by
    ``exact_wire_bytes`` (plain's counted; allreduce's modelled, and none
    counted), and no kernel launched, the probe included."""
    import tempfile
    import torch
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    with tempfile.TemporaryDirectory() as tmp:
        stacked = _stacked_checkpoint(dev, os.path.join(tmp, "ckpt_stacked"))
        t0 = time.perf_counter()
        spawn_ranks_of(_dist_small_rank, tmp, 600)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"small{r}.pt"),
                            weights_only=False) for r in range(N_NODES)]
        crossed = dist_checkpoints(dev, os.path.join(tmp, "ckpt_ranks"),
                                   stacked, [r["checkpoint"] for r in ranks])
    print(f"[dist] small phase: {N_NODES} ranks in {wall:.1f} s; "
          f"transport {ranks[0]['transport']}; launches per rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}",
          flush=True)
    cfg = _small_cfg()
    params = Model(cfg).init(N_NODES, 1, "cpu")
    report = {"launches": [r["launches"] for r in ranks],
              "exact_launches": [r["exact_launches"] for r in ranks],
              "checkpoint": crossed}
    check(not any(any(r["exact_launches"].values()) for r in ranks),
          f"[dist] the exact modes launched kernels (the probe included): "
          f"{report['exact_launches']}")
    for mode, topology, steps_k in DIST_MODE_RUNS:
        tr = _dist_trainer("top_k", (), steps_k, cfg, dev, topology=topology,
                           mode=mode)
        recs = [r[(mode, topology)] for r in ranks]
        bufs = [[b.to(dev) for b in part] for part in _exchange_inputs(tr.spec)]
        tr.exchange(*bufs, seed=23)
        diff = max(float((rec["exchange"][b][0] - bufs[0][b][i].cpu())
                         .abs().max())
                   for i, rec in enumerate(recs)
                   for b in range(tr.spec.n_buckets))
        want = [exact_wire_bytes(mode, topology, steps_k, r, tr.spec)
                for r in range(N_NODES)]
        sent = [rec["sent"] for rec in recs]
        wire = [rec["wire_bytes"] for rec in recs]
        order = ("" if mode == "plain" else
                 "; the ranks sum in gloo's ring order on host buffers, the "
                 "stacked engine in node order 0..3 on the card")
        print(f"[dist] small {mode} on {topology}, gossip_steps={steps_k}: the "
              f"exchange alone, per rank against the stacked exchange on the "
              f"card: max |dx| {diff:.3e} (bit-equal: {diff == 0.0}){order}; "
              f"bytes per rank (counted by sendrecv, modelled as a ring "
              f"all-reduce) per exchange {sent}, per step {wire}, formula "
              f"{want}", flush=True)
        check(diff == 0.0 if mode == "plain" else diff <= 1e-6,
              f"[dist] {mode} on {topology}: the per-rank exchange differs "
              f"from the stacked one by {diff}")
        check(sent == want and all(w == [v] * STEPS
                                   for w, v in zip(wire, want)),
              f"[dist] {mode} on {topology}: bytes sent {sent}, per step "
              f"{wire}, the formula says {want}")
        state = tr.state_from_params(params)
        batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
        losses = [tr.step(state, tr.batch_to_device(batches()))["loss"]
                  for _ in range(STEPS)]
        x = [torch.cat([rec["x"][b] for rec in recs])
             for b in range(tr.spec.n_buckets)]
        moved, dx, _, total = hold_small(
            "[dist]", mode, [0.0] * tr.spec.n_buckets,
            (recs[0]["losses"], x, None),
            (losses, [b.cpu() for b in state.x], None))
        print(f"[dist] small {mode} on {topology}, {STEPS} steps: per-rank "
              f"losses {recs[0]['losses']} vs stacked {losses}; max |dx| "
              f"{dx:.3e} of {total} coordinates", flush=True)
        report[f"{mode}@{topology}"] = {
            "exchange_max_dx": diff, "bytes_counted_modelled": sent,
            "wire_bytes_counted_modelled": wire,
            "wire_formula": want, "losses_dist": recs[0]["losses"],
            "losses_stacked": losses, "max_dx": dx}
    for comp, kw, steps_k in DIST_SMALL:
        tr = _dist_trainer(comp, kw, steps_k, cfg, dev)
        bufs = [[b.to(dev) for b in part] for part in _exchange_inputs(tr.spec)]
        tr.exchange(*bufs, seed=23)
        same = all(torch.equal(r[comp]["exchange"][p][b][0], bufs[p][b][i].cpu())
                   for i, r in enumerate(ranks) for p in range(3)
                   for b in range(tr.spec.n_buckets))
        print(f"[dist] small {comp} gossip_steps={steps_k}: the exchange alone, "
              f"per rank against the stacked exchange on the card: x, x_hat "
              f"and s bit-equal: {same}", flush=True)
        check(same, f"[dist] {comp}: the per-rank exchange and the stacked "
              f"exchange differ")
        state = tr.state_from_params(params)
        batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
        dispatch.reset_launch_counts()
        losses = [tr.step(state, tr.batch_to_device(batches()))["loss"]
                  for _ in range(STEPS)]
        cat = lambda key: [torch.cat([r[comp][key][b] for r in ranks])
                           for b in range(tr.spec.n_buckets)]
        got = (ranks[0][comp]["losses"], cat("x"), cat("x_hat"))
        moved, dx, dx_moved, total = hold_small(
            "[dist]", comp, tr.exchange.bucket_gammas, got,
            (losses, [b.cpu() for b in state.x],
             [b.cpu() for b in state.x_hat]))
        print(f"[dist] small {comp}, {STEPS} steps: per-rank losses {got[0]} "
              f"vs stacked {losses}; max |dx| {dx:.3e}; moved {moved} of "
              f"{total} coordinates (max |dx| there {dx_moved:.3e})",
              flush=True)
        report[comp] = {"exchange_bit_equal": same, "losses_dist": got[0],
                        "losses_stacked": losses, "max_dx": dx,
                        "moved": moved}
    for topology in DIST_TOPOLOGIES:
        for comp, kw, steps_k in DIST_TOPOLOGY_RUNS:
            tr = _dist_trainer(comp, kw, steps_k, cfg, dev, topology=topology)
            bufs = [[b.to(dev) for b in part]
                    for part in _exchange_inputs(tr.spec)]
            tr.exchange(*bufs, seed=29)
            recs = [r[(topology, comp)] for r in ranks]
            same = all(torch.equal(rec["exchange"][p][b][0],
                                   bufs[p][b][i].cpu())
                       for i, rec in enumerate(recs) for p in range(3)
                       for b in range(tr.spec.n_buckets))
            payload = sum(recs[0]["payload_bytes"])
            sends = [rec["sends"] for rec in recs]
            sent = [rec["sent"] for rec in recs]
            want_sends = [steps_k * k for k in SENDS_PER_ROUND[topology]]
            print(f"[dist] small {comp} on {topology}, gossip_steps={steps_k}: "
                  f"the exchange alone, per rank against the stacked exchange "
                  f"on the card: x, x_hat and s bit-equal: {same}; bytes sent "
                  f"per rank {sent} = sends {sends} x {payload} payload "
                  f"bytes", flush=True)
            check(same, f"[dist] {comp} on {topology}: the per-rank exchange "
                  f"and the stacked exchange differ")
            check(sends == want_sends and sent == [k * payload for k in sends],
                  f"[dist] {comp} on {topology}: sends {sends} (expected "
                  f"{want_sends}), bytes {sent}")
            report[f"{comp}@{topology}"] = {"exchange_bit_equal": same,
                                            "bytes_sent": sent,
                                            "sends": sends,
                                            "payload_bytes": payload}
    for comp, kw, steps_k, topology in DIST_BF16_RUNS:
        from repro_torch.comm.packing import bucket_wire_nbytes
        tr = _dist_trainer(comp, kw, steps_k, cfg, dev, topology=topology,
                           state_dtype="bfloat16")
        bufs = [[b.to(dev) for b in part] for part in _exchange_inputs(tr.spec)]
        tr.exchange(*bufs, seed=31)
        recs = [r[("bf16", topology, comp)] for r in ranks]
        same = all(torch.equal(rec["exchange"][p][b][0], bufs[p][b][i].cpu())
                   for i, rec in enumerate(recs) for p in range(3)
                   for b in range(tr.spec.n_buckets))
        payload = sum(bucket_wire_nbytes(tr.spec, tr.compressor))
        sends = [rec["sends"] for rec in recs]
        sent = [rec["sent"] for rec in recs]
        want_sends = [steps_k * k for k in SENDS_PER_ROUND[topology]]
        print(f"[dist] small bf16-state {comp} on {topology}, gossip_steps="
              f"{steps_k}: the exchange alone, per rank against the stacked "
              f"exchange on the card: x (f32), x_hat and s (bf16) bit-equal: "
              f"{same}; bytes sent per rank {sent} = sends {sends} x "
              f"{payload} payload bytes (bf16 values)", flush=True)
        check(same, f"[dist] bf16-state {comp} on {topology}: the per-rank "
              f"exchange and the stacked exchange differ")
        check(sends == want_sends and sent == [k * payload for k in sends]
              and all(rec["payload_bytes"] == bucket_wire_nbytes(
                  tr.spec, tr.compressor) for rec in recs),
              f"[dist] bf16-state {comp} on {topology}: sends {sends} "
              f"(expected {want_sends}), bytes {sent}")
        report[f"bf16-state {comp}@{topology}"] = {
            "exchange_bit_equal": same, "bytes_sent": sent, "sends": sends,
            "payload_bytes": payload}
    for run in DIST_ENGINE_RUNS:
        from repro_torch.comm.packing import (bucket_wire_nbytes,
                                              leaf_wire_nbytes)
        comp, kw, steps_k, topology, sdt, packed, pipelined = run
        tr = _dist_trainer(comp, kw, steps_k, cfg, dev, topology=topology,
                           state_dtype=sdt, packed=packed,
                           pipelined=pipelined)
        bufs = [[b.to(dev) for b in part] for part in _exchange_inputs(tr.spec)]
        tr.exchange(*bufs, seed=37)
        recs = [r[("engine",) + run] for r in ranks]
        same = all(torch.equal(rec["exchange"][p][b][0], bufs[p][b][i].cpu())
                   for i, rec in enumerate(recs) for p in range(3)
                   for b in range(tr.spec.n_buckets))
        sizes = (bucket_wire_nbytes if packed else leaf_wire_nbytes)(
            tr.spec, tr.compressor)
        payload = sum(sizes)
        sends = [rec["sends"] for rec in recs]
        sent = [rec["sent"] for rec in recs]
        want_sends = [steps_k * k for k in SENDS_PER_ROUND[topology]]
        label = (f"{'packed' if packed else 'per-leaf'}"
                 f"{' pipelined' if pipelined else ''} {sdt}-state {comp} on "
                 f"{topology}, gossip_steps={steps_k}")
        print(f"[dist] small {label}: the exchange alone, per rank against "
              f"the stacked exchange on the card: x, x_hat and s bit-equal: "
              f"{same}; bytes sent per rank {sent} = sends {sends} x "
              f"{payload} payload bytes ({len(sizes)} payloads)", flush=True)
        check(same, f"[dist] {label}: the per-rank exchange and the stacked "
              f"exchange differ")
        check(sends == want_sends and sent == [k * payload for k in sends]
              and all(rec["payload_bytes"] == sizes for rec in recs),
              f"[dist] {label}: sends {sends} (expected {want_sends}), "
              f"bytes {sent}")
        report[label] = {"exchange_bit_equal": same, "bytes_sent": sent,
                         "sends": sends, "payload_bytes": payload}
    return report


def _stacked_checkpoint(dev, path):
    """The stacked engine's checkpoint of DIST_CKPT at ``path``: 2 steps of
    the f32 smoke decoder with bf16 EF state from seed 1's weights.
    Returns the state saved, on the host."""
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.models.transformer import Model
    cfg = _small_cfg()
    comp, kw, steps_k, topology = DIST_CKPT
    tr = _dist_trainer(comp, kw, steps_k, cfg, dev, topology=topology,
                       state_dtype="bfloat16")
    state = tr.state_from_params(Model(cfg).init(N_NODES, 1, "cpu"))
    batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
    for _ in range(2):
        tr.step(state, tr.batch_to_device(batches()))
    tr.save_checkpoint(path, state)
    return _host_state(state)


def dist_checkpoints(dev, ranks_path, stacked, recs):
    """[dist]'s checkpoints: each rank restored its row of the stacked
    engine's checkpoint (``stacked``: the state saved) bit for bit, and the
    stacked engine restores the 4 ranks' checkpoint (``ranks_path``; each
    rank's state in ``recs``) bit for bit."""
    import torch
    from repro_torch.checkpoint.manifest import read_manifest
    row = lambda st, r: {k: (v if v is None or not isinstance(v, list)
                             else [b[r:r + 1] for b in v])
                         for k, v in st.items()}
    cat = lambda key: (None if recs[0]["saved"][key] is None else
                       [torch.cat([rec["saved"][key][b] for rec in recs])
                        for b in range(len(recs[0]["saved"][key]))])
    bad_rows = [(r, _same_state(rec["restored"], row(stacked, r)))
                for r, rec in enumerate(recs)]
    comp, kw, steps_k, topology = DIST_CKPT
    tr = _dist_trainer(comp, kw, steps_k, _small_cfg(), dev,
                       topology=topology, state_dtype="bfloat16")
    back, man, warmup = tr.restore_checkpoint(ranks_path)
    want = dict(recs[0]["saved"], **{k: cat(k) for k in
                                     ("x", "x_hat", "s", "mu", "nu")})
    bad_back = _same_state(_host_state(back), want)
    print(f"[checkpoint] [dist] bf16-state {comp} on {topology}: {N_NODES} "
          f"ranks restored their rows of the stacked engine's checkpoint, "
          f"bit-equal: {[not b for _, b in bad_rows]} (warmup "
          f"{[rec['warmup'] for rec in recs]}); the stacked engine restored "
          f"the ranks' checkpoint ({man.process_count} shard files), "
          f"bit-equal: {not bad_back} (warmup {warmup})", flush=True)
    check(not any(b for _, b in bad_rows) and not bad_back and warmup == 0
          and all(rec["warmup"] == 0 for rec in recs)
          and man.process_count == N_NODES
          and read_manifest(ranks_path).step == 2,
          f"[checkpoint] [dist]: rows {bad_rows}, stacked {bad_back}")
    return {"ranks_restore_stacked_bit_equal": [not b for _, b in bad_rows],
            "stacked_restores_ranks_bit_equal": not bad_back}


def _dist_full_rank(rank, store, out_dir, batch_per_node):
    """One rank of the full-width [dist] phase: qwen3-1.7b widths, 2
    layers, node ``rank`` of 4, DIST_FULL gossip, STEPS steps; counts
    reset just before the trainer is built (its probe runs there).  Peak
    memory is taken apart: up to the exchange (forward, backward,
    optimizer) and in it."""
    import json as _json
    import torch
    from repro_torch.comm.packing import bucket_wire_bits
    from repro_torch.configs.qwen3_1_7b import CONFIG
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import close_node_group
    group = _dist_group(rank, store)
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    comp, kw, steps_k = DIST_FULL
    tr = _dist_trainer(comp, kw, steps_k, cfg, group.device, group)
    state = tr.init_state(seed=0)
    batches = make_lm_batch_fn(cfg, DIST_SEQ, batch_per_node, N_NODES, 1.0,
                               node=rank)
    rec = {"losses": [], "ms": [], "wire_bytes": [], "staging_ms": [],
           "init_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "peak_before_exchange_gib": 0.0, "peak_in_exchange_gib": 0.0,
           "batch_per_node": batch_per_node}
    exchange = tr.exchange

    def exchange_with_peaks(*args, **kwargs):
        gib = lambda: torch.cuda.max_memory_allocated() / 2 ** 30
        rec["peak_before_exchange_gib"] = max(rec["peak_before_exchange_gib"],
                                              gib())
        torch.cuda.reset_peak_memory_stats()
        exchange(*args, **kwargs)
        rec["peak_in_exchange_gib"] = max(rec["peak_in_exchange_gib"], gib())
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_memory_stats()
    tr.exchange = exchange_with_peaks
    for _ in range(STEPS):
        batch = tr.batch_to_device(batches())
        torch.cuda.synchronize()
        staged, t0 = group.staging_s, time.perf_counter()
        mets = tr.step(state, batch)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(mets["loss"])
        rec["wire_bytes"].append(mets["wire_bytes"])
        rec["staging_ms"].append((group.staging_s - staged) * 1e3)
    free, total = torch.cuda.mem_get_info()
    rec.update(
        launches=dispatch.launch_counts(),
        peak_gib=max(rec["init_peak_gib"], rec["peak_before_exchange_gib"],
                     rec["peak_in_exchange_gib"]),
        card_used_gib=(total - free) / 2 ** 30,
        payload_bytes=exchange.payload_bytes,
        payload_bits_analytic=bucket_wire_bits(tr.spec, tr.compressor),
        dense_bytes=[b.size * 4 for b in tr.spec.buckets],
        gossip_steps=steps_k, sends=exchange.sends,
        buckets=tr.spec.n_buckets, transport=group.describe(),
        probe=dataclasses.asdict(exchange.probe))
    # one more step under the profiler in every rank at once: each sees
    # its own kernels only
    tr.exchange = exchange
    batch = tr.batch_to_device(batches())
    rec["profile"] = profile_call(f"rank {rank}", lambda: tr.step(state, batch),
                                  GOSSIP_KERNELS, show=False)
    with open(os.path.join(out_dir, f"full{rank}.json"), "w") as f:
        _json.dump(rec, f)
    del state, tr
    close_node_group()


def dist_full_width(stacked, batch_per_node=DIST_BATCH):
    """The per-rank engine at full width: 4 ranks on the one card, one
    gossip node each, qwen3-1.7b widths (2 layers), DIST_FULL gossip at
    sequence DIST_SEQ x batch DIST_BATCH per node, STEPS steps.  Checks
    finite losses, the launches of each kernel per rank (the probe once,
    one EF update per bucket per round, no decode kernel: sparse payloads
    decode by scatter) and that each rank sent exactly the spec's payload
    bytes per round; prints ms/step beside the stacked engine's
    (``stacked``, measured earlier in this run), each rank's peak memory,
    the wire bytes, the transport and the probe record."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks_of(_dist_full_rank, tmp, 900, batch_per_node)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(N_NODES):
            with open(os.path.join(tmp, f"full{r}.json")) as f:
                ranks.append(json.load(f))
    comp = DIST_FULL[0]
    print(f"[dist] full width {comp} 0.01, {N_NODES} ranks, "
          f"sequence {DIST_SEQ} x batch {batch_per_node} per node: spawn to exit "
          f"{wall:.1f} s; transport {ranks[0]['transport']}; probe "
          f"{ranks[0]['probe']}", flush=True)
    for r, rec in enumerate(ranks):
        check(all(math.isfinite(v) for v in rec["losses"]),
              f"[dist] rank {r}: non-finite losses {rec['losses']}")
        per_step = rec["sends"] * sum(rec["payload_bytes"])
        check(all(b == per_step for b in rec["wire_bytes"]),
              f"[dist] rank {r}: sent {rec['wire_bytes']} bytes per step, "
              f"the spec says {per_step}")
        want = STEPS * rec["gossip_steps"] * rec["buckets"]
        counts = rec["launches"]
        check(counts["ef_update"] == want and counts["probe_scale"] == 1
              and sum(counts.values()) == want + 1,
              f"[dist] rank {r}: launches {counts}, expected {want} ef_update "
              f"and one probe_scale")
        check(rec["probe"]["intact"], f"[dist] rank {r}: probe {rec['probe']}")
        print(f"[dist] rank {r}: losses {rec['losses']}; ms/step {rec['ms']} "
              f"(first step included); staging ms/step {rec['staging_ms']}; "
              f"peak device memory {rec['peak_gib']:.3f} GiB (at init "
              f"{rec['init_peak_gib']:.3f}, up to the exchange "
              f"{rec['peak_before_exchange_gib']:.3f}, in it "
              f"{rec['peak_in_exchange_gib']:.3f}; card in use "
              f"{rec['card_used_gib']:.3f} GiB); wire bytes per step "
              f"{rec['wire_bytes'][-1]} = {rec['sends']} sends x "
              f"{sum(rec['payload_bytes'])} payload bytes (the spec's), dense "
              f"buckets {sum(rec['dense_bytes'])} bytes, analytic "
              f"{sum(rec['payload_bits_analytic']) // 8} bytes; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    steady = [max(rec["ms"][i] for rec in ranks) for i in range(1, STEPS)]
    print(f"[dist] full width: ms/step, steps 2-{STEPS}, slowest rank "
          f"{steady} against the stacked engine's {stacked['ms_per_step'][1:]}"
          f" in this run", flush=True)
    profiles = [rec["profile"] for rec in ranks]
    if all(profiles):
        # a kernel's profiled span includes the time slices the other
        # contexts hold the card, so the ranks' busy times overlap and
        # their sum is no measure of the card's idle share
        print(f"[dist] full width, one more step profiled in every rank: "
              + ", ".join(
                  f"rank {r}: wall {p['wall_ms']:.3f} ms, device busy "
                  f"{p['device_busy_ms']:.3f} ms in {p['launches']} launches "
                  f"(port kernels {p['port kernels']:.3f}, matmul "
                  f"{p['matmul']:.3f}, other {p['other']:.3f})"
                  for r, p in enumerate(profiles)), flush=True)
    return {"ranks": ranks, "ms_per_step_slowest_rank": steady,
            "stacked_ms_per_step": stacked["ms_per_step"]}


#: [checkpoint]: the full-width cell (compressor and fraction, EF state
#: dtype, local step) and the parameters per node it reckons with
CKPT_FULL = ("top_k", (("fraction", 0.01),), "bfloat16", "sgd")
#: its depth: 1 layer at full width, the script's time budget having been
#: overrun; its training is the [state-bf16] path's, run there at 2 layers
CKPT_FULL_LAYERS = 1
#: [checkpoint] small: (compressor, comp_kwargs) x EF state dtype
CKPT_SMALL = ((("qsgd", (("s", 16),)), ("top_k", (("fraction", 0.05),))),
              ("float32", "bfloat16"))
CKPT_ELASTIC_NODES = (8, 2)


def _bits(t):
    import torch
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _host_state(state):
    """A copy of a trainer state's buffers on the host."""
    cpu = lambda bufs: None if bufs is None else [b.cpu() for b in bufs]
    return {"x": cpu(state.x), "x_hat": cpu(state.x_hat), "s": cpu(state.s),
            "mu": cpu(state.opt.mu), "nu": cpu(state.opt.nu),
            "count": state.opt.count, "step": state.step, "seed": state.seed}


def _same_state(a, b):
    """Every buffer of two host states bit-equal, and count, step, seed
    equal; returns the names of what differs."""
    import torch
    bad = [k for k in ("count", "step", "seed") if a[k] != b[k]]
    for k in ("x", "x_hat", "s", "mu", "nu"):
        if (a[k] is None) != (b[k] is None):
            bad.append(k)
            continue
        for i, (u, v) in enumerate(zip(a[k] or (), b[k] or ())):
            if u.dtype != v.dtype or not torch.equal(_bits(u), _bits(v)):
                bad.append(f"{k}[{i}]")
    return bad


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def checkpoint_full_width(dev):
    """[checkpoint] at full width: qwen3-1.7b widths, CKPT_FULL_LAYERS
    layers, 4 nodes on a ring, CKPT_FULL, sequence 512 x batch 4 per
    node.  STEPS steps
    uninterrupted; then, from the same seed and batches, 1 step, a save, a
    restore into a fresh trainer and STEPS - 1 steps.  x, x_hat, s, the
    step and the seed must be bit-equal between the two runs (every
    buffer's bits compared).  Prints the disk's free space first, the save
    and restore seconds and GB/s, the bytes on disk beside the reckoned
    nodes x parameters x (4 + 2 + 2) bytes, and the first step after the
    restore beside the uninterrupted run's steps.  If the disk cannot hold
    two such checkpoints the node count is halved (never the width), and
    the cut is printed."""
    import tempfile
    import torch
    from repro_torch.configs.base import ChocoConfig
    from repro_torch.configs.qwen3_1_7b import CONFIG
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model, count_params
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer

    comp, kw, sdt, opt = CKPT_FULL
    cfg = dataclasses.replace(CONFIG, n_layers=CKPT_FULL_LAYERS)
    params = count_params(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        nodes = N_NODES
        reckoned = lambda n: n * params * (4 + 2 + 2)
        print(f"[checkpoint] full width: {tmp} has {free} bytes free "
              f"({free / 2 ** 30:.2f} GiB); one checkpoint of {nodes} nodes, "
              f"{cfg.n_layers} layer(s), is "
              f"reckoned at {reckoned(nodes)} bytes ({nodes} x {params} "
              f"parameters x (4 + 2 + 2) bytes)", flush=True)
        while nodes > 1 and 2 * reckoned(nodes) > free:
            nodes //= 2
            print(f"[checkpoint] CUT: the disk cannot hold two checkpoints; "
                  f"node count cut to {nodes}", flush=True)

        def trainer():
            return DecentralizedTrainer(
                model=Model(cfg), choco=ChocoConfig(
                    compressor=comp, comp_kwargs=kw, state_dtype=sdt),
                n_nodes=nodes, optimizer=make_optimizer(opt),
                lr_fn=cosine_schedule(0.1, warmup=STEPS // 10 + 1,
                                      total=STEPS), device=dev)

        make = make_lm_batch_fn(cfg, DIST_SEQ, 4, nodes, 1.0)
        batches = [make() for _ in range(STEPS)]

        def steps(tr, state, todo):
            ms = []
            for b in todo:
                batch = tr.batch_to_device(b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mets = tr.step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                check(math.isfinite(mets["loss"]),
                      f"[checkpoint] loss {mets['loss']}")
            return ms

        dispatch.reset_launch_counts()
        tr = trainer()
        state = tr.init_state(seed=0)
        whole_ms = steps(tr, state, batches)
        whole = _host_state(state)
        del tr, state
        torch.cuda.empty_cache()

        tr = trainer()
        state = tr.init_state(seed=0)
        steps(tr, state, batches[:1])
        path = os.path.join(tmp, "step1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save_checkpoint(path, state)
        save_s = time.perf_counter() - t0
        del tr, state
        torch.cuda.empty_cache()
        on_disk = _dir_bytes(path)
        tr = trainer()
        t0 = time.perf_counter()
        state, man, warmup = tr.restore_checkpoint(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(warmup == 0 and man.step == 1 and state.step == 1,
              f"[checkpoint] restore: warmup {warmup}, step {man.step}")
        resumed_ms = steps(tr, state, batches[1:])
        counts = dispatch.launch_counts()
        bad = _same_state(_host_state(state), whole)
        del tr, state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = on_disk / 1e9
    print(f"[checkpoint] full width {comp} 0.01, {sdt} state, {opt}, {nodes} "
          f"nodes: save {save_s:.3f} s ({gb / save_s:.3f} GB/s), restore "
          f"{restore_s:.3f} s ({gb / restore_s:.3f} GB/s; the file just "
          f"written, so from the page cache where it holds); {on_disk} bytes "
          f"on disk ({on_disk / 2 ** 30:.3f} GiB) against {reckoned(nodes)} "
          f"reckoned ({reckoned(nodes) / 1e9:.2f} GB, "
          f"{reckoned(nodes) / 2 ** 30:.2f} GiB); first step after the "
          f"restore {resumed_ms[0]:.1f} ms (then {resumed_ms[1:]}) against "
          f"the uninterrupted run's {whole_ms} ms (first step included); "
          f"x, x_hat, s, step and seed bit-equal to the uninterrupted run: "
          f"{not bad}", flush=True)
    check(not bad, f"[checkpoint] the resumed run differs from the "
          f"uninterrupted one in {bad}")
    return counts, {"nodes": nodes, "save_s": save_s, "restore_s": restore_s,
                    "bytes_on_disk": on_disk, "bytes_reckoned": reckoned(nodes),
                    "disk_free_bytes": free, "save_gb_per_s": gb / save_s,
                    "restore_gb_per_s": gb / restore_s,
                    "uninterrupted_ms": whole_ms, "resumed_ms": resumed_ms}


def consensus_distance(x):
    """sum_i ||x_i - mean_j x_j||^2 / n over the node-stacked buffers."""
    n = x[0].shape[0]
    return sum(float(((b.double() - b.double().mean(0)) ** 2).sum())
               for b in x) / n


def checkpoint_small(dev):
    """[checkpoint] at smoke size, f32 decoder, 4 nodes on a ring, momentum,
    for QSGD s=16 and top_k 0.05 with f32 and bf16 EF state: 2 steps on
    the card and a save; its elastic restores on 8 and on 2 nodes on the
    card (x_hat and s zero, then the warmup: its rounds, its launches, one
    codes, one dequantize and one EF update per bucket per round for QSGD,
    one EF update for top_k, and the consensus distance and ||x - x_hat||
    before and after); that checkpoint restored on the CPU, and 2 CPU
    steps from the same weights saved and restored on the card, each
    bit-equal to the state saved."""
    import tempfile
    import torch
    from repro_torch.checkpoint.elastic import consensus_warmup_rounds
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    cfg = _small_cfg()
    params = Model(cfg).init(N_NODES, 1, "cpu")
    launches = {k: 0 for k in kernel_names()}
    report = {}
    comps, dtypes = CKPT_SMALL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_small_") as tmp:
        for comp, kw in comps:
            for sdt in dtypes:
                tag = f"{comp}-{sdt}"
                saved = {}
                for role, device in (("card", dev), ("cpu", "cpu")):
                    tr = _dist_trainer(comp, kw, 1, cfg, device,
                                       state_dtype=sdt)
                    state = tr.state_from_params(params)
                    batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
                    for _ in range(2):
                        tr.step(state, tr.batch_to_device(batches()))
                    path = os.path.join(tmp, f"{tag}-{role}")
                    tr.save_checkpoint(path, state)
                    saved[role] = (path, _host_state(state))
                # the card's checkpoint on the CPU, the CPU's on the card
                crossed = {}
                for src, dst, device in (("card", "cpu", "cpu"),
                                         ("cpu", "card", dev)):
                    path, want = saved[src]
                    tr = _dist_trainer(comp, kw, 1, cfg, device,
                                       state_dtype=sdt)
                    got, _, warmup = tr.restore_checkpoint(path)
                    bad = _same_state(_host_state(got), want)
                    check(warmup == 0 and not bad,
                          f"[checkpoint] {tag}: the {src} checkpoint restored "
                          f"on the {dst}: warmup {warmup}, differs in {bad}")
                    crossed[f"{src}->{dst}"] = not bad
                rec = {"card_cpu_bit_equal": crossed}
                path = saved["card"][0]
                for n in CKPT_ELASTIC_NODES:
                    tr = _dist_trainer(comp, kw, 1, cfg, dev, state_dtype=sdt,
                                       n_nodes=n)
                    state, man, warmup = tr.restore_checkpoint(path)
                    want = consensus_warmup_rounds(
                        min(t.delta for t in tr.topologies))
                    check(warmup == want and man.n_nodes == N_NODES and
                          not any(bool(b.any()) for b in state.x_hat + state.s),
                          f"[checkpoint] {tag} 4 -> {n}: warmup {warmup} "
                          f"(expected {want}), x_hat and s not zero")
                    ef_err = lambda: math.sqrt(sum(
                        float(((x.double() - h.double()) ** 2).sum())
                        for x, h in zip(state.x, state.x_hat)))
                    before = (consensus_distance(state.x), ef_err())
                    torch.cuda.synchronize()
                    dispatch.reset_launch_counts()
                    tr.consensus_warmup(state, warmup)
                    torch.cuda.synchronize()
                    counts = dispatch.launch_counts()
                    after = (consensus_distance(state.x), ef_err())
                    per = warmup * tr.choco.gossip_steps * tr.spec.n_buckets
                    expect = {k: 0 for k in counts}
                    expect["ef_update_bf16" if sdt == "bfloat16"
                           else "ef_update"] = per
                    if comp == "qsgd":
                        expect["qsgd_codes"] = expect["dequantize"] = per
                    check(counts == expect,
                          f"[checkpoint] {tag} 4 -> {n} warmup launches "
                          f"{counts}, expected {expect}")
                    check(all(math.isfinite(v) for v in before + after),
                          f"[checkpoint] {tag} 4 -> {n}: {before} {after}")
                    for k, v in counts.items():
                        launches[k] += v
                    print(f"[checkpoint] small {tag}: elastic 4 -> {n} nodes, "
                          f"warmup {warmup} rounds (the new graph's); "
                          f"consensus distance {before[0]:.6e} -> "
                          f"{after[0]:.6e}, ||x - x_hat|| {before[1]:.6e} -> "
                          f"{after[1]:.6e}; launches "
                          f"{ {k: v for k, v in counts.items() if v} } "
                          f"({warmup} rounds x {tr.choco.gossip_steps} "
                          f"gossip_steps x {tr.spec.n_buckets} buckets); card "
                          f"checkpoint on the CPU and CPU checkpoint on the "
                          f"card bit-equal: {crossed}", flush=True)
                    rec[f"elastic_4_to_{n}"] = {
                        "warmup": warmup, "consensus_before": before[0],
                        "consensus_after": after[0],
                        "ef_error_before": before[1],
                        "ef_error_after": after[1], "launches": counts}
                report[tag] = rec
    report["launches"] = launches
    return report


#: [sim]: CHOCO-Gossip as examples/quickstart.py runs it, (label,
#: compressor, gamma, rounds), ring of SIM_GOSSIP_N nodes, d = SIM_GOSSIP_D
SIM_GOSSIP_N, SIM_GOSSIP_D = 25, 2000
SIM_GOSSIP_RUNS = (("exact", None, 1.0, 300), ("qsgd127", ("qsgd", 127), 1.0,
                                                300),
                   ("top_1pct", ("top_k", 0.01), 0.046, 3000))
#: [sim]: CHOCO-SGD on the epsilon stand-in at the paper's full size
#: (benchmarks/bench_sgd.py: ring n = 9, sorted data, batch 4, eta_t =
#: 300 / (t + 300), top 1% at gamma 0.04, qsgd_16 at 0.2); its 1200 steps
#: cut to SIM_SGD_STEPS to keep the script's time (300 until the frontend
#: phases came)
SIM_SGD_N, SIM_SGD_M, SIM_SGD_D, SIM_SGD_STEPS, SIM_SGD_BATCH = (
    9, 400_000, 2_000, 150, 4)
SIM_SGD_RUNS = (("choco_qsgd16", ("qsgd", 16), 0.2),
                ("choco_top1pct", ("top_k", 0.01), 0.04),
                ("dsgd_exact", None, None))
#: [sim] free runs, card against CPU: the mixing products and reductions
#: sum in another order (ulp level), which the exact and QSGD gossip
#: curves and every f(x_bar) keep within this bound (the quickstart's
#: curves also agree with the JAX package's within it,
#: tests/test_torch_sim.py).  The top 1% gossip curve is printed beside
#: it, not held to it: over 3000 rounds one ulp can move a selection at
#: the k-th magnitude, after which the two runs are different runs.
SIM_RTOL = 1e-4
#: [sim] round by round (``_hold_rounds``): each round is made again on
#: the CPU from the card's state before it, so the only difference left
#: is the summation order of one round's products and reductions; x, s,
#: x_hat and the gradient are held within this bound of their largest
#: magnitude.  A QSGD level may still move where a value lies within
#: rounding of a level boundary under the norm's other summation order:
#: at most SIM_MOVED_PER_ROUND coordinates per round, over all nodes.  No
#: top-k selection may move (same input, same tie rule).  On an H100
#: 80GB HBM3 at 700 W the sound runs read at most 1.9e-7 and moved
#: nothing; runs with a fault injected in the card's path (PERF.md)
#: moved 1,836 to 1,381,563.
SIM_STEP_RTOL = 1e-5
SIM_MOVED_PER_ROUND = 1


def _sim_compressor(spec):
    from repro_torch.core.compression import QSGD, TopK
    if spec is None:
        return None
    name, arg = spec
    return QSGD(arg) if name == "qsgd" else TopK(fraction=arg)


def _timed(fn, dev):
    """(result, ms) of ``fn()`` on ``dev``, synchronised; launch counts
    reset just before it and returned (on the CPU, ms is None)."""
    import torch
    from repro_torch.kernels import dispatch
    if dev.type != "cuda":
        return fn(), None, None
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, dispatch.launch_counts()


def _hold_sim_launches(label, comp, rounds, counts):
    """A QSGD run launches the codes and dequantize kernels once per
    round, and no other kernel; the others launch none."""
    want = rounds if comp is not None and comp.name == "qsgd" else 0
    check(counts["qsgd_codes"] == want and counts["dequantize"] == want
          and sum(counts.values()) == 2 * want,
          f"[sim] {label}: launches {counts}, expected {want} qsgd_codes and "
          f"dequantize and no other")


def _fmt(worst):
    return {k: f"{v:.3e}" for k, v in worst.items()}


def _rel(got, want, keep=None):
    """max |got - want| over the columns ``keep`` (all if None), over
    max |want|; 0 where they agree."""
    d = (got - want).abs()
    if keep is not None:
        d = d[:, keep]
    worst = float(d.max()) if d.numel() else 0.0
    return 0.0 if worst == 0.0 else worst / float(want.abs().max())


def _hold_rounds(label, state, step, rounds, levels):
    """Card against CPU round by round.  ``state`` is the card's state at
    the start, a NamedTuple of (n, d) tensors (x, and x_hat and s where the
    scheme keeps them) and ints; ``step(state, t, grad=None)`` makes round
    t from a state on either device and returns (the new state, the
    gradient it computed or None), stepping with ``grad`` where given.
    The CPU makes each round from the card's state before it and with the
    card's gradient, so no earlier difference reaches a top-k selection or
    a QSGD level, and the gradient is held on its own.  An x_hat
    coordinate moves where the two differ by more than SIM_STEP_RTOL of
    max|x_hat|; x and s are held off the moved coordinates' columns (a
    moved entry reaches x and s through W only in its column), x_hat
    elsewhere and the gradient everywhere.  Coordinates may move only
    where ``levels`` (QSGD), SIM_MOVED_PER_ROUND per round.  Returns
    (coordinates moved, {field: largest relative difference over the
    rounds})."""
    import torch
    fields = [f for f in state._fields
              if isinstance(getattr(state, f), torch.Tensor)]
    worst, moved = dict.fromkeys(fields, 0.0), 0
    for t in range(rounds):
        here = type(state)(*(v.cpu() if isinstance(v, torch.Tensor) else v
                             for v in state))
        state, grad = step(state, t)
        ref, ref_grad = step(here, t, None if grad is None else grad.cpu())
        got = {f: getattr(state, f).cpu() for f in fields}
        want = {f: getattr(ref, f) for f in fields}
        keep = None
        if "x_hat" in got:
            at = ((got["x_hat"] - want["x_hat"]).abs()
                  > SIM_STEP_RTOL * float(want["x_hat"].abs().max()))
            moved += int(at.sum())
            keep = ~at.any(dim=0)
        for f in fields:
            # a field of another width (push-sum's weight column) never
            # reads x_hat's columns: it is held whole
            cols = (keep if keep is not None
                    and got[f].shape[-1] == keep.numel() else None)
            worst[f] = max(worst[f], _rel(got[f], want[f], cols))
        if grad is not None:
            worst["grad"] = max(worst.get("grad", 0.0),
                                _rel(grad.cpu(), ref_grad))
    check(moved <= (SIM_MOVED_PER_ROUND * rounds if levels else 0)
          and all(v <= SIM_STEP_RTOL for v in worst.values()),
          f"[sim] {label}: round by round, card against CPU, {moved} "
          f"coordinates moved and largest relative differences {worst}")
    return moved, worst


def sim_gossip(dev):
    """CHOCO-Gossip (Algorithm 1) and exact gossip at the quickstart's
    sizes on the card and on the CPU, from the same x0 and the same QSGD
    dither (CPU generators, moved to the card): the free runs' error
    curves within SIM_RTOL (top 1%: printed), and each round held by
    ``_hold_rounds``; first and last error, bits per coordinate and ms
    per round."""
    import numpy as np
    import torch
    from repro_torch.core.baselines import (exact_gossip_round,
                                            run_gossip_baseline)
    from repro_torch.core.choco_gossip import (choco_gossip_round, init_state,
                                               mixing, run_choco_gossip)
    from repro_torch.core.topology import ring
    n, d = SIM_GOSSIP_N, SIM_GOSSIP_D
    W = ring(n).W
    x0 = torch.randn((n, d), generator=torch.Generator().manual_seed(0))
    Ws = {"cpu": mixing(W, x0), dev.type: mixing(W, x0.to(dev))}
    Iterates = collections.namedtuple("Iterates", "x")
    report = {}
    for label, spec, gamma, rounds in SIM_GOSSIP_RUNS:
        comp = _sim_compressor(spec)
        rand = None
        if comp is not None and comp.stochastic:
            gen = torch.Generator().manual_seed(1)
            rand = [comp.draw(x0, gen) for _ in range(rounds)]
        curves, timing = {}, None
        for which, device in (("card", dev), ("cpu", torch.device("cpu"))):
            x = x0.to(device)
            draws = (None if rand is None else
                     (lambda t, r=[a.to(device) for a in rand]: r[t]))
            if comp is None:
                go = lambda: run_gossip_baseline("exact", x, W, None, rounds)[1]
            else:
                go = lambda: run_choco_gossip(x, W, gamma, comp, rounds,
                                              draws=draws)[1]
            err, ms, counts = _timed(go, device)
            curves[which] = err.cpu().numpy()
            if which == "card":
                timing = (ms / rounds, counts)
        card, cpu = curves["card"], curves["cpu"]
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        held = comp is None or comp.name != "top_k"
        if comp is None:
            start = Iterates(x0.to(dev))

            def step(st, t, grad=None):
                return st._replace(x=exact_gossip_round(
                    st.x, Ws[st.x.device.type])), None
        else:
            start = init_state(x0.to(dev))

            def step(st, t, grad=None, comp=comp, gamma=gamma):
                r = None if rand is None else rand[t].to(st.x.device)
                return choco_gossip_round(st, Ws[st.x.device.type], gamma,
                                          comp, r), None
        moved, worst = _hold_rounds(label, start, step, rounds,
                                    levels=comp is not None
                                    and comp.name == "qsgd")
        bits = 32.0 if comp is None else comp.wire_bits(d) / d
        print(f"[sim] choco-gossip ring n={n} d={d} {label}, {rounds} rounds: "
              f"error {card[0]:.4e} -> {card[-1]:.4e} on the card, "
              f"{cpu[0]:.4e} -> {cpu[-1]:.4e} on the CPU (free runs: max "
              f"relative difference {rel:.3e}{'' if held else ', not held'}); "
              f"round by round: {moved} coordinates moved, largest "
              f"relative differences {_fmt(worst)}; {bits:.1f} "
              f"bits/coordinate; {timing[0]:.4f} ms/round on the card; "
              f"launches { {k: v for k, v in timing[1].items() if v} }",
              flush=True)
        check(np.all(np.isfinite(card)),
              f"[sim] {label}: the card's error curve is not finite")
        if held:
            check(rel <= SIM_RTOL,
                  f"[sim] {label}: card and CPU error curves differ by {rel}")
        check(card[-1] < 1e-3 * card[0], f"[sim] {label}: no consensus "
              f"({card[0]} -> {card[-1]})")
        _hold_sim_launches(label, comp, rounds, timing[1])
        report[label] = {"rounds": rounds, "err_first": float(card[0]),
                         "err_last": float(card[-1]),
                         "err_last_cpu": float(cpu[-1]), "max_rel_diff": rel,
                         "rounds_moved": moved, "rounds_max_rel": worst,
                         "bits_per_coord": bits, "ms_per_round": timing[0],
                         "launches": timing[1]}
    return report


#: [sim]: pipelined CHOCO-Gossip (the pipelined engine's matrix twin) at
#: the quickstart's sizes: (label, compressor spec, gamma, rounds)
#: 150 rounds, 300 until the frontend phases came (the script's time)
SIM_PIPELINED_RUNS = (("pipelined_exact", ("identity",), 0.5, 150),
                      ("pipelined_qsgd127", ("qsgd", 127), 0.5, 150))


def sim_pipelined(dev):
    """Pipelined CHOCO-Gossip on the ring of 25 at d 2000, on the card and
    on the CPU from the same x0 and dither: error curves within SIM_RTOL,
    the error falling, and the QSGD run's launches one codes and one
    dequantize per round; ms per round on the card."""
    import numpy as np
    import torch
    from repro_torch.core.choco_gossip import run_choco_pipelined_gossip
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.topology import ring
    n, d = SIM_GOSSIP_N, SIM_GOSSIP_D
    W = ring(n).W
    x0 = torch.randn((n, d), generator=torch.Generator().manual_seed(0))
    report = {}
    for label, spec, gamma, rounds in SIM_PIPELINED_RUNS:
        comp = (make_compressor("identity") if spec[0] == "identity"
                else _sim_compressor(spec))
        rand = None
        if comp.stochastic:
            gen = torch.Generator().manual_seed(1)
            rand = [comp.draw(x0, gen) for _ in range(rounds)]
        curves, timing = {}, None
        for which, device in (("card", dev), ("cpu", torch.device("cpu"))):
            x = x0.to(device)
            draws = (None if rand is None else
                     (lambda t, r=[a.to(device) for a in rand]: r[t]))
            err, ms, counts = _timed(lambda: run_choco_pipelined_gossip(
                x, W, gamma, comp, rounds, draws=draws)[1], device)
            curves[which] = err.cpu().numpy()
            if which == "card":
                timing = (ms / rounds, counts)
        card, cpu = curves["card"], curves["cpu"]
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        print(f"[sim] pipelined choco-gossip ring n={n} d={d} {label}, gamma "
              f"{gamma}, {rounds} rounds: error {card[0]:.4e} -> "
              f"{card[-1]:.4e} on the card, {cpu[0]:.4e} -> {cpu[-1]:.4e} on "
              f"the CPU (max relative difference {rel:.3e}); "
              f"{timing[0]:.4f} ms/round on the card; launches "
              f"{ {k: v for k, v in timing[1].items() if v} }", flush=True)
        check(np.all(np.isfinite(card)) and card[-1] < card[0],
              f"[sim] {label}: the error did not fall ({card[0]} -> "
              f"{card[-1]})")
        check(rel <= SIM_RTOL, f"[sim] {label}: card and CPU error curves "
              f"differ by {rel}")
        _hold_sim_launches(label, None if comp.name == "identity" else comp,
                           rounds, timing[1])
        report[label] = {"rounds": rounds, "gamma": gamma,
                         "err_first": float(card[0]),
                         "err_last": float(card[-1]),
                         "err_last_cpu": float(cpu[-1]), "max_rel_diff": rel,
                         "ms_per_round": timing[0], "launches": timing[1]}
    return report


def sim_sgd(dev):
    """CHOCO-SGD (Algorithm 6) with QSGD(16) and top 1%, and exact D-SGD
    (Algorithm 3), on the epsilon stand-in at m = 400,000, d = 2,000
    (A: 3.2 GB f32 on the card, made by numpy from the float64 draw of
    ``make_logreg``), ring n = 9, sorted data: SIM_SGD_STEPS steps each on
    the card and on the CPU with the same minibatches and dither (CPU
    generators); the free runs' f(x_bar) at the start and the end within
    SIM_RTOL (their final x printed), each step held by ``_hold_rounds``;
    wire bits per node, ms per step."""
    import torch
    from repro_torch.core.baselines import plain_dsgd_step
    from repro_torch.core.choco_gossip import mixing
    from repro_torch.core.choco_sgd import (choco_sgd_step,
                                            experiment_lr_schedule,
                                            init_state, run_choco_sgd)
    from repro_torch.core.topology import ring
    from repro_torch.data.synthetic import make_logreg
    n, d, steps = SIM_SGD_N, SIM_SGD_D, SIM_SGD_STEPS
    t0 = time.perf_counter()
    cpu = make_logreg("epsilon", n, sorted_assignment=True, m=SIM_SGD_M, d=d,
                      seed=0, device="cpu")
    built = time.perf_counter() - t0
    card = dataclasses.replace(cpu, A=cpu.A.to(dev), b=cpu.b.to(dev),
                               node_index=cpu.node_index.to(dev))
    print(f"[sim] epsilon stand-in m={SIM_SGD_M} d={d}, {n} nodes sorted: "
          f"built on the host in {built:.1f} s; A on the card "
          f"{card.A.numel() * 4 / 1e9:.2f} GB", flush=True)
    W = ring(n).W
    like = torch.zeros((n, d))
    Ws = {"cpu": mixing(W, like), dev.type: mixing(W, like.to(dev))}
    grad_fns = {"cpu": cpu.make_grad_fn(SIM_SGD_BATCH),
                dev.type: card.make_grad_fn(SIM_SGD_BATCH)}
    lr = experiment_lr_schedule(1, 300.0, 300.0)
    Iterates = collections.namedtuple("Iterates", "x")
    report = {"build_s": built}
    for label, spec, gamma in SIM_SGD_RUNS:
        comp = _sim_compressor(spec)
        gen = torch.Generator().manual_seed(2)
        draws = [(grad_fns["cpu"].draw(n, gen),
                  comp.draw(like, gen) if comp is not None and comp.stochastic
                  else None) for _ in range(steps)]
        res = {}
        for which, prob, device in (("card", card, dev),
                                    ("cpu", cpu, torch.device("cpu"))):
            on = [(b.to(device), None if r is None else r.to(device))
                  for b, r in draws]
            grad_fn = grad_fns[device.type]
            x0 = torch.zeros((n, d), device=device)
            f0 = float(prob.full_loss(x0.mean(dim=0)))
            if comp is None:
                def go():
                    X = x0
                    for t in range(steps):
                        X = plain_dsgd_step(X, Ws[device.type], grad_fn,
                                            lr(t), on[t][0])
                    return X
            else:
                go = lambda: run_choco_sgd(x0, W, grad_fn, comp, lr, gamma,
                                           steps, draws=lambda t: on[t])[0].x
            X, ms, counts = _timed(go, device)
            res[which] = (f0, float(prob.full_loss(X.mean(dim=0))), ms,
                          counts, X.cpu())
        (f0, f1, ms, counts, X), (g0, g1, _, _, Xp) = res["card"], res["cpu"]
        rel = abs(f1 - g1) / abs(g1)

        def step(st, t, grad=None, comp=comp, gamma=gamma):
            dv = st.x.device
            batch, r = draws[t]
            G = grad_fns[dv.type](st.x, batch.to(dv))
            use = G if grad is None else grad
            if comp is None:
                return st._replace(x=plain_dsgd_step(
                    st.x, Ws[dv.type], lambda X, b: use, lr(t), batch)), G
            return choco_sgd_step(st, Ws[dv.type], lambda X, b: use, comp,
                                  lr(t), gamma, batch,
                                  None if r is None else r.to(dv)), G
        x0 = torch.zeros((n, d), device=dev)
        moved, worst = _hold_rounds(
            label, Iterates(x0) if comp is None else init_state(x0), step,
            steps, levels=comp is not None and comp.name == "qsgd")
        bits = (32 * d if comp is None else comp.wire_bits(d)) * 2 * steps
        print(f"[sim] {label}, {steps} steps: f(x_bar) {f0:.6f} -> {f1:.6f} "
              f"on the card, {g0:.6f} -> {g1:.6f} on the CPU (free runs: "
              f"relative difference {rel:.3e}, final x {_rel(X, Xp):.3e} of "
              f"max|x|); step by step: {moved} coordinates moved, largest "
              f"relative differences {_fmt(worst)}; wire "
              f"{bits / 1e6:.3f} Mbit per node (2 neighbours); "
              f"{ms / steps:.4f} ms/step on the card; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        check(math.isfinite(f1) and f1 < f0 and rel <= SIM_RTOL
              and abs(f0 - g0) <= SIM_RTOL * abs(g0),
              f"[sim] {label}: f(x_bar) {f0} -> {f1} on the card, {g0} -> "
              f"{g1} on the CPU")
        _hold_sim_launches(label, comp, steps, counts)
        report[label] = {"steps": steps, "f_start": f0, "f_end": f1,
                         "f_end_cpu": g1, "rel_diff": rel,
                         "x_rel_diff": _rel(X, Xp), "steps_moved": moved,
                         "steps_max_rel": worst,
                         "wire_mbit_per_node": bits / 1e6,
                         "ms_per_step": ms / steps, "launches": counts}
    del card
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# [process]: the stochastic topology processes through the replica engine
# ---------------------------------------------------------------------------

#: [process]: (process, compressor) of the full-width runs, bf16 EF state
#: (matching with f32 state would need about 84.6 GiB, more than the card)
PROCESS_RUNS = (("matching", "top_k"), ("matching", "qsgd"),
                ("linkfail", "top_k"), ("linkfail", "qsgd"))
PROCESS_STATE = "bfloat16"
PROCESS_DROP = 0.1
#: the peaks predicted before the first run (GiB): the bf16 state's
#: measured 52.276 GiB plus 5.39 GiB per further bf16 tree (matching on the
#: ring keeps 2 more, link failures 1 more)
PROCESS_PREDICTED_GIB = {"matching": 63.1, "linkfail": 57.7}
#: [process] small: (process, compressor, kwargs, state dtype, packed,
#: topology, gossip rounds) of the exchange held card against CPU
PROCESS_SMALL_RUNS = (
    ("matching", "top_k", (("fraction", 0.05),), "float32", True, "ring", 2),
    ("matching", "rand_k", (("fraction", 0.05),), "bfloat16", True, "chain", 2),
    ("matching", "rand_k", (("fraction", 0.05),), "float32", False, "star", 2),
    ("matching", "top_k", (("fraction", 0.05),), "bfloat16", False, "ring", 2),
    ("linkfail", "rand_k", (("fraction", 0.05),), "float32", True, "chain", 2),
    ("linkfail", "top_k", (("fraction", 0.05),), "bfloat16", True, "ring", 2),
    ("linkfail", "top_k", (("fraction", 0.05),), "float32", False, "star", 2),
    ("linkfail", "rand_k", (("fraction", 0.05),), "bfloat16", False, "ring",
     2),
    # QSGD on bf16 state per leaf: f32 payloads (decoded), the kernel's
    # (bf16 state, f32 payload) build
    ("matching", "qsgd", (("s", 16),), "bfloat16", False, "ring", 2),
    ("linkfail", "qsgd", (("s", 16),), "bfloat16", False, "chain", 2))
PROCESS_SMALL_SHAPES = ((300, 70), (5000,), (128, 33), (7,), (3, 1000))
#: [process] small, per rank: runs of PROCESS_DIST_RUNS's form, seeded
PROCESS_DIST_RUNS = (
    ("matching", "qsgd", (("s", 16),), "bfloat16", True, "chain", 2),
    ("linkfail", "top_k", (("fraction", 0.05),), "float32", False, "ring", 2),
    ("linkfail", "qsgd", (("s", 16),), "bfloat16", True, "star", 1))
PROCESS_SEED = 4242
#: [sim]: (label, process, compressor, gamma, rounds) of CHOCO-Gossip under
#: the processes at the quickstart's size (ring 25, d 2000); 150 rounds,
#: 300 until the frontend phases came (the script's time)
SIM_PROCESS_RUNS = (("matching_exact", "matching", None, 1.0, 150),
                    ("matching_top_1pct", "matching", ("top_k", 0.01), 0.046,
                     150),
                    ("linkfail_exact", "linkfail", None, 1.0, 150),
                    ("linkfail_top_1pct", "linkfail", ("top_k", 0.01), 0.046,
                     150))
#: [sim] under a process: elements of x and the references that may differ
#: from the CPU's repeat of a round by more than SIM_STEP_RTOL of the
#: largest magnitude (a top-k selection flipped by an ulp moves 2
#: coordinates of one node's reference and, through the mixing, of up to
#: 3 nodes' x)
SIM_PROCESS_MOVED = 8


#: [kernel] replica_update: (EF state, payload) dtypes of each form's
#: cases: f32, bf16 state with bf16 payloads (the packed engine's) and with
#: f32 payloads (the per-leaf engine's QSGD and sign, decoded to f32)
REPLICA_DTYPES = (("float32", "float32"), ("bfloat16", "bfloat16"),
                  ("bfloat16", "float32"))


def check_replica_kernels(dev):
    """The replica-update kernel's two forms in each REPLICA_DTYPES case at
    the embedding bucket (4, 311,164,928), in place, against the plain
    version chunk by chunk, bit for bit: matching with ring weights (send
    1, gamma v), link failures (the ring form at tau 0) with the ring's
    R = 2 replicas and one link of each round down.  Each timed beside its plain version and its
    bytes bound.  Returns (records by case, the record of the kernel line:
    matching on bf16 state and payloads, the [process] cell's build, the
    largest |kernel - plain| over every case)."""
    import torch
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(11)
    length = 311_164_928
    shape = (N_NODES, length)
    chunk = EF_BF16_PLAIN_CHUNK
    records, max_err = {}, 0.0
    node = lambda w: torch.tensor(w, dtype=torch.float32, device=dev)
    send, gv = node((1.0,) * N_NODES), node((2.5e-5,) * N_NODES)
    # the ring's receive weights, rows 0 and 3 of round 0 and row 1 of
    # round 1 with their link down
    w = node(((0.0, 1 / 3, 1 / 3, 0.0), (1 / 3, 0.0, 1 / 3, 1 / 3)))
    gamma = 3.7e-5
    for form in ("matching", "linkfail"):
        for sdt, qdt in REPLICA_DTYPES:
            sd, qd = getattr(torch, sdt), getattr(torch, qdt)
            x = torch.randn(shape, generator=gen, device=dev)
            mk = lambda sc, dt: (torch.randn(shape, generator=gen, device=dev)
                                 * sc).to(dt)
            if form == "matching":
                ins = [x, mk(0.5, sd), mk(0.5, sd), mk(0.1, qd), mk(0.1, qd)]
                out = [t.clone() for t in ins[:3]]
                call = lambda o: dispatch.replica_matching(*o, ins[3], ins[4],
                                                           send, gv)
                plain_one = lambda part: ref.replica_matching_ref(
                    *[t[:, part] for t in ins], send, gv)
                flops = 7 * x.numel()
            else:
                ins = [x, mk(0.5, sd), mk(0.1, qd), mk(0.5, sd), mk(0.5, sd),
                       mk(0.1, qd), mk(0.1, qd)]
                out = [t.clone() for t in (ins[0], ins[1], ins[3], ins[4])]
                # link failures: the ring form at tau = 0
                call = lambda o: dispatch.replica_stale(
                    o[0], o[1], ins[2], o[2:], ins[5:], [], [[], []], w,
                    None, gamma)
                plain_one = lambda part: (lambda r: (r[0], r[1], *r[2]))(
                    ref.replica_stale_ref(
                        ins[0][:, part], ins[1][:, part], ins[2][:, part],
                        [t[:, part] for t in ins[3:5]],
                        [t[:, part] for t in ins[5:]], [], [[], []], w,
                        None, gamma))
                flops = 15 * x.numel()
            call(out)
            err = 0.0
            for c in range(0, length, chunk):
                part = slice(c, c + chunk)
                for g, want in zip(out, plain_one(part)):
                    got = g[:, part]
                    err = max(err, float((got.double() - want.double())
                                         .abs().max()))
                    check(torch.equal(got, want),
                          f"[kernel] replica_update {form} {sdt} state, "
                          f"{qdt} payloads differs from its plain version "
                          f"(max abs {err})")
            max_err = max(max_err, err)
            ms = time_ms(lambda: call(out), 5)

            def plain():
                for c in range(0, length, chunk):
                    plain_one(slice(c, c + chunk))
            plain_ms = time_ms(plain, 1)
            bms, by = bound_ms(ins, out, flops)
            short = {"float32": "f32", "bfloat16": "bf16"}
            name = f"{form}_{short[sdt]}" + (
                "" if sdt == qdt else f"_{short[qdt]}q")
            print(f"[kernel] replica_update {name} n={N_NODES} len={length}"
                  f"{' R=2' if form == 'linkfail' else ''}: bit-equal (max "
                  f"abs {err}); {ms:.3f} ms (bound {bms:.3f} ms, {by}, "
                  f"{bms / ms:.3f} of it), plain {plain_ms:.3f} ms",
                  flush=True)
            records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                 bound_ms=bms, bound_by=by, max_abs_err=err,
                                 shape=[N_NODES, length])
            del x, ins, out
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    main = {k: v for k, v in records["matching_bf16"].items()
            if k != "max_abs_err"}
    return records, main, max_err


def process_full_width(dev, state_bf16):
    """[process]: the training cell (2 layers, ring, 4 nodes, bf16 EF
    state) under matching and link failures (p = PROCESS_DROP), top_k 0.01
    and QSGD s=16, each printed beside the [state-bf16] static run of the
    same compressor in this call: ms per step over steps 2-3, the peak
    beside its prediction, the device's idle share of the profiled step,
    launches per step per kernel, and the wire bytes per node per step
    (computed from the spec)."""
    runs = {}
    for kind, comp in PROCESS_RUNS:
        counts, rec = train_full_width(comp, dev, state_dtype=PROCESS_STATE,
                                       process=kind, drop=PROCESS_DROP)
        base = state_bf16[comp][1]
        prof, base_prof = rec["profile"] or {}, base["profile"] or {}
        per_step = {k: v // STEPS for k, v in counts.items() if v}
        rec["predicted_peak_gib"] = PROCESS_PREDICTED_GIB[kind]
        print(f"[process] {kind} {comp} ({PROCESS_STATE} state): ms/step "
              f"over steps 2-3 {rec['ms_per_step'][1:]} against the static "
              f"engine's {base['ms_per_step'][1:]}; peak "
              f"{rec['peak_gib']:.3f} GiB against {base['peak_gib']:.3f} GiB, "
              f"predicted {PROCESS_PREDICTED_GIB[kind]} GiB; device idle "
              f"share {prof.get('device_idle_share', float('nan')):.4f} "
              f"against {base_prof.get('device_idle_share', float('nan')):.4f}"
              f"; launches per step {per_step}; wire bytes per node per step "
              f"{rec['wire_bytes_per_node_step']} against "
              f"{base['wire_bytes_per_node_step']} (computed from the spec); "
              f"samples {rec['samples']}", flush=True)
        runs[f"process_{kind}_{comp}"] = (counts, rec)
    return runs


def _small_inputs(run, comp, sdt, seed, packed=True):
    """The shared inputs of a small exchange run (``run`` seeds the data):
    (spec over PROCESS_SMALL_SHAPES in ``sdt``, ``leaves(scale, dtype)``
    drawing node-stacked packed buffers from ``rng``, ``rng``,
    ``draws_on(device)``: draws(t,
    u) of the CPU's making under ``seed``, moved to ``device``, per
    bucket, or per leaf unit unless ``packed``; None without draws)."""
    import numpy as np
    import torch
    from repro_torch.comm import gossip, packing
    spec = packing.make_bucket_spec(
        [torch.empty(sh, dtype=getattr(torch, sdt), device="meta")
         for sh in PROCESS_SMALL_SHAPES], align=gossip._pack_align(comp))
    rng = np.random.default_rng(len(str(run)))
    leaves = lambda sc, dt: packing.pack_leaves(spec, [torch.from_numpy(
        (sc * rng.standard_normal((N_NODES,) + sh)).astype(np.float32))
        for sh in PROCESS_SMALL_SHAPES], dtype=dt)
    units = None if packed else gossip._units(spec, False)
    cache = {}

    def draw(t, u):
        if (t, u) not in cache:
            key = packing.fold_seed(seed, t * 1000 + u)
            if units is None:
                b = spec.buckets[u]
                cache[t, u] = packing.draw(comp, b, spec.bucket_slots(u),
                                           torch.empty((N_NODES, b.size)),
                                           key)
            else:
                unit = [un for un in units if un.index == u][0]
                cache[t, u] = packing.leaf_draw(
                    comp, torch.empty((N_NODES * unit.rows, unit.width)),
                    unit.rows, key)
        return cache[t, u]

    def draws_on(device):
        if not comp.stochastic:
            return None
        return lambda t, u: draw(t, u).to(device)
    return spec, leaves, rng, draws_on


def _to_device(obj, device):
    import torch
    return (obj.to(device) if torch.is_tensor(obj)
            else [_to_device(o, device) for o in obj])


def _process_case(run, device):
    """(process, compressor, spec, (x, x_hat, s) in the engine's layout on
    ``device``, draws(t, u) of the CPU's making, moved to ``device``) of
    one PROCESS_SMALL_RUNS / PROCESS_DIST_RUNS / STALE_SMALL_RUNS /
    STALE_DIST_RUNS entry; a staleness run's rings start random, so every
    delay reads them."""
    import torch
    from repro_torch.comm.schedule import compile_schedule
    from repro_torch.comm.stochastic import make_topology_process
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.topology import make_topology
    kind, comp_name, kw, sdt, packed, topo, k = run[:7]
    opts = (dict(max_staleness=run[7], straggler_edges=run[8])
            if kind == "staleness" else dict(edge_drop_prob=0.4))
    proc = make_topology_process(kind, compile_schedule(
        make_topology(topo, N_NODES)), **opts)
    comp = make_compressor(comp_name, **dict(kw))
    dtype = getattr(torch, sdt)
    spec, leaves, _, draws_on = _small_inputs(run, comp, sdt, PROCESS_SEED,
                                              packed)
    R = proc.schedule.n_rounds
    tau = run[7] if kind == "staleness" else 0
    x = leaves(1.0, torch.float32)
    x_hat = ([leaves(0.5, dtype) for _ in range(R)] if kind == "matching"
             else [leaves(0.5, dtype)] + [leaves(0.05, dtype)
                                          for _ in range(tau)]
             if kind == "staleness" else leaves(0.5, dtype))
    s = ([leaves(0.5, dtype) for _ in range(R)]
         + [leaves(0.05, dtype) for _ in range(R * tau)])
    return (proc, comp, spec,
            tuple(_to_device(b, device) for b in (x, x_hat, s)),
            draws_on(device))


def _flat_bufs(obj):
    return ([obj] if not isinstance(obj, (list, tuple))
            else [b for o in obj for b in _flat_bufs(o)])


def process_small(dev):
    """[process] small: the replica exchange alone on the card against the
    CPU, PROCESS_SMALL_RUNS: matching and link failures, packed and per
    leaf, f32 and bf16 state, on ring, chain and star, top_k, rand_k and
    QSGD (the CPU's draws on both; QSGD per leaf on bf16 state ships f32
    payloads), the samples drawn from the same seed on
    both devices: the samples equal, x, x_hat and s (every reference and
    replica) bit-equal, one replica-update launch per unit per gossip
    round on the card.  Returns the card's launches."""
    import torch
    from repro_torch.comm import gossip
    from repro_torch.kernels import dispatch
    launches = {k: 0 for k in kernel_names()}
    for run in PROCESS_SMALL_RUNS:
        kind, comp_name, kw, sdt, packed, topo, k = run
        got = {}
        for device in (dev, torch.device("cpu")):
            proc, comp, spec, bufs, draws = _process_case(run, device)
            ex = gossip.make_process_exchange(spec=spec, process=proc,
                                              compressor=comp, gamma=0.3,
                                              gossip_steps=k, packed=packed)
            dispatch.reset_launch_counts()
            ex(*bufs, seed=PROCESS_SEED, draws=draws)
            counts = dispatch.launch_counts()
            got[device.type] = (bufs, [getattr(sm, "tolist", lambda: sm)()
                                       for sm in ex.last_samples], counts)
        (cb, cs, cc), (hb, hs, hc) = got[dev.type], got["cpu"]
        check(cs == hs, f"[process] small {run}: samples {cs} on the card, "
              f"{hs} on the CPU")
        for g, w in zip(_flat_bufs(cb), _flat_bufs(hb)):
            check(torch.equal(g.cpu(), w), f"[process] small {run}: the card "
                  f"and the CPU differ")
        units = spec.n_buckets if packed else len(spec.slots)
        # besides the replica update only the compressor's kernels launch
        # (QSGD's codes and dequantize), no EF update
        check(cc["replica_update"] == k * units
              and not any(v for name, v in cc.items()
                          if name.startswith("ef_update"))
              and sum(hc.values()) == 0,
              f"[process] small {run}: launches {cc}, expected "
              f"{k * units} replica_update and no EF update")
        for name, v in cc.items():
            launches[name] += v
        print(f"[process] small {kind} {comp_name} {sdt} "
              f"{'packed' if packed else 'per-leaf'} {topo} x{k}: samples "
              f"{cs} equal, x, x_hat and s bit-equal card and CPU; "
              f"replica_update {cc['replica_update']} launches ({units} "
              f"units x {k} rounds)", flush=True)
    return launches


def _process_dist_rank(rank, store, out_dir):
    import torch
    from repro_torch.comm import gossip
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh
    group = _dist_group(rank, store)
    dev = group.device
    results = {}
    row = lambda obj: (obj[rank:rank + 1].clone() if torch.is_tensor(obj)
                       else [row(o) for o in obj])
    # the [stale] runs in the same ranks: one spawn for both phases
    for key, run in ([(i, r) for i, r in enumerate(PROCESS_DIST_RUNS)]
                     + [(("stale", i), r)
                        for i, r in enumerate(STALE_DIST_RUNS)]):
        proc, comp, spec, bufs, draws = _process_case(run, dev)
        ex = gossip.make_dist_process_exchange(
            spec=spec, process=proc, compressor=comp, gamma=0.3,
            gossip_steps=run[6], group=group, packed=run[4])
        mine = row(bufs)
        before = group.bytes_sent
        dispatch.reset_launch_counts()
        if run[0] == "staleness":
            _, shipped = _small_calls(ex, mine, draws, STALE_SMALL_CALLS,
                                      STALE_SEED, slice(rank, rank + 1))
        else:
            ex(*mine, seed=PROCESS_SEED)
            shipped = ex.sent_rounds(ex.last_samples)
        results[key] = ([b.cpu() for b in _flat_bufs(mine)],
                        group.bytes_sent - before,
                        shipped * sum(ex.payload_bytes),
                        dispatch.launch_counts())
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def process_dist_small(dev):
    """[process] small, per rank: 4 ranks on the card run
    PROCESS_DIST_RUNS with the seeds' own draws and samples, each rank's
    x, x_hat and s bit-equal to its row of the stacked exchange on the
    card, its bytes sent its payload bytes times the rounds it shipped;
    the same ranks then run STALE_DIST_RUNS (held by stale_dist_small).
    Returns (the ranks' launches, summed, the ranks' results)."""
    import tempfile
    import torch
    from repro_torch.comm import gossip
    with tempfile.TemporaryDirectory(prefix="chip_process_") as tmp:
        spawn_ranks_of(_process_dist_rank, tmp, DIST_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(N_NODES)]
    launches = {k: 0 for k in kernel_names()}
    for i, run in enumerate(PROCESS_DIST_RUNS):
        proc, comp, spec, bufs, _ = _process_case(run, dev)
        gossip.make_process_exchange(spec=spec, process=proc, compressor=comp,
                                     gamma=0.3, gossip_steps=run[6],
                                     packed=run[4])(*bufs, seed=PROCESS_SEED)
        stacked = [b.cpu() for b in _flat_bufs(bufs)]
        sent = []
        for r, res in enumerate(ranks):
            mine, nbytes, want, counts = res[i]
            for g, w in zip(mine, stacked):
                check(torch.equal(g, w[r:r + 1]), f"[process] dist {run}: "
                      f"rank {r} differs from the stacked exchange")
            check(nbytes == want, f"[process] dist {run}: rank {r} sent "
                  f"{nbytes} bytes, expected {want}")
            sent.append(nbytes)
            for name, v in counts.items():
                launches[name] += v
        print(f"[process] small per rank {run[0]} {run[1]} {run[3]} "
              f"{'packed' if run[4] else 'per-leaf'} {run[5]} x{run[6]}: "
              f"{N_NODES} ranks bit-equal to the stacked exchange on the "
              f"card; bytes sent per rank {sent} (payload bytes x rounds "
              f"shipped)", flush=True)
    return launches, ranks


def sim_process(dev):
    """[sim] under the processes: CHOCO-Gossip (the replica simulator,
    ``comm/stochastic.py:run_choco_gossip_process``) at ring 25, d 2000,
    SIM_PROCESS_RUNS, on the card and on the CPU from the same x0, the
    samples drawn from the same seed: each round held against the CPU's
    repeat of it from the card's state (x and the references within
    SIM_STEP_RTOL of their largest magnitude, at most SIM_PROCESS_MOVED
    elements beyond), the free runs' final consensus errors printed."""
    import torch
    from repro_torch.comm.packing import fold_seed
    from repro_torch.comm.stochastic import (ProcessGossipState,
                                             choco_process_round,
                                             init_process_state,
                                             process_from_topology,
                                             run_choco_gossip_process)
    from repro_torch.core.topology import ring
    n, d = SIM_GOSSIP_N, SIM_GOSSIP_D
    x0 = torch.randn((n, d), generator=torch.Generator().manual_seed(5))
    report = {}
    for label, kind, spec, gamma, rounds in SIM_PROCESS_RUNS:
        proc = process_from_topology(kind, ring(n), edge_drop_prob=0.1)
        comp = _sim_compressor(spec)
        if comp is None:
            from repro_torch.core.compression import Identity
            comp = Identity()
        finals = {}
        for which, device in (("card", dev), ("cpu", torch.device("cpu"))):
            st, errs = run_choco_gossip_process(x0.to(device), proc, gamma,
                                                comp, rounds, seed=7)
            finals[which] = (float(errs[0]), float(errs[-1]))
        check(all(math.isfinite(v) for v in finals["card"]) and
              finals["card"][1] < finals["card"][0],
              f"[sim] {label}: consensus error {finals['card']}")
        moved_max, worst = 0, 0.0
        state = init_process_state(x0.to(dev), proc)
        for step in range(rounds):
            seed = fold_seed(7, step)
            nxt = choco_process_round(state, proc, gamma, comp, seed)
            cpu = choco_process_round(ProcessGossipState(
                state.x.cpu(), state.refs.cpu()), proc, gamma, comp, seed)
            for g, w in ((nxt.x, cpu.x), (nxt.refs, cpu.refs)):
                gap = (g.cpu() - w).abs()
                tol = SIM_STEP_RTOL * float(w.abs().max())
                moved = int((gap > tol).sum())
                moved_max = max(moved_max, moved)
                worst = max(worst, float(gap.max()) / max(
                    float(w.abs().max()), 1e-30))
            check(moved_max <= SIM_PROCESS_MOVED, f"[sim] {label}: round "
                  f"{step} moved {moved_max} elements beyond the tolerance")
            state = nxt
        print(f"[sim] {label}: ring {n}, d {d}, {rounds} rounds, gamma "
              f"{gamma}: consensus error {finals['card'][0]:.6e} -> "
              f"{finals['card'][1]:.6e} on the card, {finals['cpu'][1]:.6e} "
              f"on the CPU; held round by round (largest relative gap "
              f"{worst:.3e}, at most {moved_max} elements moved)", flush=True)
        report[label] = {"first_error": finals["card"][0],
                         "final_error_card": finals["card"][1],
                         "final_error_cpu": finals["cpu"][1],
                         "round_max_rel": worst, "moved_max": moved_max}
    return report


# ---------------------------------------------------------------------------
# [stale]: bounded-staleness gossip through the replica engine's stale form
# ---------------------------------------------------------------------------

#: [stale]: the compressors of the full-width runs (bf16 EF state, tau
#: STALE_TAU, the uniform delay law (0.5, 0.5))
STALE_RUNS = ("top_k", "qsgd")
STALE_TAU = 1
#: the peak reckoned before the first run (GiB): the bf16 state's measured
#: 52.276 GiB plus 4 more bf16 trees of 5.386 GiB (x_hat's ring slot, and
#: each of the ring's 2 rounds a receive-ring slot and a replica beyond
#: the static engine's one s)
STALE_PREDICTED_GIB = 73.8
#: the full-width memory a 4-node run may take before it falls back to 3
#: nodes on the ring (R is still 2), never a narrower model
STALE_FALLBACK_NODES = 3
#: [stale] small: ("staleness", compressor, kwargs, state dtype, packed,
#: topology, gossip rounds, tau, straggler edges) of the exchange held card against
#: CPU over STALE_SMALL_CALLS calls (QSGD on bf16 state per leaf only: on
#: f32 state the card's and the CPU's norms sum in another order)
STALE_SMALL_RUNS = (
    ("staleness", "top_k", (("fraction", 0.05),), "float32", True, "ring",
     2, 1, None),
    ("staleness", "rand_k", (("fraction", 0.05),), "bfloat16", True,
     "chain", 1, 2, None),
    ("staleness", "top_k", (("fraction", 0.05),), "float32", True, "star",
     1, 3, None),
    ("staleness", "top_k", (("fraction", 0.05),), "bfloat16", False,
     "star", 1, 2, ((0, 1),)),
    ("staleness", "rand_k", (("fraction", 0.05),), "float32", False, "ring",
     2, 3, None),
    # QSGD on bf16 state per leaf: f32 payloads, the kernel's (bf16 state,
    # f32 payload) build
    ("staleness", "qsgd", (("s", 16),), "bfloat16", False, "chain", 1, 2,
     None),
    ("staleness", "top_k", (("fraction", 0.05),), "bfloat16", True, "ring",
     1, 0, None))
STALE_SMALL_CALLS = 3
#: [stale] small per rank: runs of STALE_SMALL_RUNS's form
STALE_DIST_RUNS = (
    ("staleness", "qsgd", (("s", 16),), "bfloat16", True, "chain", 2, 2,
     None),
    ("staleness", "top_k", (("fraction", 0.05),), "float32", False, "star",
     1, 3, ((0, 2),)))
STALE_SEED = 5151
#: [sim]: (label, compressor, gamma, rounds) of bounded-staleness
#: CHOCO-Gossip at ring 25, d 2000, tau STALE_SIM_TAU
#: 150 rounds, 300 until the frontend phases came (the script's time)
SIM_STALE_RUNS = (("stale_exact", None, 1.0, 150),
                  ("stale_top_1pct", ("top_k", 0.01), 0.046, 150))
STALE_SIM_TAU = 2
#: [kernel] replica_update stale form: the length of the tau > 1 cases,
#: and the plain version's column chunk at the full width
STALE_TAUS = (2, 3)
STALE_PLAIN_CHUNK = 1 << 23


def check_stale_kernels(dev):
    """The replica-update kernel's bounded-staleness form in each
    REPLICA_DTYPES case, bit for bit against ``ref.replica_stale_ref``:
    tau 1 with the ring's R = 2 replicas at the embedding bucket
    (4, 311,164,928), in place, chunk by chunk, with the delays (0, 1) and
    (1, 0) on the two rounds' rows, timed beside its plain version and its
    bytes bound (4 elements a thread); tau 2 and 3 at ODD_LENGTH (one
    element a thread) and ODD_LENGTH + 1 (4 a thread) with every delay in
    range on some row and round.  Returns (records by case, the record of the
    kernel line: bf16 state and payloads, the [stale] cell's build, the
    largest |kernel - plain| over every case)."""
    import torch
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(13)
    node = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt, device=dev)
    w = node(((1 / 3,) * N_NODES, (1 / 3,) * N_NODES))
    gamma = 3.7e-5
    records, max_err = {}, 0.0
    short = {"float32": "f32", "bfloat16": "bf16"}
    for sdt, qdt in REPLICA_DTYPES:
        sd, qd = getattr(torch, sdt), getattr(torch, qdt)
        for tau, length in ((STALE_TAU, 311_164_928),) + tuple(
                (t, n) for t in STALE_TAUS for n in (ODD_LENGTH,
                                                     ODD_LENGTH + 1)):
            shape = (N_NODES, length)
            mk = lambda sc, dt: (torch.randn(shape, generator=gen, device=dev)
                                 * sc).to(dt)
            R = 2
            # every delay 0..tau on some row of some round
            delays = node([[(i + r) % (tau + 1) for i in range(N_NODES)]
                           for r in range(R)], torch.int32)
            x, h, q_self = mk(1.0, torch.float32), mk(0.5, sd), mk(0.1, qd)
            reps = [mk(0.5, sd) for _ in range(R)]
            pays = [mk(0.1, qd) for _ in range(R)]
            own = [torch.empty(shape, dtype=sd, device=dev)] + [
                mk(0.1, sd) for _ in range(tau - 1)]
            rings = [[torch.empty(shape, dtype=sd, device=dev)] + [
                mk(0.1, sd) for _ in range(tau - 1)] for _ in range(R)]
            outs = [x.clone(), h.clone(), *[t.clone() for t in reps]]

            def call():
                dispatch.replica_stale(outs[0], outs[1], q_self, outs[2:],
                                       pays, own, rings, w, delays, gamma)
            call()
            full = length > ODD_LENGTH + 1
            chunk = STALE_PLAIN_CHUNK if full else length

            def plain_one(part):
                cut = lambda t: t[:, part]
                return ref.replica_stale_ref(
                    cut(x), cut(h), cut(q_self), [cut(t) for t in reps],
                    [cut(t) for t in pays], [cut(t) for t in own],
                    [[cut(t) for t in rg] for rg in rings], w, delays, gamma)
            err = 0.0
            for c in range(0, length, chunk):
                part = slice(c, c + chunk)
                x_n, h_n, s_n, own0, ring0 = plain_one(part)
                pairs = list(zip(outs, [x_n, h_n, *s_n])) + list(zip(
                    [own[0]] + [rg[0] for rg in rings], [own0, *ring0]))
                for g, want in pairs:
                    got = g[:, part]
                    err = max(err, float((got.double() - want.double())
                                         .abs().max()))
                    check(torch.equal(got, want),
                          f"[kernel] replica_update stale tau={tau} {sdt} "
                          f"state, {qdt} payloads differs from its plain "
                          f"version (max abs {err})")
            max_err = max(max_err, err)
            name = f"stale_tau{tau}_{short[sdt]}" + (
                "" if sdt == qdt else f"_{short[qdt]}q") + (
                "" if full or length % 4 else "_vec4")
            rec = dict(max_abs_err=err, shape=[N_NODES, length], tau=tau)
            if full:
                ms = time_ms(call, 5)

                def plain():
                    for c in range(0, length, chunk):
                        plain_one(slice(c, c + chunk))
                plain_ms = time_ms(plain, 1)
                # what this run's delays read: the ring slots 1.. of the
                # rows whose delay reaches them (none at tau 1)
                bms, by = bound_ms([x, h, q_self, *reps, *pays],
                                   [x, h, *reps, own[0],
                                    *[rg[0] for rg in rings]],
                                   (5 + R * 6) * x.numel())
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                           bound_ms=bms, bound_by=by)
                print(f"[kernel] replica_update {name} n={N_NODES} "
                      f"len={length} R={R}: bit-equal (max abs {err}); "
                      f"{ms:.3f} ms (bound {bms:.3f} ms, {by}, "
                      f"{bms / ms:.3f} of it), plain {plain_ms:.3f} ms",
                      flush=True)
            else:
                print(f"[kernel] replica_update {name} n={N_NODES} "
                      f"len={length} R={R}, delays {delays.tolist()}: "
                      f"bit-equal (max abs {err})", flush=True)
            records[name] = rec
            del x, h, q_self, reps, pays, own, rings, outs
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    main = {k: v for k, v in records[f"stale_tau{STALE_TAU}_bf16"].items()
            if k not in ("max_abs_err", "tau")}
    return records, main, max_err


def stale_full_width(dev, state_bf16, process_runs):
    """[stale]: the training cell (2 layers, ring, 4 nodes, bf16 EF state)
    under bounded staleness, tau STALE_TAU with the uniform law, top_k
    0.01 and QSGD s=16, each printed beside the [state-bf16] static run
    and the [process] link-failure run of the same compressor in this
    call: ms per step over steps 2-3, the peak beside the reckoned
    STALE_PREDICTED_GIB, the device's idle share of the profiled step,
    launches per step per kernel, the wire bytes per node per step
    (computed from the spec) and the sampled delays.  If 4 nodes run out
    of memory, 3 nodes on the ring at the same width (R is still 2)."""
    import torch
    runs = {}
    for comp in STALE_RUNS:
        nodes = N_NODES
        try:
            counts, rec = train_full_width(comp, dev, state_dtype=PROCESS_STATE,
                                           process="staleness",
                                           tau=STALE_TAU)
        except torch.OutOfMemoryError as err:
            torch.cuda.empty_cache()
            nodes = STALE_FALLBACK_NODES
            print(f"[stale] {comp}: 4 nodes ran out of memory ({err}); the "
                  f"reckoning was {STALE_PREDICTED_GIB} GiB against the "
                  f"card's {torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
                  f" GiB; running {nodes} nodes on the ring at the same "
                  f"width", flush=True)
            counts, rec = train_full_width(comp, dev, state_dtype=PROCESS_STATE,
                                           process="staleness", tau=STALE_TAU,
                                           n_nodes=nodes)
        base = state_bf16[comp][1]
        lf = process_runs[f"process_linkfail_{comp}"][1]
        prof = rec["profile"] or {}
        per_step = {k: v // STEPS for k, v in counts.items() if v}
        check(per_step.get("replica_update") == 10,
              f"[stale] {comp}: replica_update {per_step} a step, expected "
              f"10 (one per bucket)")
        check(rec["wire_bytes_per_node_step"]
              == base["wire_bytes_per_node_step"],
              f"[stale] {comp}: wire bytes {rec['wire_bytes_per_node_step']}"
              f" against the static {base['wire_bytes_per_node_step']}")
        rec.update(predicted_peak_gib=STALE_PREDICTED_GIB, nodes=nodes,
                   tau=STALE_TAU)
        print(f"[stale] staleness tau={STALE_TAU} {comp} ({PROCESS_STATE} "
              f"state, {nodes} nodes): ms/step over steps 2-3 "
              f"{rec['ms_per_step'][1:]} against the static engine's "
              f"{base['ms_per_step'][1:]} and link failures' "
              f"{lf['ms_per_step'][1:]}; peak {rec['peak_gib']:.3f} GiB, "
              f"reckoned {STALE_PREDICTED_GIB} GiB (static "
              f"{base['peak_gib']:.3f}, link failures {lf['peak_gib']:.3f});"
              f" device idle share "
              f"{prof.get('device_idle_share', float('nan')):.4f}; launches "
              f"per step {per_step}; wire bytes per node per step "
              f"{rec['wire_bytes_per_node_step']} against "
              f"{base['wire_bytes_per_node_step']} (computed from the spec);"
              f" delays {rec['samples']}", flush=True)
        runs[f"stale_{comp}"] = (counts, rec)
    return runs


def _small_calls(ex, bufs, draws, calls, seed, rows=None):
    """``calls`` calls of a small exchange (stale or push-sum) on
    ``bufs``, seeds ``seed`` + call, the draws of ``rows`` (all rows if
    None; call c's round t draws ``draws(10 c + t, u)``).  Returns the
    delays of every call's gossip rounds (a stale exchange's) and the
    rounds it shipped (per rank)."""
    delays, shipped = [], 0
    for call in range(calls):
        cut = (lambda d: d) if rows is None else (lambda d: d[rows])
        ex(*bufs, seed=seed + call,
           draws=None if draws is None else
           (lambda t, u, c=call: cut(draws(10 * c + t, u))))
        samples = getattr(ex, "last_samples", None)
        if samples is not None:
            delays.append([d.tolist() for d in samples])
        if hasattr(ex, "sent_rounds"):
            shipped += ex.sent_rounds(samples)
    return delays, shipped


def stale_small(dev):
    """[stale] small: the stale exchange alone on the card against the CPU,
    STALE_SMALL_RUNS over STALE_SMALL_CALLS calls each: packed and per
    leaf, f32 and bf16 state, ring, chain and star, tau 0 to 3, top_k,
    rand_k and QSGD (QSGD per leaf on bf16 state ships f32 payloads), one
    straggler link; the delays drawn from the same seeds on both devices:
    the delays equal, x, x_hat and every replica and ring slot bit-equal,
    one replica-update launch per unit per gossip round on the card and
    no EF launch.  Returns the card's launches."""
    import torch
    from repro_torch.comm import gossip
    from repro_torch.kernels import dispatch
    launches = {k: 0 for k in kernel_names()}
    for run in STALE_SMALL_RUNS:
        _, comp_name, kw, sdt, packed, topo, k, tau, edges = run
        got = {}
        for device in (dev, torch.device("cpu")):
            proc, comp, spec, bufs, draws = _process_case(run, device)
            ex = gossip.make_process_exchange(spec=spec, process=proc,
                                              compressor=comp, gamma=0.3,
                                              gossip_steps=k, packed=packed)
            dispatch.reset_launch_counts()
            delays, _ = _small_calls(ex, bufs, draws, STALE_SMALL_CALLS,
                                        STALE_SEED)
            got[device.type] = (bufs, delays, dispatch.launch_counts())
        (cb, cs, cc), (hb, hs, hc) = got[dev.type], got["cpu"]
        check(cs == hs, f"[stale] small {run}: delays {cs} on the card, {hs}"
              f" on the CPU")
        flat_c, flat_h = _flat_bufs(cb), _flat_bufs(hb)
        check(len(flat_c) == spec.n_buckets * (
            1 + 1 + tau + proc.schedule.n_rounds * (1 + tau)),
            f"[stale] small {run}: {len(flat_c)} buffers")
        for g, w in zip(flat_c, flat_h):
            check(torch.equal(g.cpu(), w), f"[stale] small {run}: the card "
                  f"and the CPU differ")
        units = spec.n_buckets if packed else len(spec.slots)
        want = STALE_SMALL_CALLS * k * units
        check(cc["replica_update"] == want
              and not any(v for name, v in cc.items()
                          if name.startswith("ef_update"))
              and sum(hc.values()) == 0,
              f"[stale] small {run}: launches {cc}, expected {want} "
              f"replica_update and no EF update")
        for name, v in cc.items():
            launches[name] += v
        print(f"[stale] small {comp_name} {sdt} "
              f"{'packed' if packed else 'per-leaf'} {topo} x{k} tau={tau}"
              f"{'' if edges is None else f' stragglers={edges}'}: delays "
              f"{cs} equal; x, x_hat, replicas and rings bit-equal card and "
              f"CPU; replica_update {cc['replica_update']} launches "
              f"({units} units x {k} rounds x {STALE_SMALL_CALLS} calls)",
              flush=True)
    return launches


def stale_dist_small(dev, ranks):
    """[stale] small per rank: the 4 ranks of ``process_dist_small``'s
    spawn ran STALE_DIST_RUNS on the card (their results under
    ``("stale", i)`` in ``ranks``), each rank's x, x_hat and s bit-equal
    to its row of the stacked exchange on the card, its bytes its payload
    bytes times the rounds it ships in times the gossip rounds and calls.
    Returns the ranks' launches, summed."""
    import torch
    from repro_torch.comm import gossip, packing
    launches = {k: 0 for k in kernel_names()}
    for i, run in enumerate(STALE_DIST_RUNS):
        proc, comp, spec, bufs, draws = _process_case(run, dev)
        ex = gossip.make_process_exchange(spec=spec, process=proc,
                                          compressor=comp, gamma=0.3,
                                          gossip_steps=run[6], packed=run[4])
        _small_calls(ex, bufs, draws, STALE_SMALL_CALLS, STALE_SEED)
        stacked = [b.cpu() for b in _flat_bufs(bufs)]
        sent = []
        for r, res in enumerate(ranks):
            mine, nbytes, want, counts = res["stale", i]
            for g, w in zip(mine, stacked):
                check(torch.equal(g, w[r:r + 1]), f"[stale] dist {run}: "
                      f"rank {r} differs from the stacked exchange")
            sends = sum(rnd.peers(r)[0] is not None
                        for rnd in proc.schedule.rounds)
            check(nbytes == want == STALE_SMALL_CALLS * run[6] * sends * sum(
                packing.bucket_wire_nbytes(spec, comp) if run[4]
                else packing.leaf_wire_nbytes(spec, comp)),
                f"[stale] dist {run}: rank {r} sent {nbytes} bytes, expected "
                f"{want}")
            sent.append(nbytes)
            for name, v in counts.items():
                launches[name] += v
        print(f"[stale] small per rank {run[1]} {run[3]} "
              f"{'packed' if run[4] else 'per-leaf'} {run[5]} x{run[6]} "
              f"tau={run[7]}: {N_NODES} ranks bit-equal to the stacked "
              f"exchange on the card over {STALE_SMALL_CALLS} calls; bytes "
              f"sent per rank {sent} (payload bytes x rounds shipped in x "
              f"gossip rounds x calls)", flush=True)
    return launches


def sim_stale(dev):
    """[sim] under bounded staleness: CHOCO-Gossip (the stale simulator,
    ``core/choco_gossip.py:run_choco_stale_gossip``) at ring 25, d 2000,
    tau STALE_SIM_TAU, SIM_STALE_RUNS, on the card and on the CPU from the
    same x0, the delays drawn from the same seed: each round held against
    the CPU's repeat of it from the card's state (x, x_hat and the ring
    within SIM_STEP_RTOL of their largest magnitude, at most
    SIM_PROCESS_MOVED elements beyond), the final consensus errors
    printed."""
    import torch
    from repro_torch.comm.packing import fold_seed
    from repro_torch.comm.stochastic import process_from_topology
    from repro_torch.core.choco_gossip import (StaleGossipState,
                                               choco_stale_round,
                                               init_stale_state,
                                               run_choco_stale_gossip)
    from repro_torch.core.compression import Identity
    from repro_torch.core.topology import ring
    n, d = SIM_GOSSIP_N, SIM_GOSSIP_D
    x0 = torch.randn((n, d), generator=torch.Generator().manual_seed(5))
    proc = process_from_topology("staleness", ring(n),
                                 max_staleness=STALE_SIM_TAU)
    report = {}
    for label, spec, gamma, rounds in SIM_STALE_RUNS:
        comp = _sim_compressor(spec) or Identity()
        finals = {}
        for which, device in (("card", dev), ("cpu", torch.device("cpu"))):
            st, errs = run_choco_stale_gossip(x0.to(device), proc, gamma,
                                              comp, rounds, seed=7)
            finals[which] = (float(errs[0]), float(errs[-1]))
        check(all(math.isfinite(v) for v in finals["card"]) and
              finals["card"][1] < finals["card"][0],
              f"[sim] {label}: consensus error {finals['card']}")
        moved_max, worst = 0, 0.0
        state = init_stale_state(x0.to(dev), STALE_SIM_TAU)
        for step in range(rounds):
            seed = fold_seed(7, step)
            nxt = choco_stale_round(state, proc, gamma, comp, seed)
            cpu = choco_stale_round(StaleGossipState(
                *(t.cpu() for t in state)), proc, gamma, comp, seed)
            for g, w in zip(nxt, cpu):
                gap = (g.cpu() - w).abs()
                tol = SIM_STEP_RTOL * float(w.abs().max())
                moved = int((gap > tol).sum())
                moved_max = max(moved_max, moved)
                worst = max(worst, float(gap.max()) / max(
                    float(w.abs().max()), 1e-30))
            check(moved_max <= SIM_PROCESS_MOVED, f"[sim] {label}: round "
                  f"{step} moved {moved_max} elements beyond the tolerance")
            state = nxt
        print(f"[sim] {label}: ring {n}, d {d}, tau {STALE_SIM_TAU}, "
              f"{rounds} rounds, gamma {gamma}: consensus error "
              f"{finals['card'][0]:.6e} -> {finals['card'][1]:.6e} on the "
              f"card, {finals['cpu'][1]:.6e} on the CPU; held round by round "
              f"(largest relative gap {worst:.3e}, at most {moved_max} "
              f"elements moved)", flush=True)
        report[label] = {"first_error": finals["card"][0],
                         "final_error_card": finals["card"][1],
                         "final_error_cpu": finals["cpu"][1],
                         "round_max_rel": worst, "moved_max": moved_max}
    return report


#: [pushsum]: the full-width push-sum runs, (topology, compressor); f32
#: EF state, bf16 where f32 runs out of memory
PUSHSUM_RUNS = (("directed_ring", "top_k"), ("directed_ring", "qsgd"),
                ("random_digraph", "top_k"))
#: the reckoned peaks (GiB): the static engine's (PERF.md: 63.049 f32,
#: 52.276 bf16 state) plus one f32 copy of x, z = x / w (10.78 GiB)
PUSHSUM_PREDICTED_GIB = {"float32": 73.8, "bfloat16": 63.1}
#: [pushsum] small: (topology, compressor, comp_kwargs, state dtype,
#: gossip_steps) of the exchange alone, card against CPU
PUSHSUM_SMALL_RUNS = (
    ("directed_ring", "qsgd", (("s", 16),), "float32", 1),
    ("directed_ring", "sign", (), "bfloat16", 1),
    ("directed_ring", "top_k", (("fraction", 0.05),), "bfloat16", 2),
    ("random_digraph", "top_k", (("fraction", 0.05),), "float32", 1),
    ("random_digraph", "qsgd", (("s", 16),), "bfloat16", 2),
    ("random_digraph", "sign", (), "float32", 1),
    ("random_digraph", "top_k", (("fraction", 0.05),), "bfloat16", 1))
#: [pushsum] small per rank: the runs of PUSHSUM_SMALL_RUNS the ranks hold
PUSHSUM_DIST_RUNS = (PUSHSUM_SMALL_RUNS[0], PUSHSUM_SMALL_RUNS[4],
                     PUSHSUM_SMALL_RUNS[5])
PUSHSUM_CALLS = 3
PUSHSUM_SEED = 6262
#: [pushsum] small, QSGD and sign: card against CPU, f32 state within this
#: bound (absolute plus relative) and, on bf16 state, at most one element
#: in this many one bf16 step apart (the norms' summation order)
PUSHSUM_F32_TOL = 1e-6
PUSHSUM_BF16_FLIPS = 100_000
#: the push-sum launcher run (stacked, on the card)
PUSHSUM_LAUNCHER = ["--mode", "pushsum", "--topology", "random_digraph",
                    "--compressor", "qsgd", "--qsgd-s", "16"]
#: [sim] push-sum: (label, compressor, gamma, rounds) on the directed ring
#: of SIM_GOSSIP_N nodes at d = SIM_GOSSIP_D
SIM_PUSHSUM_RUNS = (("pushsum_exact", None, 1.0, 300),
                    ("pushsum_qsgd127", ("qsgd", 127), 0.5, 300))


def pushsum_full_width(dev, by_path, state_bf16):
    """[pushsum]: the training cell (2 layers, 4 nodes) in push-sum mode,
    PUSHSUM_RUNS, f32 EF state (bf16 state if f32 runs out of memory),
    each printed beside the static ring run of the same compressor and
    state dtype in this call: ms per step over steps 2-3, the peak beside
    PUSHSUM_PREDICTED_GIB and what is live at it (``memory_at_peak``),
    the device's idle share of the profiled step, launches per step
    (asserted: the codes and dequantize kernels under QSGD and the EF
    update, once per bucket), the wire bytes per node per step beside the
    static run's (asserted on the directed ring: half of it, one round
    against two, plus 4 bytes of w), and the weight column: 1^T w = n
    within 1e-3 relative, max w / min w."""
    import torch
    from repro_torch.comm.pushsum import W_BYTES
    runs = {}
    for topo, comp in PUSHSUM_RUNS:
        sdt = "float32"
        try:
            counts, rec = train_full_width(comp, dev, topology=topo,
                                           mode="pushsum", memory_trace=True)
        except torch.OutOfMemoryError as err:
            torch.cuda.empty_cache()
            sdt = "bfloat16"
            print(f"[pushsum] {topo} {comp}: f32 state ran out of memory "
                  f"({err}); the reckoning was "
                  f"{PUSHSUM_PREDICTED_GIB['float32']} GiB; running bf16 "
                  f"state", flush=True)
            counts, rec = train_full_width(comp, dev, topology=topo,
                                           mode="pushsum", state_dtype=sdt,
                                           memory_trace=True)
        base = (by_path if sdt == "float32" else state_bf16)[comp][1]
        prof, base_prof = rec["profile"] or {}, base["profile"] or {}
        per_step = {k: v // STEPS for k, v in counts.items() if v}
        ef = "ef_update" if sdt == "float32" else "ef_update_bf16"
        want = {ef: rec["units"]}
        if comp == "qsgd":
            want.update(qsgd_codes=rec["units"], dequantize=rec["units"])
        check(per_step == want, f"[pushsum] {topo} {comp}: launches per step "
              f"{per_step}, expected {want}")
        wire, base_wire = (rec["wire_bytes_per_node_step"],
                           base["wire_bytes_per_node_step"])
        if topo == "directed_ring":
            check(wire == base_wire // 2 + W_BYTES,
                  f"[pushsum] {comp}: wire bytes {wire}, not half the static "
                  f"ring's {base_wire} plus {W_BYTES}")
        mass_gap = abs(rec["psw_mass"] - N_NODES) / N_NODES
        check(mass_gap <= 1e-3, f"[pushsum] {topo} {comp}: 1^T w = "
              f"{rec['psw_mass']}, not {N_NODES}")
        rec.update(predicted_peak_gib=PUSHSUM_PREDICTED_GIB[sdt],
                   mass_rel_gap=mass_gap)
        print(f"[pushsum] {topo} ({rec['rounds']} rounds) {comp} ({sdt} "
              f"state): ms/step over steps 2-3 {rec['ms_per_step'][1:]} "
              f"against the static ring's {base['ms_per_step'][1:]}; peak "
              f"{rec['peak_gib']:.3f} GiB against {base['peak_gib']:.3f} GiB,"
              f" reckoned {PUSHSUM_PREDICTED_GIB[sdt]} GiB; device idle share "
              f"{prof.get('device_idle_share', float('nan')):.4f} against "
              f"{base_prof.get('device_idle_share', float('nan')):.4f}; "
              f"launches per step {per_step}; wire bytes per node per step "
              f"{wire} against the static ring's {base_wire} (computed from "
              f"the spec); 1^T w = {rec['psw_mass']:.9f} (n = {N_NODES}, "
              f"relative gap {mass_gap:.3e}), max w / min w = "
              f"{rec['psw_spread']:.9f}", flush=True)
        runs[f"pushsum_{topo}_{comp}"] = (counts, rec)
    return runs


def _pushsum_case(run, device):
    """(schedule, compressor, spec, [x, x_hat, s, w] on ``device``,
    draws(t, u) of the CPU's making, moved to ``device``) of one
    PUSHSUM_SMALL_RUNS entry; w starts off its ones, so its path counts."""
    import numpy as np
    import torch
    from repro_torch.comm.schedule import compile_directed_schedule
    from repro_torch.core.compression import make_compressor
    from repro_torch.core.topology import make_topology
    topo, comp_name, kw, sdt = run[:4]
    sched = compile_directed_schedule(make_topology(topo, N_NODES))
    comp = make_compressor(comp_name, **dict(kw))
    spec, leaves, rng, draws_on = _small_inputs(run, comp, sdt,
                                                PUSHSUM_SEED)
    dtype = getattr(torch, sdt)
    state = [leaves(1.0, torch.float32), leaves(0.5, dtype),
             leaves(0.5, dtype),
             torch.from_numpy(rng.uniform(0.5, 1.5, (N_NODES, 1)).astype(
                 np.float32))]
    return sched, comp, spec, _to_device(state, device), draws_on(device)


def _pushsum_launches(run, spec, counts, per_rank=False, recv=0):
    """The launches a push-sum run must make: per call and gossip round,
    per bucket, the codes kernel (QSGD, sign), the dequantize kernel (the
    stacked engine: once, its decode serving every receiver; per rank:
    the node's own and each of the ``recv`` payloads it receives) and one
    EF update; no other kernel."""
    _, comp, _, sdt, k = run
    per = PUSHSUM_CALLS * k * spec.n_buckets
    want = {name: 0 for name in counts}
    want["ef_update" if sdt == "float32" else "ef_update_bf16"] = per
    if comp in ("qsgd", "sign"):
        want["qsgd_codes" if comp == "qsgd" else "sign_codes"] = per
        want["dequantize"] = per * (1 + recv) if per_rank else per
    return want


def pushsum_small(dev):
    """[pushsum] small: the push-sum exchange alone on the card against
    the CPU, PUSHSUM_SMALL_RUNS over PUSHSUM_CALLS calls each (directed
    ring: one round; random digraph: 3 rounds and per-node weights; the
    EF kernel weighing q by a_jj and the rounds' sum nb by 1), the
    CPU's draws on both: x, x_hat, s and w bit-equal (QSGD and sign: w,
    and x, x_hat and s to PUSHSUM_F32_TOL / PUSHSUM_BF16_FLIPS), the
    launches as ``_pushsum_launches`` says.  Returns the card's
    launches."""
    import torch
    from repro_torch.comm import pushsum
    from repro_torch.kernels import dispatch
    launches = {k: 0 for k in kernel_names()}
    for run in PUSHSUM_SMALL_RUNS:
        got = {}
        for device in (dev, torch.device("cpu")):
            sched, comp, spec, state, draws = _pushsum_case(run, device)
            ex = pushsum.make_pushsum_exchange(spec=spec, schedule=sched,
                                               compressor=comp, gamma=0.3,
                                               gossip_steps=run[4])
            dispatch.reset_launch_counts()
            _small_calls(ex, state, draws, PUSHSUM_CALLS, PUSHSUM_SEED)
            got[device.type] = (state, dispatch.launch_counts())
        (cs, cc), (hs, hc) = got[dev.type], got["cpu"]
        # QSGD's and sign's scales sum each row's norm in the device's own
        # order (1e-6 relative): f32 state carries that within
        # PUSHSUM_F32_TOL; on bf16 state it may flip a bf16 rounding, at
        # most one element in PUSHSUM_BF16_FLIPS, by one bf16 step; w and
        # every other run bit-equal
        scaled = run[1] in ("qsgd", "sign")
        check(torch.equal(cs[3].cpu(), hs[3]), f"[pushsum] small {run}: w "
              f"differs card and CPU")
        flips, worst = 0, 0.0
        for g, w in zip(_flat_bufs(cs[:3]), _flat_bufs(hs[:3])):
            g, w = g.cpu().float(), w.float()
            d = (g - w).abs()
            worst = max(worst, float(d.max()))
            if not scaled:
                check(torch.equal(g, w), f"[pushsum] small {run}: the card "
                      f"and the CPU differ")
            elif run[3] == "float32":
                check(bool((d <= PUSHSUM_F32_TOL * (1 + w.abs())).all()),
                      f"[pushsum] small {run}: card and CPU differ by "
                      f"{float(d.max())}")
            else:
                bad = d > 0
                flips += int(bad.sum())
                check(bool((d[bad] <= 2.0 ** -7 * w.abs()[bad] + 1e-30).all()),
                      f"[pushsum] small {run}: a bf16 difference above one "
                      f"step")
        total = sum(b.numel() for b in _flat_bufs(hs[:3]))
        check(flips * PUSHSUM_BF16_FLIPS <= total, f"[pushsum] small {run}: "
              f"{flips} bf16 elements differ of {total}")
        mass = float(cs[3].double().sum())
        want = _pushsum_launches(run, spec, cc)
        check(cc == want and sum(hc.values()) == 0,
              f"[pushsum] small {run}: launches {cc}, expected {want}")
        for name, v in cc.items():
            launches[name] += v
        held = ("bit-equal" if not scaled else
                f"w bit-equal, x, x_hat and s within {worst:.3e} "
                f"({flips} bf16 elements differ)")
        print(f"[pushsum] small {run[0]} ({sched.n_rounds} rounds) {run[1]} "
              f"{run[3]} x{run[4]}: card against CPU over {PUSHSUM_CALLS} "
              f"calls: {held}; 1^T w = {mass:.7f}; launches "
              f"{ {k: v for k, v in cc.items() if v} }", flush=True)
    return launches


def _pushsum_dist_rank(rank, store, out_dir):
    import torch
    from repro_torch.comm import pushsum
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh
    group = _dist_group(rank, store)
    dev = group.device
    results = {}
    for i, run in enumerate(PUSHSUM_DIST_RUNS):
        sched, comp, spec, state, draws = _pushsum_case(run, dev)
        ex = pushsum.make_dist_pushsum_exchange(
            spec=spec, schedule=sched, compressor=comp, gamma=0.3,
            gossip_steps=run[4], group=group)
        mine = [t[rank:rank + 1].clone() if torch.is_tensor(t)
                else [b[rank:rank + 1].clone() for b in t] for t in state]
        before = group.bytes_sent
        dispatch.reset_launch_counts()
        _small_calls(ex, mine, draws, PUSHSUM_CALLS, PUSHSUM_SEED,
                     slice(rank, rank + 1))
        results[i] = ([b.cpu() for b in _flat_bufs(mine)],
                      group.bytes_sent - before,
                      PUSHSUM_CALLS * (ex.sends[0] * sum(ex.payload_bytes)
                                       + ex.w_bytes),
                      dispatch.launch_counts())
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close_node_group()


def pushsum_dist_small(dev):
    """[pushsum] small per rank: 4 ranks on the card run PUSHSUM_DIST_RUNS,
    each rank's x, x_hat, s and w bit-equal to its row of the stacked
    exchange on the card, its bytes sent its payload bytes plus 4 for w
    per round it sends in, per gossip round and call, its launches as
    ``_pushsum_launches`` says (a payload decoded where it lands).
    Returns the ranks' launches, summed."""
    import tempfile
    import torch
    from repro_torch.comm import pushsum
    from repro_torch.comm.packing import bucket_wire_nbytes
    with tempfile.TemporaryDirectory(prefix="chip_pushsum_") as tmp:
        spawn_ranks_of(_pushsum_dist_rank, tmp, DIST_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(N_NODES)]
    launches = {k: 0 for k in kernel_names()}
    for i, run in enumerate(PUSHSUM_DIST_RUNS):
        sched, comp, spec, state, draws = _pushsum_case(run, dev)
        _small_calls(pushsum.make_pushsum_exchange(
            spec=spec, schedule=sched, compressor=comp, gamma=0.3,
            gossip_steps=run[4]), state, draws, PUSHSUM_CALLS, PUSHSUM_SEED)
        stacked = [b.cpu() for b in _flat_bufs(state)]
        sent = []
        for r, res in enumerate(ranks):
            mine, nbytes, want, counts = res[i]
            for g, w in zip(mine, stacked):
                check(torch.equal(g, w[r:r + 1]), f"[pushsum] dist {run}: "
                      f"rank {r} differs from the stacked exchange")
            sends = sum(rnd.peers(r)[0] is not None for rnd in sched.rounds)
            recv = sum(rnd.peers(r)[1] is not None for rnd in sched.rounds)
            check(nbytes == want == PUSHSUM_CALLS * run[4] * sends * (
                sum(bucket_wire_nbytes(spec, comp)) + pushsum.W_BYTES),
                f"[pushsum] dist {run}: rank {r} sent {nbytes} bytes, "
                f"expected {want}")
            expected = _pushsum_launches(run, spec, counts, per_rank=True,
                                         recv=recv)
            check(counts == expected, f"[pushsum] dist {run}: rank {r} "
                  f"launches {counts}, expected {expected}")
            sent.append(nbytes)
            for name, v in counts.items():
                launches[name] += v
        print(f"[pushsum] small per rank {run[0]} {run[1]} {run[3]} "
              f"x{run[4]}: {N_NODES} ranks bit-equal to the stacked exchange "
              f"on the card over {PUSHSUM_CALLS} calls, w included; bytes "
              f"sent per rank {sent} (payload bytes + 4 for w, per round "
              f"sent in, per gossip round and call)", flush=True)
    return launches


def sim_pushsum(dev):
    """[sim] push-sum: the push-sum simulator
    (``core/choco_gossip.py:run_pushsum_gossip``) on the directed ring of
    SIM_GOSSIP_N nodes at d = SIM_GOSSIP_D, SIM_PUSHSUM_RUNS, on the card
    and on the CPU from the same x0 and QSGD dither: the exact free runs'
    de-biased error curves within SIM_RTOL (QSGD's printed: a moved level
    moves the rest of its curve), each round held by ``_hold_rounds`` (x,
    x_hat, s and w), 1^T w = n, and the de-biased consensus error
    printed."""
    import numpy as np
    import torch
    from repro_torch.core.choco_gossip import (init_pushsum_state, mixing,
                                               pushsum_gossip_round,
                                               run_pushsum_gossip)
    from repro_torch.core.compression import Identity
    from repro_torch.core.topology import directed_ring
    n, d = SIM_GOSSIP_N, SIM_GOSSIP_D
    A = directed_ring(n).A
    x0 = torch.randn((n, d), generator=torch.Generator().manual_seed(8))
    As = {"cpu": mixing(A, x0), dev.type: mixing(A, x0.to(dev))}
    report = {}
    for label, spec, gamma, rounds in SIM_PUSHSUM_RUNS:
        comp = _sim_compressor(spec) or Identity()
        rand = None
        if comp.stochastic:
            gen = torch.Generator().manual_seed(2)
            rand = [comp.draw(x0, gen) for _ in range(rounds)]
        curves, masses, timing = {}, {}, None
        for which, device in (("card", dev), ("cpu", torch.device("cpu"))):
            draws = (None if rand is None else
                     (lambda t, r=[a.to(device) for a in rand]: r[t]))
            (st, err), ms, counts = _timed(
                lambda: run_pushsum_gossip(x0.to(device), A, gamma, comp,
                                           rounds, draws=draws), device)
            curves[which] = err.cpu().numpy()
            masses[which] = float(st.w.double().sum())
            if which == "card":
                timing = (ms / rounds, counts)
        card, cpu = curves["card"], curves["cpu"]
        rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))

        def step(st, t, grad=None, comp=comp, gamma=gamma):
            r = None if rand is None else rand[t].to(st.x.device)
            return pushsum_gossip_round(st, As[st.x.device.type], gamma,
                                        comp, r), None
        moved, worst = _hold_rounds(label, init_pushsum_state(x0.to(dev)),
                                    step, rounds, levels=comp.name == "qsgd")
        print(f"[sim] push-sum directed ring n={n} d={d} {label}, {rounds} "
              f"rounds, gamma {gamma}: de-biased consensus error "
              f"{card[0]:.4e} -> {card[-1]:.4e} on the card, {cpu[0]:.4e} "
              f"-> {cpu[-1]:.4e} on the CPU (free runs: max relative "
              f"difference {rel:.3e}{'' if spec is None else ', not held'});"
              f" 1^T w {masses['card']:.6f}; round by "
              f"round: {moved} coordinates moved, largest relative "
              f"differences {_fmt(worst)}; {timing[0]:.4f} ms/round on the "
              f"card; launches { {k: v for k, v in timing[1].items() if v} }",
              flush=True)
        check(np.all(np.isfinite(card)) and card[-1] < card[0],
              f"[sim] {label}: de-biased error {card[0]} -> {card[-1]}")
        # a QSGD level that moves (round by round: at most one a round)
        # moves the free run's later curve: measured 1.4e-4 over 300
        # rounds, so that curve is printed, the rounds held
        if spec is None:
            check(rel <= SIM_RTOL, f"[sim] {label}: card and CPU error "
                  f"curves differ by {rel}")
        check(abs(masses["card"] - n) <= 1e-3 * n,
              f"[sim] {label}: 1^T w = {masses['card']}, not {n}")
        _hold_sim_launches(label, None if spec is None else comp, rounds,
                           timing[1])
        report[label] = {"rounds": rounds, "gamma": gamma,
                         "err_first": float(card[0]),
                         "err_last": float(card[-1]),
                         "err_last_cpu": float(cpu[-1]),
                         "max_rel_diff": rel, "w_mass": masses["card"],
                         "rounds_moved": moved, "rounds_max_rel": worst,
                         "ms_per_round": timing[0], "launches": timing[1]}
    return report


def kernel_names():
    """Every kernel's name in the launch counts."""
    from repro_torch.kernels import dispatch
    return tuple(dispatch.KERNELS)


def spawn_ranks_of(fn, tmp, deadline_s, *extra):
    """N_NODES ranks of ``fn(rank, store, tmp, *extra)``, meeting in a
    FileStore in ``tmp``; any rank's failure raises."""
    from repro_torch.launch.mesh import spawn_ranks
    spawn_ranks(fn, N_NODES, (os.path.join(tmp, "store"), tmp, *extra),
                deadline_s=deadline_s)


def probe_host_path(x, calls=10_000):
    """Host microseconds per call of each step of the probe wrapper
    (``kernels/probe.py:probe_scale``), each step run ``calls`` times
    alone between two ``time.perf_counter_ns`` reads, beside the whole
    wrapper and ``torch.mul(x, 2)``, and the two lookups the wrapper made
    before they were cut (a ``torch.cuda.Stream`` object for the stream, a
    device object for the dispatch's device check).  The launch step
    enqueues the kernel on the current stream; the device is synchronised
    before each step."""
    import torch
    from repro_torch.kernels import build, dispatch
    lib = build.load_library("probe")
    out = torch.empty_like(x)
    stream = build.stream_of(x)
    steps = {
        "load_library": lambda: build.load_library("probe"),
        "require": lambda: build.require(x, "x", torch.float32),
        "empty_like": lambda: torch.empty_like(x),
        "stream_of": lambda: build.stream_of(x),
        # the lookups the wrapper made before: a Stream object, a device
        "stream_object (before)": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "device_type (before)": lambda: x.device.type == "cpu",
        "data_ptr": lambda: (x.data_ptr(), out.data_ptr(), x.numel()),
        "launch": lambda: lib.probe_scale(x.data_ptr(), out.data_ptr(),
                                          x.numel(), stream),
        "check_launch": lambda: build.check_launch(lib, 0, "probe_scale"),
        "wrapper": lambda: dispatch.probe_scale(x),
        "torch.mul": lambda: torch.mul(x, 2),
    }
    us = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter_ns() - t0) / calls / 1e3
        torch.cuda.synchronize()
    print(f"[kernel] probe_scale host path, us per call over {calls} calls: "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items()), flush=True)
    return us


def check_probe(dev):
    """The collective-layer probe kernel against its plain version at the
    JAX probe's (8, 128) f32 block: bit-equal.  Splits the wrapper's host
    path, then times kernel, plain version and ``torch.mul(x, 2)`` in
    turns; the bound is 8 KiB moved at the HBM rate, far below a launch's
    latency."""
    import torch
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.probe import PROBE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(PROBE_SHAPE, generator=gen, device=dev)
    got, want = dispatch.probe_scale(x), ref.probe_scale_ref(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"probe_scale: kernel and plain version "
          f"differ (max abs {err})")
    host_us = probe_host_path(x)
    bms, by = bound_ms([x], [got], x.numel())
    (ms, plain_ms, lib_ms), wins = time_interleaved_ms(
        [lambda: dispatch.probe_scale(x), lambda: ref.probe_scale_ref(x),
         lambda: torch.mul(x, 2)], rounds=40, per_round=50)
    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=bms, bound_by=by, timed="interleaved",
                  fastest_share=dict(zip(("kernel", "plain", "library"),
                                         wins)),
                  host_us=host_us, shape=list(PROBE_SHAPE), max_abs_err=err)
    print(f"[kernel] probe_scale {PROBE_SHAPE}: bit-equal; timed in turns "
          f"with its plain version and torch.mul(x, 2) in one loop (40 "
          f"rounds of 50 calls each): {ms:.4f} ms (bound {bms:.6f} ms, {by}: "
          f"the launch latency sets it), plain {plain_ms:.4f} ms, "
          f"torch.mul(x, 2) {lib_ms:.4f} ms (the kernel {ms / lib_ms:.2f}x); "
          f"fastest in {record['fastest_share']} of the rounds", flush=True)
    return record


def prefill_budget(dev):
    """Where the card's f32 prefill differs from the CPU's, on the inputs
    of ``tests/test_torch_cuda.py``'s prefill test (the smoke decoder in
    f32, ``Model.init`` seed 0, prompt 200 x batch 2).  Layer 0's
    attention output three ways: (1) the flash kernel against
    ``ref.flash_attention_ref`` on the card, on the same q, k and v; (2)
    ``attn_impl="chunked"`` on the card (the kernel) against the CPU (the
    plain version); (3) ``attn_impl="naive"`` on the card against the
    CPU.  Then the whole prefill, chunked and naive, card against CPU: the
    logits and the k and v caches.  Each difference is printed as its max
    |d| and as its share of the bound 1e-5 + 1e-5 |want| (the test's
    logits bound).  The chunked run is held to the test's bounds: logits
    within that one, the caches within PREFILL_CACHE_ATOL + 1e-5 |want|."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import dispatch, ref
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model

    def diff(got, want, atol=1e-5):
        got, want = got.cpu().double(), want.cpu().double()
        d = (got - want).abs()
        return float(d.max()), float((d / (atol + 1e-5 * want.abs())).max())

    cpu, row = torch.device("cpu"), {}
    for impl in ("chunked", "naive"):
        cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                                  dtype="float32", attn_impl=impl)
        model = Model(cfg)
        params = model.init(1, 0, "cpu")
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, 2, 200)))
        got = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            p = {k: v.to(d) for k, v in params.items()}
            t = toks.to(d)
            x = model._embed_tokens(p, t)
            layer0 = next(model._layers(p))[1]
            xn = L.rms_norm(x, L.per_node(layer0["ln1"], x.dim()), cfg.norm_eps)
            pos = torch.arange(200, device=d)[None].expand(2, 200)
            attn = model._sub(layer0, "attn/")
            h, _ = L.attention(attn, xn, cfg, pos)
            logits, cache = model.prefill(p, t)
            got[where] = dict(h=h, logits=logits, k=cache["stack/c0/k"],
                              v=cache["stack/c0/v"])
            if where == "card" and impl == "chunked":
                q, k, v = L._qkv(attn, xn, cfg, pos)
                qkv = (q.reshape(2, 200, cfg.n_heads, -1),
                       k.reshape(2, 200, cfg.n_kv_heads, -1),
                       v.reshape(2, 200, cfg.n_kv_heads, -1))
                row["1_kernel_vs_plain_on_card"] = diff(
                    dispatch.flash_attention(*qkv),
                    ref.flash_attention_ref(*qkv))
        tag = "2_kernel_on_card_vs_cpu" if impl == "chunked" \
            else "3_naive_on_card_vs_cpu"
        row[tag] = diff(got["card"]["h"], got["cpu"]["h"])
        for name in ("logits", "k", "v"):
            row[f"prefill_{impl}_{name}"] = diff(got["card"][name],
                                                 got["cpu"][name])
        if impl == "chunked":
            check(row["prefill_chunked_logits"][1] <= 1.0,
                  f"[prefill-budget] the logits are outside the test's bound "
                  f"({row['prefill_chunked_logits'][1]:.3f} of it)")
            for name in ("k", "v"):
                _, share = diff(got["card"][name], got["cpu"][name],
                                PREFILL_CACHE_ATOL)
                check(share <= 1.0, f"[prefill-budget] the {name} cache is "
                      f"outside the test's bound ({share:.3f} of it)")
    print("[prefill-budget] " + "; ".join(
        f"{k} max|d| {a:.4e} (bound share {b:.3f})"
        for k, (a, b) in row.items()), flush=True)
    return row


def attention_pairs(s, causal, window=None):
    """(query, key) pairs per head that the mask keeps: S (S + 1) / 2
    causal, S^2 not, and under a window only keys k > q - window."""
    import torch
    q = torch.arange(s, dtype=torch.int64)
    hi = q if causal else torch.full_like(q, s - 1)
    lo = torch.clamp_min(q - window + 1, 0) if window else torch.zeros_like(q)
    return int((hi - lo + 1).sum())


def flash_bounds(tensors_in, out, causal, window=None):
    """(bound ms, bound_by, f32 CUDA-core bound ms, flops) of one attention
    call: q, k, v read once and out written once at the HBM rate, against
    4 * Dh flops per (query, key) pair that the mask keeps
    (:func:`attention_pairs`) at the card's peak rate for the work: bf16
    inputs at the bf16 tensor cores' rate; f32 inputs, whose f32-accurate
    products take three TF32 products each (3xTF32), at a third of the
    TF32 tensor cores' rate.  The f32 CUDA-core bound (the same flops at
    67 TFLOP/s, the bound of earlier rows) stands beside it."""
    import torch
    n, s, h, dh = out.shape
    flops = 4 * dh * n * h * attention_pairs(s, causal, window)
    rate = (BF16_TC_FLOPS_PER_S if out.dtype == torch.bfloat16
            else TF32_TC_FLOPS_PER_S / TF32_TERMS)
    bms, by = bound_ms(list(tensors_in), [out], flops, rate)
    return bms, by, flops / F32_FLOPS_PER_S * 1e3, flops


def flash_cases(dev, cases=FLASH_CASES, seed=3):
    """(label, q, k, v, kwargs) of each of ``cases`` in order, normal
    draws from one generator seeded ``seed``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, n, s, h, kv, dh, dtype, causal, cap, window in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((n, s, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((n, s, kv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((n, s, kv, dh), generator=gen, device=dev).to(dt)
        yield label, q, k, v, dict(causal=causal, softcap=cap, window=window)


def sdpa_call(q, k, v, causal, window):
    """The one PyTorch call for the same attention, as a timing yardstick
    (the port never calls it), or (None, why) where it has none: SDPA
    takes no window, so a windowed case gets it with the window as an
    explicit boolean (S, S) mask, through the memory-efficient backend
    with k and v repeated to q's heads (no backend takes grouped heads
    beside a mask); if that does not run either, there is no call.  f32
    inputs (no window) take the memory-efficient backend, the one that
    takes f32, with k and v repeated to q's heads."""
    import torch
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None and q.dtype == torch.float32:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        rep = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))

        def call():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
        return call, "SDPA memory-efficient backend, f32"
    if window is None:
        return (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)), None
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[2] // k.shape[2]
    kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
    pos = torch.arange(q.shape[1], device=q.device)
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as err:
        torch.cuda.empty_cache()
        return None, (f"none: SDPA has no window, and with the window as a "
                      f"boolean mask it did not run ({str(err)[:120]})")
    return call, "SDPA memory-efficient backend, the window as a boolean mask"


def time_flash_case(label, q, k, v, kw, got):
    """One FLASH_TIMED case: the kernel (10 launches, 3 where one takes
    100 ms or more), its plain version (one call), the library yardstick
    (:func:`sdpa_call`, as many calls as the kernel's) and the bounds."""
    import torch
    from repro_torch.kernels import dispatch, ref
    bms, by, f32_ms, flops = flash_bounds((q, k, v), got, kw["causal"],
                                          kw["window"])
    lib, lib_note = sdpa_call(q, k, v, kw["causal"], kw["window"])
    kernel = lambda: dispatch.flash_attention(q, k, v, **kw)
    # 10 launches, 3 where one takes 100 ms or more (the f32 Dh 256 layers)
    reps = 10 if time_ms(kernel, 1) < 100 else 3
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 1)
    lib_ms = None if lib is None else time_ms(lib, reps)
    torch.cuda.empty_cache()
    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  library_note=lib_note, bound_ms=bms, bound_by=by,
                  bound_f32_cuda_core_ms=f32_ms, tflop_per_s=flops / ms / 1e9,
                  bound_share=bms / ms, flops=flops,
                  shape=[list(q.shape), list(k.shape)], dtype=str(q.dtype)[6:],
                  **kw)
    lib_txt = ("none" if lib_ms is None else
               f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x)")
    rate = ("the bf16 tensor-core peak" if q.dtype == torch.bfloat16
            else "the 3xTF32 tensor-core rate")
    print(f"[kernel] flash_attention {label}: {ms:.3f} ms "
          f"({record['tflop_per_s']:.1f} TFLOP/s, "
          f"{100 * record['bound_share']:.1f}% of the bound {bms:.3f} ms, "
          f"{by}, at {rate}; {f32_ms:.3f} ms at the 67 "
          f"TFLOP/s f32 CUDA-core rate), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_txt}"
          + (f" [{lib_note}]" if lib_note else ""), flush=True)
    return record


def check_flash(dev, cases=FLASH_CASES, timed=FLASH_TIMED, seed=3):
    """The flash kernels against their plain version in ``cases``; every
    case is timed in ``timed``.

    f32 (the 3xTF32 tensor-core kernel): max abs error <= 1e-5 *
    max|out|; the plain version's matmuls run in full f32
    (``torch.backends.cuda.matmul.allow_tf32`` is False).  bf16
    (the tensor-core kernel, P rounded to bf16 as the plain version rounds
    it): contract (a), max|d| / max|want| <= FLASH_BF16_RTOL and at most
    FLASH_BF16_ULP_SHARE of the elements more than one bf16 ulp apart; and
    contract (b), the plain version within FLASH_BF16_F32P_RTOL of the
    f32-P result.  Returns the timing record of each ``timed`` case (the
    first with every case's readings and, for FLASH_CASES, the f32
    kernel's record) and the max abs error."""
    import torch
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import flash_attention as fa
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the f32 plain version must run full-f32 matmuls (allow_tf32 is on)")
    records, max_err, readings = {}, 0.0, {}
    for label, q, k, v, kw in flash_cases(dev, cases, seed):
        got = dispatch.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        max_err = max(max_err, err)
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
        what = f"max abs err {err:.3e}, max |out| {top:.3f}"
        if q.dtype == torch.float32:
            readings[label] = {"rel": err / top, "max_abs_err": err}
            what += f", max|d| / max|out| {err / top:.4e} (bound 1e-05)"
            check(err <= 1e-5 * top, f"flash {label}: {what} > 1e-5 max|out|")
        else:
            # (a) the kernel against the plain version; (b) the plain
            # version against the f32-P result (the f32 path on the upcast
            # inputs, rounded once at the output)
            rel, share = fa.bf16_gap(got, want)
            f32p = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           **kw).to(q.dtype)
            rel_b, share_b = fa.bf16_gap(want, f32p)
            del f32p
            readings[label] = {"a_rel": rel, "a_ulp_share": share,
                               "b_rel": rel_b, "b_ulp_share": share_b,
                               "max_abs_err": err}
            what += (f"; (a) kernel vs plain max|d|/max|want| {rel:.4e} "
                     f"(bound {fa.FLASH_BF16_RTOL:.0e}), share > 1 ulp "
                     f"{share:.4e} (bound {fa.FLASH_BF16_ULP_SHARE:.0e}); "
                     f"(b) plain vs f32-P {rel_b:.4e} (bound "
                     f"{fa.FLASH_BF16_F32P_RTOL:.0e}), share > 1 ulp "
                     f"{share_b:.4e}")
            check(rel <= fa.FLASH_BF16_RTOL and share <= fa.FLASH_BF16_ULP_SHARE,
                  f"flash {label}: contract (a) broken: {what}")
            check(rel_b <= fa.FLASH_BF16_F32P_RTOL,
                  f"flash {label}: contract (b) broken: {what}")
        print(f"[kernel] flash_attention {label} q{tuple(q.shape)} "
              f"k{tuple(k.shape)} {str(q.dtype)[6:]} causal={kw['causal']} "
              f"softcap={kw['softcap']} window={kw['window']}: {what}",
              flush=True)
        del want
        torch.cuda.empty_cache()
        if label in timed:
            records[label] = time_flash_case(label, q, k, v, kw, got)
            records[label]["contract"] = readings[label]
        del q, k, v, got
        torch.cuda.empty_cache()
    if cases is FLASH_CASES:
        first = records[timed[0]]
        first["f32"] = time_flash_f32(dev)
        first["contract"] = readings
        first["contract_bounds"] = {"a_rel": fa.FLASH_BF16_RTOL,
                                    "a_ulp_share": fa.FLASH_BF16_ULP_SHARE,
                                    "b_rel": fa.FLASH_BF16_F32P_RTOL,
                                    "f32_rel": 1e-5}
    return records, max_err


def time_flash_f32(dev):
    """The f32 entry (the 3xTF32 tensor-core kernel) at the prefill
    layer's shape, q (1, 32768, 16, 128), k and v 8 heads, causal: held
    within 1e-5 of max|out| of the plain version, then timed beside the
    plain version and ``scaled_dot_product_attention`` on the same f32
    inputs (its memory-efficient backend, the one that takes f32; k and v
    are repeated to 16 heads before the timed calls, as that backend takes
    no grouped heads), whose own distance to the plain version is printed
    beside the kernel's; and the bounds (3xTF32 and the f32 CUDA-core
    rate)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 32768, 16, 128), generator=gen, device=dev)
    k, v = (torch.randn((1, 32768, 8, 128), generator=gen, device=dev)
            for _ in range(2))
    got = dispatch.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    top = float(want.abs().max())
    rel = float((got - want).abs().max()) / top
    check(bool(torch.isfinite(got).all()) and rel <= 1e-5,
          f"flash f32 prefill layer: max|d| / max|out| {rel:.4e} > 1e-5")
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(2, dim=2).transpose(1, 2) for t in (k, v))
    F = torch.nn.functional
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_rel = float((lib.transpose(1, 2) - want).abs().max()) / top
        del lib
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 3)
    del want
    bms, by, f32_ms, flops = flash_bounds((q, k, v), got, True)
    ms = time_ms(lambda: dispatch.flash_attention(q, k, v, causal=True), 3)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                       1)
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
               bound_by=by, bound_f32_cuda_core_ms=f32_ms,
               tflop_per_s=flops / ms / 1e9, bound_share=bms / ms,
               max_rel_err=rel, library_max_rel_err=lib_rel,
               shape=[list(q.shape), list(k.shape)], dtype="float32")
    print(f"[kernel] flash_attention f32 prefill layer q{tuple(q.shape)} "
          f"k{tuple(k.shape)} causal: max|d| / max|out| against the plain "
          f"version {rel:.4e} (bound 1e-05; SDPA's {lib_rel:.4e}); "
          f"{ms:.3f} ms ({rec['tflop_per_s']:.1f} TFLOP/s, "
          f"{100 * rec['bound_share']:.1f}% of the bound {bms:.3f} ms, {by}, "
          f"at the 3xTF32 tensor-core rate; {f32_ms:.3f} ms at the 67 TFLOP/s "
          f"f32 CUDA-core rate), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention (memory-efficient backend, f32) "
          f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x)", flush=True)
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return rec


#: [flash-instances]: one common case for every instance of both kernels,
#: (N, S, H, KV), causal, no softcap, and the window of the windowed ones:
#: their times side by side beside SDPA in the same dtype, the bound and
#: the share of it, so the instances can be ranked against each other
FLASH_INSTANCE_CASE = (1, 8192, 16, 8)
FLASH_INSTANCE_WINDOW = 1024


def flash_instance_cases():
    """[flash-instances]: a :func:`check_flash` case for every instance of
    both flash kernels (each dtype, head dim of ``HEAD_DIMS`` and window)
    at FLASH_INSTANCE_CASE, labelled "instance <variant name>"."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    n, s, h, kv = FLASH_INSTANCE_CASE
    return tuple((f"instance {fa.variant(dtype, dh, window)}", n, s, h, kv, dh,
                  str(dtype)[6:], True, None, window)
                 for dtype in (torch.bfloat16, torch.float32)
                 for dh in fa.HEAD_DIMS[dtype]
                 for window in (None, FLASH_INSTANCE_WINDOW))


def check_flash_sass(path, f32_path=None):
    """The flash kernels were compiled to tensor-core code: every
    ``flash_tc_kernel`` instantiation in the bf16 library's SASS
    (``cuobjdump -sass``; each head dim of ``HEAD_DIMS``, 32, 64, 80, 128
    and 256, with and without a window: 10) holds wgmma (``HGMMA``) and TMA
    loads (``UTMALDG``), and, given the f32 library, every
    ``flash_attention_kernel`` instantiation there (the same head dims,
    Dh 256's named ``flash_attention_kernel_dh256``, with and without a
    window: 10) holds ``HGMMA``: a CUDA-core kernel cannot pass for
    either.  A missing ``cuobjdump`` is a failure."""
    import torch
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), f"cuobjdump not found ({tool}): the flash "
          f"libraries' SASS cannot be checked")

    def functions(lib, kernel, expected):
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        found = {}
        for section in sass.split("Function : ")[1:]:
            name = section.split(None, 1)[0]
            if kernel in name:
                found[name] = (section.count("HGMMA"), section.count("UTMALDG"))
        check(len(found) == expected, f"{lib.name} SASS: {len(found)} "
              f"{kernel} functions, expected {expected} (each head dim with "
              f"and without a window)")
        return found

    found = functions(path, "flash_tc_kernel",
                      2 * len(HEAD_DIMS[torch.bfloat16]))
    for name, (hgmma, utmaldg) in found.items():
        check(hgmma > 0 and utmaldg > 0, f"flash_tc SASS: {name} has {hgmma} "
              f"HGMMA and {utmaldg} UTMALDG instructions")
    print("[build] flash_tc SASS: " + "; ".join(
        f"{name[-60:]}: {h} HGMMA, {u} UTMALDG"
        for name, (h, u) in found.items()), flush=True)
    if f32_path is not None:
        f32 = functions(f32_path, "flash_attention_kernel",
                        2 * len(HEAD_DIMS[torch.float32]))
        for name, (hgmma, _) in f32.items():
            check(hgmma > 0, f"flash (f32) SASS: {name} has no HGMMA")
        print("[build] flash (f32) SASS: " + "; ".join(
            f"{name[-60:]}: {h} HGMMA" for name, (h, _) in f32.items()),
              flush=True)
        found.update(f32)
    return found


def full_width_serving_model(dev, arch, n_layers=None, dtype=None):
    """``arch`` at full width and depth (or ``n_layers``) with the flash
    kernel, random weights from seed 0 drawn in f32 and cast once to its
    compute dtype (bf16, or ``dtype``); the f32 draw is freed before this
    returns (in f32 it is the weights).  Returns (model, params, the
    draw's peak device memory in GiB)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    model = Model(dataclasses.replace(
        cfg, attn_impl="chunked", n_layers=n_layers or cfg.n_layers,
        dtype=dtype or cfg.dtype))
    params = model.compute_params(model.init(1, 0, dev))
    torch.cuda.synchronize()
    draw = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for t in params.values()) / 2 ** 30
    print(f"[prefill] {arch}: {model.cfg.n_layers} layers, "
          f"{sum(t.numel() for t in params.values())} "
          f"parameters, {held:.3f} GiB in {model.cfg.dtype}; the f32 draw "
          f"and the cast peaked at {draw:.3f} GiB", flush=True)
    return model, params, draw


def _flash_variants():
    from repro_torch.kernels import flash_attention as fa
    return dict(fa.flash_attention.variants)


def prefill_full_width(model, params, dev, kernel="flash_tc_kernel"):
    """Model.prefill at 32768 tokens, PREFILL_CALLS times, then profiled:
    one flash launch per layer (the local layers' with the window), no
    other kernel, the cache of each layer kind at its length (a local
    layer's ring min(window, 32768) slots) in the model's dtype, finite
    logits, the peak device memory, and the profiled call split into flash
    / matmul / other, its flash launches all of ``kernel`` (the bf16
    tensor-core kernel; "flash_attention_kernel", the f32 one)."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import block_pattern
    cfg = model.cfg
    shape = INPUT_SHAPES["prefill_32k"]
    seq, batch = shape.seq_len, 1       # global batch 32 cut to 1: one card
    toks = torch.randint(0, cfg.vocab_size, (1, batch, seq), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    pattern, repeat, tail = block_pattern(cfg)
    heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
    want_shapes = {f"stack/c{i}/{n}": (1, repeat, batch,
                                       model.cache_len(kind, seq)) + heads
                   for i, kind in enumerate(pattern) for n in ("k", "v")}
    want_shapes.update({f"tail/t{i}/{n}": (1, batch, model.cache_len(kind, seq))
                        + heads for i, kind in enumerate(tail)
                        for n in ("k", "v")})
    n_local = repeat * pattern.count("dense_local") + tail.count("dense_local")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    ms = []
    for _ in range(PREFILL_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, toks)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(logits.shape) == (1, batch, 1, cfg.vocab_size),
              f"prefill logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "prefill: non-finite logits")
        got_shapes = {k: tuple(t.shape) for k, t in caches.items()}
        check(got_shapes == want_shapes and all(
            t.dtype == model.dtype for t in caches.values()),
            f"prefill caches {got_shapes}, expected {want_shapes} in "
            f"{model.dtype}")
        del logits, caches
    counts = dispatch.launch_counts()
    variants = _flash_variants()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want_launches = PREFILL_CALLS * cfg.n_layers
    windowed = sum(c for v, c in variants.items() if v.endswith("_window"))
    check(counts["flash_attention"] == want_launches,
          f"prefill: {counts['flash_attention']} flash launches, expected "
          f"{PREFILL_CALLS} calls x {cfg.n_layers} layers = {want_launches}")
    check(sum(counts.values()) == want_launches, f"prefill counts {counts}")
    check(windowed == PREFILL_CALLS * n_local,
          f"prefill: {windowed} windowed flash launches ({variants}), "
          f"expected {PREFILL_CALLS} calls x {n_local} local layers")
    print(f"[prefill] {cfg.name} layers={cfg.n_layers} tokens={seq} "
          f"batch={batch} (prefill_32k, batch {shape.global_batch} cut to "
          f"{batch}): ms per call {ms} (first call first); flash launches "
          f"{counts['flash_attention']} = {PREFILL_CALLS} x {cfg.n_layers} "
          f"({windowed} with the window: {variants}); caches "
          f"{sorted(set(want_shapes.values()))}; peak device memory "
          f"{peak:.3f} GiB", flush=True)
    profile = profile_call(f"one {cfg.name} prefill call",
                           lambda: model.prefill(params, toks), FLASH_KERNELS,
                           audit=True)
    check(profile is not None, "prefill: the profiler recorded no device time")
    tc_ms, tc_launches = profile["by_kernel"][kernel]
    check(tc_launches == cfg.n_layers and tc_ms > 0
          and profile["wrapper_launches"] == cfg.n_layers
          and all(c == 0 for k, (_, c) in profile["by_kernel"].items()
                  if k != kernel),
          f"prefill: the profiled call's flash kernels {profile['by_kernel']}"
          f", the wrappers' {profile['wrapper_launches']}; expected "
          f"{cfg.n_layers} launches of {kernel} and none of the other")
    print(f"[prefill] the profiled {cfg.name} call: {kernel} "
          f"{tc_launches} launches, {tc_ms:.3f} ms of device time "
          f"({100 * tc_ms / profile['device_busy_ms']:.1f}% of busy); matmul "
          f"{profile['matmul']:.3f} ms, other {profile['other']:.3f} ms",
          flush=True)
    return counts, {"arch": cfg.name, "ms_per_call": ms, "peak_gib": peak,
                    "tokens": seq, "batch": batch, "variants": variants,
                    "cache_shapes": want_shapes, "profile": profile}


def decode_past_prefill(model, params, dev, steps=DECODE_PAST_STEPS):
    """Decode steps that continue a 32768-token prompt: caches of 32768 +
    ``steps`` slots from ``init_cache``, filled through ``Model.hidden`` (as
    ``Model.prefill`` fills its S slots: a local layer keeps the last
    ``window`` positions, position p in slot p % window), then ``steps``
    decode steps from position 32768.  Checks finite logits, that each
    global cache's slots 32768 on were written, and that each local ring
    was written over in place from slot 32768 % window on (it wraps).
    Returns (launch counts, the record with ms per decode step)."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import block_pattern
    cfg = model.cfg
    seq = INPUT_SHAPES["prefill_32k"].seq_len
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, 1, seq + steps), device=dev,
                         generator=gen)
    dispatch.reset_launch_counts()
    caches = model.init_cache(1, seq + steps, dev)
    model.hidden(params, toks[:, :, :seq], caches)
    pattern = block_pattern(cfg)[0]
    local = [f"stack/c{i}/k" for i, kind in enumerate(pattern)
             if kind == "dense_local"]
    glob = [f"stack/c{i}/k" for i, kind in enumerate(pattern)
            if kind in ("dense_global", "moe")]
    ring = {k: caches[k].shape[3] for k in local}
    before = {k: caches[k][:, :, :, seq % ring[k]:][:, :, :, :steps].clone()
              for k in local}
    check(all(not caches[k][:, :, :, seq:].any() for k in glob),
          "decode-32k: a global cache's slots past the prompt are not empty")
    ms = []
    for t in range(steps):
        pos = torch.full((1,), seq + t, dtype=torch.long, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, toks[:, :, seq + t:seq + t + 1],
                                           caches, pos)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all()),
              f"decode-32k: non-finite logits at position {seq + t}")
    counts = dispatch.launch_counts()
    check(all(bool(caches[k][:, :, :, seq:].abs().amax(dim=(-1, -2)).gt(0).all())
              for k in glob),
          "decode-32k: a global cache's new slots were not written")
    for k in local:
        after = caches[k][:, :, :, seq % ring[k]:][:, :, :, :steps]
        check(bool((after != before[k]).any(dim=(-1, -2)).all()),
              f"decode-32k: the local ring {k} ({ring[k]} slots) was not "
              f"written over from slot {seq % ring[k]}")
    check(sum(counts.values()) == cfg.n_layers,
          f"decode-32k: launches {counts}; the hidden pass launches one "
          f"flash kernel per layer, decode none")
    rec = {"arch": cfg.name, "prompt": seq, "steps": steps,
           "cache_slots": {"global": seq + steps, "local": sorted(set(
               ring.values()))}, "ms_per_step": ms}
    print(f"[decode-32k] {cfg.name}: {seq}-token prompt through Model.hidden "
          f"into caches of {seq + steps} slots (local rings "
          f"{sorted(set(ring.values()))}), then {steps} decode steps from "
          f"position {seq}: finite logits, global slots {seq}.. written, the "
          f"local rings wrapped; ms per step {[round(m, 3) for m in ms]}",
          flush=True)
    del caches
    torch.cuda.empty_cache()
    return counts, rec


def serve_full_width(arch, args=("--batch", "8", "--prompt-len", "32",
                                  "--gen-len", "32", "--requests", "2")):
    """The serve launcher at full width, on the card: by default the JAX
    launcher's defaults with 2 requests."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import main
    argv = ["--arch", arch, *args, "--device", "cuda"]
    dispatch.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    counts = dispatch.launch_counts()
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"serve launcher returned {rc}")
    check(sum(counts.values()) == 0,
          f"serve: launches {counts}; decode goes through no kernel")
    line = [l for l in out.splitlines() if l.startswith("[serve] summary ")]
    check(len(line) == 1, "serve: no summary line")
    summary = json.loads(line[0][len("[serve] summary "):])
    for key in ("ttft_p50_s", "ttft_p99_s", "tok_p50_s", "tok_p99_s",
                "throughput_tok_s", "peak_gib"):
        val = summary.get("serve/" + key)
        check(val is not None and math.isfinite(val) and val > 0,
              f"serve: {key} = {val}")
    print(f"[serve] {arch} launches {counts}", flush=True)
    return counts, summary


def decode_over(model, params, toks, cache):
    """Decode toks (1, B, S) one at a time from position 0 into ``cache``;
    returns the last step's logits."""
    import torch
    B = toks.shape[1]
    for t in range(toks.shape[2]):
        pos = torch.full((B,), t, dtype=torch.long, device=toks.device)
        logits, cache = model.decode_step(params, toks[:, :, t:t + 1], cache, pos)
    return logits


def profile_decode(model, params, dev):
    """Wall time and device time of one full-width decode step at the serve
    launcher's batch 8, unprofiled (host clock, synchronised) and then
    under the profiler: the device's idle share says whether the host's
    launches or the device's work set the per-token time."""
    import torch
    b, ctx = 8, 64
    cache = model.init_cache(b, ctx, dev)
    tok = torch.zeros((1, b, 1), dtype=torch.long, device=dev)
    pos = torch.full((b,), 40, dtype=torch.long, device=dev)
    step = lambda: model.decode_step(params, tok, cache, pos)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 10
    profile = profile_call("one decode step, batch 8", step, FLASH_KERNELS)
    print(f"[decode] one full-width decode step at batch 8: {wall:.3f} ms "
          f"wall (mean of 10, synchronised)", flush=True)
    return {"wall_ms": wall, "profile": profile}


def consistency_full_width(model, params, dev):
    """Prefill (through the kernel) against decode over the same 256 x 2
    tokens: the JAX test's bound max|d| / max(max|logits|, 1) < 0.05, and
    the same greedy token.  Returns (the prefill's launch counts, the
    record)."""
    import torch
    from repro_torch.kernels import dispatch
    s, b = 256, 2
    toks = torch.randint(0, model.cfg.vocab_size, (1, b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    dispatch.reset_launch_counts()
    pre, _ = model.prefill(params, toks)
    counts = dispatch.launch_counts()
    variants = _flash_variants()
    launches = counts["flash_attention"]
    t0 = time.perf_counter()
    dec = decode_over(model, params, toks, model.init_cache(b, s, dev))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    a, w = dec.float(), pre.float()
    rel = float((a - w).abs().max()) / max(float(w.abs().max()), 1.0)
    same = torch.equal(a.argmax(-1), w.argmax(-1))
    print(f"[consistency] {model.cfg.name} full width, prompt {s} x batch "
          f"{b}: prefill vs decode max|d| / max(max|logits|, 1) = {rel:.4e} "
          f"(bound 0.05); argmax equal: {same}; flash launches in the "
          f"prefill {launches} ({variants}); {s} decode steps in "
          f"{decode_s:.1f} s", flush=True)
    check(launches == model.cfg.n_layers, f"consistency: {launches} launches")
    check(rel < 0.05, f"prefill and decode logits differ: {rel}")
    check(same, "prefill and decode pick different greedy tokens")
    return counts, {"arch": model.cfg.name, "rel": rel, "argmax_equal": same,
                    "variants": variants, "decode_s": decode_s}


@contextlib.contextmanager
def replayed_picks(picks, replay):
    """``models/moe.py``'s expert picks (``moe.pick``): appended to
    ``picks`` in call order, or, with ``replay``, taken from it in the same
    order; ``mismatch`` counts the picks of a replay where this device's
    own top-k chose otherwise, and ``total`` all of them."""
    from repro_torch.models import moe
    pick = moe.pick
    queue = iter(list(picks))
    stats = {"mismatch": 0, "total": 0}

    def call(scores, k):
        own = pick(scores, k)
        if not replay:
            picks.append(own.cpu())
            return own
        idx = next(queue).to(scores.device)
        stats["mismatch"] += int((own != idx).any(dim=-1).sum())
        stats["total"] += own[..., 0].numel()
        return idx
    moe.pick = call
    try:
        yield stats
    finally:
        moe.pick = pick


def serve_small_cuda_vs_cpu(dev, arch="qwen3-1.7b", attn_impl="chunked",
                            prompt_len=200, steps=8, dtype="float32",
                            head_dim=None):
    """A smoke model in ``dtype`` (at ``head_dim`` where given): the
    prefill's logits, then a cache of
    prompt_len + steps slots filled through ``Model.hidden`` and ``steps``
    decode steps, on the card against the same on the CPU (the plain
    versions), within 1e-5 of the largest logit in float32 and
    SMALL_BF16_RTOL of it in bfloat16.  With ``attn_impl`` "chunked" the
    card's two passes over the prompt launch one flash kernel per layer
    each.  An MoE model in bf16 runs on the CPU first and the card then
    takes the CPU's expert picks (:func:`replayed_picks`): one bf16 ulp of
    a hidden state flips near-tied picks (with its own picks the card's
    qwen3-moe smoke logits were 1.38 from the CPU's, a third of the
    largest), which would hide what the check is for; the card's own picks
    are counted against the CPU's.  Returns the card's launch counts and
    flash variants."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype=dtype, attn_impl=attn_impl,
                              head_dim=head_dim or cfg.head_dim)
    model = Model(cfg)
    params = model.compute_params(model.init(1, 1, "cpu"))
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (1, 2, prompt_len), generator=gen)
    follow = torch.randint(0, cfg.vocab_size, (1, 2, steps), generator=gen)
    replay = cfg.family == "moe" and dtype == "bfloat16"
    picks, runs = [], {}
    for device in ((torch.device("cpu"), dev) if replay
                   else (dev, torch.device("cpu"))):
        p = {k: v.to(device) for k, v in params.items()}
        dispatch.reset_launch_counts()
        with replayed_picks(picks, replay and device.type == "cuda") as stats:
            logits, _ = model.prefill(p, prompt.to(device))
            cache = model.init_cache(2, prompt_len + steps, device)
            model.hidden(p, prompt.to(device), cache)
            out = [logits]
            for t in range(steps):
                pos = torch.full((2,), prompt_len + t, dtype=torch.long,
                                 device=device)
                lg, cache = model.decode_step(
                    p, follow[:, :, t:t + 1].to(device), cache, pos)
                out.append(lg)
        runs[device.type] = torch.cat(out, dim=2).float().cpu()
        if device.type == "cuda":
            counts, variants = dispatch.launch_counts(), _flash_variants()
            own = (f"; the CPU's expert picks replayed, the card's own "
                   f"differed in {stats['mismatch']} of {stats['total']} "
                   f"tokens' picks (bound {MOE_PICK_MISMATCH_SHARE} of them)"
                   if replay else "")
    d = float((runs["cuda"] - runs["cpu"]).abs().max())
    top = max(float(runs["cpu"].abs().max()), 1.0)
    rtol = 1e-5 if dtype == "float32" else SMALL_BF16_RTOL
    want = 2 * cfg.n_layers if attn_impl == "chunked" else 0
    print(f"[small] {arch} smoke {dtype} {attn_impl} head dim "
          f"{cfg.resolved_head_dim}: prefill {prompt_len} + "
          f"{steps} decode steps, CUDA vs CPU max|d| = {d:.3e} (max |logit| "
          f"{top:.3f}, bound {rtol:.0e} of it); flash launches "
          f"{counts['flash_attention']} {variants}{own}", flush=True)
    check(d <= rtol * top, f"{arch} {dtype} {attn_impl}: CUDA and CPU "
          f"serving logits differ by {d}")
    check(not replay or (stats["total"] > 0 and stats["mismatch"]
                         <= MOE_PICK_MISMATCH_SHARE * stats["total"]),
          f"{arch} {dtype} {attn_impl}: the card's own expert picks differ "
          f"from the CPU's in {stats['mismatch']} of {stats['total']} tokens "
          f"(bound {MOE_PICK_MISMATCH_SHARE} of them)")
    check(counts["flash_attention"] == want and sum(counts.values()) == want,
          f"{arch} {attn_impl}: launches {counts}, expected {want} flash")
    return counts, variants


@contextlib.contextmanager
def plain_flash():
    """Every flash call of the model stack runs the plain version
    (``ref.flash_attention_ref``) on the tensors' own device: the
    reference run a full-width model is held against."""
    from repro_torch.kernels import dispatch, ref
    kernel = dispatch.flash_attention
    dispatch.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        dispatch.flash_attention = kernel


def frontend_batch(model, batch, seq, seed, dev):
    """The family's batch from ``make_lm_batch_fn`` (numpy draws, as the
    JAX package's), one node, on the card: hubert's frame embeddings, or
    llava's patch embeddings and text tokens (seq counts both)."""
    import torch
    from repro_torch.data.synthetic import make_lm_batch_fn
    keys = {"audio": ("frame_embeds",),
            "vlm": ("patch_embeds", "tokens")}[model.cfg.family]
    b = make_lm_batch_fn(model.cfg, seq, batch, 1, seed=seed)()
    out = {k: torch.from_numpy(b[k]).to(dev) for k in keys}
    if "tokens" in out:
        out["tokens"] = out["tokens"].long()
    return out


def frontend_prefill(model, params, batch, calls, label):
    """``Model.prefill`` of ``batch`` ``calls`` times, then once profiled:
    one bf16 flash launch per layer per call, all of the arch's variant;
    finite logits (1, B, 1, V); the caches (1, layers, B, S, KV, Dh) in
    bf16; the wall ms of each call, the peak device memory and the
    profiled call's flash, matmul and other device ms.  Returns (the
    calls' launch counts, the record)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    cfg = model.cfg
    B = next(iter(batch.values())).shape[1]
    S = sum(batch[k].shape[2] for k in batch)
    heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
    want_shapes = {f"stack/c0/{n}": (1, cfg.n_layers, B, S) + heads
                   for n in ("k", "v")}
    variant = fa.variant(torch.bfloat16, cfg.resolved_head_dim, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(logits.shape) == (1, B, 1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{label}: logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        got = {k: tuple(t.shape) for k, t in caches.items()}
        check(got == want_shapes and all(
            t.dtype == torch.bfloat16 for t in caches.values()),
            f"{label}: caches {got}, expected {want_shapes} in bf16")
        del logits, caches
    counts = dispatch.launch_counts()
    variants = _flash_variants()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = calls * cfg.n_layers
    check(counts["flash_attention"] == want and sum(counts.values()) == want
          and variants == {variant: want},
          f"{label}: launches {counts}, variants {variants}; expected "
          f"{calls} calls x {cfg.n_layers} layers of {variant}")
    # the wrapper's counts above prove the launches; the profiler splits
    # the device time (it listed 47 of hubert's 48 flash launches in one
    # H100 run, all 48 counted by the wrapper: it drops a kernel's record
    # now and then, which the audit shows)
    profile = profile_call(f"one {label} call",
                           lambda: model.prefill(params, batch), FLASH_KERNELS,
                           audit=True)
    check(profile is not None, f"{label}: the profiler recorded no device time")
    tc_ms, tc_launches = profile["by_kernel"]["flash_tc_kernel"]
    check(tc_launches > 0 and tc_ms > 0
          and profile["by_kernel"]["flash_attention_kernel"][1] == 0,
          f"{label}: the profiled call's flash kernels {profile['by_kernel']}")
    print(f"[frontend] {label}: batch {B} x {S} positions, {cfg.n_layers} "
          f"layers: wall ms per call {[round(m, 1) for m in ms]} (first call "
          f"first); flash launches {variants} ({cfg.n_layers} a call); the "
          f"profiled call's flash_tc_kernel {tc_ms:.3f} ms in {tc_launches} "
          f"launches of "
          f"{profile['device_busy_ms']:.3f} ms busy, matmul "
          f"{profile['matmul']:.3f}, other {profile['other']:.3f}; peak device "
          f"memory {peak:.3f} GiB", flush=True)
    return counts, {"arch": cfg.name, "batch": B, "positions": S,
                    "ms_per_call": ms, "variants": variants, "peak_gib": peak,
                    "flash_ms": tc_ms, "flash_profiled_launches": tc_launches,
                    "profile": profile}


def against_plain_flash(model, params, batch, label, rtol=FRONTEND_BF16_RTOL):
    """``Model.prefill`` of ``batch`` through the kernel and again through
    the plain flash version on the card (:func:`plain_flash`): the logits
    and every cache leaf within ``rtol`` of max|want|, layer 0's k and v
    (made before any attention) bit-equal.  Returns the record (the
    caches' readings in layer order)."""
    import torch
    from repro_torch.models.transformer import block_pattern
    got_logits, got = model.prefill(params, batch)
    with plain_flash():
        want_logits, want = model.prefill(params, batch)
    torch.cuda.synchronize()
    rel = lambda a, b: float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)
    logits_rel = rel(got_logits, want_logits)
    pattern, repeat, tail = block_pattern(model.cfg)
    leaves = ([(f"stack/c{c}/", (slice(None), r)) for r in range(repeat)
               for c in range(len(pattern))]
              + [(f"tail/t{i}/", (slice(None),)) for i in range(len(tail))])
    layer_rel = [max(rel(got[key + n][at], want[key + n][at])
                     for n in ("k", "v")) for key, at in leaves]
    first = all(torch.equal(got[f"stack/c0/{n}"][:, 0], want[f"stack/c0/{n}"][:, 0])
                for n in ("k", "v"))
    print(f"[frontend] {label} through the kernel against the plain flash "
          f"version on the card: logits max|d|/max|want| {logits_rel:.4e}; "
          f"caches worst layer {max(layer_rel):.4e} (layer "
          f"{layer_rel.index(max(layer_rel))}), last layer {layer_rel[-1]:.4e} "
          f"(bound {rtol:.0e}); layer 0's k and v bit-equal "
          f"{first}", flush=True)
    check(first, f"{label}: layer 0's caches differ before any attention")
    check(logits_rel <= rtol and max(layer_rel) <= rtol,
          f"{label}: kernel against plain flash logits {logits_rel:.4e}, "
          f"caches {max(layer_rel):.4e}")
    del got, want
    torch.cuda.empty_cache()
    return {"logits_rel": logits_rel, "cache_rel_by_layer": layer_rel}


def hubert_full_width(dev):
    """[frontend] hubert: hubert-xlarge at full width and depth (48
    layers, head dim 80, bf16, weights from seed 0): the prefill of one
    32768-frame sequence, twice, then of 8 x 1500 frames, held against the
    plain flash version.  Returns (the long prefill's counts, the
    30 s batch's counts, the record)."""
    import torch
    model, params, draw = full_width_serving_model(dev, "hubert-xlarge")
    long_counts, long_rec = frontend_prefill(
        model, params, frontend_batch(model, *HUBERT_LONG, 11, dev),
        PREFILL_CALLS, "hubert-xlarge prefill_32k")
    batch = frontend_batch(model, *HUBERT_BATCH, 12, dev)
    batch_counts, batch_rec = frontend_prefill(model, params, batch, 1,
                                               "hubert-xlarge 8 x 1500")
    batch_rec["against_plain"] = against_plain_flash(
        model, params, batch, "hubert-xlarge 8 x 1500")
    del model, params, batch
    torch.cuda.empty_cache()
    return long_counts, batch_counts, {"prefill_32k": long_rec,
                                       "batch_30s": batch_rec,
                                       "weights_draw_peak_gib": draw}


def hubert_small_cuda_vs_cpu(dev):
    """The hubert smoke encoder at head dim 80 (the full config's) in f32,
    through the f32 kernel: 300 frames x 2, prefill logits and caches on
    the card against the CPU (plain versions), within 1e-5 (+ 1e-5
    relative) of the logits and HUBERT_SMALL_CACHE_ATOL of the caches; 2
    f32_dh80 launches.  Returns the card's launch counts and variants."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("hubert-xlarge", smoke=True),
                              head_dim=80, dtype="float32",
                              attn_impl="chunked")
    model = Model(cfg)
    params = model.init(1, 0, "cpu")
    batch = frontend_batch(model, 2, 300, 13, "cpu")
    runs = {}
    for device in (dev, torch.device("cpu")):
        dispatch.reset_launch_counts()
        logits, caches = model.prefill(
            {k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in batch.items()})
        runs[device.type] = (logits.cpu(), {k: c.cpu() for k, c in caches.items()})
        if device.type == "cuda":
            counts, variants = dispatch.launch_counts(), _flash_variants()
    d = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    top = max(float(runs["cpu"][0].abs().max()), 1.0)
    cache_share = max(float(((runs["cuda"][1][k] - c).abs() / (
        HUBERT_SMALL_CACHE_ATOL + 1e-5 * c.abs())).max())
        for k, c in runs["cpu"][1].items())
    print(f"[frontend] hubert smoke at head dim 80, f32: prefill 2 x 300 "
          f"frames, CUDA vs CPU logits max|d| {d:.3e} (max |logit| "
          f"{top:.3f}); caches {cache_share:.3f} of their bound; flash "
          f"launches {variants}", flush=True)
    check(d <= 1e-5 * top, f"hubert small: CUDA and CPU logits differ by {d}")
    check(cache_share <= 1.0, f"hubert small: caches {cache_share:.3f} of "
          f"their bound")
    check(variants == {"f32_dh80": cfg.n_layers}, f"hubert small: {variants}")
    return counts, variants


def llava_full_width(dev):
    """[frontend] llava: llava-next-mistral-7b at full width and depth (32
    layers, bf16, weights from seed 0): the prefill of 2880 patch
    embeddings and 29888 text tokens (S = 32768, batch 1), twice.  Returns
    (counts, record)."""
    import torch
    model, params, draw = full_width_serving_model(dev, "llava-next-mistral-7b")
    batch = frontend_batch(model, 1, 2880 + LLAVA_TEXT, 14, dev)
    check(batch["patch_embeds"].shape[2] == 2880
          and batch["tokens"].shape[2] == LLAVA_TEXT,
          f"llava batch {[tuple(t.shape) for t in batch.values()]}")
    counts, rec = frontend_prefill(model, params, batch, PREFILL_CALLS,
                                   "llava-next-mistral-7b prefill_32k")
    rec["weights_draw_peak_gib"] = draw
    del model, params, batch
    torch.cuda.empty_cache()
    return counts, rec


def profile_moe_stages(label, fn):
    """One more call of ``fn`` under the profiler, split by the
    ``moe.<stage>`` ranges that ``models/moe.py`` opens: the
    device ms of the flash kernel, of the experts (their matmuls and the
    rest of their SwiGLU), of the router (its logits, softmax, top-k and
    slots), of the gather and scatter (dispatch and combine) and of the
    rest.  A kernel belongs to the stage whose range holds its launch
    call on the host (the trace's correlation id); "unattributed" counts
    kernels whose launch call the trace lacks."""
    prof, wall = profiled(fn)
    events = trace_events(prof)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e["name"][len("moe."):]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("moe."))
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launched[corr] = float(e["ts"])
    split = dict.fromkeys(("flash", "experts_matmul", "experts_other",
                           "router", "gather_scatter", "rest",
                           "unattributed"), 0.0)
    kernels = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        ts = launched.get((e.get("args") or {}).get("correlation"))
        stage = None if ts is None else next(
            (n for a, b, n in ranges if a <= ts <= b), None)
        if any(k in name for k in FLASH_KERNELS):
            key = "flash"
        elif ts is None:
            key = "unattributed"
        elif stage == "experts":
            key = "experts_matmul" if is_matmul(name) else "experts_other"
        elif stage == "route":
            key = "router"
        elif stage in ("dispatch", "combine"):
            key = "gather_scatter"
        else:
            key = "rest"
        split[key] += float(e.get("dur", 0)) / 1e3
        kernels[key] += 1
    busy = sum(split.values())
    print(f"[profile] {label}, by stage: wall {wall:.3f} ms (profiled), "
          f"device busy {busy:.3f} ms in {sum(kernels.values())} kernels "
          f"({len(ranges)} stage ranges); " + ", ".join(
              f"{k} {v:.3f} ms ({kernels[k]})" for k, v in split.items()),
          flush=True)
    check(busy > 0 and ranges, f"{label}: the profiler's trace has no "
          f"device time or no stage range")
    return {"wall_ms": wall, "device_busy_ms": busy, "ms": split,
            "kernels": dict(kernels), "stage_ranges": len(ranges)}


def moe_full_width(dev):
    """[prefill-moe]: qwen3-moe-30b-a3b at its published widths (d_model
    2048, 32/4 heads at Dh 128, 128 experts top-8 of d_expert 768, groups
    of 512, capacity 1.25), depth cut to MOE_LAYERS, bf16, weights from
    seed 0: :func:`prefill_full_width` of 32768 tokens (one bf16_dh128
    launch per layer a call), the profiled call split by MoE stage, then
    MOE_DECODE_STEPS decode steps past the prompt
    (:func:`decode_past_prefill`).  Returns (the prefill's counts, the
    decode's counts, the record)."""
    import torch
    model, params, draw = full_width_serving_model(
        dev, "qwen3-moe-30b-a3b", n_layers=MOE_LAYERS)
    counts, rec = prefill_full_width(model, params, dev)
    check(rec["variants"] == {"bf16_dh128": PREFILL_CALLS * MOE_LAYERS},
          f"prefill-moe: flash variants {rec['variants']}, expected "
          f"{PREFILL_CALLS} x {MOE_LAYERS} bf16_dh128")
    rec["weights_draw_peak_gib"] = draw
    rec["layers"] = MOE_LAYERS
    toks = torch.randint(0, model.cfg.vocab_size, (1, 1, 32768), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    rec["stages"] = profile_moe_stages(
        f"one {model.cfg.name} prefill call ({MOE_LAYERS} layers)",
        lambda: model.prefill(params, toks))
    dec_counts, dec = decode_past_prefill(model, params, dev,
                                          steps=MOE_DECODE_STEPS)
    del model, params, toks
    torch.cuda.empty_cache()
    return counts, dec_counts, rec, dec


def f32_dh256_profiled(profile):
    """{variant: launches} of the f32 Dh 256 kernel in a profiled call,
    read from its kernels' names (the instance's template argument: with
    the window or without)."""
    out = {"f32_dh256": 0, "f32_dh256_window": 0}
    for name, (_, count) in profile["kernel_names"].items():
        if "flash_attention_kernel_dh256" not in name:
            continue
        windowed = "<true>" in name or "ILb1E" in name
        check(windowed or "<false>" in name or "ILb0E" in name,
              f"the f32 Dh 256 kernel's name {name!r} shows no instance")
        out["f32_dh256_window" if windowed else "f32_dh256"] += count
    return out


def gemma2_f32_full_width(dev):
    """[prefill-gemma2-f32]: gemma2-9b at its published widths with
    ``dtype="float32"``, depth cut to GEMMA2_F32_LAYERS (4 local, 4
    global), weights from seed 0: :func:`prefill_full_width` of 32768
    tokens through the f32 kernel (one launch per layer a call: 4
    ``f32_dh256`` on the global layers, 4 ``f32_dh256_window`` on the local
    ones, counted by the wrappers and, in the profiled call, by the
    profiler), the same prefill against the plain flash version on the
    card within PREFILL_F32_RTOL, then GEMMA2_F32_DECODE_STEPS decode steps
    past the prompt.  Returns (the prefill's counts, the decode's counts,
    the prefill record, the decode record)."""
    import torch
    model, params, draw = full_width_serving_model(
        dev, "gemma2-9b", n_layers=GEMMA2_F32_LAYERS, dtype="float32")
    half = GEMMA2_F32_LAYERS // 2
    counts, rec = prefill_full_width(model, params, dev,
                                     kernel="flash_attention_kernel")
    want = {"f32_dh256": PREFILL_CALLS * half,
            "f32_dh256_window": PREFILL_CALLS * half}
    check(rec["variants"] == want, f"prefill-gemma2-f32: flash variants "
          f"{rec['variants']}, expected {want}")
    profiled_variants = f32_dh256_profiled(rec["profile"])
    check(profiled_variants == {"f32_dh256": half, "f32_dh256_window": half},
          f"prefill-gemma2-f32: the profiled call's f32 Dh 256 launches "
          f"{profiled_variants}, expected {half} of each")
    flash_ms, _ = rec["profile"]["by_kernel"]["flash_attention_kernel"]
    print(f"[prefill-gemma2-f32] the profiled call's f32 Dh 256 launches by "
          f"instance {profiled_variants}; flash {flash_ms:.3f} ms, matmul "
          f"{rec['profile']['matmul']:.3f} ms, other "
          f"{rec['profile']['other']:.3f} ms of "
          f"{rec['profile']['device_busy_ms']:.3f} ms busy", flush=True)
    rec.update(weights_draw_peak_gib=draw, layers=GEMMA2_F32_LAYERS,
               profiled_variants=profiled_variants)
    toks = torch.randint(0, model.cfg.vocab_size, (1, 1, 32768), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    rec["against_plain"] = against_plain_flash(
        model, params, toks, f"gemma2-9b f32 ({GEMMA2_F32_LAYERS} layers)",
        rtol=PREFILL_F32_RTOL)
    dec_counts, dec = decode_past_prefill(model, params, dev,
                                          steps=GEMMA2_F32_DECODE_STEPS)
    del model, params, toks
    torch.cuda.empty_cache()
    return counts, dec_counts, rec, dec


def train_archs_small(dev):
    """[train-archs] small: each of TRAIN_ARCHS' smoke models (f32 and
    bf16 compute), TRAIN_ARCHS_STEPS steps of each TRAIN_ARCHS_COMPRESSORS
    on the ring, on the card and on the CPU from the same weights with the
    same draws.  f32: the ``[small]`` rules (:func:`hold_small`: losses
    within 1e-5 relative, x within 1e-5 + 1e-5 max|x|, no moved
    selection).  bf16: the devices' bf16 matmuls sum in other orders, so
    the losses and each bucket's update x - x0 are held within
    SMALL_BF16_RTOL of their largest magnitude (a moved top-k selection
    moves x by gamma times a delta, far below that).  Launches on the
    card: per step and bucket the EF update, and with QSGD its codes and
    dequantize.  Returns (the card's launch counts summed, the record)."""
    import torch
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer
    steps = TRAIN_ARCHS_STEPS
    report, launches = {}, {k: 0 for k in kernel_names()}
    for arch in TRAIN_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype=dtype)
            params = Model(cfg).init(N_NODES, 1, "cpu")
            for comp, kw in TRAIN_ARCHS_COMPRESSORS:
                runs = {}
                for device in (dev, torch.device("cpu")):
                    tr = DecentralizedTrainer(
                        model=Model(cfg), choco=ChocoConfig(
                            compressor=comp, comp_kwargs=kw),
                        n_nodes=N_NODES, optimizer=make_optimizer("momentum"),
                        lr_fn=cosine_schedule(0.1, 1, steps), device=device)
                    state = tr.state_from_params(params)
                    batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
                    dispatch.reset_launch_counts()
                    losses = [tr.step(state, tr.batch_to_device(batches()),
                                      draws=small_draws(tr, j))["loss"]
                              for j in range(steps)]
                    runs[device.type] = (losses, [b.cpu() for b in state.x],
                                         [b.cpu() for b in state.x_hat],
                                         dispatch.launch_counts())
                (lc, xc, hc, counts), (lp, xp, hp, _) = runs["cuda"], runs["cpu"]
                per = steps * tr.spec.n_buckets
                want = {k: 0 for k in counts}
                want["ef_update"] = per
                if comp == "qsgd":
                    want["qsgd_codes"] = want["dequantize"] = per
                label = f"{arch} {dtype} {comp}"
                check(counts == want, f"[train-archs] {label}: launches "
                      f"{counts}, expected {want}")
                for k, v in counts.items():
                    launches[k] += v
                if dtype == "float32":
                    gammas = tr.exchange.bucket_gammas
                    moved, dx, _, total = hold_small(
                        f"[train-archs] {arch}", comp, gammas, (lc, xc, hc),
                        (lp, xp, hp))
                    what = (f"max |x_cuda - x_cpu| {dx:.3e}, moved selections "
                            f"{moved} of {total}")
                else:
                    x0 = [b.cpu() for b in tr.state_from_params(params).x]
                    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
                    upd = max(float(((a - z) - (b - z)).abs().max())
                              / max(float((b - z).abs().max()), 1e-30)
                              for a, b, z in zip(xc, xp, x0))
                    what = (f"losses max rel {loss_rel:.3e}, updates x - x0 "
                            f"max|d| / max|want| {upd:.3e} (bound "
                            f"{SMALL_BF16_RTOL:.0e})")
                    check(loss_rel <= SMALL_BF16_RTOL and upd
                          <= SMALL_BF16_RTOL, f"[train-archs] {label}: {what}")
                print(f"[train-archs] small {label}, {steps} steps, card "
                      f"against CPU: losses {lc} vs {lp}; {what}; launches "
                      f"{ {k: v for k, v in counts.items() if v} }",
                      flush=True)
                report[label] = {"losses_cuda": lc, "losses_cpu": lp,
                                 "detail": what}
                del tr, state
            torch.cuda.empty_cache()
    return launches, report


def train_archs(dev):
    """[train-archs]: the full-width run (TRAIN_ARCH_FULL: gemma-7b, 1
    layer, top_k 0.01, bf16 EF state, plain SGD, through
    :func:`train_full_width`) with its ms a step, peak, wire bytes per node
    per step and gossip launches per step; the smoke archs card against
    CPU (:func:`train_archs_small`); the launcher at TRAIN_ARCHS_LAUNCHER.
    Returns ({path: launch counts}, the record)."""
    import torch
    arch, layers = TRAIN_ARCH_FULL
    full_counts, full = train_full_width("top_k", dev, arch=arch,
                                         layers=layers,
                                         state_dtype="bfloat16",
                                         optimizer="sgd")
    per_step = {k: v / STEPS for k, v in full_counts.items() if v}
    print(f"[train-archs] {arch} at full width, {layers} layer, "
          f"{N_NODES} nodes, ring, top_k 0.01, bf16 EF state, sgd: ms/step "
          f"{[round(m, 1) for m in full['ms_per_step']]} (first step "
          f"included); peak {full['peak_gib']:.3f} GiB ({full['init_peak_gib']:.3f} "
          f"GiB at init); wire bytes per node per step "
          f"{full['wire_bytes_per_node_step']}; gossip launches per step "
          f"{per_step} over {full['units']} buckets", flush=True)
    torch.cuda.empty_cache()
    small_counts, small = train_archs_small(dev)
    paths = {f"train_archs_{arch}": full_counts,
             "train_archs_small": small_counts}
    for name in TRAIN_ARCHS_LAUNCHER:
        paths[f"launcher_{name}"] = run_launcher(
            ["--compressor", "top_k", "--fraction", "0.05"], arch=name)
    return paths, {"full_width": dict(full, arch=arch, layers=layers,
                                      launches_per_step=per_step),
                   "small": small}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.models.transformer import param_shapes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    with phase("build"):
        with concurrent.futures.ThreadPoolExecutor(len(build.LIBRARIES)) as pool:
            built = list(pool.map(build.build, build.LIBRARIES))
        for name in build.LIBRARIES:
            build.load_library(name)
        print(f"[build] {', '.join(p.name for p, _ in built)} in "
              f"{time.perf_counter() - t0:.1f}s (one nvcc per source, in "
              f"parallel)", flush=True)
        for _, log in built:
            for line in log.splitlines():
                print(f"[build] {line}", flush=True)
        check_flash_sass(build.library_path("flash_tc"),
                         build.library_path("flash"))

    from repro_torch.comm.packing import leaf_route, make_bucket_spec
    from repro_torch.configs.qwen3_1_7b import CONFIG
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    shapes = param_shapes(cfg)
    spec = make_bucket_spec([torch.empty(s, device="meta") for _, s in shapes],
                            routes=[leaf_route(p) for p, _ in shapes])
    lengths = sorted({b.size for b in spec.buckets}, reverse=True) + [ODD_LENGTH]
    print(f"[kernel] checking the full-width bucket lengths and an odd one: "
          f"{lengths}", flush=True)
    with phase("kernels"):
        records, max_err = check_kernels(lengths, dev)
        engine_records, engine_err = check_engine_kernels(dev)
        records.update(engine_records)
        max_err.update(engine_err)
        replica_forms, replica_record, replica_err = check_replica_kernels(dev)
        probe_record = check_probe(dev)
        topk_record, topk_err = check_topk(dev)
        topk_selection_cuda_vs_cpu(dev)
        ops_counts = topk_ops_path(dev)
    with phase("kernels-stale"):
        stale_forms, stale_record, stale_err = check_stale_kernels(dev)
    with phase("train"):
        by_path = {c: train_full_width(c, dev) for c in TRAIN_COMPRESSORS}
    with phase("topology"):
        # the slice's own path: the top_k cell with only the graph changed
        star_counts, star = train_full_width("top_k", dev, topology="star")
        ring_run = by_path["top_k"][1]
        print(f"[topology] star against the ring, top_k 0.01, full width: "
              f"ms/step {star['ms_per_step']} against "
              f"{ring_run['ms_per_step']} (first step included); peak device "
              f"memory {star['peak_gib']:.3f} against "
              f"{ring_run['peak_gib']:.3f} GiB", flush=True)
    with phase("state-bf16"):
        state_bf16 = state_bf16_full_width(dev, by_path)
    with phase("engines"):
        engines = engines_full_width(dev, by_path, state_bf16)
    with phase("process"):
        process_runs = process_full_width(dev, state_bf16)
    with phase("stale"):
        stale_runs = stale_full_width(dev, state_bf16, process_runs)
    with phase("pushsum"):
        pushsum_runs = pushsum_full_width(dev, by_path, state_bf16)
    with phase("modes"):
        modes = modes_full_width(dev)
    with phase("checkpoint"):
        ckpt_full_counts, ckpt_full = checkpoint_full_width(dev)
    with phase("launcher"):
        launcher_counts = {label: run_launcher(extra)
                           for label, extra in LAUNCHER_RUNS}
        per_rank_launcher_counts = {
            label: run_launcher_per_rank(extra)
            for label, extra in LAUNCHER_PER_RANK_RUNS}
    with phase("launcher-stale"):
        for label, extra, per_rank in STALE_LAUNCHER_RUNS:
            if per_rank:
                per_rank_launcher_counts[label] = run_launcher_per_rank(extra)
            else:
                launcher_counts[label] = run_launcher(extra)
    with phase("small"):
        small = small_cuda_vs_cpu(dev)
        leaf_small = leaf_exchange_cuda_vs_cpu(dev)
        process_small_counts = process_small(dev)
        ckpt_small = checkpoint_small(dev)
        torch.cuda.empty_cache()
    with phase("small-stale"):
        stale_small_counts = stale_small(dev)
        torch.cuda.empty_cache()
    with phase("small-pushsum"):
        pushsum_small_counts = pushsum_small(dev)
        launcher_counts["launcher_pushsum"] = run_launcher(PUSHSUM_LAUNCHER)
        torch.cuda.empty_cache()
    with phase("dist"):
        dist_small_report = dist_small(dev)
        torch.cuda.empty_cache()
        # the ranks also run the [stale] per-rank cases (one spawn)
        process_dist_counts, process_ranks = process_dist_small(dev)
        torch.cuda.empty_cache()
    with phase("dist-stale"):
        stale_dist_counts = stale_dist_small(dev, process_ranks)
        torch.cuda.empty_cache()
    with phase("dist-pushsum"):
        pushsum_dist_counts = pushsum_dist_small(dev)
        torch.cuda.empty_cache()
    with phase("dist-full-width"):
        dist_full = dist_full_width(by_path[DIST_FULL[0]][1])
        torch.cuda.empty_cache()
        plain_bytes = exact_wire_bytes("plain", "ring", 1, 0, spec)[0]
        top_k_bytes = dist_full["ranks"][0]["wire_bytes"][-1]
        print(f"[dist] computed, not measured: the per-rank plain mode "
              f"(exact D-SGD) at full width on the ring would send "
              f"{plain_bytes} bytes per rank per step (2 sends x 4 B x "
              f"{sum(b.size for b in spec.buckets)} padded elements), "
              f"{plain_bytes / top_k_bytes:.1f}x the {top_k_bytes} that "
              f"top_k 0.01 sent per rank per step above", flush=True)
    with phase("sim"):
        sim = {"gossip": sim_gossip(dev), "sgd": sim_sgd(dev),
               "pipelined": sim_pipelined(dev)}
        sim_counts = {k: sum(r["launches"][k] for part in sim.values()
                             for r in part.values() if isinstance(r, dict))
                      for k in kernel_names()}
        sim_proc = sim_process(dev)
    with phase("sim-stale"):
        sim_stale_report = sim_stale(dev)
    with phase("sim-pushsum"):
        sim_pushsum_report = sim_pushsum(dev)

    with phase("flash"):
        flash_records, flash_err = check_flash(dev)
    with phase("prefill"):
        model, params, _ = full_width_serving_model(dev, "qwen3-1.7b")
        prefill_counts, prefill = prefill_full_width(model, params, dev)
        consistency_counts, consistency = consistency_full_width(
            model, params, dev)
        decode = profile_decode(model, params, dev)
        del model, params
        torch.cuda.empty_cache()
    with phase("serve"):
        serve_counts, serve = serve_full_width("qwen3-1.7b")
        small_counts, _ = serve_small_cuda_vs_cpu(dev)
        budget = prefill_budget(dev)
    # gemma2-9b: local (windowed) and global layers at head dim 256
    with phase("prefill-gemma2"):
        model, params, draw_gib = full_width_serving_model(dev, "gemma2-9b")
        g2_prefill_counts, g2_prefill = prefill_full_width(model, params, dev)
        g2_prefill["weights_draw_peak_gib"] = draw_gib
        g2_decode_counts, g2_decode = decode_past_prefill(model, params, dev)
    with phase("consistency-gemma2"):
        g2_cons_counts, g2_cons = consistency_full_width(model, params, dev)
        del model, params
        torch.cuda.empty_cache()
    with phase("serve-gemma2"):
        g2_serve_counts, g2_serve = serve_full_width("gemma2-9b")
        torch.cuda.empty_cache()
    with phase("dense-small"):
        dense_small = {"_".join([arch, impl] + [f"dh{d}" for d in dh]):
                       serve_small_cuda_vs_cpu(dev, arch, impl, prompt_len=24,
                                               steps=40,
                                               head_dim=dh[0] if dh else None)
                       for arch, impl, *dh in DENSE_SMALL}
    g2_phases = ("prefill-gemma2", "consistency-gemma2", "serve-gemma2",
                 "dense-small")
    print(f"[phase] the gemma2-9b and dense-variant phases took "
          f"{sum(PHASES[p] for p in g2_phases):.1f} s together", flush=True)
    # the frontends: hubert-xlarge's encoder at head dim 80, llava-next's
    # image-prefixed prefill and serving
    with phase("flash-dh80"):
        dh80_records, _ = check_flash(dev, FLASH_DH80_CASES,
                                      FLASH_DH80_TIMED, seed=8)
    with phase("frontend-hubert"):
        hubert_counts, hubert_batch_counts, hubert = hubert_full_width(dev)
        hubert_small_counts, hubert_small = hubert_small_cuda_vs_cpu(dev)
    with phase("frontend-llava"):
        llava_counts, llava = llava_full_width(dev)
        llava_serve_counts, llava_serve = serve_full_width(
            "llava-next-mistral-7b", SERVE_LLAVA_ARGS)
        torch.cuda.empty_cache()
    frontend_phases = ("flash-dh80", "frontend-hubert", "frontend-llava")
    print(f"[phase] the frontend phases took "
          f"{sum(PHASES[p] for p in frontend_phases):.1f} s together",
          flush=True)
    # the MoE family: flash at head dim 32, qwen3-moe-30b-a3b at full width
    # and cut depth, the qwen3-moe and llama4 smoke models
    with phase("flash-dh32"):
        dh32_records, _ = check_flash(dev, FLASH_DH32_CASES,
                                      FLASH_DH32_TIMED, seed=9)
    with phase("prefill-moe"):
        (moe_counts, moe_decode_counts, moe_prefill,
         moe_decode) = moe_full_width(dev)
    with phase("moe-small"):
        moe_small = {f"{arch}_{dtype}_{impl}": serve_small_cuda_vs_cpu(
            dev, arch, impl, prompt_len=24, steps=40, dtype=dtype)
            for arch, dtype, impl in MOE_SMALL}
        moe_serve_counts, moe_serve = serve_full_width("qwen3-moe-30b-a3b",
                                                       SERVE_MOE_ARGS)
        torch.cuda.empty_cache()
    moe_phases = ("flash-dh32", "prefill-moe", "moe-small")
    print(f"[phase] the MoE phases took "
          f"{sum(PHASES[p] for p in moe_phases):.1f} s together", flush=True)
    # the f32 flash at Dh 256 on gemma2-9b's prefill; training the served
    # dense variants and frontends
    with phase("prefill-gemma2-f32"):
        (g2f32_counts, g2f32_decode_counts, g2f32,
         g2f32_decode) = gemma2_f32_full_width(dev)
    with phase("train-archs"):
        train_arch_paths, train_arch_rec = train_archs(dev)
        torch.cuda.empty_cache()
    with phase("flash-instances"):
        cases = flash_instance_cases()
        instance_records, _ = check_flash(
            dev, cases, tuple(c[0] for c in cases), seed=12)
        flash_instances = {k.split()[1]: v
                           for k, v in instance_records.items()}
    new_phases = ("prefill-gemma2-f32", "train-archs", "flash-instances")
    print(f"[phase] the f32 gemma2 prefill, training and flash instance "
          f"phases took "
          f"{sum(PHASES[p] for p in new_phases):.1f} s together", flush=True)

    # launches of each kernel on every path this script drives (the counts
    # set to 0 just before each path and read just after); the per-rank
    # engine's runs summed over the ranks
    paths = {
        **{c: counts for c, (counts, _) in by_path.items()},
        "topology_star": star_counts,
        **{f"state_bf16_{c}": counts for c, (counts, _) in state_bf16.items()},
        **{f"modes_{label}": counts for label, (counts, _) in modes.items()},
        **{label: counts for label, (counts, _) in engines.items()},
        **{label: counts for label, (counts, _) in process_runs.items()},
        **{label: counts for label, (counts, _) in stale_runs.items()},
        **{label: counts for label, (counts, _) in pushsum_runs.items()},
        **launcher_counts,
        **per_rank_launcher_counts,
        "process_small": process_small_counts,
        "process_dist_small": process_dist_counts,
        "stale_small": stale_small_counts,
        "stale_dist_small": stale_dist_counts,
        "pushsum_small": pushsum_small_counts,
        "pushsum_dist_small": pushsum_dist_counts,
        "sim_pushsum": {k: sum(r["launches"][k]
                               for r in sim_pushsum_report.values())
                        for k in kernel_names()},
        "small": small["launches"],
        "leaf_small": {k: sum(r["launches"][k] for r in leaf_small.values())
                       for k in kernel_names()},
        "checkpoint_full_width": ckpt_full_counts,
        "checkpoint_warmup": ckpt_small["launches"],
        "dist_small": {k: sum(c[k] for c in dist_small_report["launches"])
                       for k in kernel_names()},
        "dist_small_exact_modes": {
            k: sum(c[k] for c in dist_small_report["exact_launches"])
            for k in kernel_names()},
        "dist_full_width": {k: sum(r["launches"][k] for r in dist_full["ranks"])
                            for k in kernel_names()},
        "sim": sim_counts, "topk_ops": ops_counts, "prefill": prefill_counts,
        "consistency": consistency_counts,
        "serve": serve_counts, "serve_small": small_counts,
        "prefill_gemma2": g2_prefill_counts,
        "decode_32k_gemma2": g2_decode_counts,
        "consistency_gemma2": g2_cons_counts, "serve_gemma2": g2_serve_counts,
        **{f"dense_small_{k}": c for k, (c, _) in dense_small.items()},
        "prefill_hubert": hubert_counts,
        "prefill_hubert_batch": hubert_batch_counts,
        "hubert_small": hubert_small_counts, "prefill_llava": llava_counts,
        "serve_llava": llava_serve_counts, "prefill_moe": moe_counts,
        "decode_32k_moe": moe_decode_counts,
        **{f"moe_small_{k}": c for k, (c, _) in moe_small.items()},
        "serve_moe": moe_serve_counts,
        "prefill_gemma2_f32": g2f32_counts,
        "decode_32k_gemma2_f32": g2f32_decode_counts,
        **train_arch_paths}
    by_kernel = lambda name: {p: c[name] for p, c in paths.items()}
    # the training paths whose launches count as the gossip kernels' main
    # path: the four compressors, star, the bf16-state runs, the [modes]
    # runs, the [pushsum] runs, the [checkpoint] runs and its elastic
    # warmups
    train_paths = (list(by_path) + ["topology_star"]
                   + [f"train_archs_{TRAIN_ARCH_FULL[0]}"]
                   + [f"state_bf16_{c}" for c in state_bf16]
                   + list(engines)
                   + [f"modes_{label}" for label in modes]
                   + list(pushsum_runs)
                   + ["checkpoint_full_width", "checkpoint_warmup"])
    check(all(paths[p]["ef_update"] + paths[p]["ef_update_bf16"] > 0
              for p in list(pushsum_runs) + ["pushsum_small",
                                             "pushsum_dist_small",
                                             "launcher_pushsum"]),
          "a push-sum path launched no EF update")
    # the per-leaf and pipelined variants' paths also take in the small
    # phases, where the bf16-state pipelined EF update runs
    engine_paths = train_paths + ["small", "leaf_small",
                                  "launcher_per_leaf_pipelined"]

    # ef_update_bf16 has no pallas_call counterpart: it replaces the leaf
    # update the JAX engine runs as fused jnp on bf16 EF state
    # nor have the per-leaf codes (QSGD.compress, jnp in the per-leaf
    # engine) and the pipelined order (_pipelined_leaf_updates, jnp)
    sources = {"qsgd_codes": "src/repro/kernels/qsgd.py:64",
               "sign_codes": "src/repro/kernels/qsgd.py:86",
               "dequantize": "src/repro/kernels/qsgd.py:118",
               "ef_update": "src/repro/kernels/ef_update.py:52",
               "ef_update_bf16": "src/repro/comm/gossip.py:195",
               "qsgd_leaf_codes": "src/repro/core/compression.py:336",
               "ef_update_pipelined": "src/repro/comm/pipelined.py:71",
               "ef_update_bf16_pipelined": "src/repro/comm/pipelined.py:71"}
    variants = ("qsgd_leaf_codes", "ef_update_pipelined",
                "ef_update_bf16_pipelined")
    kernels = []
    for name, replaces in sources.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_kernels.cu",
            "replaces": replaces,
            "launches": sum(paths[p][name] for p in (
                engine_paths if name in variants else train_paths)),
            "launches_by_path": by_kernel(name),
            "max_abs_err": max(v for k, v in max_err.items()
                               if k in (name, name + "_int16")),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"]})
        if name == "qsgd_leaf_codes":
            kernels[-1]["bf16_input"] = records["qsgd_leaf_codes_bf16"]
        if name == "ef_update_bf16":
            kernels[-1]["gemma_7b_embedding_bucket"] = records[
                f"ef_update_bf16_len{EF_BF16_WIDE}"]
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
    # the replica update has no pallas_call counterpart: it replaces the
    # process engine's update, which JAX runs as jnp; its main path is the
    # [process] cell and the launchers under a process
    process_paths = list(process_runs) + ["launcher_matching",
                                          "launcher_linkfail"]
    check(all(paths[p]["replica_update"] > 0 for p in list(stale_runs)
              + ["launcher_staleness", "stale_small"]),
          "the stale paths launched no replica_update")
    kernels.append({
        "name": "replica_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_kernels.cu",
        "replaces": "src/repro/comm/gossip.py:667",
        "launches": sum(paths[p]["replica_update"] for p in process_paths),
        "launches_by_path": by_kernel("replica_update"),
        "max_abs_err": replica_err, **replica_record,
        "forms": replica_forms})
    check(kernels[-1]["launches"] > 0, "replica_update never launched")
    # its bounded-staleness form, one CUDA entry with the others: on the
    # [stale] paths every replica_update launch is the stale form's
    stale_paths = list(stale_runs) + ["launcher_staleness",
                                      "launcher_per_rank_staleness_rank0"]
    kernels.append({
        "name": "replica_update_stale", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gossip_kernels.cu",
        "replaces": "src/repro/comm/async_gossip.py:376",
        "launches": sum(paths[p]["replica_update"] for p in stale_paths),
        "launches_by_path": {p: paths[p]["replica_update"]
                             for p in stale_paths
                             + ["stale_small", "stale_dist_small"]},
        "max_abs_err": stale_err, **stale_record, "forms": stale_forms})
    check(kernels[-1]["launches"] > 0, "replica_update_stale never launched")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        # the bf16 tensor-core kernel, the main path's; f32 inputs take the
        # 3xTF32 kernel of csrc/flash_attention.cu (its record: "f32")
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": prefill_counts["flash_attention"],
        "launches_by_path": by_kernel("flash_attention"),
        "max_abs_err": flash_err, **flash_records[FLASH_TIMED[0]],
        "qwen3_moe_layer": flash_records["qwen3-moe layer"]})
    check(kernels[-1]["launches"] > 0, "flash_attention never launched")
    # its Dh 256 instances, without and with the window, on gemma2-9b's
    # prefill path (its global and local layers)
    variant_paths = {"prefill": prefill["variants"],
                     "prefill_gemma2": g2_prefill["variants"],
                     "consistency": consistency["variants"],
                     "consistency_gemma2": g2_cons["variants"],
                     "prefill_hubert": hubert["prefill_32k"]["variants"],
                     "prefill_hubert_batch": hubert["batch_30s"]["variants"],
                     "hubert_small": hubert_small,
                     "prefill_llava": llava["variants"],
                     "prefill_moe": moe_prefill["variants"],
                     **{f"moe_small_{k}": v
                        for k, (_, v) in moe_small.items()},
                     "dense_small_yi-9b_chunked":
                         dense_small["yi-9b_chunked"][1],
                     "prefill_gemma2_f32": g2f32["variants"],
                     **{f"dense_small_{arch}_chunked_dh256":
                        dense_small[f"{arch}_chunked_dh256"][1]
                        for arch in ("gemma2-9b", "gemma-7b")}}
    for name, label, variant in (
            ("flash_attention_bf16_dh256", "gemma2 global layer", "bf16_dh256"),
            ("flash_attention_bf16_dh256_window", "gemma2 local layer",
             "bf16_dh256_window")):
        rec = flash_records[label]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": g2_prefill["variants"].get(variant, 0),
            "launches_by_path": {p: v.get(variant, 0)
                                 for p, v in variant_paths.items()},
            "max_abs_err": rec["contract"]["max_abs_err"], **rec})
        if variant == "bf16_dh256":
            kernels[-1]["gemma_7b_layer"] = flash_records["gemma-7b layer"]
        check(kernels[-1]["launches"] > 0, f"{name} never launched on the "
              f"gemma2-9b prefill path")
    # its Dh 80 instances: bf16 on hubert-xlarge's full-width prefill, f32
    # on the hubert smoke encoder at Dh 80 (no full-width path runs f32)
    for name, label, variant, path in (
            ("flash_attention_bf16_dh80", "hubert layer", "bf16_dh80",
             "prefill_hubert"),
            ("flash_attention_f32_dh80", "f32 hubert layer", "f32_dh80",
             "hubert_small")):
        rec = dh80_records[label]
        batch_rec = dh80_records[label.replace("layer", "30 s")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
                       if variant.startswith("bf16") else
                       "src/repro_torch/kernels/csrc/flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": variant_paths[path].get(variant, 0),
            "launches_by_path": {p: v.get(variant, 0)
                                 for p, v in variant_paths.items()},
            "max_abs_err": max(r["contract"]["max_abs_err"]
                               for r in (rec, batch_rec)),
            **rec, "batch_30s": batch_rec})
        check(kernels[-1]["launches"] > 0, f"{name} never launched on the "
              f"{path} path")
    # its Dh 32 instances, both on the MoE smoke models' chunked paths (f32
    # also on yi-9b's smoke model); no full-width path runs Dh 32
    dh32_paths = [p for p in variant_paths if p.startswith("moe_small_")
                  or p == "dense_small_yi-9b_chunked"]
    for name, label, variant in (
            ("flash_attention_bf16_dh32", "qwen3-moe heads Dh 32", "bf16_dh32"),
            ("flash_attention_f32_dh32", "f32 qwen3-moe heads Dh 32",
             "f32_dh32")):
        rec = dh32_records[label]
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
                       if variant.startswith("bf16") else
                       "src/repro_torch/kernels/csrc/flash_attention.cu"),
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": sum(variant_paths[p].get(variant, 0)
                            for p in dh32_paths),
            "launches_by_path": {p: v.get(variant, 0)
                                 for p, v in variant_paths.items()},
            "max_abs_err": rec["contract"]["max_abs_err"], **rec})
        check(kernels[-1]["launches"] > 0, f"{name} never launched on the "
              f"MoE smoke paths")
    # its f32 Dh 256 instances, without and with the window, on the f32
    # gemma2-9b prefill path (its global and local layers)
    for name, label, variant in (
            ("flash_attention_f32_dh256", "f32 gemma2 global layer",
             "f32_dh256"),
            ("flash_attention_f32_dh256_window", "f32 gemma2 local layer",
             "f32_dh256_window")):
        rec = flash_records[label]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:77",
            "launches": g2f32["variants"].get(variant, 0),
            "launches_by_path": {p: v.get(variant, 0)
                                 for p, v in variant_paths.items()},
            "max_abs_err": rec["contract"]["max_abs_err"], **rec})
        if variant == "f32_dh256":
            kernels[-1]["gemma_7b_layer"] = flash_records["f32 gemma-7b layer"]
        check(kernels[-1]["launches"] > 0, f"{name} never launched on the "
              f"f32 gemma2-9b prefill path")
    # its path is its public op, as in the JAX package; no trainer path
    # reaches it (the engine selects top-k payloads in plain PyTorch)
    kernels.append({
        "name": "block_topk_mask", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_topk.cu",
        "replaces": "src/repro/kernels/topk.py:50",
        "launches": ops_counts["block_topk_mask"],
        "launches_by_path": by_kernel("block_topk_mask"),
        "max_abs_err": topk_err, **topk_record})
    check(kernels[-1]["launches"] > 0, "block_topk_mask never launched")
    # its path is the per-rank engine's choco exchange build, once per rank
    kernels.append({
        "name": "probe_scale", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/probe.cu",
        "replaces": "src/repro/kernels/dispatch.py:133",
        "launches": paths["dist_full_width"]["probe_scale"],
        "launches_by_path": by_kernel("probe_scale"),
        **probe_record})
    check(kernels[-1]["launches"] == N_NODES,
          f"probe_scale launched {kernels[-1]['launches']} times on the "
          f"per-rank full-width run, expected once per rank")
    extra = {k: records[k] for k in ("qsgd_codes_int16", "dequantize_int16")}
    train = {c: r for c, (_, r) in by_path.items()}
    print(json.dumps({"int16": extra, "train": train, "topology_star": star,
                      "state_bf16": {c: r for c, (_, r) in state_bf16.items()},
                      "modes": {k: r for k, (_, r) in modes.items()},
                      "engines": {k: r for k, (_, r) in engines.items()},
                      "process": {k: r for k, (_, r) in process_runs.items()},
                      "stale": {k: r for k, (_, r) in stale_runs.items()},
                      "pushsum": {k: r for k, (_, r) in pushsum_runs.items()},
                      "sim_pushsum": sim_pushsum_report,
                      "sim_process": sim_proc, "sim_stale": sim_stale_report,
                      "phases_s": PHASES,
                      "leaf_small": leaf_small,
                      "checkpoint": {"full_width": ckpt_full,
                                     "small": ckpt_small},
                      "sim": sim, "small": small,
                      "prefill": prefill, "serve": serve, "decode": decode,
                      "consistency": consistency,
                      "gemma2": {"prefill": g2_prefill, "decode_32k": g2_decode,
                                 "consistency": g2_cons, "serve": g2_serve},
                      "frontends": {"hubert": hubert,
                                    "hubert_small": hubert_small,
                                    "llava": llava, "serve_llava": llava_serve},
                      "moe": {"prefill": moe_prefill, "decode_32k": moe_decode,
                              "small": {k: v for k, (_, v) in
                                        moe_small.items()},
                              "serve": moe_serve},
                      "gemma2_f32": {"prefill": g2f32,
                                     "decode_32k": g2f32_decode},
                      "train_archs": train_arch_rec,
                      "flash_instances": flash_instances,
                      "dist_small": {k: v for k, v in dist_small_report.items()
                                     if k != "launches"},
                      "dist_full_width": dist_full,
                      "prefill_budget": budget}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
