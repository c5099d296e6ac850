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
   version round every operation separately), and times kernel, plain
   version, the bytes bound and,
   for dequantize, the one PyTorch call that computes the same function.
   QSGD is checked twice at each length: with inv_norm = 1/||x|| per node
   row, as the trainer calls it (codes of -1, 0 or 1 at these lengths),
   and with inv_norm = 0.999/max|x|, which reaches every level up to s;
   The collective-layer probe kernel is held bit-equal to its plain version
   at the JAX probe's (8, 128) block and timed in turns with its plain
   version and ``torch.mul(x, 2)`` in one loop;
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
   beside the ring's ms/step and peak memory; then ``[modes]``, the same
   cell through the same code in the paper's three modes: CHOCO-SGD top_k
   with plain SGD on Dirichlet(0.1) token shards, exact D-SGD (plain) with
   momentum and the all-reduce baseline with AdamW, checking finite
   losses and the launches (the EF update per bucket per step under
   choco, no kernel in the exact modes);
5. runs the training launcher (``repro_torch.launch.train.main``) for a
   --smoke run with --compressor top_k --fraction 0.05 and one with
   --mode plain --optimizer adamw --data-skew-alpha 0.5, then the first
   with --simulate-devices 4 (4 ranks on the card, the per-rank engine),
   checking its engine line, its probe record and rank 0's launches;
6. holds small float32 training runs on the card against the same runs on
   the CPU (the plain versions), step by step: SignNorm, top_k,
   block_top_k, identity with the exact small-leaf bucket, and rand_k and
   randomized gossip fed the same draws on both devices, on the ring;
   top_k on torus, chain, star and the time-varying pair "ring,star";
   plain on star, allreduce with plain SGD and QSGD under AdamW;
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
   sent to its own sends times the payload bytes; plain (ring; star, 2
   rounds) and allreduce hold the exchange alone bit-equal (allreduce:
   within 1e-6, its sum runs in gloo's order), 3 steps to the ``[small]``
   rules, each rank's bytes by formula (plain's counted; allreduce's a
   ring model, none counted) and no launch, the probe included;
   the full-width plain mode's bytes are printed as computed;
   then ``[sim]``, the paper's algorithms as matrix simulators on the card
   against the CPU: CHOCO-Gossip at the quickstart's sizes (ring 25, d
   2000: exact, QSGD(127), top 1%) and CHOCO-SGD (QSGD(16), top 1%) with
   exact D-SGD on the epsilon stand-in at m = 400,000, d = 2,000, ring 9,
   each run free on both devices and again round by round, the CPU
   making each round from the card's state (x, x_hat and s held; QSGD
   levels and top-k selections counted where they move);
7. holds the flash-attention kernels against their plain version: the
   bf16 tensor-core kernel (``csrc/flash_attention_sm90.cu``; the build
   phase checks that its SASS holds wgmma and TMA loads) at the
   full-width prefill layer shape (32768 tokens, 16/8 heads, causal), at
   an odd length (1000), at 2048, at Dh 64 with a softcap and non-causal,
   each to contract (a) (``FLASH_BF16_RTOL``, ``FLASH_BF16_ULP_SHARE``)
   and its plain version to contract (b) against the f32-P result; the
   f32 CUDA-core kernel with a softcap within 1e-5 of max|out|; and times
   the bf16 kernel at the prefill layer, its plain version,
   ``scaled_dot_product_attention`` (the library yardstick, which the
   port never calls) and the bounds, and the f32 kernel at the same
   shape beside SDPA on the same f32 inputs;
8. prefills qwen3-1.7b at full width and full depth (28 layers) through
   ``Model.prefill`` with ``attn_impl="chunked"``: one prompt of 32768
   tokens (the ``prefill_32k`` shape, its batch of 32 cut to 1 for one
   card), twice, checking 28 flash launches per call, finite logits and
   the cache shapes, then profiles one more call, which must attribute
   28 launches and their device time to the tensor-core kernel;
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
11. prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the repository's ``src/`` beside it, it exits non-zero and prints no result.
"""
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
ODD_LENGTH = 1_000_003
GOSSIP_KERNELS = ("qsgd_codes_kernel", "sign_codes_kernel",
                  "dequantize_kernel", "ef_update_kernel")
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
#: (label, N, S, H, KV, Dh, dtype, causal, softcap); the first is the
#: full-width prefill layer, and the one that is timed.  Drawn in this
#: order from one generator, so each case keeps its inputs from run to run.
FLASH_CASES = (
    ("prefill layer", 1, 32768, 16, 8, 128, "bfloat16", True, None),
    ("odd length", 2, 1000, 16, 8, 128, "bfloat16", True, None),
    ("f32 softcap", 2, 512, 8, 8, 64, "float32", False, 50.0),
    ("S 2048", 1, 2048, 16, 8, 128, "bfloat16", True, None),
    ("Dh 64 softcap", 2, 512, 8, 8, 64, "bfloat16", False, 50.0),
    ("non-causal", 2, 1000, 16, 8, 128, "bfloat16", False, None),
)
PREFILL_CALLS = 2
#: the f32 prefill test's cache tolerance, atol (rtol 1e-5), from
#: ``prefill_budget``'s measurements
PREFILL_CACHE_ATOL = 4e-5


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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
        if length == max(lengths):
            records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
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
        del ins, inplace, x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return records, max_err


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


def profile_call(label, fn, ours, show=True):
    """One more call of ``fn`` under torch.profiler: device time by kernel,
    grouped into the port's kernels (names in ``ours``), matmuls and
    everything else; printed unless ``show`` is False."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    kernels = [(dev_us(e) / 1e3, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        print(f"[profile] {label}: the profiler recorded no device time",
              flush=True)
        return None
    groups = {"port kernels": 0.0, "matmul": 0.0, "other": 0.0}
    # device ms and launches of each of ours, by the name it is matched on
    by_kernel = {k: [0.0, 0] for k in ours}
    for e in prof.key_averages():
        for k in ours:
            if e.device_type == DeviceType.CUDA and k in e.key:
                by_kernel[k][0] += dev_us(e) / 1e3
                by_kernel[k][1] += e.count
    for ms, name in kernels:
        if any(k in name for k in ours):
            groups["port kernels"] += ms
        elif any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass",
                                             "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0)
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
    return {"wall_ms": wall, "device_busy_ms": busy, "launches": launches,
            "device_idle_share": idle, "by_kernel": by_kernel,
            "host_top": [[ms, name, count] for ms, name, count in host],
            **groups}


def train_full_width(compressor, dev, topology="ring", mode="choco",
                     optimizer="momentum", lr=0.1, skew=None):
    """Full-width qwen3-1.7b (2 layers), 4 nodes, on ``topology`` (1
    gossip round per step), in ``mode`` with the ``optimizer`` local step
    at ``lr``, on Dirichlet(``skew``) token shards where given: STEPS
    steps, then one profiled step."""
    import torch
    from repro_torch.configs.base import ChocoConfig
    from repro_torch.configs.qwen3_1_7b import CONFIG
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model, count_params
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer

    cfg = dataclasses.replace(CONFIG, n_layers=2)
    kw = {"qsgd": (("s", 16),), "sign": ()}.get(compressor,
                                                 (("fraction", 0.01),))
    torch.cuda.reset_peak_memory_stats()
    tr = DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=compressor, comp_kwargs=kw,
                                            topology=topology,
                                            data_skew_alpha=skew),
        n_nodes=N_NODES, optimizer=make_optimizer(optimizer),
        lr_fn=cosine_schedule(lr, warmup=STEPS // 10 + 1, total=STEPS),
        device=dev, mode=mode)
    state = tr.init_state(seed=0)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # the launcher's default sequence for the uncut 28-layer model
    seq = min(CONFIG.n_layers * 64, 512)
    batches = make_lm_batch_fn(cfg, seq, 4, N_NODES, 1.0,
                               skew_alpha=tr.choco.data_skew_alpha)
    label = compressor if mode == "choco" else "none"
    skew_tv = None if skew is None else batches.skew_tv
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} seq={seq} batch=4 "
          f"params={count_params(cfg) / 1e6:.1f}M nodes={N_NODES} "
          f"mode={mode} optimizer={optimizer} lr={lr} "
          f"topology={topology} rounds={tr.schedules[0].n_rounds} "
          f"compressor={label} buckets={tr.spec.n_buckets} "
          f"gamma={tr.gamma:.3e}"
          + ("" if skew is None else
             f" data_skew_alpha={skew} skew_tv={skew_tv:.6f}"), flush=True)
    dispatch.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(STEPS):
        batch = tr.batch_to_device(batches())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mets = tr.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(mets["loss"])
        print(f"[train] step {state.step} loss {mets['loss']:.4f} "
              f"lr {mets['lr']:.4f} ({step_ms[-1]:.1f} ms)", flush=True)
    counts = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    retries = torch.cuda.memory_stats()["num_alloc_retries"]
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    expected = STEPS * tr.choco.gossip_steps * tr.spec.n_buckets
    # sparse payloads decode by scatter: no dequantize launch on their path;
    # the exact modes launch no kernel
    choco = mode == "choco"
    on_path = {"qsgd_codes": choco and compressor == "qsgd",
               "sign_codes": choco and compressor == "sign",
               "dequantize": choco and compressor in ("qsgd", "sign"),
               "ef_update": choco, "flash_attention": False,
               "block_topk_mask": False, "probe_scale": False}
    for name, used in on_path.items():
        want = expected if used else 0
        print(f"[train] {mode} {label}: {name} launches {counts[name]} "
              f"(expected {want}: {STEPS} steps x {tr.choco.gossip_steps} "
              f"gossip_steps x {tr.spec.n_buckets} buckets on its path, "
              f"else 0)", flush=True)
        check(counts[name] == want, f"{name}: {counts[name]} launches, "
              f"expected {want}")
    print(f"[train] {mode} {label} {optimizer}: losses {losses}; ms/step "
          f"{step_ms} (first step included); peak device memory {peak:.2f} "
          f"GiB over the steps, {init_peak:.2f} GiB at init; allocator "
          f"retries (cache flushed to fit an allocation) so far {retries}",
          flush=True)
    batch = tr.batch_to_device(batches())
    profile = profile_call(f"one {mode} {label} {optimizer} step on the "
                           f"{topology}", lambda: tr.step(state, batch),
                           GOSSIP_KERNELS)
    del state, tr
    torch.cuda.empty_cache()
    return counts, {"topology": topology, "mode": mode,
                    "optimizer": optimizer, "lr": lr, "skew_alpha": skew,
                    "skew_tv": skew_tv, "losses": losses,
                    "ms_per_step": step_ms, "peak_gib": peak,
                    "init_peak_gib": init_peak, "alloc_retries": retries,
                    "profile": profile}


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


#: the launcher's --smoke runs on the card: (label, extra flags); the
#: first is the choco path, the second the exact mode with the new flags
LAUNCHER_RUNS = (("launcher_smoke", ["--compressor", "top_k", "--fraction",
                                     "0.05"]),
                 ("launcher_plain_adamw_skew", ["--mode", "plain",
                                                "--optimizer", "adamw",
                                                "--data-skew-alpha", "0.5"]))


def run_launcher(extra):
    """The user's entry point, --smoke, on the card, with ``extra`` flags:
    finite losses, and the EF update per bucket per step under choco and
    no kernel in the exact modes."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import main
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", f"{N_NODES}x1",
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
    buckets = int(out.split("buckets=")[1].split()[0])
    want = STEPS * buckets if "mode=choco" in out else 0
    check(counts["ef_update"] == want and sum(counts.values()) == want,
          f"launcher launch counts {counts}, expected {want} ef_update "
          f"launches and no other")
    if "--data-skew-alpha" in extra:
        check("skew_tv=" in out, "launcher: no skew_tv in the header")
    print(f"[launcher] {' '.join(extra)}: launches {counts}", flush=True)
    return counts


def run_launcher_per_rank():
    """The user's entry point with --simulate-devices: the launcher builds
    the kernels, spawns N_NODES ranks on the card and rank 0 prints.
    Checks the engine line, the probe record, finite losses and rank 0's
    launches: the probe kernel once, the EF update per bucket per step."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-1.7b", "--smoke", "--mesh", f"{N_NODES}x1",
            "--simulate-devices", str(N_NODES), "--compressor", "top_k",
            "--fraction", "0.05", "--steps", str(STEPS)]
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
    check(counts["ef_update"] == want and counts["probe_scale"] == 1
          and sum(counts.values()) == want + 1,
          f"per-rank launcher: rank 0 launches {counts}, expected {want} "
          f"ef_update and one probe_scale")
    print(f"[launcher] per-rank, {N_NODES} ranks on the card: {wall:.1f} s "
          f"from start to exit; rank 0 launches {counts}", flush=True)
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
               1e-3))


def small_draws(tr, step):
    """rand_k's and randomized gossip's draws for one step, made on the CPU
    from a seed, so the card and the CPU run get the same ones."""
    import torch
    from repro_torch.comm import packing
    if tr.compressor is None or not tr.compressor.stochastic:
        return None

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
    The exact modes have no x_hat: every coordinate of x is held.  Launches:
    per step, bucket and round one EF update, and the codes and dequantize
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
    for comp, kw, exact, topology, steps_k, mode, opt, lr in SMALL_RUNS:
        runs = {}
        for device in (dev, "cpu"):
            tr = DecentralizedTrainer(
                model=Model(cfg), choco=ChocoConfig(
                    compressor=comp, comp_kwargs=kw, exact_small_leaves=exact,
                    topology=topology, gossip_steps=steps_k),
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
        per_kernel = STEPS * steps_k * tr.spec.n_buckets
        choco = mode == "choco"
        want = {k: 0 for k in counts}
        want["ef_update"] = per_kernel if choco else 0
        if choco and comp in ("qsgd", "sign"):
            want[f"{comp}_codes"] = want["dequantize"] = per_kernel
        check(counts == want, f"[small] {mode} {comp} {topology}: launches "
              f"{counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
        check(any(b.exact for b in tr.spec.buckets) == exact,
              f"[small] {comp}: exact buckets")
        gammas = (tr.exchange.bucket_gammas if choco
                  else [0.0] * tr.spec.n_buckets)
        moved, dx, dx_moved, total = hold_small(
            "[small]", comp, gammas, (lc, xc, hc), (lp, xp, hp))
        what = comp if choco else mode
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


def hold_small(label, comp, gammas, got, want):
    """The ``[small]`` rules of ``small_cuda_vs_cpu`` for one run ``got`` =
    (losses, x buffers, x_hat buffers or None in the exact modes) against
    ``want``, buffers on the CPU.  Returns (moved coordinates, max |dx|, max
    |dx| at the moved ones, coordinates)."""
    import numpy as np
    import torch
    (lc, xc, hc), (lp, xp, hp) = got, want
    if hc is None:
        hc = hp = [None] * len(xc)
    moved, dx_moved = 0, 0.0
    for a, b, ha, hb, g in zip(xc, xp, hc, hp, gammas):
        d = (a - b).abs()
        # the moved selections: none without x_hat (the exact modes)
        at = ((ha - hb).abs() > 1e-4 if ha is not None
              else torch.zeros_like(d, dtype=torch.bool))
        moved += int(at.sum())
        rest = float(d[~at].max()) if (~at).any() else 0.0
        check(rest <= 1e-5 + 1e-5 * float(b.abs().max()),
              f"{label} {comp}: iterates differ by {rest} off the moved "
              f"selections")
        if at.any():
            dx_moved = max(dx_moved, float(d[at].max()))
            check(dx_moved <= 1e-5 + 2 * g * float(hb.abs().max()),
                  f"{label} {comp}: a moved selection shifted x by {dx_moved}")
    dx = max(float((a - b).abs().max()) for a, b in zip(xc, xp))
    check(np.allclose(lc, lp, rtol=1e-5, atol=0),
          f"{label} {comp}: losses differ: {lc} against {lp}")
    if comp == "sign":
        check(dx <= 1e-5, f"{label} {comp}: iterates differ by {dx}")
    limit = N_NODES * STEPS if comp == "sign" else 0
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
#: the full-width [dist] phase's compressor and, per node, sequence and batch
DIST_FULL = ("top_k", (("fraction", 0.01),), 1)
DIST_SEQ, DIST_BATCH = 512, 4
DIST_TIMEOUT_S = 300.0


def _dist_trainer(comp, kw, steps_k, cfg, dev, group=None, topology="ring",
                  mode="choco"):
    from repro_torch.configs.base import ChocoConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import cosine_schedule, momentum_sgd
    from repro_torch.train.trainer import DecentralizedTrainer
    return DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=comp, comp_kwargs=kw,
                                            topology=topology,
                                            gossip_steps=steps_k),
        n_nodes=N_NODES, optimizer=momentum_sgd(),
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
    on the CPU from seed 17."""
    import torch
    gen = torch.Generator().manual_seed(17)
    return [[torch.randn((N_NODES, b.size), generator=gen) * scale
             for b in spec.buckets] for scale in (1.0, 0.5, 0.1)]


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
    torch.cuda.synchronize()
    out["launches"] = dispatch.launch_counts()
    out["transport"] = group.describe()
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
        t0 = time.perf_counter()
        spawn_ranks_of(_dist_small_rank, tmp, 600)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"small{r}.pt"),
                            weights_only=False) for r in range(N_NODES)]
    print(f"[dist] small phase: {N_NODES} ranks in {wall:.1f} s; "
          f"transport {ranks[0]['transport']}; launches per rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}",
          flush=True)
    cfg = _small_cfg()
    params = Model(cfg).init(N_NODES, 1, "cpu")
    report = {"launches": [r["launches"] for r in ranks],
              "exact_launches": [r["exact_launches"] for r in ranks]}
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
    return report


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


#: [sim]: CHOCO-Gossip as examples/quickstart.py runs it, (label,
#: compressor, gamma, rounds), ring of SIM_GOSSIP_N nodes, d = SIM_GOSSIP_D
SIM_GOSSIP_N, SIM_GOSSIP_D = 25, 2000
SIM_GOSSIP_RUNS = (("exact", None, 1.0, 300), ("qsgd127", ("qsgd", 127), 1.0,
                                                300),
                   ("top_1pct", ("top_k", 0.01), 0.046, 3000))
#: [sim]: CHOCO-SGD on the epsilon stand-in at the paper's full size
#: (benchmarks/bench_sgd.py: ring n = 9, sorted data, batch 4, eta_t =
#: 300 / (t + 300), top 1% at gamma 0.04, qsgd_16 at 0.2); its 1200 steps
#: cut to SIM_SGD_STEPS to keep the script's time
SIM_SGD_N, SIM_SGD_M, SIM_SGD_D, SIM_SGD_STEPS, SIM_SGD_BATCH = (
    9, 400_000, 2_000, 300, 4)
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
            worst[f] = max(worst[f], _rel(got[f], want[f], keep))
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
    import collections
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


def sim_sgd(dev):
    """CHOCO-SGD (Algorithm 6) with QSGD(16) and top 1%, and exact D-SGD
    (Algorithm 3), on the epsilon stand-in at m = 400,000, d = 2,000
    (A: 3.2 GB f32 on the card, made by numpy from the float64 draw of
    ``make_logreg``), ring n = 9, sorted data: SIM_SGD_STEPS steps each on
    the card and on the CPU with the same minibatches and dither (CPU
    generators); the free runs' f(x_bar) at the start and the end within
    SIM_RTOL (their final x printed), each step held by ``_hold_rounds``;
    wire bits per node, ms per step."""
    import collections
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


def check_probe(dev):
    """The collective-layer probe kernel against its plain version at the
    JAX probe's (8, 128) f32 block: bit-equal.  Times kernel and plain
    version; the bound is 8 KiB moved at the HBM rate, far below a
    launch's latency."""
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
    bms, by = bound_ms([x], [got], x.numel())
    (ms, plain_ms, lib_ms), wins = time_interleaved_ms(
        [lambda: dispatch.probe_scale(x), lambda: ref.probe_scale_ref(x),
         lambda: torch.mul(x, 2)], rounds=40, per_round=50)
    record = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=bms, bound_by=by, timed="interleaved",
                  fastest_share=dict(zip(("kernel", "plain", "library"),
                                         wins)),
                  shape=list(PROBE_SHAPE), max_abs_err=err)
    print(f"[kernel] probe_scale {PROBE_SHAPE}: bit-equal; timed in turns "
          f"with its plain version and torch.mul(x, 2) in one loop (40 "
          f"rounds of 50 calls each): {ms:.4f} ms (bound {bms:.6f} ms, {by}: "
          f"the launch latency sets it), plain {plain_ms:.4f} ms, "
          f"torch.mul(x, 2) {lib_ms:.4f} ms; fastest in "
          f"{record['fastest_share']} of the rounds", flush=True)
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
            got[where] = dict(h=h, logits=logits, k=cache["k"], v=cache["v"])
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


def flash_bounds(tensors_in, out, causal):
    """(bound ms, bound_by, f32 CUDA-core bound ms, flops) of one attention
    call: q, k, v read once and out written once at the HBM rate, against
    4 * Dh flops per (query, key) pair that the mask keeps (S (S + 1) / 2
    pairs per head when causal, S^2 otherwise) at the card's peak rate for
    the inputs' type (bf16 tensor cores for bf16, f32 outside the tensor
    cores for f32); and the same flops at the f32 CUDA-core rate, the rate
    of the f32 kernel's arithmetic."""
    import torch
    n, s, h, dh = out.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * dh * n * h * pairs
    rate = (BF16_TC_FLOPS_PER_S if out.dtype == torch.bfloat16
            else F32_FLOPS_PER_S)
    bms, by = bound_ms(list(tensors_in), [out], flops, rate)
    return bms, by, flops / F32_FLOPS_PER_S * 1e3, flops


def flash_cases(dev):
    """(label, q, k, v, kwargs) of each of FLASH_CASES in order, normal
    draws from one generator seeded 3."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, n, s, h, kv, dh, dtype, causal, cap in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((n, s, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((n, s, kv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((n, s, kv, dh), generator=gen, device=dev).to(dt)
        yield label, q, k, v, dict(causal=causal, softcap=cap)


def check_flash(dev):
    """The flash kernels against their plain version in FLASH_CASES.

    f32 (the CUDA-core kernel): max abs error <= 1e-5 * max|out|.  bf16
    (the tensor-core kernel, P rounded to bf16 as the plain version rounds
    it): contract (a), max|d| / max|want| <= FLASH_BF16_RTOL and at most
    FLASH_BF16_ULP_SHARE of the elements more than one bf16 ulp apart; and
    contract (b), the plain version within FLASH_BF16_F32P_RTOL of the
    f32-P result.  Returns the timing record of the first case, with every
    bf16 case's readings, and the max abs error."""
    import torch
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import flash_attention as fa
    record, max_err, readings = None, 0.0, {}
    for label, q, k, v, kw in flash_cases(dev):
        got = dispatch.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        max_err = max(max_err, err)
        check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
        what = f"max abs err {err:.3e}, max |out| {top:.3f}"
        if q.dtype == torch.float32:
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
                               "b_rel": rel_b, "b_ulp_share": share_b}
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
              f"softcap={kw['softcap']}: {what}", flush=True)
        if record is None:
            causal = kw["causal"]
            bms, by, f32_ms, flops = flash_bounds((q, k, v), got, causal)
            F = torch.nn.functional
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            plain = ref.flash_attention_ref(q, k, v, **kw)
            lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
            lib_err = float((lib.transpose(1, 2).float() - plain.float()).abs().max())
            del lib, plain
            ms = time_ms(lambda: dispatch.flash_attention(q, k, v, **kw), 10)
            record = dict(
                ms=ms,
                plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 1),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), 10),
                bound_ms=bms, bound_by=by, bound_f32_cuda_core_ms=f32_ms,
                tflop_per_s=flops / ms / 1e9, bound_share=bms / ms,
                shape=[list(q.shape), list(k.shape)], dtype=str(q.dtype)[6:])
            print(f"[kernel] flash_attention {label}: {ms:.3f} ms "
                  f"({record['tflop_per_s']:.1f} TFLOP/s, "
                  f"{100 * record['bound_share']:.1f}% of the bound {bms:.3f} "
                  f"ms, {by}, at the bf16 tensor-core peak; {f32_ms:.3f} ms at "
                  f"the 67 TFLOP/s f32 CUDA-core rate), plain "
                  f"{record['plain_ms']:.3f} ms, scaled_dot_product_attention "
                  f"{record['library_ms']:.3f} ms ({ms / record['library_ms']:.2f}x"
                  f"; max abs diff to the plain version {lib_err:.3e})",
                  flush=True)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    record["f32"] = time_flash_f32(dev)
    record["contract"] = readings
    record["contract_bounds"] = {"a_rel": fa.FLASH_BF16_RTOL,
                                 "a_ulp_share": fa.FLASH_BF16_ULP_SHARE,
                                 "b_rel": fa.FLASH_BF16_F32P_RTOL}
    return record, max_err


def time_flash_f32(dev):
    """The f32 entry (the CUDA-core kernel) at the prefill layer's shape,
    q (1, 32768, 16, 128), k and v 8 heads, causal: kernel, plain version
    and ``scaled_dot_product_attention`` on the same f32 inputs (its
    memory-efficient backend, the one that takes f32; k and v are repeated
    to 16 heads before the timed calls, as that backend takes no grouped
    heads), and the bounds."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import dispatch, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 32768, 16, 128), generator=gen, device=dev)
    k, v = (torch.randn((1, 32768, 8, 128), generator=gen, device=dev)
            for _ in range(2))
    got = dispatch.flash_attention(q, k, v, causal=True)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(2, dim=2).transpose(1, 2) for t in (k, v))
    F = torch.nn.functional
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_err = float((lib.transpose(1, 2) - got).abs().max())
        del lib
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 3)
    bms, by, _, flops = flash_bounds((q, k, v), got, True)
    ms = time_ms(lambda: dispatch.flash_attention(q, k, v, causal=True), 2)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                       1)
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
               bound_by=by, tflop_per_s=flops / ms / 1e9,
               bound_share=bms / ms, library_max_abs_diff=lib_err,
               shape=[list(q.shape), list(k.shape)], dtype="float32")
    print(f"[kernel] flash_attention f32 prefill layer q{tuple(q.shape)} "
          f"k{tuple(k.shape)} causal: {ms:.3f} ms ({rec['tflop_per_s']:.1f} "
          f"TFLOP/s, {100 * rec['bound_share']:.1f}% of the bound {bms:.3f} "
          f"ms, {by}, at the f32 CUDA-core rate), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention (memory-efficient backend, f32) "
          f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x; max abs diff to the kernel "
          f"{lib_err:.3e})", flush=True)
    del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()
    return rec


def check_flash_sass(path):
    """The bf16 flash kernel was compiled to tensor-core code: every
    ``flash_tc_kernel`` instantiation in the library's SASS
    (``cuobjdump -sass``) holds wgmma (``HGMMA``) and TMA loads
    (``UTMALDG``), so a CUDA-core kernel cannot pass for it.  A missing
    ``cuobjdump`` is a failure."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), f"cuobjdump not found ({tool}): the flash_tc "
          f"library's SASS cannot be checked")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if "flash_tc_kernel" in name:
            found[name] = (section.count("HGMMA"), section.count("UTMALDG"))
    check(len(found) == 2, f"flash_tc SASS: {len(found)} flash_tc_kernel "
          f"functions, expected 2 (Dh 64 and 128)")
    for name, (hgmma, utmaldg) in found.items():
        check(hgmma > 0 and utmaldg > 0, f"flash_tc SASS: {name} has {hgmma} "
              f"HGMMA and {utmaldg} UTMALDG instructions")
    print("[build] flash_tc SASS: " + "; ".join(
        f"{name[-60:]}: {h} HGMMA, {u} UTMALDG"
        for name, (h, u) in found.items()), flush=True)
    return found


def full_width_serving_model(dev):
    """qwen3-1.7b at full width and depth with the flash kernel, random
    weights from seed 0 cast once to bf16."""
    from repro_torch.configs.qwen3_1_7b import CONFIG
    from repro_torch.models.transformer import Model
    model = Model(dataclasses.replace(CONFIG, attn_impl="chunked"))
    params = model.compute_params(model.init(1, 0, dev))
    return model, params


def prefill_full_width(model, params, dev):
    """Model.prefill at 32768 tokens, PREFILL_CALLS times, then profiled."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.kernels import dispatch
    cfg = model.cfg
    shape = INPUT_SHAPES["prefill_32k"]
    seq, batch = shape.seq_len, 1       # global batch 32 cut to 1: one card
    toks = torch.randint(0, cfg.vocab_size, (1, batch, seq), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
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
        want = (1, cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        for name in ("k", "v"):
            check(tuple(caches[name].shape) == want and caches[name].dtype
                  == torch.bfloat16, f"prefill cache {name}: "
                  f"{tuple(caches[name].shape)} {caches[name].dtype}")
        del logits, caches
    counts = dispatch.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want_launches = PREFILL_CALLS * cfg.n_layers
    check(counts["flash_attention"] == want_launches,
          f"prefill: {counts['flash_attention']} flash launches, expected "
          f"{PREFILL_CALLS} calls x {cfg.n_layers} layers = {want_launches}")
    check(sum(counts.values()) == want_launches, f"prefill counts {counts}")
    print(f"[prefill] {cfg.name} layers={cfg.n_layers} tokens={seq} "
          f"batch={batch} (prefill_32k, batch {shape.global_batch} cut to "
          f"{batch}): ms per call {ms} (first call first); flash launches "
          f"{counts['flash_attention']} = {PREFILL_CALLS} x {cfg.n_layers}; "
          f"peak device memory {peak:.3f} GiB", flush=True)
    profile = profile_call("one prefill call", lambda: model.prefill(params, toks),
                           FLASH_KERNELS)
    check(profile is not None, "prefill: the profiler recorded no device time")
    tc_ms, tc_launches = profile["by_kernel"]["flash_tc_kernel"]
    check(tc_launches == cfg.n_layers and tc_ms > 0
          and profile["by_kernel"]["flash_attention_kernel"][1] == 0,
          f"prefill: the profiled call's flash kernels {profile['by_kernel']}; "
          f"expected {cfg.n_layers} launches of flash_tc_kernel and none of "
          f"the f32 kernel")
    print(f"[prefill] the profiled call: flash_tc_kernel {tc_launches} "
          f"launches, {tc_ms:.3f} ms of device time "
          f"({100 * tc_ms / profile['device_busy_ms']:.1f}% of busy)",
          flush=True)
    return counts, {"ms_per_call": ms, "peak_gib": peak, "tokens": seq,
                    "batch": batch, "profile": profile}


def serve_full_width():
    """The serve launcher at full width: the JAX launcher's defaults with 2
    requests, on the card."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import main
    argv = ["--arch", "qwen3-1.7b", "--batch", "8", "--prompt-len", "32",
            "--gen-len", "32", "--requests", "2", "--device", "cuda"]
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
    print(f"[serve] launches {counts}", flush=True)
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
    launches = counts["flash_attention"]
    dec = decode_over(model, params, toks, model.init_cache(b, s, dev))
    a, w = dec.float(), pre.float()
    rel = float((a - w).abs().max()) / max(float(w.abs().max()), 1.0)
    same = torch.equal(a.argmax(-1), w.argmax(-1))
    print(f"[consistency] full width, prompt {s} x batch {b}: prefill vs "
          f"decode max|d| / max(max|logits|, 1) = {rel:.4e} (bound 0.05); "
          f"argmax equal: {same}; flash launches in the prefill {launches}",
          flush=True)
    check(launches == model.cfg.n_layers, f"consistency: {launches} launches")
    check(rel < 0.05, f"prefill and decode logits differ: {rel}")
    check(same, "prefill and decode pick different greedy tokens")
    return counts, {"rel": rel, "argmax_equal": same}


def serve_small_cuda_vs_cpu(dev):
    """The smoke decoder in float32 with the flash kernel: prefill of 200
    tokens and 8 decode steps on the card against the same on the CPU
    (the plain version), within 1e-5 of the largest logit."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32", attn_impl="chunked")
    model = Model(cfg)
    params = model.init(1, 1, "cpu")
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (1, 2, 200), generator=gen)
    follow = torch.randint(0, cfg.vocab_size, (1, 2, 8), generator=gen)
    runs = {}
    for device in (dev, torch.device("cpu")):
        p = {k: v.to(device) for k, v in params.items()}
        logits, pre = model.prefill(p, prompt.to(device))
        cache = model.init_cache(2, 208, device)
        for name in ("k", "v"):
            cache[name][:, :, :, :200] = pre[name]
        out = [logits]
        for t in range(8):
            pos = torch.full((2,), 200 + t, dtype=torch.long, device=device)
            lg, cache = model.decode_step(p, follow[:, :, t:t + 1].to(device),
                                          cache, pos)
            out.append(lg)
        runs[device.type] = torch.cat(out, dim=2).cpu()
    d = float((runs["cuda"] - runs["cpu"]).abs().max())
    top = max(float(runs["cpu"].abs().max()), 1.0)
    print(f"[small] smoke f32 chunked: prefill 200 + 8 decode steps, CUDA vs "
          f"CPU max|d| = {d:.3e} (max |logit| {top:.3f})", flush=True)
    check(d <= 1e-5 * top, f"CUDA and CPU serving logits differ by {d}")


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
    with concurrent.futures.ThreadPoolExecutor(len(build.LIBRARIES)) as pool:
        built = list(pool.map(build.build, build.LIBRARIES))
    for name in build.LIBRARIES:
        build.load_library(name)
    print(f"[build] {', '.join(p.name for p, _ in built)} in "
          f"{time.perf_counter() - t0:.1f}s (one nvcc per source, in parallel)",
          flush=True)
    for _, log in built:
        for line in log.splitlines():
            print(f"[build] {line}", flush=True)
    check_flash_sass(build.library_path("flash_tc"))

    from repro_torch.comm.packing import leaf_route, make_bucket_spec
    from repro_torch.configs.qwen3_1_7b import CONFIG
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    shapes = param_shapes(cfg)
    spec = make_bucket_spec([torch.empty(s, device="meta") for _, s in shapes],
                            routes=[leaf_route(p) for p, _ in shapes])
    lengths = sorted({b.size for b in spec.buckets}, reverse=True) + [ODD_LENGTH]
    print(f"[kernel] checking the full-width bucket lengths and an odd one: "
          f"{lengths}", flush=True)
    records, max_err = check_kernels(lengths, dev)
    probe_record = check_probe(dev)

    topk_record, topk_err = check_topk(dev)
    topk_selection_cuda_vs_cpu(dev)
    ops_counts = topk_ops_path(dev)
    by_path = {c: train_full_width(c, dev) for c in TRAIN_COMPRESSORS}
    # the slice's own path: the top_k cell with only the graph changed
    star_counts, star = train_full_width("top_k", dev, topology="star")
    ring_run = by_path["top_k"][1]
    print(f"[topology] star against the ring, top_k 0.01, full width: "
          f"ms/step {star['ms_per_step']} against {ring_run['ms_per_step']} "
          f"(first step included); peak device memory {star['peak_gib']:.3f} "
          f"against {ring_run['peak_gib']:.3f} GiB", flush=True)
    modes = modes_full_width(dev)
    launcher_counts = {label: run_launcher(extra)
                       for label, extra in LAUNCHER_RUNS}
    per_rank_launcher_counts = run_launcher_per_rank()
    small = small_cuda_vs_cpu(dev)
    torch.cuda.empty_cache()
    dist_small_report = dist_small(dev)
    torch.cuda.empty_cache()
    dist_full = dist_full_width(by_path[DIST_FULL[0]][1])
    torch.cuda.empty_cache()
    plain_bytes = exact_wire_bytes("plain", "ring", 1, 0, spec)[0]
    top_k_bytes = dist_full["ranks"][0]["wire_bytes"][-1]
    print(f"[dist] computed, not measured: the per-rank plain mode (exact "
          f"D-SGD) at full width on the ring would send {plain_bytes} bytes "
          f"per rank per step (2 sends x 4 B x "
          f"{sum(b.size for b in spec.buckets)} padded elements), "
          f"{plain_bytes / top_k_bytes:.1f}x the {top_k_bytes} that top_k "
          f"0.01 sent per rank per step above", flush=True)
    sim = {"gossip": sim_gossip(dev), "sgd": sim_sgd(dev)}
    sim_counts = {k: sum(r["launches"][k] for part in sim.values()
                         for r in part.values() if isinstance(r, dict))
                  for k in kernel_names()}

    flash_record, flash_err = check_flash(dev)
    model, params = full_width_serving_model(dev)
    prefill_counts, prefill = prefill_full_width(model, params, dev)
    consistency_counts, consistency = consistency_full_width(model, params,
                                                             dev)
    decode = profile_decode(model, params, dev)
    del model, params
    torch.cuda.empty_cache()
    serve_counts, serve = serve_full_width()
    serve_small_cuda_vs_cpu(dev)
    budget = prefill_budget(dev)

    # launches of each kernel on every path this script drives (the counts
    # set to 0 just before each path and read just after); the per-rank
    # engine's runs summed over the ranks
    paths = {
        **{c: counts for c, (counts, _) in by_path.items()},
        "topology_star": star_counts,
        **{f"modes_{label}": counts for label, (counts, _) in modes.items()},
        **launcher_counts,
        "launcher_per_rank_rank0": per_rank_launcher_counts,
        "small": small["launches"],
        "dist_small": {k: sum(c[k] for c in dist_small_report["launches"])
                       for k in kernel_names()},
        "dist_small_exact_modes": {
            k: sum(c[k] for c in dist_small_report["exact_launches"])
            for k in kernel_names()},
        "dist_full_width": {k: sum(r["launches"][k] for r in dist_full["ranks"])
                            for k in kernel_names()},
        "sim": sim_counts, "topk_ops": ops_counts, "prefill": prefill_counts,
        "consistency": consistency_counts,
        "serve": serve_counts}
    by_kernel = lambda name: {p: c[name] for p, c in paths.items()}
    # the training paths whose launches count as the gossip kernels' main
    # path: the four compressors, star and the [modes] runs
    train_paths = (list(by_path) + ["topology_star"]
                   + [f"modes_{label}" for label in modes])

    sources = {"qsgd_codes": "src/repro/kernels/qsgd.py:64",
               "sign_codes": "src/repro/kernels/qsgd.py:86",
               "dequantize": "src/repro/kernels/qsgd.py:118",
               "ef_update": "src/repro/kernels/ef_update.py:52"}
    kernels = []
    for name, replaces in sources.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_kernels.cu",
            "replaces": replaces,
            "launches": sum(paths[p][name] for p in train_paths),
            "launches_by_path": by_kernel(name),
            "max_abs_err": max(v for k, v in max_err.items()
                               if k.startswith(name)),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"]})
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        # the bf16 tensor-core kernel, the main path's; f32 inputs take the
        # CUDA-core kernel of csrc/flash_attention.cu (its record: "f32")
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": prefill_counts["flash_attention"],
        "launches_by_path": by_kernel("flash_attention"),
        "max_abs_err": flash_err, **flash_record})
    check(kernels[-1]["launches"] > 0, "flash_attention never launched")
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
                      "modes": {k: r for k, (_, r) in modes.items()},
                      "sim": sim, "small": small,
                      "prefill": prefill, "serve": serve, "decode": decode,
                      "consistency": consistency,
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
