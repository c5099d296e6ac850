#!/usr/bin/env python3
"""On-card check of the PyTorch port (``src/repro_torch``): run with

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA device.  It

1. builds the four hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   bucket lengths of the full-width run and at an odd length: QSGD codes
   (int8 and int16), sign codes and dequantize bit-equal, the EF update
   within 0 ulp (kernel and plain version round every operation
   separately), and times kernel, plain version, the bytes bound and,
   for dequantize, the one PyTorch call that computes the same function.
   QSGD is checked twice at each length: with inv_norm = 1/||x|| per node
   row, as the trainer calls it (codes of -1, 0 or 1 at these lengths),
   and with inv_norm = 0.999/max|x|, which reaches every level up to s;
3. trains qwen3-1.7b at its published widths, depth cut to 2 layers, 4
   nodes on a ring, through ``DecentralizedTrainer``, at the uncut
   model's launcher default of sequence 512 and batch 4 per node: 3 steps
   with QSGD (s=16) and 3 with SignNorm, checking finite losses and that
   each kernel launched steps x gossip_steps x buckets times on its path,
   then profiles one more step of each;
4. runs the launcher (``repro_torch.launch.train.main``) for a --smoke run;
5. holds a small float32 run on the card against the same run on the CPU
   (the plain versions), step by step;
6. prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA device, or without
the repository's ``src/`` beside it, it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
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
ODD_LENGTH = 1_000_003


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


def bound_ms(tensors_in, tensors_out, flops):
    """Least time for the work: the larger of bytes / HBM rate (each input
    read once, each output written once) and f32 flops / f32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors_in + tensors_out)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
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
        coef = (1 / 3, 1 / 3, 1.956e-05)
        outs = dispatch.ef_bucket_update(*ins, *coef)
        bound = bound_ms(ins, list(outs), 8 * x.numel())
        # the plain version row by row: elementwise, so the same numbers
        plain_row = lambda j: (lambda i: ref.ef_update_ref(
            *[t[i:i + 1] for t in ins], *coef)[j][0])
        compare("ef_update", [(o, plain_row(j)) for j, o in enumerate(outs)],
                length)
        del outs
        report("ef_update", length,
               time_ms(lambda: dispatch.ef_bucket_update(*ins, *coef), reps),
               time_ms(lambda: ref.ef_update_ref(*ins, *coef), reps), None,
               bound)
        del ins, x
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return records, max_err


def profile_step(tr, state, batch):
    """One more step under torch.profiler: device time by kernel, grouped
    into the port's kernels, matmuls and everything else."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        tr.step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: (getattr(e, "self_device_time_total", 0)
                        or getattr(e, "self_cuda_time_total", 0))
    kernels = [(dev_us(e) / 1e3, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        print("[profile] the profiler recorded no device time", flush=True)
        return None
    ours = ("qsgd_codes_kernel", "sign_codes_kernel", "dequantize_kernel",
            "ef_update_kernel")
    groups = {"port kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for ms, name in kernels:
        if any(k in name for k in ours):
            groups["port kernels"] += ms
        elif any(k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass",
                                             "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    print(f"[profile] one step: wall {wall:.1f} ms (profiled), device busy "
          f"{busy:.1f} ms; " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                          groups.items()), flush=True)
    for ms, name in sorted(kernels, reverse=True)[:12]:
        print(f"[profile] {ms:9.3f} ms  {name[:110]}", flush=True)
    return {"wall_ms": wall, "device_busy_ms": busy, **groups}


def train_full_width(compressor, dev):
    """Full-width qwen3-1.7b (2 layers), 4 nodes, ring: STEPS steps."""
    import torch
    from repro_torch.configs.base import ChocoConfig
    from repro_torch.configs.qwen3_1_7b import CONFIG
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model, count_params
    from repro_torch.optim.sgd import MomentumSGD, cosine_schedule
    from repro_torch.train.trainer import DecentralizedTrainer

    cfg = dataclasses.replace(CONFIG, n_layers=2)
    kw = (("s", 16),) if compressor == "qsgd" else ()
    torch.cuda.reset_peak_memory_stats()
    tr = DecentralizedTrainer(
        model=Model(cfg), choco=ChocoConfig(compressor=compressor, comp_kwargs=kw),
        n_nodes=N_NODES, optimizer=MomentumSGD(),
        lr_fn=cosine_schedule(0.1, warmup=STEPS // 10 + 1, total=STEPS),
        device=dev)
    state = tr.init_state(seed=0)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # the launcher's default sequence for the uncut 28-layer model
    seq = min(CONFIG.n_layers * 64, 512)
    batches = make_lm_batch_fn(cfg, seq, 4, N_NODES, 1.0)
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} seq={seq} batch=4 "
          f"params={count_params(cfg) / 1e6:.1f}M nodes={N_NODES} "
          f"compressor={compressor} buckets={tr.spec.n_buckets} "
          f"gamma={tr.gamma:.3e}", flush=True)
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
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    expected = STEPS * tr.choco.gossip_steps * tr.spec.n_buckets
    on_path = {"qsgd_codes": compressor == "qsgd",
               "sign_codes": compressor == "sign",
               "dequantize": True, "ef_update": True}
    for name, used in on_path.items():
        want = expected if used else 0
        print(f"[train] {compressor}: {name} launches {counts[name]} "
              f"(expected {STEPS} steps x {tr.choco.gossip_steps} gossip_steps "
              f"x {tr.spec.n_buckets} buckets = {want})", flush=True)
        check(counts[name] == want, f"{name}: {counts[name]} launches, "
              f"expected {want}")
    print(f"[train] {compressor}: losses {losses}; ms/step {step_ms} (first "
          f"step included); peak device memory {peak:.2f} GiB over the steps, "
          f"{init_peak:.2f} GiB at init", flush=True)
    profile = profile_step(tr, state, tr.batch_to_device(batches()))
    del state, tr
    torch.cuda.empty_cache()
    return counts, {"losses": losses, "ms_per_step": step_ms,
                    "peak_gib": peak, "init_peak_gib": init_peak,
                    "profile": profile}


def run_launcher():
    """The user's entry point, --smoke, on the card."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import main
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--mesh", f"{N_NODES}x1",
            "--compressor", "qsgd", "--qsgd-s", "16", "--steps", str(STEPS),
            "--device", "cuda"]
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
    want = STEPS * buckets
    check(counts["qsgd_codes"] == counts["dequantize"] == counts["ef_update"]
          == want and counts["sign_codes"] == 0,
          f"launcher launch counts {counts}, expected {want} each")
    print(f"[launcher] launches {counts}", flush=True)
    return counts


def small_cuda_vs_cpu(dev):
    """The smoke decoder in float32, SignNorm (deterministic), 3 steps on the
    card and on the CPU from the same weights: losses within 1e-5 relative
    and x within 1e-5 (summation order differs)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.models.transformer import Model
    from repro_torch.optim.sgd import MomentumSGD, cosine_schedule
    from repro_torch.train.trainer import DecentralizedTrainer

    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32")
    params = Model(cfg).init(N_NODES, torch.Generator().manual_seed(1), "cpu")
    runs = {}
    for device in (dev, "cpu"):
        tr = DecentralizedTrainer(
            model=Model(cfg), choco=ChocoConfig(compressor="sign"),
            n_nodes=N_NODES, optimizer=MomentumSGD(),
            lr_fn=cosine_schedule(0.1, 1, STEPS), device=device)
        state = tr.state_from_params(params)
        batches = make_lm_batch_fn(cfg, 128, 4, N_NODES, 1.0)
        losses = [tr.step(state, tr.batch_to_device(batches()))["loss"]
                  for _ in range(STEPS)]
        runs[str(device)] = (losses, [b.cpu() for b in state.x])
    (lc, xc), (lp, xp) = runs[str(dev)], runs["cpu"]
    dx = max(float((a - b).abs().max()) for a, b in zip(xc, xp))
    print(f"[small] smoke f32 sign, {STEPS} steps: CUDA losses {lc} vs CPU "
          f"{lp}; max |x_cuda - x_cpu| = {dx:.3e}", flush=True)
    check(np.allclose(lc, lp, rtol=1e-5, atol=0), "CUDA and CPU losses differ")
    check(dx <= 1e-5, f"CUDA and CPU iterates differ by {dx}")


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
    path, log = build.build()
    build.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f}s\n{log}",
          flush=True)

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

    by_path = {c: train_full_width(c, dev) for c in ("qsgd", "sign")}
    launcher_counts = run_launcher()
    small_cuda_vs_cpu(dev)

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
            "launches": sum(c[name] for c, _ in by_path.values()),
            "launches_by_path": {**{c: by_path[c][0][name] for c in by_path},
                                 "launcher_smoke": launcher_counts[name]},
            "max_abs_err": max(v for k, v in max_err.items()
                               if k.startswith(name)),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"]})
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
    extra = {k: records[k] for k in ("qsgd_codes_int16", "dequantize_int16")}
    train = {c: r for c, (_, r) in by_path.items()}
    print(json.dumps({"int16": extra, "train": train}), flush=True)
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
