"""Serving launcher of the port: a greedy decode loop against a KV cache on
one device.

    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu

Flag names, defaults and the loop are the JAX launcher's
(``repro.launch.serve``): per request a fresh cache, the prompt
teacher-forced through ``Model.decode_step`` one token at a time, then
greedy ``argmax`` decoding.  Latency is reported per request: TTFT
(prompt ingest plus the first generated token, blocked on the token)
p50/p99 across ``--requests``, and per-token time p50/p99 across every
later generated token.  The weights are random, drawn from seed 0 and
cast once to the compute dtype; ``--seed`` draws the prompts from a
``torch.Generator``.

``--device`` (default cuda) picks the device; without CUDA the launcher
raises unless it is given ``--device cpu``.  Refused before torch is
imported: ``--mesh`` and ``--simulate-devices`` (one device),
``--kv-layout seq`` (a sharding choice with nothing to shard on one
device), ``--metrics-dir`` (the telemetry sinks are not ported),
hubert-xlarge (an encoder: it has no decode step, as the JAX launcher
says) and every other architecture but the dense decoders, qwen3-1.7b,
gemma2-9b (local and global layers, its local caches ring buffers of the
4096-token window), gemma-7b and yi-9b, llava-next-mistral-7b, whose
text prompts are served as the JAX launcher serves them (no image: the
prompt is teacher-forced through ``decode_step``), and the MoE decoders
qwen3-moe-30b-a3b and llama4-maverick-400b-a17b (llama4 at full width
does not fit one card: serve it with ``--smoke``).
"""
import argparse
import json
import sys
import time

# torch-free: argument validation runs before torch is imported
from repro_torch.obs.timers import percentile

ARCH_CHOICES = ("qwen3-1.7b", "gemma2-9b", "gemma-7b", "yi-9b",
                "llava-next-mistral-7b", "qwen3-moe-30b-a3b",
                "llama4-maverick-400b-a17b")
#: the encoder-only archs: ported, but with nothing to decode
ENCODER_ARCHS = ("hubert-xlarge",)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--kv-layout", default="head", choices=["head", "seq"])
    ap.add_argument("--requests", type=int, default=1,
                    help="decode requests to run (fresh cache each); "
                         "latency percentiles aggregate across them")
    ap.add_argument("--metrics-dir", default=None)
    ap.add_argument("--simulate-devices", type=int, default=0)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or, when asked, the CPU")
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the prompts' torch.Generator")
    return ap


def _validate(ap, args) -> None:
    if args.arch in ENCODER_ARCHS:
        ap.error(f"--arch {args.arch}: encoder-only arch has no decode step")
    if args.arch not in ARCH_CHOICES:
        ap.error(f"--arch {args.arch!r} is not ported; choose from "
                 f"{', '.join(ARCH_CHOICES)} (the decoders)")
    if args.mesh is not None:
        ap.error("--mesh is not supported by the port: it serves on one "
                 "device")
    if args.simulate_devices:
        ap.error("--simulate-devices is not supported by the port: it "
                 "serves on one device")
    if args.kv_layout != "head":
        ap.error(f"--kv-layout {args.kv_layout} is not supported by the "
                 f"port: a sharding choice, with nothing to shard on one "
                 f"device")
    if args.metrics_dir is not None:
        ap.error("--metrics-dir is not supported by the port: the telemetry "
                 "sinks are not ported")
    for flag in ("requests", "batch", "prompt_len", "gen_len"):
        if getattr(args, flag) < 1:
            ap.error(f"--{flag.replace('_', '-')} must be >= 1, got "
                     f"{getattr(args, flag)}")


def run_request(model, params, prompt, gen_len: int, sync):
    """One request: a fresh cache, the prompt (B, P) teacher-forced through
    ``decode_step``, then ``gen_len`` greedy tokens.  ``sync`` blocks until
    the device is done.  Returns (generated tokens (B, gen_len), TTFT in
    s, per-token times in s of the tokens after the first)."""
    import torch
    B, P = prompt.shape
    max_seq = P + gen_len
    cache = model.init_cache(B, max_seq, prompt.device)
    tok = prompt[:, :1]
    out, tok_times, ttft = [], [], None
    t0 = last = time.perf_counter()
    for t in range(max_seq - 1):
        pos = torch.full((B,), t, dtype=torch.long, device=prompt.device)
        logits, cache = model.decode_step(params, tok[None], cache, pos)
        nxt = torch.argmax(logits[0, :, -1], dim=-1)[:, None]
        tok = prompt[:, t + 1:t + 2] if t + 1 < P else nxt
        if t + 1 >= P:
            # block per generated token: per-token latency is the serving
            # metric, and asynchronous launches would hide it
            sync()
            now = time.perf_counter()
            if t + 1 == P:
                ttft = now - t0
            else:
                tok_times.append(now - last)
            last = now
            out.append(nxt)
    return torch.cat(out, dim=1), ttft, tok_times


def main(argv=None):
    """Command-line entry point: per request a greedy decode loop;
    reports TTFT and per-token latency percentiles, tok/s and the peak
    device memory."""
    ap = _parser()
    args = ap.parse_args(argv)
    _validate(ap, args)

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen_len
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    params = model.compute_params(model.init(1, 0, device))
    gen = torch.Generator().manual_seed(args.seed)

    ttfts, tok_times = [], []
    t_all = time.perf_counter()
    for _ in range(args.requests):
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen)
        _, ttft, times = run_request(model, params, prompt.to(device), G, sync)
        ttfts.append(ttft)
        tok_times.extend(times)
    dt = time.perf_counter() - t_all
    total_tok = B * G * args.requests
    summary = {"serve/ttft_p50_s": percentile(ttfts, 50),
               "serve/ttft_p99_s": percentile(ttfts, 99),
               "serve/throughput_tok_s": total_tok / dt}
    if tok_times:   # gen-len 1: TTFT is the only per-token sample
        summary["serve/tok_p50_s"] = percentile(tok_times, 50)
        summary["serve/tok_p99_s"] = percentile(tok_times, 99)
    print("[serve] " + " ".join(f"{k.split('/', 1)[1]} {v:.4f}"
                                for k, v in sorted(summary.items())),
          flush=True)
    print(f"[serve] arch={cfg.name} kv_layout={args.kv_layout} decoded "
          f"{G * args.requests}x{B} tokens in {dt:.2f}s "
          f"({total_tok / dt:.1f} tok/s)", flush=True)
    if on_cuda:
        summary["serve/peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[serve] peak device memory {summary['serve/peak_gib']:.3f} "
              f"GiB on {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print("[serve] peak device memory: not measured (cpu)", flush=True)
    print("[serve] summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
