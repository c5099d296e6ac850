"""Training launcher of the port: CHOCO-SGD with all gossip nodes on one GPU.

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --mesh 4x1 \\
        --compressor qsgd --qsgd-s 16 --steps 3

Flag names are the JAX launcher's (``repro.launch.train``).  ``--mesh Nx1``
gives the node count; the port stacks the N nodes on one device, so a
model extent above 1 is refused.  Every flag outside the ported slice is
refused with a message, before torch is imported.  ``--device`` (default
cuda) picks the device; without CUDA the launcher raises unless it is
given ``--device cpu``.
"""
import argparse
import sys
import time

# torch-free: argument validation runs before torch is imported
from repro_torch.configs.base import parse_topology

ARCH_CHOICES = ("qwen3-1.7b",)
COMPRESSOR_CHOICES = ("qsgd", "sign")

#: flags of the JAX launcher whose features the port does not have:
#: given any value other than the default, the launcher refuses them
_REFUSED = {
    "topology_process": ("none", "stochastic topology processes"),
    "edge_drop_prob": (None, "link-failure processes"),
    "matching_sampler": (None, "matching processes"),
    "max_staleness": (None, "bounded-staleness gossip"),
    "straggler_edges": (None, "straggler links"),
    "straggler_delay_probs": (None, "straggler links"),
    "pipeline_gossip": (False, "the pipelined gossip engine"),
    "state_dtype": ("float32", "bf16 / non-f32 error-feedback state"),
    "gossip_engine": ("packed", "the per-leaf gossip engine"),
    "exact_small_leaves": (False, "the uncompressed small-leaf bucket"),
    "kernel_backend": (None, "a kernel-backend switch (the route follows "
                             "the tensor's device: --device)"),
    "optimizer": ("momentum", "optimizers other than momentum"),
    "data_skew_alpha": (None, "Dirichlet data skew"),
    "checkpoint_dir": (None, "checkpoints"),
    "checkpoint_every": (0, "checkpoints"),
    "keep_checkpoints": (None, "checkpoints"),
    "resume": (None, "checkpoints"),
    "elastic_warmup_rounds": (None, "elastic restore"),
    "simulate_devices": (0, "simulated host devices (the nodes are "
                            "stacked on one device)"),
    "metrics_dir": (None, "the telemetry sinks"),
    "diag_every": (0, "the Lyapunov diagnostics"),
    "divergence_action": (None, "the Lyapunov diagnostics"),
    "profile_dir": (None, "the profiler session"),
    "profile_steps": (None, "the profiler session"),
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch-per-node", type=int, default=None)
    ap.add_argument("--mode", default="choco",
                    choices=["choco", "plain", "allreduce", "pushsum"])
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--topology-process", default="none")
    ap.add_argument("--edge-drop-prob", type=float, default=None)
    ap.add_argument("--matching-sampler", default=None)
    ap.add_argument("--max-staleness", type=int, default=None)
    ap.add_argument("--straggler-edges", default=None)
    ap.add_argument("--straggler-delay-probs", default=None)
    ap.add_argument("--pipeline-gossip", action="store_true")
    ap.add_argument("--gossip-steps", type=int, default=1,
                    help="CHOCO gossip rounds per SGD step")
    ap.add_argument("--compressor", default="top_k",
                    help=f"one of {', '.join(COMPRESSOR_CHOICES)}")
    ap.add_argument("--fraction", type=float, default=0.01,
                    help="coordinate fraction of the sparsifiers (not ported)")
    ap.add_argument("--qsgd-s", type=int, default=None,
                    help="quantization levels (required with --compressor qsgd)")
    ap.add_argument("--state-dtype", default="float32")
    ap.add_argument("--gossip-engine", default="packed")
    ap.add_argument("--kernel-backend", default=None)
    ap.add_argument("--exact-small-leaves", action="store_true")
    ap.add_argument("--optimizer", default="momentum")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--heterogeneity", type=float, default=1.0)
    ap.add_argument("--data-skew-alpha", type=float, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--keep-checkpoints", type=int, default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--elastic-warmup-rounds", type=int, default=None)
    ap.add_argument("--simulate-devices", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="Nx1: N gossip nodes, model extent 1 (required)")
    ap.add_argument("--metrics-dir", default=None)
    ap.add_argument("--diag-every", type=int, default=0)
    ap.add_argument("--divergence-action", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--profile-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or, when asked, the CPU")
    return ap


def _validate(ap, args) -> int:
    """Fail fast on anything outside the slice; returns the node count."""
    if args.arch not in ARCH_CHOICES:
        ap.error(f"--arch {args.arch!r} is not ported; choose from "
                 f"{', '.join(ARCH_CHOICES)}")
    for dest, (default, what) in _REFUSED.items():
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            ap.error(f"{flag} is not supported by the port: {what} is not "
                     f"ported")
    if args.mode != "choco":
        ap.error(f"--mode {args.mode} is not ported; the port runs --mode choco")
    if parse_topology(args.topology) != ("ring",):
        ap.error(f"--topology {args.topology!r} is not ported; the port has "
                 f"only a static ring")
    if args.gossip_steps < 1:
        ap.error("--gossip-steps must be >= 1")
    if args.compressor not in COMPRESSOR_CHOICES:
        ap.error(f"--compressor {args.compressor} is not ported; choose from "
                 f"{', '.join(COMPRESSOR_CHOICES)}")
    if args.compressor == "qsgd" and args.qsgd_s is None:
        ap.error("--compressor qsgd requires --qsgd-s (quantization levels)")
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.mesh is None:
        ap.error("--mesh Nx1 is required: the N gossip nodes are stacked on "
                 "one device")
    dims = args.mesh.split("x")
    if len(dims) != 2 or not all(d.isdigit() for d in dims):
        ap.error(f"--mesh {args.mesh!r}: expected Nx1 (a pod axis is not "
                 f"ported)")
    n, model = int(dims[0]), int(dims[1])
    if model != 1:
        ap.error(f"--mesh {args.mesh}: model extent {model} > 1 is not "
                 f"ported (tensor parallelism); use {n}x1")
    if n < 1:
        ap.error("--mesh: need at least one node")
    return n


def main(argv=None):
    """Command-line entry point: validate the flags torch-free, then train."""
    ap = _parser()
    args = ap.parse_args(argv)
    n_nodes = _validate(ap, args)

    import torch
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.models.transformer import Model, count_params
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer, resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    comp_kwargs = (("s", args.qsgd_s),) if args.compressor == "qsgd" else ()
    trainer = DecentralizedTrainer(
        model=Model(cfg),
        choco=ChocoConfig(compressor=args.compressor, comp_kwargs=comp_kwargs,
                          topology=args.topology,
                          gossip_steps=args.gossip_steps),
        n_nodes=n_nodes, optimizer=make_optimizer(args.optimizer),
        lr_fn=cosine_schedule(args.lr, warmup=min(100, args.steps // 10 + 1),
                              total=args.steps),
        device=device)
    print(f"[train] arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
          f"nodes={n_nodes} device={device} mode={args.mode} "
          f"topology={args.topology} gossip_steps={args.gossip_steps} "
          f"compressor={args.compressor} buckets={trainer.spec.n_buckets} "
          f"gamma={trainer.gamma:.3e}", flush=True)

    state = trainer.init_state(seed=0)
    seq = args.seq_len or min(cfg.n_layers * 64, 512)
    bpn = args.batch_per_node or 4
    next_batch = make_lm_batch_fn(cfg, seq, bpn, n_nodes, args.heterogeneity)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    last_t, last_i = time.perf_counter(), 0
    for i in range(args.steps):
        mets = trainer.step(state, trainer.batch_to_device(next_batch()))
        if i == 0 or i % 10 == 0 or i == args.steps - 1:
            sync()
            now = time.perf_counter()
            per = (now - last_t) / max(i + 1 - last_i, 1)
            tail = f"first step {per:.2f}s" if i == 0 else f"{per:.2f}s/step"
            print(f"[train] step {state.step:5d} loss {mets['loss']:.4f} "
                  f"lr {mets['lr']:.4f} ({tail})", flush=True)
            last_t, last_i = now, i + 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
