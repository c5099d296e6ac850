"""Training launcher of the port: CHOCO-SGD and its exact baselines
(``--mode plain``, D-SGD; ``--mode allreduce``) on n gossip nodes.

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --mesh 4x1 \\
        --compressor top_k --fraction 0.05 --steps 3

Flag names are the JAX launcher's (``repro.launch.train``).  ``--mesh Nx1``
gives the node count N; a model extent above 1 is refused.  Two engines:

* by default the N nodes are stacked on one device (the stacked engine);
* with ``--simulate-devices N`` (the counterpart of the JAX launcher's
  simulated host devices) the launcher spawns N processes, one gossip node
  each, and under ``torchrun --nproc-per-node N`` each process is one node
  (the per-rank engine, ``launch/mesh.py`` says which transport).

``--optimizer sgd|momentum|adamw`` picks the local step and
``--data-skew-alpha`` Dirichlet(alpha) non-IID token shards.  The
launcher prints which engine runs, and for the per-rank engine the
transport and, under choco, the collective-layer probe's record (rank 0
prints).  Every flag outside the ported slice is refused with a message,
before torch is imported.  ``--device`` (default cuda) picks the device;
without CUDA the launcher raises unless it is given ``--device cpu``.
"""
import argparse
import json
import os
import sys
import tempfile
import time

# torch-free: argument validation runs before torch is imported
from repro_torch.configs.base import parse_topology
from repro_torch.core.topology import DIRECTED_TOPOLOGIES, SYMMETRIC_TOPOLOGIES
from repro_torch.launch.env import file_rendezvous, torchrun_rendezvous

ARCH_CHOICES = ("qwen3-1.7b",)
#: the compressors the JAX launcher can run (randomized_gossip takes p, not
#: --fraction: the JAX launcher fails on it, and this one refuses it)
COMPRESSOR_CHOICES = ("identity", "rand_k", "top_k", "block_top_k", "qsgd",
                      "sign")
#: ``optim/sgd.py:make_optimizer``'s names, checked before torch is imported
OPTIMIZER_CHOICES = ("sgd", "momentum", "adamw")

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
    "kernel_backend": (None, "a kernel-backend switch (the route follows "
                             "the tensor's device: --device)"),
    "checkpoint_dir": (None, "checkpoints"),
    "checkpoint_every": (0, "checkpoints"),
    "keep_checkpoints": (None, "checkpoints"),
    "resume": (None, "checkpoints"),
    "elastic_warmup_rounds": (None, "elastic restore"),
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
                    help="coordinate fraction of rand_k, top_k and block_top_k")
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
    ap.add_argument("--simulate-devices", type=int, default=0,
                    help="spawn N processes, one gossip node each (N must "
                         "match --mesh Nx1)")
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
    if args.mode == "pushsum":
        ap.error("--mode pushsum is not ported; the port runs --mode choco, "
                 "plain or allreduce")
    if args.optimizer not in OPTIMIZER_CHOICES:
        ap.error(f"--optimizer {args.optimizer!r}: choose from "
                 f"{', '.join(OPTIMIZER_CHOICES)}")
    if args.data_skew_alpha is not None and not args.data_skew_alpha > 0:
        ap.error(f"--data-skew-alpha must be > 0 (Dirichlet concentration), "
                 f"got {args.data_skew_alpha}")
    names = parse_topology(args.topology)
    if not names:
        ap.error("--topology: name at least one graph")
    for name in names:
        if name in DIRECTED_TOPOLOGIES:
            ap.error(f"--topology {name} is directed and needs --mode "
                     f"pushsum, which is not ported")
        if name not in SYMMETRIC_TOPOLOGIES:
            ap.error(f"--topology {name!r}: choose from "
                     f"{', '.join(SYMMETRIC_TOPOLOGIES)}, or a comma-separated "
                     f"sequence of them")
    if args.gossip_steps < 1:
        ap.error("--gossip-steps must be >= 1")
    if args.gossip_steps % len(names):
        ap.error(f"--topology {args.topology} is a sequence of {len(names)} "
                 f"graphs: --gossip-steps must be a multiple of "
                 f"{len(names)}, so every graph runs each step")
    if args.compressor == "randomized_gossip":
        ap.error("--compressor randomized_gossip takes a keep probability p, "
                 "not --fraction, so the launcher cannot run it (the JAX "
                 "launcher fails on it too); use ChocoConfig(compressor="
                 "\"randomized_gossip\", comp_kwargs=((\"p\", ...),))")
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
    rdv = torchrun_rendezvous()
    if args.simulate_devices:
        if rdv is not None:
            ap.error("--simulate-devices spawns the ranks itself; under "
                     "torchrun leave it out")
        if args.simulate_devices != n:
            ap.error(f"--simulate-devices {args.simulate_devices} must match "
                     f"--mesh {args.mesh}: one process per gossip node")
    if rdv is not None and rdv.world_size != n:
        ap.error(f"torchrun started {rdv.world_size} ranks for --mesh "
                 f"{args.mesh}: one rank per gossip node")
    return n


def main(argv=None):
    """Command-line entry point: validate the flags torch-free, then train
    on the engine the flags and the environment ask for."""
    ap = _parser()
    args = ap.parse_args(argv)
    n_nodes = _validate(ap, args)
    rdv = torchrun_rendezvous()
    if args.simulate_devices:
        return _spawn(args, n_nodes)
    if rdv is not None:
        from repro_torch.launch.mesh import close_node_group, make_node_group
        group = make_node_group(n_nodes, args.device, rdv)
        try:
            return _train(args, n_nodes, group)
        finally:
            close_node_group()
    return _train(args, n_nodes, None)


def spawn_deadline_s(steps: int) -> float:
    """How long the spawned ranks may run in all: one process-group
    timeout for set-up and one for each step.  A rank that dies stops the
    others at once; a rank blocked on a peer raises after one timeout, so
    a step that ran past a whole timeout has hung."""
    from repro_torch.launch.mesh import DEFAULT_TIMEOUT_S
    return DEFAULT_TIMEOUT_S * (steps + 1)


def _spawn(args, n_nodes: int) -> int:
    """Build the kernels once, then run one process per gossip node and
    wait for all of them; a rank that fails fails the launcher."""
    import concurrent.futures
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.train.trainer import resolve_device
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import build
        with concurrent.futures.ThreadPoolExecutor(len(build.LIBRARIES)) as ex:
            list(ex.map(build.build, build.LIBRARIES))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        spawn_ranks(_rank_main, n_nodes,
                    (args, n_nodes, os.path.join(tmp, "store")),
                    deadline_s=spawn_deadline_s(args.steps))
    return 0


def _rank_main(rank: int, args, n_nodes: int, store: str) -> None:
    """One spawned rank: join the group in the FileStore ``store``, train."""
    import torch
    from repro_torch.launch.mesh import close_node_group, make_node_group
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_nodes))
    group = make_node_group(n_nodes, args.device,
                            file_rendezvous(store, rank, n_nodes))
    try:
        _train(args, n_nodes, group)
    finally:
        close_node_group()


def _train(args, n_nodes: int, group) -> int:
    """Train ``args.steps`` steps: all nodes here (``group`` None) or this
    rank's node.  Only the stacked run or rank 0 prints."""
    import torch
    from repro_torch.configs.base import ChocoConfig, get_config
    from repro_torch.data.synthetic import make_lm_batch_fn
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer import Model, count_params
    from repro_torch.optim.sgd import cosine_schedule, make_optimizer
    from repro_torch.train.trainer import DecentralizedTrainer, resolve_device

    device = resolve_device(args.device) if group is None else group.device
    say = print if group is None or group.rank == 0 else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    launched = dispatch.launch_counts()
    if args.compressor == "qsgd":
        comp_kwargs = (("s", args.qsgd_s),)
    elif args.compressor in ("sign", "identity"):
        comp_kwargs = ()
    else:
        comp_kwargs = (("fraction", args.fraction),)
    trainer = DecentralizedTrainer(
        model=Model(cfg),
        choco=ChocoConfig(compressor=args.compressor, comp_kwargs=comp_kwargs,
                          topology=args.topology,
                          gossip_steps=args.gossip_steps,
                          exact_small_leaves=args.exact_small_leaves,
                          data_skew_alpha=args.data_skew_alpha),
        n_nodes=n_nodes, optimizer=make_optimizer(args.optimizer),
        lr_fn=cosine_schedule(args.lr, warmup=min(100, args.steps // 10 + 1),
                              total=args.steps),
        device=device, group=group, mode=args.mode)
    seq = args.seq_len or min(cfg.n_layers * 64, 512)
    bpn = args.batch_per_node or 4
    next_batch = make_lm_batch_fn(cfg, seq, bpn, n_nodes, args.heterogeneity,
                                  skew_alpha=trainer.choco.data_skew_alpha,
                                  node=None if group is None else group.rank)
    engine = "stacked" if group is None else "per-rank"
    compressor = args.compressor if args.mode == "choco" else "none"
    skew = ("" if args.data_skew_alpha is None else
            f" data_skew_alpha={args.data_skew_alpha} "
            f"skew_tv={next_batch.skew_tv:.4f}")
    say(f"[train] arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
        f"nodes={n_nodes} engine={engine} device={device} mode={args.mode} "
        f"optimizer={args.optimizer} "
        f"topology={args.topology} gossip_steps={args.gossip_steps} "
        f"compressor={compressor} buckets={trainer.spec.n_buckets} "
        f"exact_buckets={sum(b.exact for b in trainer.spec.buckets)} "
        f"gamma={trainer.gamma:.3e}{skew}", flush=True)
    if group is None:
        say("[train] engine stacked: the nodes are stacked on one device, "
            "a schedule round is an index gather", flush=True)
    else:
        say(f"[train] engine per-rank: one process per node; transport "
            f"{group.describe()}", flush=True)
        if args.mode == "choco":
            say(f"[train] probe {trainer.exchange.probe}", flush=True)

    state = trainer.init_state(seed=0)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    last_t, last_i = time.perf_counter(), 0
    for i in range(args.steps):
        mets = trainer.step(state, trainer.batch_to_device(next_batch()))
        if i == 0 or i % 10 == 0 or i == args.steps - 1:
            sync()
            now = time.perf_counter()
            per = (now - last_t) / max(i + 1 - last_i, 1)
            tail = f"first step {per:.2f}s" if i == 0 else f"{per:.2f}s/step"
            wire = ("" if group is None else
                    f" wire {mets['wire_bytes']} B sent by rank 0"
                    if args.mode != "allreduce" else
                    f" wire {mets['wire_bytes_modelled']} B modelled for "
                    f"rank 0 (a ring all-reduce; not counted)")
            say(f"[train] step {state.step:5d} loss {mets['loss']:.4f} "
                f"lr {mets['lr']:.4f} ({tail}){wire}", flush=True)
            last_t, last_i = now, i + 1
    launched = {k: v - launched[k] for k, v in dispatch.launch_counts().items()}
    say(f"[train] kernel launches{'' if group is None else ' on rank 0'} "
        f"{json.dumps(launched)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
