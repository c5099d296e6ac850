"""Training launcher of the port: CHOCO-SGD and its exact baselines
(``--mode plain``, D-SGD; ``--mode allreduce``) on n gossip nodes.

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --mesh 4x1 \\
        --compressor top_k --fraction 0.05 --steps 3

Flag names are the JAX launcher's (``repro.launch.train``).  ``--mesh Nx1``
gives the node count N (by default one node per ``--simulate-devices`` or
torchrun rank, else 16, the gossip nodes of the JAX launcher's default
production mesh); a model extent above 1 is refused.  Two engines:

* by default the N nodes are stacked on one device (the stacked engine);
* with ``--simulate-devices N`` (the counterpart of the JAX launcher's
  simulated host devices) the launcher spawns N processes, one gossip node
  each, and under ``torchrun --nproc-per-node N`` each process is one node
  (the per-rank engine, ``launch/mesh.py`` says which transport).

``--topology-process matching|linkfail|staleness`` runs the gossip under
a stochastic topology process (``comm/stochastic.py``; ``--matching-sampler
uniform|weighted``, ``--edge-drop-prob P``; ``--max-staleness TAU``,
``--straggler-edges 0-1,2-3``, ``--straggler-delay-probs P0,..,PTAU``,
bounded staleness under ``--mode choco`` only), the header printing the
process and its expected (delta, beta).
Spawned ranks on ``--device cpu`` run on one thread each
(``CPU_RANK_ENV``), as the stacked run's bit-equal twin.
``--optimizer sgd|momentum|adamw`` picks the local step and
``--data-skew-alpha`` Dirichlet(alpha) non-IID token shards.
``--mode pushsum`` runs directed push-sum gossip (``--topology
directed_ring|random_digraph``, or a symmetric graph; the packed engine
only).
``--gossip-engine per-leaf`` runs the per-leaf gossip engine (one payload
per leaf) instead of the packed one, and ``--pipeline-gossip`` the
pipelined engine (the exchange on the pre-gradient iterate, on a side
CUDA stream beside the backward pass on the stacked engine); both refuse
what the JAX launcher refuses.

Checkpoints are the JAX launcher's: ``--checkpoint-dir D
--checkpoint-every K`` saves a sharded checkpoint (``checkpoint/``) to
``D/step<N>`` every K steps, ``--keep-checkpoints M`` keeps the newest M,
and ``--resume`` takes a checkpoint directory (the port's or the JAX
package's) or a legacy flat ``.npz``.  ``--steps`` is the total budget:
resuming a step-60 checkpoint with ``--steps 100`` trains 40 steps more,
the learning-rate schedule anchored at step 0, and the data stream starts
anew.  A checkpoint of another node count restores elastically (rows
tiled or averaged, x_hat and s zeroed, then a consensus warmup of
``--elastic-warmup-rounds`` rounds, by default the new graph's count).
The
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
from repro_torch.configs.base import (STATE_DTYPES, get_config,
                                      parse_delay_probs,
                                      parse_straggler_edges, parse_topology)
from repro_torch.core.topology import DIRECTED_TOPOLOGIES, TOPOLOGIES
from repro_torch.checkpoint.manifest import read_manifest
from repro_torch.launch.env import file_rendezvous, torchrun_rendezvous

#: the archs the launcher trains: the dense decoders and the frontends the
#: port serves (the MoE family's FFN has no training path yet)
ARCH_CHOICES = ("qwen3-1.7b", "gemma2-9b", "gemma-7b", "yi-9b",
                "hubert-xlarge", "llava-next-mistral-7b")
#: the MoE family, served but not trained
MOE_ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
#: the recurrent families (ssm, hybrid), served but not trained
SSM_ARCHS = ("zamba2-1.2b", "rwkv6-3b")
#: the compressors the JAX launcher can run (randomized_gossip takes p, not
#: --fraction: the JAX launcher fails on it, and this one refuses it)
COMPRESSOR_CHOICES = ("identity", "rand_k", "top_k", "block_top_k", "qsgd",
                      "sign")
#: ``optim/sgd.py:make_optimizer``'s names, checked before torch is imported
OPTIMIZER_CHOICES = ("sgd", "momentum", "adamw")
#: the JAX launcher's gossip engines
ENGINE_CHOICES = ("packed", "per-leaf")
#: the node count without ``--mesh``, ``--simulate-devices`` or torchrun:
#: the data extent of the JAX launcher's default, its production mesh
#: (``src/repro/launch/mesh.py:make_production_mesh``, data 16 x model 16;
#: the port's model extent is 1)
PRODUCTION_NODES = 16
#: the JAX launcher's ``--topology-process`` choices
PROCESS_CHOICES = ("none", "matching", "linkfail", "staleness")
#: the environment of a spawned CPU rank, set before its interpreter
#: starts: one OpenMP and one MKL thread (a CPU sum over more threads adds
#: in another order, and the stacked run takes one thread per node)
CPU_RANK_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "MKL_DYNAMIC": "FALSE", "OMP_DYNAMIC": "FALSE"}

#: flags of the JAX launcher whose features the port does not have:
#: given any value other than the default, the launcher refuses them
_REFUSED = {
    "kernel_backend": (None, "a kernel-backend switch (the route follows "
                             "the tensor's device: --device)"),
    "metrics_dir": (None, "the telemetry sinks"),
    "diag_every": (0, "the Lyapunov diagnostics"),
    "divergence_action": (None, "the Lyapunov diagnostics"),
    "profile_dir": (None, "the profiler session"),
    "profile_steps": (None, "the profiler session"),
}


def default_seq_len(cfg) -> int:
    """The sequence without ``--seq-len``: the JAX launcher's, 64 a layer
    up to 512."""
    return min(cfg.n_layers * 64, 512)


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
    ap.add_argument("--topology-process", default="none",
                    choices=list(PROCESS_CHOICES),
                    help="stochastic topology process: 'matching' samples "
                         "one schedule round per gossip round, 'linkfail' "
                         "drops each edge i.i.d. with --edge-drop-prob per "
                         "round, 'staleness' delivers each edge's payload "
                         "up to --max-staleness rounds late (--mode choco)")
    ap.add_argument("--edge-drop-prob", type=float, default=None,
                    help="Bernoulli link-failure probability in [0, 1) "
                         "(requires --topology-process linkfail)")
    ap.add_argument("--matching-sampler", default=None,
                    choices=["uniform", "weighted"],
                    help="round sampler for --topology-process matching "
                         "(default uniform)")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="staleness bound tau >= 0 for --topology-process "
                         "staleness: per-edge payload delays are sampled "
                         "uniformly from {0..tau} (default 1; tau=0 is the "
                         "always-fresh replica engine)")
    ap.add_argument("--straggler-edges", default=None,
                    help="comma-separated slow links ('0-1,2-3') whose "
                         "delays come from --straggler-delay-probs instead "
                         "of the uniform law (requires --topology-process "
                         "staleness; node pairs of the graph's edges)")
    ap.add_argument("--straggler-delay-probs", default=None,
                    help="comma-separated P(d=0..tau) of the straggler "
                         "links (--max-staleness + 1 entries); default the "
                         "point mass at tau, a maximally slow link")
    ap.add_argument("--pipeline-gossip", action="store_true")
    ap.add_argument("--gossip-steps", type=int, default=1,
                    help="CHOCO gossip rounds per SGD step")
    ap.add_argument("--compressor", default="top_k",
                    help=f"one of {', '.join(COMPRESSOR_CHOICES)}")
    ap.add_argument("--fraction", type=float, default=0.01,
                    help="coordinate fraction of rand_k, top_k and block_top_k")
    ap.add_argument("--qsgd-s", type=int, default=None,
                    help="quantization levels (required with --compressor qsgd)")
    ap.add_argument("--state-dtype", default="float32",
                    help=f"dtype of the EF states x_hat and s: "
                         f"{' or '.join(STATE_DTYPES)} (choco; the exact "
                         f"modes hold none)")
    ap.add_argument("--gossip-engine", default="packed")
    ap.add_argument("--kernel-backend", default=None)
    ap.add_argument("--exact-small-leaves", action="store_true")
    ap.add_argument("--optimizer", default="momentum")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--heterogeneity", type=float, default=1.0)
    ap.add_argument("--data-skew-alpha", type=float, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--keep-checkpoints", type=int, default=None,
                    help="retain only the newest K checkpoint dirs under "
                         "--checkpoint-dir (after each successful save; "
                         "never the step just saved)")
    ap.add_argument("--resume", default=None,
                    help="sharded checkpoint dir (manifest.json) or a legacy "
                         "flat .npz; --steps stays the TOTAL budget")
    ap.add_argument("--elastic-warmup-rounds", type=int, default=None,
                    help="CHOCO-GOSSIP warmup rounds after an elastic "
                         "restore (default: from the new graph's spectral "
                         "gap)")
    ap.add_argument("--simulate-devices", type=int, default=0,
                    help="spawn N processes, one gossip node each (N must "
                         "match --mesh Nx1)")
    ap.add_argument("--mesh", default=None,
                    help="Nx1: N gossip nodes, model extent 1 (default: "
                         "one node per --simulate-devices or torchrun rank, "
                         "else 16x1, the data extent of the JAX launcher's "
                         "production mesh)")
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
    if args.arch in MOE_ARCHS:
        ap.error(f"--arch {args.arch!r}: training the MoE family is not "
                 f"ported (ROADMAP §1.4); it is served only "
                 f"(repro_torch.launch.serve)")
    if args.arch in SSM_ARCHS:
        ap.error(f"--arch {args.arch!r}: training the SSM and hybrid "
                 f"families is not ported (ROADMAP §1.5: the WKV6 kernel "
                 f"has no backward); it is served only "
                 f"(repro_torch.launch.serve)")
    if args.arch not in ARCH_CHOICES:
        ap.error(f"--arch {args.arch!r} is not ported; choose from "
                 f"{', '.join(ARCH_CHOICES)}")
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "vlm":
        image = cfg.frontend.n_tokens
        seq = args.seq_len or default_seq_len(cfg)
        if seq - image - 1 < 1:
            ap.error(f"--seq-len {seq} leaves no text after {cfg.name}'s "
                     f"{image} image tokens (the batch's text takes S - "
                     f"{image} positions, S - {image} - 1 token steps); pass "
                     f"--seq-len {image + 2} or more")
    for dest, (default, what) in _REFUSED.items():
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            ap.error(f"{flag} is not supported by the port: {what} is not "
                     f"ported")
    if args.state_dtype not in STATE_DTYPES:
        ap.error(f"--state-dtype {args.state_dtype} is not supported by the "
                 f"port: the EF state is {' or '.join(STATE_DTYPES)}")
    if args.gossip_engine not in ENGINE_CHOICES:
        ap.error(f"--gossip-engine {args.gossip_engine!r}: choose from "
                 f"{', '.join(ENGINE_CHOICES)}")
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
        if name not in TOPOLOGIES:
            ap.error(f"--topology {name!r}: choose from "
                     f"{', '.join(TOPOLOGIES)}, or a comma-separated "
                     f"sequence of them")
    # directed graphs and push-sum: the JAX launcher's rules and wording
    # (src/repro/launch/train.py:217-236)
    if any(name in DIRECTED_TOPOLOGIES for name in names) \
            and args.mode != "pushsum":
        ap.error(f"--topology {args.topology!r} is directed "
                 f"(column-stochastic); --mode {args.mode} assumes a "
                 f"symmetric W. Directed graphs need the push-sum engine: "
                 f"--mode pushsum (de-biased x/w, comm/pushsum.py)")
    if args.mode == "pushsum":
        if len(names) > 1:
            ap.error("--mode pushsum runs one directed schedule; "
                     f"time-varying sequences are unsupported "
                     f"(got --topology {args.topology!r})")
        if args.topology_process != "none":
            ap.error("--mode pushsum owns its directed schedule; combining "
                     "it with --topology-process is unsupported")
        if args.gossip_engine != "packed":
            ap.error("--mode pushsum is packed-only (the weight scalar "
                     "rides in-band with the bucket payloads); drop "
                     "--gossip-engine per-leaf")
    if args.topology_process != "none":
        # the JAX launcher's combination rules
        # (src/repro/launch/train.py:237-258)
        if len(names) > 1:
            ap.error(f"--topology-process {args.topology_process} is itself "
                     f"the per-step mixing distribution; a time-varying "
                     f"--topology sequence ({args.topology!r}) is ambiguous")
        if args.mode == "allreduce":
            ap.error("--topology-process has no effect under --mode "
                     "allreduce (no gossip graph); drop one of the two")
    if args.edge_drop_prob is not None:
        if args.topology_process != "linkfail":
            ap.error("--edge-drop-prob only applies to --topology-process "
                     "linkfail")
        if not 0.0 <= args.edge_drop_prob < 1.0:
            ap.error(f"--edge-drop-prob must be in [0, 1), got "
                     f"{args.edge_drop_prob} (p = 1 never mixes)")
    if args.matching_sampler is not None \
            and args.topology_process != "matching":
        ap.error("--matching-sampler only applies to --topology-process "
                 "matching")
    # bounded staleness and its straggler links (the JAX launcher's rules,
    # src/repro/launch/train.py:259-291)
    if args.topology_process == "staleness" and args.mode != "choco":
        ap.error(f"--topology-process staleness requires --mode choco "
                 f"(got --mode {args.mode}): the async engine ring-buffers "
                 f"compressed increments, which only the choco engine ships")
    if args.max_staleness is not None:
        if args.topology_process != "staleness":
            ap.error("--max-staleness only applies to --topology-process "
                     "staleness")
        if args.max_staleness < 0:
            ap.error(f"--max-staleness must be >= 0, got "
                     f"{args.max_staleness}")
    if args.straggler_delay_probs is not None and args.straggler_edges is None:
        ap.error("--straggler-delay-probs names the straggler links' delay "
                 "distribution; it requires --straggler-edges")
    if args.straggler_edges is not None:
        if args.topology_process != "staleness":
            ap.error("--straggler-edges models per-edge DELAYS; it requires "
                     "--topology-process staleness")
        try:
            parse_straggler_edges(args.straggler_edges)
        except ValueError as e:
            ap.error(f"--straggler-edges: {e}")
        if args.straggler_delay_probs is not None:
            try:
                probs = parse_delay_probs(args.straggler_delay_probs)
            except ValueError as e:
                ap.error(f"--straggler-delay-probs: {e}")
            tau = args.max_staleness if args.max_staleness is not None else 1
            if len(probs) != tau + 1:
                ap.error(f"--straggler-delay-probs needs max_staleness + 1 "
                         f"= {tau + 1} entries (P(d=0..{tau})), got "
                         f"{len(probs)}")
    if args.pipeline_gossip:
        # the JAX launcher's rules (src/repro/launch/train.py:295-311)
        if args.mode != "choco":
            ap.error(f"--pipeline-gossip hides the COMPRESSED exchange "
                     f"behind the backward pass via the error-feedback "
                     f"carry; --mode {args.mode} has no (x_hat, s) state to "
                     f"double-buffer; it requires --mode choco")
        if args.topology_process != "none":
            ap.error(f"--pipeline-gossip is itself a deterministic delay-1 "
                     f"staleness process; stacking --topology-process "
                     f"{args.topology_process} on top compounds two delay "
                     f"models with no Theorem-2 gamma for the composite")
        if len(names) > 1:
            ap.error(f"--pipeline-gossip needs one static schedule: a "
                     f"payload compressed under graph W_k but integrated a "
                     f"step later under W_k+1 breaks the recursion (got "
                     f"--topology {args.topology!r})")
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
    if args.keep_checkpoints is not None:
        if args.keep_checkpoints < 1:
            ap.error(f"--keep-checkpoints must be >= 1, got "
                     f"{args.keep_checkpoints}")
        if not args.checkpoint_dir:
            ap.error("--keep-checkpoints requires --checkpoint-dir")
    rdv = torchrun_rendezvous()
    if args.mesh is None:
        # one node per spawned or torchrun rank, else the JAX launcher's
        # production mesh's gossip nodes
        n = (args.simulate_devices
             or (rdv.world_size if rdv else PRODUCTION_NODES))
        args.mesh = f"{n}x1"
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
    if args.resume:
        # before a restore, a warmup or a spawn: an exhausted budget exits
        _budget_check(args, _resume_step(args.resume))
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


def _is_sharded(path: str) -> bool:
    """A directory is always the sharded format (a torn save, without its
    manifest, fails as such, never as a missing .npz)."""
    return os.path.isdir(path)


def _resume_step(path: str) -> int:
    """The step of checkpoint ``path``: its manifest's, or the legacy
    npz's ``step`` leaf."""
    if _is_sharded(path):
        return read_manifest(path).step
    import numpy as np
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return int(z["step"])


def _budget_check(args, resumed: int) -> None:
    if resumed >= args.steps:
        raise SystemExit(
            f"[train] --steps {args.steps} is the TOTAL step budget, but "
            f"{args.resume} is already at step {resumed}: nothing to do "
            f"(raise --steps; the LR schedule stays anchored at step 0 "
            f"over the full budget)")


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
    # CPU ranks start on one thread each (CPU_RANK_ENV, set before their
    # interpreters start, then restored here); the card's ranks as they are
    env = CPU_RANK_ENV if args.device == "cpu" else {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
            spawn_ranks(_rank_main, n_nodes,
                        (args, n_nodes, os.path.join(tmp, "store")),
                        deadline_s=spawn_deadline_s(args.steps))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 0


def _rank_main(rank: int, args, n_nodes: int, store: str) -> None:
    """One spawned rank: join the group in the FileStore ``store``, train."""
    import torch
    from repro_torch.launch.mesh import close_node_group, make_node_group
    if args.device == "cpu":
        torch.set_num_threads(1)
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
    from repro_torch.configs.base import ChocoConfig
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
                          packed_gossip=args.gossip_engine == "packed",
                          pipeline_gossip=args.pipeline_gossip,
                          state_dtype=args.state_dtype,
                          data_skew_alpha=args.data_skew_alpha,
                          topology_process=(None if args.topology_process
                                            == "none"
                                            else args.topology_process),
                          edge_drop_prob=(0.1 if args.edge_drop_prob is None
                                          else args.edge_drop_prob),
                          matching_sampler=args.matching_sampler
                          or "uniform",
                          max_staleness=(1 if args.max_staleness is None
                                         else args.max_staleness),
                          straggler_edges=args.straggler_edges,
                          straggler_delay_probs=args.straggler_delay_probs),
        n_nodes=n_nodes, optimizer=make_optimizer(args.optimizer),
        lr_fn=cosine_schedule(args.lr, warmup=min(100, args.steps // 10 + 1),
                              total=args.steps),
        device=device, group=group, mode=args.mode)
    seq = args.seq_len or default_seq_len(cfg)
    bpn = args.batch_per_node or 4
    next_batch = make_lm_batch_fn(cfg, seq, bpn, n_nodes, args.heterogeneity,
                                  skew_alpha=trainer.choco.data_skew_alpha,
                                  node=None if group is None else group.rank)
    engine = "stacked" if group is None else "per-rank"
    compressor = (args.compressor if args.mode in ("choco", "pushsum")
                  else "none")
    skew = ("" if args.data_skew_alpha is None else
            f" data_skew_alpha={args.data_skew_alpha} "
            f"skew_tv={next_batch.skew_tv:.4f}")
    proc = trainer.process
    if proc is not None:
        delta, beta = proc.expected_delta_beta()
        detail = (f"sampler={proc.sampler}" if proc.kind == "matching"
                  else f"edge_drop_prob={proc.drop_prob}"
                  if proc.kind == "linkfail" else
                  f"max_staleness={proc.max_staleness} "
                  f"freshness={min(proc.edge_freshness):.4f} "
                  f"straggler_edges={args.straggler_edges}")
        skew += (f" process={proc.kind} {detail} expected_delta={delta:.4f} "
                 f"expected_beta={beta:.4f}")
    say(f"[train] arch={cfg.name} params={count_params(cfg) / 1e6:.1f}M "
        f"nodes={n_nodes} engine={engine} state_dtype={args.state_dtype} "
        f"device={device} mode={args.mode} "
        f"optimizer={args.optimizer} "
        f"topology={args.topology} gossip_steps={args.gossip_steps} "
        f"gossip_engine={args.gossip_engine}"
        f"{' pipelined' if args.pipeline_gossip else ''} "
        f"compressor={compressor} buckets={trainer.spec.n_buckets} "
        f"leaves={len(trainer.paths)} "
        f"exact_buckets={sum(b.exact for b in trainer.spec.buckets)} "
        f"gamma={trainer.gamma:.3e}{skew}", flush=True)
    if group is None:
        say("[train] engine stacked: the nodes are stacked on one device, "
            "a schedule round is an index gather", flush=True)
    else:
        say(f"[train] engine per-rank state_dtype={args.state_dtype}: one "
            f"process per node; transport {group.describe()}", flush=True)
        if args.mode in ("choco", "pushsum"):
            say(f"[train] probe {trainer.exchange.probe}", flush=True)

    state, resumed = _initial_state(args, trainer, n_nodes, say)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    last_t, last_i = time.perf_counter(), 0
    remaining = args.steps - resumed       # --steps is the total budget
    for i in range(remaining):
        mets = trainer.step(state, trainer.batch_to_device(next_batch()))
        if i == 0 or i % 10 == 0 or i == remaining - 1:
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
        if (args.checkpoint_dir and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0):
            path = os.path.join(args.checkpoint_dir, f"step{state.step}")
            trainer.save_checkpoint(path, state, metadata={"arch": cfg.name},
                                    keep_last=args.keep_checkpoints)
            say(f"[train] checkpointed {path}", flush=True)
    launched = {k: v - launched[k] for k, v in dispatch.launch_counts().items()}
    say(f"[train] kernel launches{'' if group is None else ' on rank 0'} "
        f"{json.dumps(launched)}", flush=True)
    return 0


def _initial_state(args, trainer, n_nodes: int, say):
    """(state, its step): a fresh state under seed 0, or ``--resume``'s,
    after the elastic warmup where the restore asks for one."""
    if not args.resume:
        return trainer.init_state(seed=0), 0
    if _is_sharded(args.resume):
        state, man, warmup = trainer.restore_checkpoint(args.resume)
        rounds = (args.elastic_warmup_rounds
                  if args.elastic_warmup_rounds is not None else warmup)
        if warmup and rounds:
            say(f"[train] elastic restore: checkpoint n_nodes={man.n_nodes} "
                f"topology={man.fingerprint.get('topology')} -> "
                f"n_nodes={n_nodes} topology={args.topology}; x_hat/s "
                f"re-zeroed, consensus warmup {rounds} CHOCO-GOSSIP rounds "
                f"(re-derived Theorem-2 gamma={trainer.gamma:.3e})",
                flush=True)
            trainer.consensus_warmup(state, rounds)
        resumed = man.step
    else:                                              # legacy flat npz
        state = trainer.restore_legacy(args.resume)
        resumed = state.step
    say(f"[train] resumed from {args.resume} at step {resumed}", flush=True)
    return state, resumed


if __name__ == "__main__":
    sys.exit(main())
