"""Quickstart of the PyTorch port: CHOCO-Gossip average consensus.

25 simulated nodes on a ring agree on the mean of their vectors, with
exact gossip, with 8-bit QSGD and with top 1% sparsification, as
``examples/quickstart.py`` runs them in the JAX package.  x0 and QSGD's
dither come from CPU ``torch.Generator``s (seed 0), so a run on the card
and a run on the CPU start from the same numbers; on the card QSGD runs
through the port's codes and dequantize kernels.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.baselines import run_gossip_baseline
from repro_torch.core.choco_gossip import run_choco_gossip
from repro_torch.core.compression import QSGD, TopK
from repro_torch.core.topology import ring


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or, when asked, the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu")
    dev = torch.device(args.device)
    n, d = 25, 2000
    topo = ring(n)
    x0 = torch.randn((n, d), generator=torch.Generator().manual_seed(0)).to(dev)
    print(f"ring(n={n}): spectral gap delta={topo.delta:.4f}; device {dev}")

    t0 = time.perf_counter()
    _, err = run_gossip_baseline("exact", x0, topo.W, None, 300)
    print(f"[exact  ] err: {err[0]:.2e} -> {err[-1]:.2e}  (32*d bits/msg; "
          f"{time.perf_counter() - t0:.2f} s)")

    comp = QSGD(127)
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    _, err = run_choco_gossip(x0, topo.W, 1.0, comp, 300,
                              draws=lambda t: comp.draw(x0, gen))
    print(f"[qsgd   ] err: {err[0]:.2e} -> {err[-1]:.2e}  "
          f"({comp.wire_bits(d) / d:.1f} bits/coord; "
          f"{time.perf_counter() - t0:.2f} s)")

    comp = TopK(fraction=0.01)
    t0 = time.perf_counter()
    _, err = run_choco_gossip(x0, topo.W, 0.046, comp, 3000)
    print(f"[top 1% ] err: {err[0]:.2e} -> {err[-1]:.2e}  "
          f"(~{100 * comp.omega(d):.0f}% of coords/msg; "
          f"{time.perf_counter() - t0:.2f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
