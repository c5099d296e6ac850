#!/usr/bin/env python3
"""Shows that ``chip_smoke.py``'s ``[sim]`` checks catch a wrong
compression on the card: run with

    python3 chip_sim_faults.py

from the root of a checkout, on a machine with one CUDA device.  It runs
the ``[sim]`` phase once as ``chip_smoke.py`` does (every check must
pass), then again with one fault at a time injected into the card's path
only (the CPU's plain versions stay sound), with the checks recording
instead of raising:

* ``dequantize_bf16_scale``: the dequantize kernel is given the row scale
  rounded to bf16 (a precision fault);
* ``codes_dither_plus_1e-3``: the QSGD codes kernel is given the dither
  plus 1e-3 (about one level in a thousand moves);
* ``topk_bf16_magnitudes``: the top-k selection ranks magnitudes rounded
  to bf16 (some selections move).

Each fault runs the ``[sim]`` runs it reaches (QSGD or top 1%, gossip and
SGD).  Prints the ``[sim]`` lines, one ``[fault]`` line per check that
caught a fault, and as its last line a JSON summary (per run: coordinates
moved, the largest relative differences round by round, the checks that
failed); exits 0 only if the sound run passed and every faulted run
failed at least one check.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_sim_faults: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import dispatch, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sound = {"gossip": chip_smoke.sim_gossip(dev),
             "sgd": chip_smoke.sim_sgd(dev)}

    codes, dequantize, topk_rows = (dispatch.qsgd_codes, dispatch.dequantize,
                                    ops.topk_rows)
    faults = {
        "dequantize_bf16_scale": ("qsgd", lambda: setattr(
            dispatch, "dequantize", lambda c, scale: dequantize(
                c, scale.bfloat16().float() if c.is_cuda else scale))),
        "codes_dither_plus_1e-3": ("qsgd", lambda: setattr(
            dispatch, "qsgd_codes", lambda x, xi, inv, s: codes(
                x, xi + 1e-3 if x.is_cuda else xi, inv, s))),
        "topk_bf16_magnitudes": ("top", lambda: setattr(
            ops, "topk_rows", lambda x, k: topk_rows(
                x.bfloat16().float() if x.is_cuda else x, k))),
    }
    caught = []

    def record(cond, msg):
        if not cond:
            caught.append(msg)
            print(f"[fault] caught: {msg}", flush=True)

    chip_smoke.check = record
    gossip_runs, sgd_runs = chip_smoke.SIM_GOSSIP_RUNS, chip_smoke.SIM_SGD_RUNS
    summary = {"sound": {
        label: {"moved": r.get("rounds_moved", r.get("steps_moved")),
                "max_rel": r.get("rounds_max_rel", r.get("steps_max_rel"))}
        for part in sound.values() for label, r in part.items()
        if isinstance(r, dict)}}
    ok = True
    for name, (runs, inject) in faults.items():
        dispatch.qsgd_codes, dispatch.dequantize, ops.topk_rows = (
            codes, dequantize, topk_rows)
        inject()
        caught.clear()
        chip_smoke.SIM_GOSSIP_RUNS = tuple(r for r in gossip_runs
                                           if r[0].startswith(runs))
        chip_smoke.SIM_SGD_RUNS = tuple(r for r in sgd_runs if runs in r[0])
        print(f"[fault] {name}", flush=True)
        got = {"gossip": chip_smoke.sim_gossip(dev),
               "sgd": chip_smoke.sim_sgd(dev)}
        runs_of = {label: {"moved": r.get("rounds_moved",
                                          r.get("steps_moved")),
                           "max_rel": r.get("rounds_max_rel",
                                            r.get("steps_max_rel")),
                           "caught": [m for m in caught
                                      if m.startswith(f"[sim] {label}:")]}
                   for part in got.values() for label, r in part.items()
                   if isinstance(r, dict)}
        summary[name] = runs_of
        ok = ok and all(r["caught"] for r in runs_of.values())
    print(json.dumps({"ok": ok, **summary}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
