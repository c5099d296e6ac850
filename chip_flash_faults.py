#!/usr/bin/env python3
"""Shows that the flash-attention contracts catch a faulted kernel: run
with

    python3 chip_flash_faults.py

from the root of a checkout, on a machine with one CUDA device.  It
builds the tensor-core kernel (``csrc/flash_attention_sm90.cu``) as it is
and three more times with one fault each, written at run time from the
source into the build directory (no faulted source is kept):

* ``trunc_p``: P truncated to bf16 instead of rounded to nearest even;
* ``skip_alpha``: the running output not rescaled by alpha on a tile's
  key block 1 (its second block, after the window's first);
* ``stale_last``: the last key block's K and V read from the previous
  block's stage of the ring (the Dh 32 to 128 tile: the Dh 256 tile has
  one K and one V slot, no ring);

builds the f32 3xTF32 kernel (``csrc/flash_attention.cu``) as it is and
three more times, the same way:

* ``one_term``: each product takes its big.big term only (1xTF32);
* ``two_term``: each product drops its small.big term (2xTF32);
* ``f32_skip_alpha``: the running output not rescaled by alpha on key
  block 1;

and makes the plain version once with a fault, for contract (b):

* ``plain_skip_alpha``: the plain version's running output not rescaled
  by alpha on key block 1.

The cases are ``chip_smoke.py``'s flash cases on the inputs it draws
(``FLASH_CASES``, ``FLASH_DH80_CASES``, ``FLASH_DH32_CASES``) and two of
its own (Dh 80 with a window): every instance of both kernels, each head
dim (32, 64, 80, 128, 256 in both dtypes; f32 Dh 256 is a kernel of its
own, whose Q K^T lines the f32 faults share and whose P V and rescale
lines they edit too) with and without a window.  On each bf16 case it
prints contract (a)'s readings of every kernel against the sound plain
version (max|d| / max|want|, share of elements more than one bf16 ulp
apart) and contract (b)'s reading of both
plain versions against the f32-P result, with the bounds of
``kernels/flash_attention.py``; on each f32 case, max|d| / max|out| of
every f32 kernel against the plain version (bound 1e-5).  Then, per
fault, the instances it reaches and in which of their cases it broke its
contract.  The last line is a JSON summary; it exits 0 only if the sound
kernels and plain version meet their contracts in every case and every
fault breaks its contract in at least one case of every instance it
reaches.
"""
import concurrent.futures
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

#: fault -> [(text of the sound source, its replacement), ...]; each key
#: block loop counts ``it`` (``j`` at Dh 256) from a tile's first block,
#: kb_lo (0 without a window), so "key block 1" is a tile's second block
SKIP_ALPHA_STAGED = (
    "      o[i] = __fadd_rn(__fmul_rn(o[i], alpha[(i >> 1) & 1]), pv[i]);",
    "      o[i] = __fadd_rn(it == 1 ? o[i] : __fmul_rn(o[i], alpha[(i >> 1) "
    "& 1]), pv[i]);")
KERNEL_FAULTS = {
    "trunc_p": [(
        "    p[i / 2] = pack_bf16(e0, e1);",
        "    p[i / 2] = (__float_as_uint(e0) >> 16) |\n"
        "               (__float_as_uint(e1) & 0xffff0000u);")],
    "skip_alpha": [
        SKIP_ALPHA_STAGED,
        ("      o_lo[i] = __fmul_rn(o_lo[i], alpha[(i >> 1) & 1]);\n"
         "      o_hi[i] = __fmul_rn(o_hi[i], alpha[(i >> 1) & 1]);\n",
         "      if (j != 1) {\n"
         "        o_lo[i] = __fmul_rn(o_lo[i], alpha[(i >> 1) & 1]);\n"
         "        o_hi[i] = __fmul_rn(o_hi[i], alpha[(i >> 1) & 1]);\n"
         "      }\n")],
    "stale_last": [(
        "    const int s = it % kStages;\n"
        "    mbar_wait(full(s), (it / kStages) & 1);\n",
        "    const int s0 = it % kStages;\n"
        "    mbar_wait(full(s0), (it / kStages) & 1);\n"
        "    const int s = (kb == n_k - 1 && it > 0) ? (it - 1) % kStages : s0;\n"),
        ("    mbar_arrive(empty(s));", "    mbar_arrive(empty(s0));")],
}
#: the head dims each bf16 fault reaches: stale_last faults the K/V ring
#: of the staged tile (Dh 32 to 128); the Dh 256 tile has one K and one V
#: slot and no ring to read stale
KERNEL_FAULT_DIMS = {"trunc_p": (32, 64, 80, 128, 256),
                     "skip_alpha": (32, 64, 80, 128, 256),
                     "stale_last": (32, 64, 80, 128)}
#: the same for the f32 kernel, (text, times it stands in the source): the
#: Q K^T lines are the same in the Dh 32-128 kernel and the Dh 256 one, the
#: P V lines differ (P from registers; P from shared memory at Dh 256)
F32_BIG_SMALL = (
    ("      wgmma_ss(s, dqb + qo, dks + ko);          // big . small\n", 2),
    ("      wgmma_rs(pv, pb, dvs + vo);               // big . small\n", 1),
    ("      wgmma_ss(pv, dpb + 2 * j, dvs + 2 * j);   // big . small\n", 1))
F32_SMALL_BIG = (
    ("      wgmma_ss(s, dqs + qo, dkb + ko);          // small . big\n", 2),
    ("      wgmma_rs(pv, pl, dvb + vo);               // small . big\n", 1),
    ("      wgmma_ss(pv, dps + 2 * j, dvb + 2 * j);   // small . big\n", 1))
F32_FAULTS = {
    "one_term": [(line, "", n) for line, n in F32_BIG_SMALL + F32_SMALL_BIG],
    "two_term": [(line, "", n) for line, n in F32_SMALL_BIG],
    # both f32 kernels rescale the output in the same line
    "f32_skip_alpha": [SKIP_ALPHA_STAGED + (2,)],
}
#: the f32 contract: max|d| / max|out| against the plain version
F32_RTOL = 1e-5
PLAIN_FAULT = (
    "        acc_new = acc[..., r0:r1, :] * alpha[..., None] + pv",
    "        acc_new = (acc[..., r0:r1, :] if k0 == FLASH_BLOCK\n"
    "                   else acc[..., r0:r1, :] * alpha[..., None]) + pv")


def edited(text, pairs, what="the source"):
    """``text`` with each (old, new) or (old, new, times) of ``pairs``
    replaced; raises unless ``old`` stands in it that many times (once by
    default)."""
    for i, (old, new, *times) in enumerate(pairs):
        want = times[0] if times else 1
        if text.count(old) != want:
            raise RuntimeError(
                f"{what}: anchor {i} of {len(pairs)} is in the source "
                f"{text.count(old)} times, not {want}: {old!r}")
        text = text.replace(old, new)
    return text


def faulted_plain():
    """The plain version with PLAIN_FAULT, made from its source."""
    from repro_torch.kernels import ref
    text = edited(inspect.getsource(ref.flash_attention_ref), [PLAIN_FAULT],
                  "plain_skip_alpha")
    scope = dict(vars(ref))
    exec(compile(text, "<plain_skip_alpha>", "exec"), scope)
    return scope["flash_attention_ref"]


#: (label, N, S, H, KV, Dh, dtype, causal, softcap, window): the instances
#: chip_smoke.py's cases do not launch (Dh 80 with a window), drawn from a
#: generator of their own (seed 10)
EXTRA_CASES = (
    ("Dh 80 window", 2, 1000, 16, 8, 80, "bfloat16", True, None, 300),
    ("f32 Dh 80 window", 2, 1000, 16, 8, 80, "float32", True, None, 300),
)


def all_cases(chip_smoke, dev):
    """chip_smoke.py's flash cases (FLASH_CASES, FLASH_DH80_CASES,
    FLASH_DH32_CASES, on the inputs it draws) and EXTRA_CASES: every
    instance of both kernels, each head dim with and without a window."""
    for cases, seed in ((chip_smoke.FLASH_CASES, 3),
                        (chip_smoke.FLASH_DH80_CASES, 8),
                        (chip_smoke.FLASH_DH32_CASES, 9),
                        (EXTRA_CASES, 10)):
        yield from chip_smoke.flash_cases(dev, cases, seed)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_faults: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build, dispatch, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fault_dir = build.BUILD_DIR / "faults"
    fault_dir.mkdir(parents=True, exist_ok=True)

    def faulted(library, faults):
        """{name: library} of the sound library and one faulted copy per
        fault, registered with ``build``."""
        sound = build.LIBRARIES[library]
        libs = {"sound": library}
        for name, pairs in faults.items():
            path = fault_dir / f"{sound.source.stem}_{name}.cu"
            path.write_text(edited(sound.source.read_text(), pairs,
                                   f"fault {name} of {sound.source.name}"))
            libs[name] = f"{library}_{name}"
            build.LIBRARIES[libs[name]] = build.Library(path, sound.flags,
                                                        sound.signatures)
        return libs

    libs = faulted("flash_tc", KERNEL_FAULTS)
    f32_libs = faulted("flash", F32_FAULTS)
    f32_libs["f32_sound"] = f32_libs.pop("sound")
    every = list(libs.values()) + list(f32_libs.values())
    with concurrent.futures.ThreadPoolExecutor(len(every)) as pool:
        list(pool.map(build.build, every))
    chip_smoke.check_flash_sass(build.library_path("flash_tc"),
                                build.library_path("flash"))
    plain_fault = faulted_plain()

    bounds = {"a_rel": fa.FLASH_BF16_RTOL, "a_ulp_share": fa.FLASH_BF16_ULP_SHARE,
              "b_rel": fa.FLASH_BF16_F32P_RTOL}
    readings = {name: {} for name in [*libs, "plain_skip_alpha"]}
    f32_readings = {name: {} for name in f32_libs}
    #: case label -> its instance, "<dtype>_dh<Dh>[_window]"
    instance = {}
    entry = fa._ENTRY[torch.bfloat16]
    f32_entry = fa._ENTRY[torch.float32]
    for label, q, k, v, kw in all_cases(chip_smoke, dev):
        instance[label] = fa.variant(q.dtype, q.shape[-1], kw["window"])
        if q.dtype == torch.float32:
            want = ref.flash_attention_ref(q, k, v, **kw)
            top = float(want.abs().max())
            for name, lib in f32_libs.items():
                fa._ENTRY[torch.float32] = (lib, f32_entry[1])
                try:
                    got = dispatch.flash_attention(q, k, v, **kw)
                finally:
                    fa._ENTRY[torch.float32] = f32_entry
                torch.cuda.synchronize()
                f32_readings[name][label] = {
                    "rel": float((got - want).abs().max()) / top}
                print(f"[faults] {name:16s} {label:28s} max|d| / max|out| "
                      f"{f32_readings[name][label]['rel']:.4e}", flush=True)
                del got
            del q, k, v, want
            torch.cuda.empty_cache()
            continue
        want = ref.flash_attention_ref(q, k, v, **kw)
        f32p = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       **kw).to(q.dtype)
        for name, lib in libs.items():
            fa._ENTRY[torch.bfloat16] = (lib, entry[1])
            try:
                got = dispatch.flash_attention(q, k, v, **kw)
            finally:
                fa._ENTRY[torch.bfloat16] = entry
            torch.cuda.synchronize()
            rel, share = fa.bf16_gap(got, want)
            readings[name][label] = {"a_rel": rel, "a_ulp_share": share}
            if name == "sound":
                readings[name][label]["b_rel"], readings[name][label][
                    "b_ulp_share"] = fa.bf16_gap(want, f32p)
            del got
        rel_b, share_b = fa.bf16_gap(plain_fault(q, k, v, **kw), f32p)
        readings["plain_skip_alpha"][label] = {"b_rel": rel_b,
                                               "b_ulp_share": share_b}
        for name, by_case in readings.items():
            r = by_case[label]
            print(f"[faults] {name:16s} {label:28s} " + ", ".join(
                f"{key} {val:.4e}" for key, val in r.items()), flush=True)
        del q, k, v, want, f32p
        torch.cuda.empty_cache()

    def broken(r):
        if "rel" in r:
            return r["rel"] > F32_RTOL
        return any(r.get(key, 0.0) > bound for key, bound in bounds.items())

    def reaches(name, inst):
        """Whether fault ``name`` is in instance ``inst``'s code."""
        if name in ("sound", "plain_skip_alpha") or name in f32_libs:
            return True
        return int(inst.split("_dh")[1].split("_")[0]) in KERNEL_FAULT_DIMS[
            name]

    # per fault, per instance it reaches: the cases whose contract it broke
    matrix = {}
    for family, found in (("bf16", readings), ("f32", f32_readings)):
        for name, by_case in found.items():
            cells = {}
            for label, r in by_case.items():
                if reaches(name, instance[label]):
                    cells.setdefault(instance[label], [])
                    if broken(r):
                        cells[instance[label]].append(label)
            matrix[name] = cells
    sound = [inst for name in ("sound", "f32_sound") if name in matrix
             for inst, cases in matrix[name].items() if cases]
    missed = {name: [inst for inst, cases in cells.items() if not cases]
              for name, cells in matrix.items()
              if name not in ("sound", "f32_sound")}
    ok = not sound and not any(missed.values())
    for name, cells in matrix.items():
        print(f"[faults] {name}: " + "; ".join(
            f"{inst} broken in {len(cases)} ({', '.join(cases) or 'none'})"
            for inst, cases in sorted(cells.items())), flush=True)
    print(f"[faults] the sound kernels broke their contract in {sound or 'no'} "
          f"instance; faults missed {missed}", flush=True)
    print(json.dumps({"ok": ok, "bounds": dict(bounds, f32_rel=F32_RTOL),
                      "instances": instance, "readings": readings,
                      "f32_readings": f32_readings, "matrix": matrix}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
