"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library of its own, with a plain C interface, and loaded with ``ctypes``
at first use, into ``_build/`` beside this file (listed in
``.gitignore``).  A library's name carries a hash of its source and
flags, so a changed source rebuilds and two processes building at once
never load a half-written file.

* ``gossip`` (``csrc/gossip_kernels.cu``): the gossip kernels (codes in
  the packed and the per-leaf form, dequantize, the EF update on f32 and
  on bf16 state, each in serial and pipelined order), built with
  ``--fmad=false``: the QSGD codes must be bit-equal to their plain
  versions, and an FMA contraction moves a code by a whole level.
* ``flash`` (``csrc/flash_attention.cu``): the f32 flash-attention
  forward on the tensor cores in 3xTF32, held to a tolerance, so FMA
  contraction stays on.
* ``flash_tc`` (``csrc/flash_attention_sm90.cu``): the bf16
  flash-attention forward on the tensor cores (wgmma, TMA), held to a
  tolerance, FMA contraction on like ``flash``; the steps whose rounding
  the plain version fixes use the rounded intrinsics.  It includes no
  CUTLASS header and links no ``-lcuda``.
* ``topk`` (``csrc/block_topk.cu``): the per-row top-k selection mask,
  built with ``--fmad=false``: its mask and thresholds must be bit-equal
  to the plain version.
* ``probe`` (``csrc/probe.cu``): the collective-layer probe's ``x * 2``,
  built with ``--fmad=false`` like the other bit-equal kernels.

Nothing here runs at import time, and nothing falls back: no ``nvcc``, a
failed build or a failed launch raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_P, _F, _I64, _INT = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64, ctypes.c_int
_FLASH = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _INT, _INT, _F, _F,
          _P)


@dataclasses.dataclass(frozen=True)
class Library:
    source: Path
    flags: tuple
    signatures: dict


LIBRARIES = {
    "gossip": Library(
        CSRC / "gossip_kernels.cu", _COMMON_FLAGS + ("--fmad=false",), {
            "qsgd_codes_i8": (_P, _P, _P, _F, _P, _I64, _I64, _P),
            "qsgd_codes_i16": (_P, _P, _P, _F, _P, _I64, _I64, _P),
            "qsgd_leaf_codes": (_P, _INT, _P, _P, _F, _P, _INT, _I64, _I64,
                                _P),
            "sign_codes": (_P, _INT, _P, _I64, _P),
            "dequantize_i8": (_P, _P, _P, _I64, _I64, _P),
            "dequantize_i16": (_P, _P, _P, _I64, _I64, _P),
            "ef_update": (_P, _P, _P, _P, _P, _P, _P, _F, _INT, _I64, _I64,
                          _I64, _I64, _P),
            "ef_update_bf16": (_P, _P, _P, _P, _P, _INT, _P, _P, _F, _INT,
                               _INT, _I64, _I64, _I64, _I64, _P),
            "replica_update": (_INT, _P, _P, _P, _P, _P, _P, _INT, _INT,
                               _P, _P, _F, _INT, _INT, _INT, _I64, _I64,
                               _I64, _I64, _P),
        }),
    "flash": Library(
        CSRC / "flash_attention.cu", _COMMON_FLAGS, {
            "flash_attention_f32": _FLASH,
        }),
    "flash_tc": Library(
        CSRC / "flash_attention_sm90.cu", _COMMON_FLAGS, {
            "flash_attention_bf16_tc": _FLASH,
        }),
    "topk": Library(
        CSRC / "block_topk.cu", _COMMON_FLAGS + ("--fmad=false",), {
            "block_topk_mask": (_P, _INT, _P, _P, _I64, _I64, _P),
        }),
    "probe": Library(
        CSRC / "probe.cu", _COMMON_FLAGS + ("--fmad=false",), {
            "probe_scale": (_P, _P, _I64, _P),
        }),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "of repro_torch cannot be built on this machine")


def library_path(name: str) -> Path:
    """Where the built library ``name`` for its current source and flags
    lives."""
    lib = LIBRARIES[name]
    digest = hashlib.sha256(lib.source.read_bytes()
                            + " ".join(lib.flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{lib.source.stem}-{digest}.so"


def build(name: str) -> tuple:
    """Compile library ``name`` if it is missing.  Returns
    ``(path, compiler_log)``; the log is empty when nothing was compiled.
    Safe to call for several libraries at once from threads."""
    out = library_path(name)
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    lib = LIBRARIES[name]
    cmd = [nvcc, *lib.flags, "-o", tmp, str(lib.source)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, " ".join(cmd) + "\n" + proc.stdout


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load kernel library ``name``, once per process."""
    path, _ = build(name)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in LIBRARIES[name].signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = _INT
    lib.error_string.argtypes = [_INT]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} "
                           f"({lib.error_string(code).decode()})")


def stream_of(t) -> int:
    """The current CUDA stream on the tensor's device, as a pointer int.
    It builds no Python ``torch.cuda.Stream`` object, the largest step of
    a probe launch's host path when it did (``chip_smoke.py`` prints both
    lookups on its ``[kernel] probe_scale host path`` line)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_rows(t, name: str, dtype, shape) -> int:
    """Check that a kernel argument is a 2-D CUDA tensor of the expected
    dtype and shape whose rows are each contiguous (a slot of a bucket,
    ``buf[:, off:off + len]``, or a whole buffer); returns its row stride
    in elements."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    rows, cols = shape
    ld, step = t.stride()
    if cols > 1 and step != 1:
        raise ValueError(f"{name}: expected contiguous rows, got strides "
                         f"{t.stride()}")
    if rows > 1 and ld < cols:
        raise ValueError(f"{name}: rows overlap (row stride {ld} < {cols})")
    return ld if rows > 1 else cols


def require(t, name: str, dtype, shape=None) -> None:
    """Check that a kernel argument is a contiguous CUDA tensor of the
    expected dtype (and shape), reading each attribute once."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    got = t.dtype
    if got != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {got}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
