"""Build and load the hand-written CUDA kernels (``csrc/gossip_kernels.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at first use, into
``_build/`` beside this file (listed in ``.gitignore``).  The library's
name carries a hash of the source and the flags, so a changed source
rebuilds and two processes building at once never load a half-written file.

Nothing here runs at import time, and nothing falls back: no ``nvcc``, a
failed build or a failed launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).parent / "csrc" / "gossip_kernels.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_P, _F, _I64, _INT = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "qsgd_codes_i8": (_P, _P, _P, _F, _P, _I64, _I64, _P),
    "qsgd_codes_i16": (_P, _P, _P, _F, _P, _I64, _I64, _P),
    "sign_codes": (_P, _P, _I64, _P),
    "dequantize_i8": (_P, _P, _P, _I64, _I64, _P),
    "dequantize_i16": (_P, _P, _P, _I64, _I64, _P),
    "ef_update": (_P, _P, _P, _P, _P, _F, _F, _F, _P, _P, _P, _I64, _P),
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


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"gossip_kernels-{digest}.so"


def build() -> tuple:
    """Compile the kernels if their library is missing.  Returns
    ``(path, compiler_log)``; the log is empty when nothing was compiled."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, " ".join(cmd) + "\n" + proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
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
    """The current CUDA stream on the tensor's device, as a pointer int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None) -> None:
    """Check that a kernel argument is a contiguous CUDA tensor of the
    expected dtype (and shape)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
