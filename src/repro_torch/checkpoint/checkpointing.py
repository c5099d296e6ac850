"""Sharded checkpoints in the JAX package's format
(``src/repro/checkpoint/checkpointing.py``), written and read with numpy
and torch.

* **sharded** (a directory): each process writes only the regions it
  holds, ``shards-p<idx>.npz`` with a sidecar ``shards-p<idx>.index.json``
  (entry ``"<leaf key>@<j>"`` -> the leaf key and the region's global
  ``start`` and ``stop``); process 0 writes ``manifest.json`` last.  The
  npz is written one member at a time (:class:`NpzWriter`), and a tensor
  on the card goes to the host in chunks, so the host never holds more
  than a chunk of the state; ``np.load`` and the JAX reader read it.
  bf16 leaves are stored as their uint16 bits, moved through
  ``Tensor.view(torch.int16)``: numpy has no bfloat16 and the port never
  asks it for one.  A restore reads any region of a leaf from whichever
  shards hold it (:class:`ShardStore`), so a checkpoint saved on n
  processes restores on any other number.
* **legacy flat npz** (one ``.npz`` file, keys flat, bf16 widened to f32):
  read for ``--resume`` as the JAX launcher reads it, each trainer only
  the node rows it holds (:class:`LegacyStore`).
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import zipfile
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.checkpoint.manifest import (
    FLAT_KEY_SEP, CheckpointError, LeafSpec, Manifest, ShardCoverageError,
    TreeMismatchError, is_sharded_checkpoint, read_manifest, storage_dtype,
    write_manifest)

_ENTRY_SEP = "@"          # npz entry name: "<leaf key>@<shard number>"
#: elements a tensor moves to the host at a time while it is written
CHUNK_ELEMS = 1 << 26

Data = Union[np.ndarray, torch.Tensor]


def flat_key(*parts: str) -> str:
    """The flat leaf key of a path (``flat_key("params", "embed/tok")`` ->
    ``"params__embed__tok"``), as the JAX package joins a tree path."""
    return FLAT_KEY_SEP.join(p for part in parts for p in part.split("/"))


class Part(NamedTuple):
    """One region ``[starts, stops)`` of a leaf that this process stores:
    a tensor (any device; bf16 stored as its bits) or an array already in
    the storage dtype."""
    starts: Sequence[int]
    stops: Sequence[int]
    data: Data


class Leaf(NamedTuple):
    key: str
    shape: Tuple[int, ...]              # global shape
    dtype: str                          # true dtype name, e.g. "bfloat16"
    parts: Iterable[Part]               # what this process stores of it,
                                        #   made as it is written


# ---------------------------------------------------------------------------
# npz, one member at a time
# ---------------------------------------------------------------------------

def _storage_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array in its storage dtype (bf16: uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def storage_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array in the storage dtype of ``dtype`` as a CPU tensor of
    the true dtype (uint16 bits -> bfloat16)."""
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


class NpzWriter:
    """Writes an ``.npz`` (a zip of stored ``.npy`` members, as
    ``np.savez`` writes it) one member at a time."""

    def __init__(self, path: str):
        self.path = path
        self._zip = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                    allowZip64=True)

    def write(self, name: str, data: Data) -> str:
        """Member ``name`` (``np.load`` names it so): a numpy array, or a
        tensor moved to the host ``CHUNK_ELEMS`` elements at a time.
        Returns the dtype name it is stored in."""
        if isinstance(data, torch.Tensor):
            t = data.detach()
            descr = (np.dtype(np.uint16) if t.dtype == torch.bfloat16
                     else _storage_array(torch.empty(0, dtype=t.dtype)).dtype)
            shape, flat = tuple(t.shape), t.reshape(-1)
            chunks = (_storage_array(flat[i:i + CHUNK_ELEMS].cpu())
                      for i in range(0, flat.numel(), CHUNK_ELEMS))
        else:
            arr = np.asarray(data, order="C")   # keeps a 0-d array 0-d
            descr, shape, chunks = arr.dtype, arr.shape, (arr.reshape(-1),)
        header = {"descr": np.lib.format.dtype_to_descr(descr),
                  "fortran_order": False, "shape": shape}
        with self._zip.open(name + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array_header_1_0(f, header)
            for chunk in chunks:
                f.write(chunk.view(np.uint8))
        return np.dtype(descr).name

    def close(self) -> None:
        self._zip.close()


# ---------------------------------------------------------------------------
# sharded save
# ---------------------------------------------------------------------------

def save_sharded(ckpt_dir: str, leaves: Iterable[Leaf], *, step: int,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 metadata: Optional[Dict[str, Any]] = None,
                 keep_last: Optional[int] = None, process_index: int = 0,
                 process_count: int = 1,
                 barrier: Optional[Callable[[], None]] = None) -> str:
    """Write this process's parts of ``leaves`` (every leaf, with the parts
    this process holds) and their index; then, after ``barrier`` (every
    process has written its files), process 0 writes the manifest, and
    after a second ``barrier`` (so that no process returns before the
    checkpoint is complete), with ``keep_last``, deletes all but the
    newest ``keep_last`` completed checkpoints beside ``ckpt_dir``, never
    ``ckpt_dir`` itself.  Returns ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    stem = os.path.join(ckpt_dir, f"shards-p{process_index:05d}")
    specs: Dict[str, LeafSpec] = {}
    entries: Dict[str, Dict[str, Any]] = {}
    writer = NpzWriter(stem + ".npz")
    try:
        for leaf in leaves:
            specs[leaf.key] = LeafSpec(shape=tuple(leaf.shape),
                                       dtype=leaf.dtype,
                                       storage=storage_dtype(leaf.dtype))
            for j, part in enumerate(leaf.parts):
                data = part.data
                entry = f"{leaf.key}{_ENTRY_SEP}{j}"
                want = [b - a for a, b in zip(part.starts, part.stops)]
                if list(data.shape) != want:
                    raise CheckpointError(
                        f"{entry}: data of shape {tuple(data.shape)} for "
                        f"the region {list(part.starts)}..{list(part.stops)}")
                stored = writer.write(entry, data)
                if stored != specs[leaf.key].storage:
                    raise CheckpointError(f"{entry}: {stored} data for a "
                                          f"{leaf.dtype} leaf")
                entries[entry] = {"key": leaf.key,
                                  "start": [int(a) for a in part.starts],
                                  "stop": [int(b) for b in part.stops]}
    finally:
        writer.close()
    with open(stem + ".index.json", "w") as f:
        json.dump({"process": process_index, "entries": entries}, f)
    if barrier is not None:
        barrier()
    if process_index == 0:
        write_manifest(ckpt_dir, Manifest(
            step=int(step), leaves=specs, fingerprint=dict(fingerprint or {}),
            metadata=dict(metadata or {}), process_count=process_count))
    if barrier is not None:
        barrier()            # no process returns before the checkpoint is
    if process_index == 0:   # complete
        if keep_last is not None:
            gc_checkpoints(os.path.dirname(os.path.abspath(ckpt_dir)),
                           keep_last, protect=ckpt_dir)
    return ckpt_dir


def gc_checkpoints(parent_dir: str, keep_last: int,
                   protect: Optional[str] = None) -> List[str]:
    """Delete all but the newest ``keep_last`` completed checkpoints under
    ``parent_dir`` (directories with a readable manifest, by its step);
    ``protect`` is never deleted, and torn directories are left alone.
    Returns the deleted paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    protect_abs = os.path.abspath(protect) if protect else None
    done = []
    for name in sorted(os.listdir(parent_dir)):
        path = os.path.join(parent_dir, name)
        if not os.path.isdir(path) or not is_sharded_checkpoint(path):
            continue
        try:
            man = read_manifest(path)
        except CheckpointError:
            continue
        done.append((man.step, path))
    done.sort(key=lambda sp: sp[0])
    deleted = []
    excess = len(done) - keep_last
    for _, path in done:
        if excess <= 0:
            break
        if protect_abs and os.path.abspath(path) == protect_abs:
            continue
        shutil.rmtree(path)
        deleted.append(path)
        excess -= 1
    return deleted


# ---------------------------------------------------------------------------
# sharded restore
# ---------------------------------------------------------------------------

class ShardStore:
    """Reader over every ``shards-p*.npz`` of a checkpoint: maps a region
    of a leaf to the stored entries that cover it.  An entry is read whole
    when first touched and kept until another is read, so the host holds
    one entry at a time."""

    def __init__(self, ckpt_dir: str):
        self.dir = ckpt_dir
        self.by_key: Dict[str, List[Tuple[str, str, List[int], List[int]]]] = {}
        self._npz: Dict[str, Any] = {}
        self._last: Tuple[Optional[Tuple[str, str]], Optional[np.ndarray]] = (
            None, None)
        for ipath in sorted(glob.glob(os.path.join(ckpt_dir,
                                                   "shards-p*.index.json"))):
            with open(ipath) as f:
                idx = json.load(f)
            npz_path = re.sub(r"\.index\.json$", ".npz", ipath)
            for entry, rec in idx["entries"].items():
                self.by_key.setdefault(rec["key"], []).append(
                    (npz_path, entry, rec["start"], rec["stop"]))

    def _entry(self, npz_path: str, entry: str) -> np.ndarray:
        if self._last[0] == (npz_path, entry):
            return self._last[1]
        self._last = (None, None)
        if npz_path not in self._npz:
            self._npz[npz_path] = np.load(npz_path)
        got = self._npz[npz_path][entry]
        self._last = ((npz_path, entry), got)
        return got

    def close(self) -> None:
        for z in self._npz.values():
            z.close()
        self._npz.clear()
        self._last = (None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_region(self, key: str, starts: Sequence[int],
                    stops: Sequence[int], storage: str) -> np.ndarray:
        """``[starts, stops)`` of leaf ``key`` in its storage dtype, from
        every stored entry that meets it (entries are disjoint, so they
        tile the region); ShardCoverageError where they leave a gap."""
        shape = tuple(b - a for a, b in zip(starts, stops))
        entries = self.by_key.get(key, ())
        for npz_path, entry, s_start, s_stop in entries:
            if list(s_start) == list(starts) and list(s_stop) == list(stops):
                data = self._entry(npz_path, entry)
                if data.dtype == np.dtype(storage):
                    return data                       # one entry, no copy
        out = np.empty(shape, np.dtype(storage))
        filled = 0
        for npz_path, entry, s_start, s_stop in entries:
            lo = [max(a, sa) for a, sa in zip(starts, s_start)]
            hi = [min(b, sb) for b, sb in zip(stops, s_stop)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            data = self._entry(npz_path, entry)
            src = tuple(slice(l - sa, h - sa)
                        for l, h, sa in zip(lo, hi, s_start))
            dst = tuple(slice(l - a, h - a)
                        for l, h, a in zip(lo, hi, starts))
            out[dst] = data[src]
            filled += int(np.prod([h - l for l, h in zip(lo, hi)],
                                  dtype=np.int64))
        want = int(np.prod(shape, dtype=np.int64))
        if filled != want:
            raise ShardCoverageError(
                f"leaf {key!r}: stored shards cover {filled} of {want} "
                f"elements of region {list(starts)}..{list(stops)} — shard "
                f"file missing from {self.dir!r}? (saved by "
                f"{len(entries)} shard entries)")
        return out


# ---------------------------------------------------------------------------
# legacy flat npz
# ---------------------------------------------------------------------------

class LegacyStore:
    """:class:`ShardStore`'s ``read_region`` over a legacy flat npz (the
    JAX ``save_pytree`` format: whole leaves under flat keys, bf16 widened
    to f32), read lazily.  Opening it reads each member's ``.npy`` header
    only and checks it against the target's ``{key: (shape, dtype)}``:
    TreeMismatchError on missing, extra or mis-shaped keys (the format
    records no dtype, so none is compared).  A region then reads only its
    rows of the member (``np.savez`` stores members uncompressed, so the
    seek to them reads nothing), so a trainer reads just the node rows it
    holds.  Each region comes in the target's storage dtype: bf16 leaves
    rounded to bf16 (as the JAX restore's ``astype``) and given as bits."""

    def __init__(self, path: str,
                 expected: Dict[str, Tuple[Tuple[int, ...], str]]):
        if not path.endswith(".npz"):
            path = path + ".npz"
        self.dtypes = {key: dtype for key, (_, dtype) in expected.items()}
        self._zip = zipfile.ZipFile(path)
        self._headers: Dict[str, Tuple[Tuple[int, ...], np.dtype, int]] = {}
        try:
            for name in self._zip.namelist():
                if name.endswith(".npy"):
                    self._headers[name[:-len(".npy")]] = self._header(name)
            missing = sorted(set(expected) - set(self._headers))
            extra = sorted(set(self._headers) - set(expected))
            mismatched = [(key, "shape", str(self._headers[key][0]),
                           str(tuple(expected[key][0])))
                          for key in sorted(set(self._headers) & set(expected))
                          if self._headers[key][0] != tuple(expected[key][0])]
            if missing or extra or mismatched:
                raise TreeMismatchError(missing, extra, mismatched)
        except BaseException:
            self._zip.close()
            raise

    def _header(self, name: str) -> Tuple[Tuple[int, ...], np.dtype, int]:
        """(shape, stored dtype, offset of the data) of member ``name``."""
        with self._zip.open(name) as f:
            version = np.lib.format.read_magic(f)   # np.savez writes 1.0
            if version != (1, 0):
                raise CheckpointError(f"{name}: .npy format {version}")
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            if fortran:
                raise CheckpointError(f"{name}: Fortran-ordered member")
            return tuple(shape), dtype, f.tell()

    def read_region(self, key: str, starts: Sequence[int],
                    stops: Sequence[int], storage: str) -> np.ndarray:
        shape, stored, offset = self._headers[key]
        # rows [starts[0], stops[0]) are contiguous; a scalar is one row
        first, rows = (starts[0], stops[0] - starts[0]) if shape else (0, 1)
        row = stored.itemsize * int(np.prod(shape[1:], dtype=np.int64))
        with self._zip.open(key + ".npy") as f:
            f.seek(offset + first * row)
            arr = np.frombuffer(bytearray(f.read(rows * row)), stored)
        arr = arr.reshape((rows,) + shape[1:])[
            (slice(None),) + tuple(slice(a, b) for a, b in
                                   zip(starts[1:], stops[1:]))
        ] if shape else arr.reshape(())
        if self.dtypes[key] == "bfloat16":
            return _storage_array(torch.from_numpy(np.asarray(
                arr, order="C")).to(torch.bfloat16))
        return arr.astype(np.dtype(storage), copy=False)

    def close(self) -> None:
        self._zip.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
