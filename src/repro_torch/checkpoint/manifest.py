"""Checkpoint manifest: schema, typed errors and tree validation, in the
JAX package's format (``src/repro/checkpoint/manifest.py``), so each
package reads the checkpoints the other writes.

A sharded checkpoint is a directory:

    <dir>/
      manifest.json             # written last, by process 0: its presence
                                #   marks the checkpoint complete
      shards-p00000.npz         # process 0's shards
      shards-p00000.index.json  # entry name -> (leaf key, global offsets)
      shards-p00001.npz ...     # one pair per process

``manifest.json`` records the flat leaf keys (path components joined with
"__"), each leaf's global shape, its true dtype (``bfloat16``, stored as
its ``uint16`` bits), the training fingerprint (mesh axes, topology,
gossip steps, node count, state dtype, compressor) and the step.  Restore
validates its target against it and raises :class:`TreeMismatchError`
listing every missing, extra or mismatched leaf.

This module imports neither torch nor numpy: the launcher reads a
manifest (the step, for the budget check) before torch is imported.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

MANIFEST_NAME = "manifest.json"
FORMAT_NAME = "choco-sharded"
FORMAT_VERSION = 1

#: separator joining tree path components into flat leaf keys
FLAT_KEY_SEP = "__"

#: dtypes npz cannot hold -> their lossless bit-cast storage dtype
STORAGE_DTYPES = {"bfloat16": "uint16"}


def key_prefix(key: str) -> str:
    """Top-level state field of a flat leaf key ("x_hat__embed__tok" ->
    "x_hat")."""
    return key.split(FLAT_KEY_SEP, 1)[0]


class CheckpointError(Exception):
    """Base of every checkpoint failure."""


class ManifestError(CheckpointError):
    """Missing, unreadable or incompatible manifest.json."""


class TreeMismatchError(CheckpointError):
    """The checkpoint's leaves do not match the restore target; carries
    every problem at once."""

    def __init__(self, missing: Sequence[str], extra: Sequence[str],
                 mismatched: Sequence[Tuple[str, str, str, str]]):
        self.missing = tuple(missing)        # keys the checkpoint lacks
        self.extra = tuple(extra)            # keys the target lacks
        self.mismatched = tuple(mismatched)  # (key, field, saved, expected)
        lines = []
        if self.missing:
            lines.append("missing from checkpoint: " + ", ".join(self.missing))
        if self.extra:
            lines.append("extra in checkpoint: " + ", ".join(self.extra))
        for key, field, saved, expected in self.mismatched:
            lines.append(f"{key}: saved {field} {saved} != expected {expected}")
        super().__init__("checkpoint tree mismatch — " + "; ".join(lines))


class ShardCoverageError(CheckpointError):
    """The stored shards do not cover a requested leaf region (a shard file
    deleted, or a save by only some of the processes)."""


class ElasticRestoreError(CheckpointError):
    """A node-count change the elastic policy cannot map."""


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]
    dtype: str            # true dtype, e.g. "bfloat16"
    storage: str          # on-disk dtype, e.g. "uint16" (bit-cast)

    def to_json(self) -> Dict[str, Any]:
        return {"shape": list(self.shape), "dtype": self.dtype,
                "storage": self.storage}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "LeafSpec":
        return cls(shape=tuple(d["shape"]), dtype=d["dtype"],
                   storage=d["storage"])


@dataclasses.dataclass(frozen=True)
class Manifest:
    step: int
    leaves: Dict[str, LeafSpec]             # flat key -> leaf spec
    fingerprint: Dict[str, Any]
    metadata: Dict[str, Any]
    process_count: int = 1
    version: int = FORMAT_VERSION

    @property
    def n_nodes(self) -> Optional[int]:
        return self.fingerprint.get("n_nodes")


def storage_dtype(dtype_name: str) -> str:
    """On-disk dtype of a leaf dtype (bit-cast where npz cannot hold it)."""
    return STORAGE_DTYPES.get(dtype_name, dtype_name)


def manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, MANIFEST_NAME)


def is_sharded_checkpoint(path: str) -> bool:
    """True iff ``path`` is a complete sharded checkpoint directory (the
    manifest is renamed into place last, so a torn save answers False)."""
    return os.path.isfile(manifest_path(path))


def write_manifest(ckpt_dir: str, manifest: Manifest) -> str:
    """Write manifest.json through a temporary file and a rename: a torn
    write never looks like a complete checkpoint."""
    doc = {
        "format": FORMAT_NAME,
        "version": manifest.version,
        "step": manifest.step,
        "process_count": manifest.process_count,
        "fingerprint": manifest.fingerprint,
        "metadata": manifest.metadata,
        "leaves": {k: s.to_json() for k, s in manifest.leaves.items()},
    }
    path = manifest_path(ckpt_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_manifest(ckpt_dir: str) -> Manifest:
    """Parse a sharded checkpoint's manifest.json; ManifestError on a
    missing or torn (schema-invalid) manifest."""
    path = manifest_path(ckpt_dir)
    if not os.path.isfile(path):
        raise ManifestError(
            f"no {MANIFEST_NAME} under {ckpt_dir!r} — not a sharded "
            f"checkpoint (legacy flat-npz checkpoints are a single .npz "
            f"file, restored by restore_legacy)")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ManifestError(f"unreadable manifest {path!r}: {e}") from e
    if doc.get("format") != FORMAT_NAME:
        raise ManifestError(
            f"{path!r} has format {doc.get('format')!r}, expected "
            f"{FORMAT_NAME!r}")
    if doc.get("version", 0) > FORMAT_VERSION:
        raise ManifestError(
            f"{path!r} is version {doc['version']}, newer than this "
            f"reader's {FORMAT_VERSION}")
    return Manifest(
        step=int(doc["step"]),
        leaves={k: LeafSpec.from_json(s) for k, s in doc["leaves"].items()},
        fingerprint=doc.get("fingerprint", {}),
        metadata=doc.get("metadata", {}),
        process_count=int(doc.get("process_count", 1)),
        version=int(doc.get("version", FORMAT_VERSION)),
    )


def validate_tree(saved: Dict[str, LeafSpec],
                  expected: Dict[str, Tuple[Tuple[int, ...], str]],
                  *, node_remap: Optional[Tuple[int, int]] = None,
                  reset_prefixes: Sequence[str] = ()) -> None:
    """Check the saved leaves against the target's ``{key: (shape,
    dtype)}``; raise :class:`TreeMismatchError` listing every problem.

    node_remap=(n_old, n_new): an elastic restore; a leaf saved as
    ``(n_old, *rest)`` where the target has ``(n_new, *rest)`` passes.
    reset_prefixes: top-level fields the restore zero-fills instead of
    reading (x_hat and s under elastic restore): keys under them are exempt
    from the missing / extra accounting, and their node extent and dtype
    are not compared."""
    pref = set(reset_prefixes)
    under_reset = lambda key: key_prefix(key) in pref
    missing = sorted(k for k in set(expected) - set(saved)
                     if not under_reset(k))
    extra = sorted(k for k in set(saved) - set(expected)
                   if not under_reset(k))
    mismatched: List[Tuple[str, str, str, str]] = []
    for key in sorted(set(saved) & set(expected)):
        spec = saved[key]
        shape, dtype = expected[key]
        shape_ok = spec.shape == tuple(shape)
        if not shape_ok and node_remap is not None and spec.shape and shape:
            n_old, n_new = node_remap
            shape_ok = (spec.shape[0] == n_old and shape[0] == n_new
                        and spec.shape[1:] == tuple(shape[1:]))
        if not shape_ok and under_reset(key) and spec.shape and shape:
            shape_ok = spec.shape[1:] == tuple(shape[1:])
        if not shape_ok:
            mismatched.append((key, "shape", str(spec.shape),
                               str(tuple(shape))))
        # reset keys are zero-filled in the target's dtype, so a state
        # dtype change there is not a mismatch
        if spec.dtype != dtype and not under_reset(key):
            mismatched.append((key, "dtype", spec.dtype, dtype))
    if missing or extra or mismatched:
        raise TreeMismatchError(missing, extra, mismatched)
