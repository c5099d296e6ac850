"""Carry parameters and KV caches between the JAX package's trees and the
port's dicts.

The JAX trainer holds node-stacked parameters as a nested dict of arrays
(``{"embed": {"tok": (n, V, D), ...}, "stack": {"p0": {...}}, "tail": {}}``);
the port holds ``"embed/tok" -> (n, V, D)`` tensors under the same paths
and shapes.  The JAX serving model's parameters and caches have no node
dimension; the port's carry n = 1 first.  Everything goes through numpy,
so this module imports nothing of JAX.  numpy has no bfloat16, so a
bf16 array comes in by its bits and a bf16 tensor goes out as float32
(exact).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_jax(tree, node: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested dict of node-stacked numpy arrays -> ``path -> tensor``.
    Empty sub-dicts (the JAX stack's empty ``tail``) carry no leaves.
    With ``node``, only that node's row, ``(1, *shape)``: what one rank of
    the per-rank engine holds."""
    out: Dict[str, torch.Tensor] = {}
    rows = slice(None) if node is None else slice(node, node + 1)

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            path = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, path + "/")
            else:
                out[path] = _tensor(np.asarray(val)[rows])
    walk(tree, "")
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_jax`: ``path -> tensor`` -> nested
    dict of numpy arrays (plus the JAX dense stack's empty ``tail``)."""
    tree: dict = {"tail": {}}
    for path, t in params.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _array(t)
    return tree


def model_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX serving model's parameter tree (no node dimension) ->
    ``path -> (1, *shape)`` tensors."""
    return {k: v[None] for k, v in params_from_jax(tree).items()}


def caches_from_jax(caches) -> Dict[str, torch.Tensor]:
    """The JAX model's cache tree (``{"stack": {"c0": {"k": (repeat, B, C,
    KV, Dh), "v": ...}, "c1": ...}, "tail": {"t0": {"k": (B, C, KV, Dh),
    ...}}}``, a pattern position's leaves per block kind: a mamba block's
    "ssm" and conv tails, an rwkv block's f32 "wkv" and shift tails, each
    in its own dtype) -> the port's ``{"stack/c0/k": (1, repeat, B, C, KV,
    Dh), ...}``."""
    return model_params_from_jax(caches)


def caches_to_jax(caches: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`caches_from_jax` for a one-node cache."""
    nodes = {t.shape[0] for t in caches.values()}
    if nodes != {1}:
        raise ValueError("the JAX serving cache has no node dimension: "
                         f"expected n = 1, got {sorted(nodes)}")
    return params_to_jax({k: t[0] for k, t in caches.items()})
