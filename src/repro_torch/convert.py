"""Carry parameters between the JAX package's tree and the port's dict.

The JAX trainer holds node-stacked parameters as a nested dict of arrays
(``{"embed": {"tok": (n, V, D), ...}, "stack": {"p0": {...}}, "tail": {}}``);
the port holds ``"embed/tok" -> (n, V, D)`` tensors under the same paths
and shapes.  Both directions go through numpy, so this module imports
nothing of JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Nested dict of node-stacked numpy arrays -> ``path -> tensor``.
    Empty sub-dicts (the JAX stack's empty ``tail``) carry no leaves."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            path = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, path + "/")
            else:
                out[path] = torch.from_numpy(np.array(val, copy=True))
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
        node[leaf] = t.detach().cpu().numpy()
    return tree
