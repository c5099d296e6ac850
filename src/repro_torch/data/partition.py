"""Seeded Dirichlet(alpha) data partitioner for non-IID data, the port's
copy of the JAX package's ``src/repro/data/partition.py`` (numpy only, the
same draws in the same order, so every output is bit-equal).

The paper's §5.3 experiments bracket data heterogeneity with two endpoints:
``shuffled`` (IID: every node sees every label) and ``sorted`` (maximally
skewed: each node owns a contiguous label range).  Koloskova et al. 2019
interpolate between them: draw each class's per-node allocation from a
symmetric Dirichlet(alpha) and shard class samples proportionally.

  * alpha -> infinity : every class splits uniformly across nodes (IID /
    ``shuffled`` limit);
  * alpha -> 0        : each class collapses onto one node (``sorted`` /
    disjoint-shard limit).

Everything here is host-side numpy on a ``np.random.default_rng(seed)``
stream, so partitions are reproducible across processes from the seed
alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _check_alpha(alpha: float) -> float:
    """Validate a Dirichlet concentration; returns it as float.

    ``alpha`` must be a finite-or-+inf value strictly greater than zero —
    Dirichlet(0) is not a distribution, and negative concentrations are a
    user error the launcher also rejects before torch is imported.
    """
    a = float(alpha)
    if not a > 0.0:
        raise ValueError(f"data skew alpha must be > 0, got {alpha!r}")
    return a


def dirichlet_class_shares(
    n_classes: int, n_nodes: int, alpha: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Per-class node allocation proportions, ``(n_classes, n_nodes)``.

    Row ``c`` is one draw from Dirichlet(alpha * 1_{n_nodes}) — the
    fraction of class ``c``'s samples each node receives.  ``alpha`` may
    be ``inf``, which short-circuits to the exact uniform 1/n allocation
    (numpy's sampler rejects non-finite concentrations).
    """
    a = _check_alpha(alpha)
    if not np.isfinite(a):
        return np.full((n_classes, n_nodes), 1.0 / n_nodes)
    shares = rng.dirichlet(np.full(n_nodes, a), size=n_classes)
    # Guard against degenerate all-zero rows from extreme underflow at
    # tiny alpha: collapse such a class onto one uniformly-drawn node.
    bad = ~np.isfinite(shares.sum(axis=1)) | (shares.sum(axis=1) <= 0)
    for c in np.nonzero(bad)[0]:
        shares[c] = 0.0
        shares[c, rng.integers(n_nodes)] = 1.0
    return shares / shares.sum(axis=1, keepdims=True)


def _largest_remainder_counts(share: np.ndarray, total: int) -> np.ndarray:
    """Integer per-node counts summing to ``total``, proportional to
    ``share`` by largest-remainder rounding."""
    raw = share * total
    base = np.floor(raw).astype(np.int64)
    short = total - int(base.sum())
    if short > 0:
        order = np.argsort(-(raw - base), kind="stable")
        base[order[:short]] += 1
    return base


def dirichlet_shards(
    labels: Sequence[int], n_nodes: int, alpha: float, seed: int = 0,
) -> np.ndarray:
    """Partition sample indices into balanced, disjoint Dirichlet shards.

    Returns an ``(n_nodes, m_per)`` int array of sample indices with
    ``m_per = len(labels) // n_nodes`` — the same balanced shape
    ``make_logreg`` feeds to the per-node gradient oracle.  Per class, the
    (shuffled) sample indices are split across nodes by largest-remainder
    rounding of a Dirichlet(alpha) share row; a final rebalance pass moves
    samples from over-full to under-full nodes (preferring each receiver's
    majority class last, so it perturbs skew as little as possible) to hit
    exactly ``m_per`` everywhere.  Shards are disjoint by construction and
    bit-reproducible from ``seed`` alone.
    """
    a = _check_alpha(alpha)
    labels_arr = np.asarray(labels)
    m = labels_arr.shape[0]
    if n_nodes <= 0:
        raise ValueError(f"n_nodes must be positive, got {n_nodes}")
    m_per = m // n_nodes
    if m_per == 0:
        raise ValueError(f"{m} samples cannot fill {n_nodes} nodes")
    rng = np.random.default_rng(seed)

    classes = np.unique(labels_arr)
    shares = dirichlet_class_shares(len(classes), n_nodes, a, rng)

    per_node: list[list[int]] = [[] for _ in range(n_nodes)]
    for c_i, c in enumerate(classes):
        idx = np.nonzero(labels_arr == c)[0]
        rng.shuffle(idx)
        counts = _largest_remainder_counts(shares[c_i], len(idx))
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for node in range(n_nodes):
            per_node[node].extend(idx[offsets[node]:offsets[node + 1]])

    # Rebalance to exactly m_per per node: donors give their most recently
    # assigned (tail) samples to receivers, so class composition of the
    # bulk of each shard is preserved.
    surplus: list[int] = []
    for node in range(n_nodes):
        extra = len(per_node[node]) - m_per
        if extra > 0:
            surplus.extend(per_node[node][m_per:])
            per_node[node] = per_node[node][:m_per]
    rng.shuffle(surplus_arr := np.asarray(surplus, dtype=np.int64))
    cursor = 0
    for node in range(n_nodes):
        need = m_per - len(per_node[node])
        if need > 0:
            per_node[node].extend(surplus_arr[cursor:cursor + need])
            cursor += need

    out = np.asarray([sorted(p) for p in per_node], dtype=np.int64)
    assert out.shape == (n_nodes, m_per)
    return out


def node_label_distributions(
    labels: Sequence[int], node_index: np.ndarray,
    classes: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Per-node label histograms, ``(n_nodes, n_classes)``, rows sum to 1.

    ``node_index`` is the ``(n_nodes, m_per)`` shard array from
    :func:`dirichlet_shards` (or ``make_logreg``'s sorted/shuffled
    assignment).  ``classes`` defaults to the sorted unique labels.
    """
    labels_arr = np.asarray(labels)
    cls = np.unique(labels_arr) if classes is None else np.asarray(classes)
    out = np.zeros((node_index.shape[0], len(cls)))
    for node in range(node_index.shape[0]):
        node_labels = labels_arr[np.asarray(node_index[node])]
        for c_i, c in enumerate(cls):
            out[node, c_i] = np.mean(node_labels == c)
    return out


def mean_tv_distance(node_probs: np.ndarray) -> float:
    """Mean total-variation distance of per-node distributions from their
    average — the ``diag/data_skew_tv`` scalar.

    0 means IID (every node's label/vocab distribution equals the global
    one); the maximum (approaching 1 as shards become disjoint across many
    nodes) means no node resembles the population.  Input rows must each
    sum to ~1; shape ``(n_nodes, n_classes)``.
    """
    probs = np.asarray(node_probs, dtype=np.float64)
    mean = probs.mean(axis=0, keepdims=True)
    return float(0.5 * np.abs(probs - mean).sum(axis=1).mean())


def data_skew_tv(
    labels: Sequence[int], node_index: np.ndarray,
) -> float:
    """Convenience: mean TV divergence of the shards in ``node_index``
    over ``labels`` — composition of :func:`node_label_distributions`
    and :func:`mean_tv_distance`."""
    return mean_tv_distance(node_label_distributions(labels, node_index))
