"""Latency summaries for the serve launcher, torch-free.

A copy of ``percentile`` from the JAX package's ``obs/timers.py`` (the
port imports nothing of that package); its step timers and sinks are not
ported.
"""
from __future__ import annotations

from typing import List, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]) without numpy — the serve
    launcher computes p50/p99 latencies before torch is imported."""
    if not values:
        raise ValueError("percentile of an empty sequence")
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile p must be in [0, 100], got {p}")
    ordered: List[float] = sorted(float(v) for v in values)
    rank = max(1, -(-int(p * len(ordered)) // 100))  # ceil(p*n/100), >= 1
    return ordered[rank - 1]
