"""Flat-vector wrappers around the kernels, and the top-k selections.

The QSGD and sign wrappers take node-stacked flat buffers ``(n, L)`` and
add the reductions the kernels leave to the caller: the per-node norm
and the payload scale.  The reductions run on the whole row (padding is
zero, so it adds nothing), one row at a time: a reduction over an
``(n, L)`` tensor sums in another order than over one ``(1, L)`` row, so
only row by row does node i get the same scale stacked with the other
nodes as alone in its own process.  The elementwise pass goes through
``kernels/dispatch.py``.

``block_topk_compress_vector`` is the public op of the top-k mask kernel
(JAX ``kernels/ops.py:45``): it tiles a flat vector into ``(R, 128)`` rows
and masks it.  ``block_topk_select`` and ``topk_rows`` select the wire
payload's indices in plain PyTorch, as the JAX package does with
``lax.top_k``; no kernel runs behind them.  ``flash_attention`` is
re-exported from dispatch, as the JAX package's ``kernels/ops.py``
re-exports its kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dispatch
from .dispatch import flash_attention  # noqa: F401  (public re-export)

LANES = 128
#: elements per chunk of the stable sort that settles rows with surplus ties
_SORT_CHUNK = 1 << 24
#: the largest k selected by k argmax passes rather than by a threshold
_ITERATIVE_K = 16


def _row_sums(fn, x):
    """(n, L) -> (n,) sums of ``fn`` of each row, one row at a time."""
    return torch.cat([torch.sum(fn(row), dim=1) for row in x.split(1)])


def qsgd_compress(x, xi, s: int, tau: float):
    """x, xi: (n, L) f32 -> (codes (n, L) int8/int16, scale (n,) f32),
    scale = ||x_i|| / (s * tau)."""
    norm = torch.sqrt(_row_sums(torch.square, x))
    inv_norm = torch.where(norm == 0, torch.zeros_like(norm), 1.0 / norm)
    return dispatch.qsgd_codes(x, xi, inv_norm, s), norm / (s * tau)


def sign_compress(x, logical: int):
    """x: (n, L) f32 -> (int8 sign codes, scale = ||x_i||_1 / logical)."""
    scale = _row_sums(torch.abs, x) / logical
    return dispatch.sign_codes(x), scale


# -- top-k -----------------------------------------------------------------------

def _topk_of_magnitudes(mag, k: int):
    """mag: (rows, L) non-negative, consumed -> (rows, k) int64 column
    indices of the k largest per row, in ``lax.top_k``'s order: magnitude
    descending and, among equal magnitudes, the lower index first.

    Up to ``_ITERATIVE_K`` (BlockTopK's budgets), k argmax passes: each
    takes the first maximal index (``argmax``'s tie rule is that of
    ``lax.top_k``) and marks it -1.  Above it, ``torch.topk`` (which breaks
    ties its own way, and differently on the CPU and the card) only fixes
    the k-th largest value t: a row with exactly k entries >= t keeps those;
    a row with more (ties at t) is settled by a stable sort, a few rows at
    a time; then the k are stable-sorted by magnitude.  No pass runs over
    every full row but a compare and a count, so no row-wide cumsum is
    needed."""
    rows, L = mag.shape
    if k <= _ITERATIVE_K:
        idx = torch.empty((rows, k), dtype=torch.long, device=mag.device)
        for j in range(k):
            first = mag.argmax(dim=1, keepdim=True)
            idx[:, j:j + 1] = first
            mag.scatter_(1, first, -1.0)
        return idx
    t = torch.topk(mag, k, dim=1, sorted=False).values.amin(dim=1,
                                                            keepdim=True)
    sel = mag >= t
    surplus = sel.sum(dim=1) > k
    tied = surplus.nonzero().squeeze(1)
    if tied.numel():
        idx = torch.empty((rows, k), dtype=torch.long, device=mag.device)
        sel[tied] = False
        for part in tied.split(max(1, _SORT_CHUNK // L)):
            idx[part] = torch.sort(mag[part], dim=1, descending=True,
                                   stable=True).indices[:, :k]
        idx[~surplus] = sel.nonzero()[:, 1].view(-1, k)
    else:
        idx = sel.nonzero()[:, 1].view(rows, k)
    del sel
    order = torch.sort(mag.gather(1, idx), dim=1, descending=True,
                       stable=True).indices
    return idx.gather(1, order)


def topk_rows(x, k: int):
    """Indices (..., k) int64 of the k largest |x| along the last dim, in
    ``lax.top_k``'s order (magnitude descending, lower index first)."""
    L = x.shape[-1]
    return _topk_of_magnitudes(x.abs().reshape(-1, L), k).view(
        *x.shape[:-1], k)


def block_topk_select(x, k_per_block: int, *, block: int = 128):
    """Blockwise top-k payload of flat vectors: x (..., d) -> (values
    (..., R, k), indices (..., R, k) int32) with R = ceil(d / block), the
    tail block zero-padded (padded positions carry value 0).  Plain
    PyTorch, as the JAX package's ``lax.top_k`` + gather.

    The only full-size temporary is |x|, the shape of x: a ragged tail is
    padded on its own, and the full blocks are selected one leading row
    at a time when a tail keeps them from being one view."""
    if block % LANES:
        raise ValueError("block must be a multiple of the 128-lane unit")
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    m, k = x2.shape[0], k_per_block
    full, tail = divmod(d, block)
    R = full + (tail > 0)
    idx = torch.empty((m, R, k), dtype=torch.long, device=x.device)
    vals = torch.empty((m, R, k), dtype=x.dtype, device=x.device)
    mag = x2.abs()
    if full and not tail:
        idx[:] = _topk_of_magnitudes(mag.view(m * full, block), k).view(
            m, full, k)
    elif full:
        for i in range(m):
            idx[i, :full] = _topk_of_magnitudes(
                mag[i, :full * block].view(full, block), k)
    if tail:
        idx[:, full] = _topk_of_magnitudes(
            F.pad(mag[:, full * block:], (0, block - tail)), k)
    del mag
    if full:
        vals[:, :full] = x2[:, :full * block].view(m, full, block).gather(
            2, idx[:, :full])
    if tail:
        vals[:, full] = F.pad(x2[:, full * block:], (0, block - tail)).gather(
            1, idx[:, full])
    return (vals.view(*lead, R, k),
            idx.to(torch.int32).view(*lead, R, k))


def _to_tiles(x, rows_multiple: int = 8):
    """Flat (d,) -> zero-padded (R, 128) with R % rows_multiple == 0."""
    d = x.numel()
    pad = (-d) % (LANES * rows_multiple)
    return F.pad(x.reshape(-1), (0, pad)).view(-1, LANES), d


def _from_tiles(t, d: int):
    return t.reshape(-1)[:d]


def block_topk_compress_vector(x, k_per_block: int):
    """Flat block top-k through the mask kernel: keep about k_per_block of
    every 128-lane row (k plus ties) of x (d,).  Returns the masked dense
    q, (d,)."""
    xt, d = _to_tiles(x)
    mask, _ = dispatch.block_topk_mask(xt, k_per_block)
    return _from_tiles(xt * mask, d)
