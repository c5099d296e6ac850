"""Plain PyTorch versions of every kernel of the port.

The gossip kernels' and the top-k mask kernel's versions compute exactly
what their CUDA kernels compute, one PyTorch operation per arithmetic step (so no two steps fuse
into an FMA), on node-stacked buffers: row i of an ``(n, L)`` tensor is
gossip node i's bucket buffer, and per-node scalars are ``(n,)`` tensors.
:func:`flash_attention_ref` repeats the flash kernel's online softmax
tile by tile; it is held to the kernel within a tolerance, as is
:func:`wkv6_ref`, RWKV-6's WKV recurrence token by token.

``dispatch.py`` routes CPU tensors here; on the card these are the
versions ``chip_smoke.py`` holds the kernels against.
"""
from __future__ import annotations

import math

import torch

#: the flash kernel's tile (query rows and key columns) and masked logit,
#: those of the Pallas kernel (block_q = block_k = 128, NEG_INF = -1e30)
FLASH_BLOCK = 128
NEG_INF = -1e30


def code_dtype(s: int) -> torch.dtype:
    """Wire code dtype for s quantization levels: int8 up to 127, int16 above."""
    return torch.int8 if s <= 127 else torch.int16


def qsgd_codes_ref(x, xi, inv_norm, s: int):
    """QSGD wire codes  sign(x) * floor(|x| * inv_norm * s + xi).

    x, xi: (n, L) f32; inv_norm: (n,) f32 (0 for a zero row).  Returns
    int8 codes for s <= 127, int16 above."""
    level = torch.floor(x.abs() * inv_norm[:, None] * float(s) + xi)
    return (torch.sign(x) * level).to(code_dtype(s))


def qsgd_leaf_codes_ref(x, xi, norm, s: int):
    """The per-leaf engine's QSGD wire codes
    sign(x) * floor(s |x| / norm + xi), a true division (the packed form,
    :func:`qsgd_codes_ref`, multiplies by 1/norm).

    x: (n, L) f32 or bf16; xi: (n, L) f32; norm: (n,) f32, a zero norm
    given as 1.  On bf16 x, s |x| is rounded to bf16 and the quotient is
    not: what XLA compiles the JAX text ``floor(s * |x| / norm + xi)`` to
    on the CPU for a bf16 x and an f32 xi (its default excess precision
    keeps the bf16 division in f32 before the f32 add), found by holding
    candidate roundings against ``QSGD.compress`` jitted on bf16 vectors
    of many lengths and scales, s in {3, 16, 100, 255}: this one matched
    every code.  Returns int8 codes for s <= 127, int16 above."""
    m = x.to(torch.float32).abs() * float(s)
    if x.dtype == torch.bfloat16:
        m = m.to(torch.bfloat16).to(torch.float32)
    level = torch.floor(m / norm[:, None] + xi)
    return (torch.sign(x.to(torch.float32)) * level).to(code_dtype(s))


def sign_codes_ref(x):
    """SignNorm wire codes: int8 sign(x) (x f32 or bf16)."""
    return torch.sign(x).to(torch.int8)


def dequantize_ref(codes, scale):
    """codes (n, L) int8/int16, scale (n,) f32 -> codes * scale in f32."""
    return codes.to(torch.float32) * scale[:, None]


def block_topk_mask_ref(x, k: int, n_iter: int = 24):
    """Per-row top-k selection mask by threshold bisection, line by line
    the JAX package's oracle.  x: (R, C) f32.  Returns (mask (R, C) f32,
    thresholds (R,) f32); a row keeps between k and k + ties elements."""
    mag = x.abs()
    lo = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    hi = mag.amax(dim=1) + torch.tensor(1e-12, dtype=torch.float32)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        cnt = (mag >= mid[:, None]).sum(dim=1)
        ge = cnt >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return (mag >= lo[:, None]).to(torch.float32), lo


def probe_scale_ref(x):
    """The collective-layer probe's body: x * 2 in f32 (the JAX probe's
    ``o = x * 2.0``)."""
    return x * 2.0


def ef_update_ref(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                  gamma: float, pipelined: bool = False):
    """CHOCO error-feedback update (Algorithm 6 lines 8-10), per node row:

        x_hat' = x_hat + q_self
        s'     = s + (w_self * q_self + w_nbr * q_nbr)
        x'     = x_half + gamma * (s' - x_hat')

    Buffers (n, L) f32; ``w_self``, ``w_nbr``: (n,) f32, node i's weights.
    The s' association is part of the contract.  ``pipelined``: the
    pipelined engine's order (``_pipelined_leaf_updates``), in which x
    reads the pre-round pair, ``x' = x_half + gamma * (s - x_hat)``.
    Returns (x', x_hat', s')."""
    x_hat_n = x_hat + q_self
    s_n = s + (w_self[:, None] * q_self + w_nbr[:, None] * q_nbr)
    x_n = x_half + gamma * ((s - x_hat) if pipelined else (s_n - x_hat_n))
    return x_n, x_hat_n, s_n


def fma_f32(a, b, c):
    """fma(a, b, c) on f32 tensors: a * b + c rounded once to f32 (round
    to nearest even), as the card's ``__fmaf_rn`` and an FMA instruction
    of the CPU compute it.  The product of two f32 values is exact in
    f64; the f64 sum and its exact error (TwoSum) settle the one case in
    which rounding the f64 sum to f32 would round twice: a sum that lands
    on the midpoint of two f32 values while the exact value does not."""
    f64 = torch.float64
    p = a.to(f64) * b.to(f64)
    c = c.to(f64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    r = s.to(torch.float32)
    r64 = r.to(f64)
    half = (torch.nextafter(r, torch.full_like(r, math.inf)).to(f64)
            - r64) * 0.5
    half_below = (r64 - torch.nextafter(
        r, torch.full_like(r, -math.inf)).to(f64)) * 0.5
    up = (s - r64 == half) & (err > 0)           # tie rounded down
    down = (r64 - s == half_below) & (err < 0)   # tie rounded up
    r = torch.where(up, torch.nextafter(r, torch.full_like(r, math.inf)), r)
    return torch.where(down, torch.nextafter(
        r, torch.full_like(r, -math.inf)), r)


def ef_update_bf16_ref(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                       gamma: float, mix_in_bf16: bool,
                       pipelined: bool = False):
    """The CHOCO error-feedback update on bf16 EF state, per node row, with
    the rounding of the JAX package's packed engine on bf16 leaves
    (``_choco_leaf_updates`` as XLA compiles it on the CPU by default):

        x_hat' = bf16(x_hat + q_self)
        mix    = bf16(bf16(w_self q_self) + bf16(w_nbr q_nbr))  mix_in_bf16
                 bf16(w_self q_self + w_nbr q_nbr)              otherwise
        s'     = bf16(s + mix)
        x'     = fma(gamma, f32(s'') - f32(x_hat'), x_half)

    ``x_half`` (n, L) f32; ``x_hat``, ``s``, ``q_self``, ``q_nbr`` (n, L)
    bf16; ``w_self``, ``w_nbr`` (n,) f32.  Uniform weights are Python
    floats in JAX, weak types that take the bf16 arrays' dtype, so the
    weighted sum runs in bf16 (``mix_in_bf16``; the caller rounds the
    weights to bf16).  Per-node self weights are an f32 array there: the
    self term promotes to f32 and so does the sum, and XLA does not round
    the bf16 neighbour term before that upcast, so only the sum rounds
    (w_nbr, a Python float, is still bf16-valued).

    XLA computes x' in a fusion of its own: it contracts the last
    multiply-add into one FMA, leaves ``s'' - x_hat'`` unrounded before
    the upcast (its default excess precision drops a bf16 rounding that
    is only widened), and recomputes s'' there: with per-node weights,
    with the weighted sum contracted into ``fma(w_self, q_self, w_nbr
    q_nbr)``, so s'' may differ from the s' it stores by one bf16 step;
    with uniform weights s'' is s'.  Each step is one f32 operation,
    rounded to bf16 where shown.

    f32 payloads (``q_self`` and ``q_nbr`` f32: the per-leaf engine's
    QSGD and sign payloads, which JAX decodes to f32) take the per-leaf
    engine's rounding, as XLA compiles it (held bit for bit against the
    JAX per-leaf engine, ``tests/test_torch_per_leaf.py``):

        x_hat' = bf16(x_hat + bf16(q_self))
        s'     = bf16(s + bf16(w_self q_self + w_nbr q_nbr))   in f32
        x'     = fma(gamma, f32(s') - f32(x_hat'), x_half)

    ``pipelined``: the pipelined order (``_pipelined_leaf_updates``), x'
    = fma(gamma, f32(s) - f32(x_hat), x_half) over the pre-round pair;
    x_hat' and s' as above.  Returns (x', x_hat', s')."""
    f32, bf16 = torch.float32, torch.bfloat16
    if q_self.dtype == f32:
        return _ef_update_bf16_f32q(x_half, x_hat, s, q_self, q_nbr, w_self,
                                    w_nbr, gamma, pipelined)
    qs = q_self.to(f32)
    x_hat_n = (x_hat.to(f32) + qs).to(bf16)
    ws = w_self[:, None].expand_as(qs)
    own = ws * qs
    nbr = w_nbr[:, None] * q_nbr.to(f32)
    if mix_in_bf16:
        own = own.to(bf16).to(f32)
        nbr = nbr.to(bf16).to(f32)
    mix = (own + nbr).to(bf16).to(f32)
    s_n = (s.to(f32) + mix).to(bf16)
    s_x = s_n
    if not mix_in_bf16:
        mix_x = fma_f32(ws, qs, nbr).to(bf16).to(f32)
        s_x = (s.to(f32) + mix_x).to(bf16)
    d = ((s.to(f32) - x_hat.to(f32)) if pipelined
         else (s_x.to(f32) - x_hat_n.to(f32)))
    x_n = fma_f32(torch.full_like(d, gamma), d, x_half)
    return x_n, x_hat_n, s_n


def _ef_update_bf16_f32q(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                         gamma: float, pipelined: bool):
    """:func:`ef_update_bf16_ref` on f32 payloads."""
    f32, bf16 = torch.float32, torch.bfloat16
    x_hat_n = (x_hat.to(f32) + q_self.to(bf16).to(f32)).to(bf16)
    own = w_self[:, None] * q_self
    nbr = w_nbr[:, None] * q_nbr
    mix = (own + nbr).to(bf16).to(f32)
    s_n = (s.to(f32) + mix).to(bf16)
    d = ((s.to(f32) - x_hat.to(f32)) if pipelined
         else (s_n.to(f32) - x_hat_n.to(f32)))
    x_n = fma_f32(torch.full_like(d, gamma), d, x_half)
    return x_n, x_hat_n, s_n


def _round_state(v, dtype):
    """f32 values rounded to the EF state's dtype (nothing for f32)."""
    return v if dtype == torch.float32 else v.to(dtype).to(torch.float32)


def replica_matching_ref(x, h, s, q_self, q_nbr, send, gv):
    """The matching form of the topology-process engine's replica update
    (JAX ``make_process_choco_fn``, ``matching_local_fn``), per node row,
    for the sampled round r:

        H_r' = H_r + st(send q_self)
        S_r' = S_r + st(q_nbr)
        x'   = x + (gamma v_r) (S_r' - H_r')

    each sum rounded to the EF state's dtype (st: the rounding of
    ``.astype(h.dtype)``, nothing on f32 state).  ``x`` (n, L) f32; ``h``,
    ``s`` f32 or bf16; ``q_self``, ``q_nbr`` f32, or bf16 with bf16 state
    (``q_nbr`` zero on a row the round gives nothing); ``send`` and ``gv``
    (n,) f32: the node's send bit and ``f32(gamma) * v_r``.  x' is one
    FMA over the unrounded f32 difference, ``fma(gv, S_r' - H_r', x)``,
    as XLA compiles the JAX text on the CPU (found by holding candidate
    roundings against the jitted JAX engine, f32 and bf16 state: this one
    matched every element).  Returns (x', H_r', S_r')."""
    f32, sd = torch.float32, h.dtype
    h_n = _round_state(h.to(f32) + _round_state(send[:, None]
                                                * q_self.to(f32), sd), sd)
    s_n = _round_state(s.to(f32) + _round_state(q_nbr.to(f32), sd), sd)
    d = s_n - h_n
    x_n = fma_f32(gv[:, None].expand_as(d), d, x)
    return x_n, h_n.to(sd), s_n.to(sd)


def replica_stale_ref(x, h, q_self, s_list, q_list, own_ring, rings, w,
                      delays, gamma: float):
    """The ring form of the replica update, bounded staleness (JAX
    ``make_async_choco_fn``, ``src/repro/comm/async_gossip.py:376-404``)
    and at tau = 0 link failures (JAX ``make_process_choco_fn``,
    ``linkfail_local_fn``), per node row, over the schedule's R rounds and
    the depth-tau rings:

        x_hat'       = x_hat + st(q_self);   own_ring[0] <- st(q_self)
        S_r'         = S_r + st(q_r);        rings[r][0] <- st(q_r)
        diff_r       = (S_r' - x_hat') - sum_{j < d_r} (rings[r][j] - own_ring[j])
        acc          = sum_r w_r diff_r                        f32
        x'           = fma(gamma, acc, x)

    ``s_list`` and ``q_list`` the R replicas and received payloads (a
    payload zero where the round gives the row nothing; every payload
    arrives); ``own_ring`` holds tau slots and ``rings`` R lists of tau
    slots, slot 0 the recycled one (what it holds on entry is not read)
    and slot j the increment of j rounds back; ``w`` (R, n) f32, each
    round's receive weights (zero where the round skips the row; under
    link failures JAX's ``round_recv[r] * mask``, zero where the row's
    link of round r is down); ``delays`` (R, n) int32, the delay of each
    row's round-r edge, in {0..tau} (not read at tau = 0, may be None).
    The differences stay f32 (unrounded on bf16 state, XLA's excess
    precision), a masked ring term is left out rather than subtracted as
    zero, and the sum over r is XLA's contraction of the JAX loop ``acc =
    0 + w_0 d_0; acc = acc + w_r d_r`` on the CPU: the zero dropped, the
    first add contracted into ``fma(w_0, d_0, w_1 d_1)`` and each later
    one into ``fma(w_r, d_r, acc)`` (found, like x's FMA, by holding
    candidates against the jitted JAX engines; the order of the first
    pair matters).  Returns (x', x_hat', [S_r'], own_ring[0]',
    [rings[r][0]']); at tau = 0 no slot takes the last two."""
    f32, sd = torch.float32, h.dtype
    tau = len(own_ring)
    q_own = _round_state(q_self.to(f32), sd)
    h_n = _round_state(h.to(f32) + q_own, sd)
    own = [q_own] + [o.to(f32) for o in own_ring[1:]]
    terms, new_s, new_rings = [], [], []
    for r, (sr, qr) in enumerate(zip(s_list, q_list)):
        q_in = _round_state(qr.to(f32), sd)
        s_n = _round_state(sr.to(f32) + q_in, sd)
        new_s.append(s_n.to(sd))
        new_rings.append(q_in.to(sd))
        diff = s_n - h_n
        ring = [q_in] + [t.to(f32) for t in rings[r][1:]] if tau else []
        for j in range(tau):
            live = (delays[r] > j)[:, None]
            diff = torch.where(live, diff - (ring[j] - own[j]), diff)
        terms.append((w[r][:, None].expand_as(diff), diff))
    (w0, d0), rest = terms[0], terms[1:]
    if not rest:
        acc = w0 * d0
    else:
        acc = fma_f32(w0, d0, rest[0][0] * rest[0][1])
        for wr, d in rest[1:]:
            acc = fma_f32(wr, d, acc)
    x_n = fma_f32(torch.full_like(acc, gamma), acc, x)
    return x_n, h_n.to(sd), new_s, q_own.to(sd), new_rings


def flash_attention_ref(q, k, v, *, causal: bool = True, softcap=None,
                        window=None, row_tile: int = FLASH_BLOCK):
    """Online-softmax attention, step for step as the flash kernels.

    q: (N, S, H, Dh); k, v: (N, S, KV, Dh), H a multiple of KV: head h
    reads KV head h // (H // KV).  Computed in f32 over 128-wide key
    blocks: the scaled query ``q * (1/sqrt(Dh))``, optional
    ``softcap * tanh(l / softcap)``, the causal mask by index (-1e30), a
    running max, denominator and accumulator, and
    ``acc / max(l, 1e-30)``.  A causal query tile stops at the diagonal
    key block, so key block j updates only the query rows from ``j * 128``
    on.  Any S: the last block is ragged.  Returns (N, S, H, Dh) in q's
    dtype.

    ``window`` (the JAX ``_chunked_attention(local=True)``'s mask): a key
    is kept iff ``k_pos > q_pos - window``, ANDed with the causal mask.
    A tile of ``row_tile`` query rows skips the key blocks that lie wholly
    before its first row's window, as the kernels' query tiles do (128
    rows in the bf16 kernel, 64 in the f32 one), and masks the rest.
    Skipping or masking a block that lies wholly before a row's window
    gives the same result bit for bit: while such blocks come first, the
    row's max stays -1e30 and its p are exp(0) = 1, but its first kept key
    sets a finite max m and alpha = exp(-1e30 - m) = 0 exactly, which
    clears the running sum and accumulator (``row_tile=S``, one tile,
    masks every such block; ``row_tile=1`` skips every one).

    bf16 inputs take the tensor-core kernel's rounding points instead:
    the logits are the product of the f32 upcasts, scaled after it,
    ``(q k^T) * (1/sqrt(Dh))``; the row sum runs over the f32 p; and p is
    rounded to bf16 (nearest even) before ``p @ v``, which sums in f32.
    (At Dh 256 the kernel accumulates ``p @ v`` onto ``acc * alpha`` on
    the tensor cores, where this adds a block's f32 sum to it: f32
    rounding apart, the same.)"""
    N, S, H, Dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    f32 = torch.float32
    bf16 = q.dtype == torch.bfloat16
    # (N, KV, rep, S, Dh): the rep query heads that share one KV head
    qf = (q.to(f32) if bf16 else q.to(f32) * (1.0 / math.sqrt(Dh))).reshape(
        N, S, KV, rep, Dh).permute(0, 2, 3, 1, 4)
    kf = k.to(f32).permute(0, 2, 1, 3)[:, :, None]          # (N, KV, 1, S, Dh)
    vf = v.to(f32).permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((N, KV, rep, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((N, KV, rep, S), dtype=f32, device=q.device)
    acc = torch.zeros((N, KV, rep, S, Dh), dtype=f32, device=q.device)
    for k0 in range(0, S, FLASH_BLOCK):
        k1 = min(k0 + FLASH_BLOCK, S)
        r0 = k0 if causal else 0
        r1 = S
        if window is not None:
            # the tiles whose first row's window reaches into this block:
            # first row t0 with t0 - window < k0 + 127
            r1 = min(S, ((k0 + FLASH_BLOCK - 2 + window) // row_tile + 1)
                     * row_tile)
            if r1 <= r0:
                continue
        logits = qf[..., r0:r1, :] @ kf[..., k0:k1, :].transpose(-1, -2)
        if bf16:
            logits = logits * (1.0 / math.sqrt(Dh))
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        if causal:
            logits = torch.where(kpos <= qpos, logits, NEG_INF)
        if window is not None:
            logits = torch.where(kpos > qpos - window, logits, NEG_INF)
        m_old = m[..., r0:r1]
        m_new = torch.maximum(m_old, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_old - m_new)
        l_new = l[..., r0:r1] * alpha + p.sum(dim=-1)
        pv = (p.to(torch.bfloat16).to(f32) if bf16 else p) @ vf[..., k0:k1, :]
        acc_new = acc[..., r0:r1, :] * alpha[..., None] + pv
        # rows outside [r0, r1) (earlier query tiles; tiles whose window
        # starts after this block) keep their state
        m = torch.cat([m[..., :r0], m_new, m[..., r1:]], dim=-1)
        l = torch.cat([l[..., :r0], l_new, l[..., r1:]], dim=-1)
        acc = torch.cat([acc[..., :r0, :], acc_new, acc[..., r1:, :]], dim=-2)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(N, S, H, Dh).to(q.dtype)


def wkv6_ref(r, k, v, w, u, state=None):
    """RWKV-6's WKV recurrence, token by token in f32, as the JAX
    ``_wkv_scan`` (``src/repro/models/rwkv6.py:72``).  Per head, with k, v
    in R^P and the state S in R^{P x P}:

        out_t = r_t^T (S_t + diag(u) k_t v_t^T)
        S_{t+1} = diag(w_t) S_t + k_t v_t^T

    r, k, v: (N, S, H, P) in any float dtype, upcast to f32; w: (N, S, H,
    P) f32 decays in (0, 1); u: (H, P) or (N, H, P) f32 bonus; state:
    (N, H, P, P) f32 carried in, or None for zeros.  Returns (out (N, S,
    H, P) f32, final state (N, H, P, P) f32)."""
    N, S, H, P = r.shape
    f32 = torch.float32
    u = u.to(f32).expand(N, H, P)[..., None]                   # (N, H, P, 1)
    st = (torch.zeros((N, H, P, P), dtype=f32, device=r.device)
          if state is None else state.to(f32))
    rf, kf, vf, wf = (t.to(f32) for t in (r, k, v, w))
    out = torch.empty((N, S, H, P), dtype=f32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (N, H, P, P)
        out[:, t] = torch.einsum("nhp,nhpq->nhq", rf[:, t], st + u * kv)
        st = wf[:, t, :, :, None] * st + kv
    return out, st
