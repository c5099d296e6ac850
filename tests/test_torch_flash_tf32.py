"""The f32 flash contract's power, on the CPU, and the CPU repair that makes
the token embedding's gradient the same in every run.

The f32 flash kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``)
runs its two products on the tensor cores in 3xTF32: each operand a is
split as big = tf32(a), small = tf32(a - big), and each product is
big.big + big.small + small.big.  Here that is emulated on the CPU, with
TF32 as round-to-nearest-even to 10 mantissa bits, inside the algorithm
of ``ref.flash_attention_ref`` (128-key blocks, online softmax, the
Pallas kernel's association), on seeded numpy inputs, and held against
the plain version on the same f32 inputs with the kernel's contract,
max|d| <= 1e-5 max|out|:

* 3xTF32 meets it, with f32 sums and, as on the card, with each 8-wide
  step's sum rounded toward zero in the kernel's order (the two
  correction terms first, the block's P V summed on its own);
* 1xTF32 (big.big) and 2xTF32 (small.big dropped) do not, so the contract
  tells the three apart;
* rounding toward zero along one chain per product across all key blocks
  (the first form of the kernel) reads several times the kernel's error.

The emulation lives here, not in the package.  The last test holds the
repair of the CPU runs: the token embedding's gradient is the same in
every run.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import FLASH_BLOCK, NEG_INF
from repro_torch.models import layers
from test_torch_slice import one_thread  # noqa: F401  (autouse)

RTOL = 1e-5

#: (S, Dh, causal, softcap): both lengths (one odd), the four head dims,
#: both masks, and a softcap case at Dh 64 and at 256
CASES = [(s, dh, causal, None) for s in (256, 1000)
         for dh in (64, 80, 128, 256)
         for causal in (True, False)] + [(1000, 64, True, 30.0),
                                         (1000, 256, True, 50.0)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest even at 10 mantissa bits (TF32), as f32."""
    bits = x.view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def product(a, b, terms):
    """a @ b from TF32 parts with f32 sums: big.big, then big.small
    (terms >= 2), then small.big (terms >= 3)."""
    (ab, al), (bb, bl) = split(a), split(b)
    out = ab @ bb
    if terms >= 2:
        out = out + ab @ bl
    if terms >= 3:
        out = out + al @ bb
    return out


def attention(q, k, v, causal, softcap, terms):
    """``ref.flash_attention_ref``'s algorithm for f32 inputs with both
    products from ``terms`` TF32 parts.  q (N, S, H, Dh), k, v (N, S, KV,
    Dh)."""
    N, S, H, Dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    qf = (q * (1.0 / math.sqrt(Dh))).reshape(N, S, KV, rep, Dh).permute(
        0, 2, 3, 1, 4)
    kf = k.permute(0, 2, 1, 3)[:, :, None]
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((N, KV, rep, S), NEG_INF)
    l = torch.zeros((N, KV, rep, S))
    acc = torch.zeros((N, KV, rep, S, Dh))
    for k0 in range(0, S, FLASH_BLOCK):
        k1 = min(k0 + FLASH_BLOCK, S)
        logits = product(qf, kf[..., k0:k1, :].transpose(-1, -2), terms)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        if causal:
            keep = (torch.arange(k0, k1)[None, :]
                    <= torch.arange(S)[:, None])
            logits = torch.where(keep, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + product(p, vf[..., k0:k1, :], terms)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(N, S, H, Dh)


def inputs(seed, s, dh, n=1, h=4, kv=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((n, s, x, dh)).astype(
        np.float32)) for x in (h, kv, kv)]


def gap(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_tf32_rounds_to_nearest_even_at_ten_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      1.0 + 2.0 ** -10 + 2.0 ** -20, -3.0e-3])
    got = tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    big, small = split(x)
    # the two parts hold 22 of the 24 mantissa bits
    assert float(((big + small) - x).abs().max() / x.abs().max()) < 2.0 ** -21


@pytest.mark.parametrize("s,dh,causal,softcap", CASES)
def test_3xtf32_meets_the_f32_contract_and_fewer_terms_do_not(s, dh, causal,
                                                              softcap):
    q, k, v = inputs(s + dh, s, dh)
    want = ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    rel = {terms: gap(attention(q, k, v, causal, softcap, terms), want)
           for terms in (1, 2, 3)}
    assert rel[3] <= RTOL, rel
    assert rel[2] > RTOL and rel[1] > RTOL, rel


# -- the tensor cores' accumulation ------------------------------------------

def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounded toward zero."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def chain(acc, terms, depth):
    """acc + sum of A @ B over ``terms``, one wgmma k8 step at a time (all
    terms of a step, in order, each rounded toward zero into acc)."""
    for k0 in range(0, depth, 8):
        for a, b in terms:
            part = a[..., k0:k0 + 8].double() @ b[k0:k0 + 8].double()
            acc = round_toward_zero(part if acc is None else acc.double() + part)
    return acc


def tensor_core_attention(q, k, v, kernel_order, keys=64):
    """One head, non-causal, ``keys``-key blocks (64; 32 at Dh 256),
    3xTF32 on emulated tensor cores.  ``kernel_order``: the kernel's
    (corrections first, the block's P V summed from zero and added with
    round-to-nearest); else one chain per product (terms interleaved per
    step, P V into the running output)."""
    S, Dh = q.shape
    qb, ql = split(q * (1.0 / math.sqrt(Dh)))
    m = torch.full((S,), NEG_INF)
    l = torch.zeros(S)
    o = torch.zeros((S, Dh))
    for k0 in range(0, S, keys):
        (kb, kl), (vb, vl) = split(k[k0:k0 + keys]), split(v[k0:k0 + keys])
        keys = kb.shape[0]
        if kernel_order:
            s = chain(chain(None, [(qb, kl.T), (ql, kb.T)], Dh),
                      [(qb, kb.T)], Dh)
        else:
            s = chain(None, [(qb, kb.T), (qb, kl.T), (ql, kb.T)], Dh)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[:, None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        m = m_new
        pb, pl = split(p)
        if kernel_order:
            pv = chain(chain(None, [(pb, vl), (pl, vb)], keys), [(pb, vb)], keys)
            o = o * alpha[:, None] + pv
        else:
            o = chain(o * alpha[:, None], [(pb, vb), (pb, vl), (pl, vb)], keys)
    return o / l[:, None]


def test_the_kernels_accumulation_order_keeps_the_contract():
    """S 1000 non-causal, Dh 128: the kernel's order meets the contract
    with room to spare; one chain per product reads several times its
    error (2.1e-6 and 1.4e-5 on these inputs)."""
    q, k, v = (t[0, :, 0] for t in inputs(7, 1000, 128, h=1, kv=1))
    want = ref.flash_attention_ref(q[None, :, None], k[None, :, None],
                                   v[None, :, None], causal=False)[0, :, 0]
    ours = gap(tensor_core_attention(q, k, v, True), want)
    one_chain = gap(tensor_core_attention(q, k, v, False), want)
    assert ours <= RTOL / 2, (ours, one_chain)
    assert one_chain >= 3 * ours, (ours, one_chain)


def test_the_kernels_accumulation_order_keeps_the_contract_at_dh80():
    """The same at hubert-xlarge's head dim 80 (10 k-steps a Q K^T
    product, P V at n80): the kernel's order within half the contract."""
    q, k, v = (t[0, :, 0] for t in inputs(7, 1000, 80, h=1, kv=1))
    want = ref.flash_attention_ref(q[None, :, None], k[None, :, None],
                                   v[None, :, None], causal=False)[0, :, 0]
    assert gap(tensor_core_attention(q, k, v, True), want) <= RTOL / 2


def test_the_kernels_accumulation_order_keeps_the_contract_at_dh256():
    """The same at gemma's head dim 256, in the order of the Dh 256
    instance: 32-key blocks, 32 k-steps a Q K^T term (each logit's chain
    is the same whichever warpgroup computes it), each block's P V at 4
    k-steps a term: within half the contract, where one chain per product
    is several times further off."""
    q, k, v = (t[0, :, 0] for t in inputs(7, 1000, 256, h=1, kv=1))
    want = ref.flash_attention_ref(q[None, :, None], k[None, :, None],
                                   v[None, :, None], causal=False)[0, :, 0]
    ours = gap(tensor_core_attention(q, k, v, True, keys=32), want)
    one_chain = gap(tensor_core_attention(q, k, v, False, keys=32), want)
    assert ours <= RTOL / 2, (ours, one_chain)
    assert one_chain >= 3 * ours, (ours, one_chain)


# -- the CPU repair ------------------------------------------------------------

def test_token_embedding_gradient_is_the_same_in_every_run():
    """The lookup's backward adds a token's rows in position order, so two
    threads give the serial sum, bit for bit, every time (advanced
    indexing's backward added them across threads in a varying order)."""
    rng = np.random.default_rng(0)
    n, V, D = 2, 512, 256
    tokens = torch.from_numpy(rng.integers(0, V, (n, 4, 128)).astype(np.int32))
    table = torch.from_numpy(rng.standard_normal((n, V, D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 4, 128, D)).astype(np.float32))
    cfg = type("Cfg", (), {"tie_embeddings": False})()
    serial = torch.zeros_like(table)
    for i in range(n):
        for t, row in zip(tokens[i].reshape(-1).tolist(), g[i].reshape(-1, D)):
            serial[i, t] += row
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for _ in range(8):
            tab = table.clone().requires_grad_(True)
            x = layers.embed_tokens({"tok": tab}, tokens, cfg)
            assert torch.equal(x.detach(), table[torch.arange(n)[:, None, None],
                                                 tokens.long()])
            (grad,) = torch.autograd.grad(x, tab, g)
            assert torch.equal(grad, serial)
    finally:
        torch.set_num_threads(threads)
