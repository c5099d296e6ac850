"""Route each kernel call of the port to its kernel: the stages of the
gossip exchanges (QSGD codes in the packed and the per-leaf form, sign
codes, dequantize, the EF update on f32 and on bf16 state, each in
serial and in pipelined order, and the topology-process engine's replica
update in its matching, link-failure and bounded-staleness forms), the top-k selection mask, flash
attention, and the collective-layer probe.

The route follows the tensor's device and nothing else:

* a CPU tensor takes the plain PyTorch version (``kernels/ref.py``);
* any other tensor goes to the hand-written CUDA kernel, which launches
  or raises.  There is no probe and no backend flag, so the plain
  version never runs on the card.

Each kernel wrapper counts its own launches; :func:`launch_counts` reads
the counts and :func:`reset_launch_counts` sets them to 0.

:func:`probe_collectives` is the port's counterpart of the JAX package's
toolchain probe (``src/repro/kernels/dispatch.py:77-157``): it asks the
per-rank engine's transport whether a tensor written by a kernel of the
port crosses it intact.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import ef_update as _ef
from . import flash_attention as _flash
from . import probe as _probe
from . import qsgd as _qsgd
from . import ref
from . import topk as _topk

#: entry name -> kernel wrapper carrying the ``launches`` count
KERNELS = {
    "qsgd_codes": _qsgd.qsgd_codes,
    "qsgd_leaf_codes": _qsgd.qsgd_leaf_codes,
    "sign_codes": _qsgd.sign_codes,
    "dequantize": _qsgd.dequantize,
    "ef_update": _ef.ef_update,
    "ef_update_pipelined": _ef.ef_update_pipelined,
    "ef_update_bf16": _ef.ef_update_bf16,
    "ef_update_bf16_pipelined": _ef.ef_update_bf16_pipelined,
    "replica_update": _ef.replica_update,
    "flash_attention": _flash.flash_attention,
    "block_topk_mask": _topk.block_topk_mask,
    "probe_scale": _probe.probe_scale,
}


def _on_cpu(t) -> bool:
    # an attribute read: ``t.device.type`` builds a device object per call
    return t.is_cpu


def qsgd_codes(x, xi, inv_norm, s: int):
    """QSGD wire codes for node-stacked bucket buffers (send half).

    ``x``, ``xi``: (n, L) f32 delta and uniform dither; ``inv_norm``: (n,)
    f32 ``1/||x_i||`` (0 for a zero row), computed by the caller on the
    unpadded buffer.  int8 codes for s <= 127, int16 above."""
    if _on_cpu(x):
        return ref.qsgd_codes_ref(x, xi, inv_norm, s)
    return _qsgd.qsgd_codes(x, xi, inv_norm, s)


def qsgd_leaf_codes(x, xi, norm, s: int):
    """The per-leaf engine's QSGD wire codes, one row per leaf row
    (``ref.qsgd_leaf_codes_ref``).  ``x``: (n, L) f32 or bf16 delta;
    ``xi``: (n, L) f32; ``norm``: (n,) f32 row norms, a zero norm given
    as 1."""
    if _on_cpu(x):
        return ref.qsgd_leaf_codes_ref(x, xi, norm, s)
    return _qsgd.qsgd_leaf_codes(x, xi, norm, s)


def sign_codes(x):
    """SignNorm int8 wire codes of (n, L) f32 or bf16 rows."""
    if _on_cpu(x):
        return ref.sign_codes_ref(x)
    return _qsgd.sign_codes(x)


def dequantize(codes, scale):
    """Receive-side decode: (n, L) codes * (n,) scale -> (n, L) f32."""
    if _on_cpu(codes):
        return ref.dequantize_ref(codes, scale)
    return _qsgd.dequantize(codes, scale)


def ef_bucket_update(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma,
                     mix_in_bf16: bool = False, pipelined: bool = False):
    """Fused CHOCO EF integrate for one node-stacked bucket, or one leaf's
    slot of it (recv half), in place: ``x_half`` (f32) becomes x',
    ``x_hat`` and ``s`` their updates.  Each row of the five tensors is
    contiguous; x_half, x_hat and s share one row stride, the payloads
    another.  ``w_self`` and ``w_nbr`` are (n,) f32 on the buffers'
    device, one weight per node row.  The EF state's dtype picks the
    entry: f32, or bf16 (``x_hat``, ``s``; the payloads bf16, or f32 from
    the per-leaf engine's QSGD and sign), where ``mix_in_bf16`` says
    whether the weighted sum of bf16 payloads runs in bf16
    (``ref.ef_update_bf16_ref``).  ``pipelined`` takes the pipelined
    engine's order (x reads the pre-round s - x_hat).  Returns those
    three tensors."""
    bf16 = x_hat.dtype == torch.bfloat16
    if not _on_cpu(x_half):
        if bf16:
            fn = _ef.ef_update_bf16_pipelined if pipelined else _ef.ef_update_bf16
            return fn(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma,
                      mix_in_bf16)
        fn = _ef.ef_update_pipelined if pipelined else _ef.ef_update
        return fn(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma)
    new = (ref.ef_update_bf16_ref(x_half, x_hat, s, q_self, q_nbr, w_self,
                                  w_nbr, gamma, mix_in_bf16, pipelined)
           if bf16 else
           ref.ef_update_ref(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr,
                             gamma, pipelined))
    for old, n in zip((x_half, x_hat, s), new):
        old.copy_(n)
    return x_half, x_hat, s


def replica_matching(x, h, s, q_self, q_nbr, send, gv):
    """The topology-process engine's matching update for one bucket (or
    leaf slot) in place (``ref.replica_matching_ref``): ``h`` is the
    sampled round's own reference H_r, ``s`` its source replica S_r,
    ``send`` and ``gv`` (n,) f32 per node row.  Returns (x, h, s)."""
    if not _on_cpu(x):
        return _ef.replica_matching(x, h, s, q_self, q_nbr, send, gv)
    new = ref.replica_matching_ref(x, h, s, q_self, q_nbr, send, gv)
    for old, t in zip((x, h, s), new):
        old.copy_(t)
    return x, h, s


def replica_stale(x, h, q_self, s_list, q_list, own_ring, rings, w,
                  delays, gamma):
    """The ring form of the replica update for one bucket (or leaf slot)
    in place (``ref.replica_stale_ref``): x, x_hat, the R replicas and
    slot 0 of the own ring and of each receive ring (``own_ring`` tau
    slots, ``rings`` R lists of tau); ``w`` (R, n) f32 receive weights,
    ``delays`` (R, n) int32, None at tau 0.  Bounded staleness, and link
    failures at tau 0 with the edge mask in ``w``.  Returns (x, h,
    s_list)."""
    if not _on_cpu(x):
        return _ef.replica_stale(x, h, q_self, s_list, q_list, own_ring,
                                 rings, w, delays, gamma)
    x_n, h_n, s_n, own0, ring0 = ref.replica_stale_ref(
        x, h, q_self, s_list, q_list, own_ring, rings, w, delays, gamma)
    outs = [(x, x_n), (h, h_n)] + list(zip(s_list, s_n))
    if own_ring:
        outs += [(own_ring[0], own0)] + [(rg[0], t)
                                         for rg, t in zip(rings, ring0)]
    for old, t in outs:
        old.copy_(t)
    return x, h, s_list


def block_topk_mask(x, k: int):
    """Per-row top-k selection: x (R, C) f32, C a multiple of 128 ->
    (mask (R, C) f32, thresholds (R,) f32)."""
    if _on_cpu(x):
        return ref.block_topk_mask_ref(x, k)
    return _topk.block_topk_mask(x, k)


def flash_attention(q, k, v, *, causal: bool = True, softcap=None):
    """Attention forward, q (N, S, H, Dh), k and v (N, S, KV, Dh) ->
    (N, S, H, Dh) in q's dtype: f32 inputs computed in f32, bf16 inputs
    with P rounded to bf16 before P V (``ref.flash_attention_ref``)."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    return _flash.flash_attention(q, k, v, causal=causal, softcap=softcap)


def probe_scale(x):
    """The collective-layer probe's body: x * 2 (f32)."""
    if _on_cpu(x):
        return ref.probe_scale_ref(x)
    return _probe.probe_scale(x)


@dataclasses.dataclass(frozen=True)
class CollectiveProbe:
    """What :func:`probe_collectives` found.  A probe that fails raises,
    so a record always says the exchange carried the kernel's output
    intact."""
    torch_version: str
    #: the process group's backend ("nccl" or "gloo")
    backend: str
    world_size: int
    #: where the ranks' tensors live ("cuda" or "cpu")
    device_type: str
    #: payloads are staged through pinned host buffers
    staged: bool
    #: the kernel's output arrived one ring hop away bit for bit
    intact: bool


def _probe_block(rank: int):
    """The probe's (8, 128) f32 input on rank ``rank``: normal draws from
    a CPU generator seeded with the rank, so every rank can rebuild any
    other rank's input."""
    gen = torch.Generator().manual_seed(rank)
    return torch.randn(_probe.PROBE_SHAPE, generator=gen)


@functools.lru_cache(maxsize=None)
def probe_collectives(group) -> CollectiveProbe:
    """Probe, once per process and group, whether a tensor written by a
    kernel of the port passes through the per-rank engine's exchange
    intact.  Launches the probe kernel on an (8, 128) f32 block on the
    rank's device (its plain version on the CPU), sends the output one hop
    around the ring through ``group.sendrecv`` (the engine's own
    transport), and checks bit for bit that what arrives is twice the
    ring neighbour's input.  Raises if it is not; switches nothing."""
    out = probe_scale(_probe_block(group.rank).to(group.device))
    src = (group.rank - 1) % group.size
    if group.size > 1:
        raw = group.sendrecv(out.reshape(-1).view(torch.uint8),
                             (group.rank + 1) % group.size, src)
        got = raw.view(torch.float32).view(_probe.PROBE_SHAPE)
    else:
        got = out
    want = ref.probe_scale_ref(_probe_block(src))
    if not torch.equal(got.cpu(), want):
        raise RuntimeError(
            f"collective probe: rank {group.rank} received from rank {src} "
            f"a block that is not twice that rank's input (backend "
            f"{group.backend}, staged {group.staged}); the exchange does not "
            f"carry kernel outputs intact")
    return CollectiveProbe(torch_version=torch.__version__,
                           backend=group.backend, world_size=group.size,
                           device_type=group.device.type, staged=group.staged,
                           intact=True)


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
