"""Route each hot-path stage of the packed gossip exchange to its kernel.

The route follows the tensor's device and nothing else:

* a CPU tensor takes the plain PyTorch version (``kernels/ref.py``);
* any other tensor goes to the hand-written CUDA kernel, which launches
  or raises.  There is no probe and no backend flag, so the plain
  version never runs on the card.

Each kernel wrapper counts its own launches; :func:`launch_counts` reads
the four counts and :func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from . import ef_update as _ef
from . import qsgd as _qsgd
from . import ref

#: entry name -> kernel wrapper carrying the ``launches`` count
KERNELS = {
    "qsgd_codes": _qsgd.qsgd_codes,
    "sign_codes": _qsgd.sign_codes,
    "dequantize": _qsgd.dequantize,
    "ef_update": _ef.ef_update,
}


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def qsgd_codes(x, xi, inv_norm, s: int):
    """QSGD wire codes for node-stacked bucket buffers (send half).

    ``x``, ``xi``: (n, L) f32 delta and uniform dither; ``inv_norm``: (n,)
    f32 ``1/||x_i||`` (0 for a zero row), computed by the caller on the
    unpadded buffer.  int8 codes for s <= 127, int16 above."""
    if _on_cpu(x):
        return ref.qsgd_codes_ref(x, xi, inv_norm, s)
    return _qsgd.qsgd_codes(x, xi, inv_norm, s)


def sign_codes(x):
    """SignNorm int8 wire codes for node-stacked bucket buffers."""
    if _on_cpu(x):
        return ref.sign_codes_ref(x)
    return _qsgd.sign_codes(x)


def dequantize(codes, scale):
    """Receive-side decode: (n, L) codes * (n,) scale -> (n, L) f32."""
    if _on_cpu(codes):
        return ref.dequantize_ref(codes, scale)
    return _qsgd.dequantize(codes, scale)


def ef_bucket_update(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma):
    """Fused CHOCO EF integrate for one node-stacked f32 bucket (recv half).
    Returns ``(x', x_hat', s')``."""
    if _on_cpu(x_half):
        return ref.ef_update_ref(x_half, x_hat, s, q_self, q_nbr,
                                 w_self, w_nbr, gamma)
    return _ef.ef_update(x_half, x_hat, s, q_self, q_nbr, w_self, w_nbr, gamma)


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
