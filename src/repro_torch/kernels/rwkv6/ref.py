"""Plain PyTorch versions of the WKV6 kernel.

Counterpart of ``repro.kernels.rwkv6.ref``.  ``reference`` is the exact
per-step recurrence, as in JAX.  ``chunked_reference`` is the model's
chunked form at a given chunk: the function the kernel computes (its
log-decay clamps make the result depend on the chunk), which the kernel
wrapper returns for CPU tensors and ``chip_smoke.py`` holds the CUDA kernel
to on the card.
"""
from repro_torch.models import rwkv as _rwkv


def reference(r, k, v, w_log, u, S0):
    """r/k/v/w_log: (B,T,H,K); u: (H,K); S0: (B,H,K,V) -> (y, S_final)."""
    return _rwkv.wkv_recurrent(r, k, v, w_log, u, S0)


def chunked_reference(r, k, v, w_log, u, S0, *, chunk):
    """The chunked form at ``chunk`` (``T % chunk == 0``)."""
    return _rwkv.wkv_chunked(r, k, v, w_log, u, S0, chunk=chunk)
