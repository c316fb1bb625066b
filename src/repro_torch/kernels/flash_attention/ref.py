"""Plain PyTorch version of the flash-attention kernel (O(S^2) memory).

Counterpart of ``repro.kernels.flash_attention.ref``: a thin call into the
model's dense ``reference``.  The kernel wrapper returns it for CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""
from repro_torch.models import attention as _attention


def reference(q, k, v, *, causal=True):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    return _attention.reference(q, k, v, causal=causal)
