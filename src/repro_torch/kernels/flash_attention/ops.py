"""Public entry of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``).

There is no ``force_pallas`` switch: the wrapper launches the CUDA kernel
for CUDA tensors and returns the plain version for CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention


def attention(q, k, v, *, causal=True):
    return flash_attention(q, k, v, causal=causal)
