"""Public entry of the WKV6 kernel (counterpart of
``repro.kernels.rwkv6.ops``).

There is no ``force_pallas`` switch: the wrapper launches the CUDA kernel
for CUDA tensors and returns the chunked plain version for CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels.rwkv6.kernel import wkv6


def wkv(r, k, v, w_log, u, *, chunk=64):
    return wkv6(r, k, v, w_log, u, chunk=chunk)
