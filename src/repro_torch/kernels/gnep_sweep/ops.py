"""Plug-ins for ``game.rm_solve(sweep_fn=...)`` and the batched solvers.

Counterpart of ``repro.kernels.gnep_sweep.ops``.  The functions keep the
JAX package's ``__name__`` strings of its default configuration, so
``SolverConfig.fingerprint()`` reads the same in both packages.  There is
no ``force_pallas`` switch: the kernel wrappers dispatch on the device of
the tensors they are given.
"""
from __future__ import annotations

import functools

from repro_torch.kernels.gnep_sweep.kernel import rm_sweep, rm_sweep_batched


@functools.lru_cache(maxsize=None)
def make_sweep_fn():
    """The single-instance sweep for ``rm_solve(sweep_fn=...)``, memoized so
    every caller shares one object (its name is fingerprinted)."""
    def fn(inc, spare, p_sorted):
        return rm_sweep(inc.contiguous(), spare, p_sorted.contiguous())
    fn.__name__ = "gnep_sweep(force_pallas=False)"
    return fn


@functools.lru_cache(maxsize=None)
def make_batched_sweep_fn():
    """The batched sweep for ``solve_distributed_batch(sweep_fn=...)`` /
    ``SolverConfig(sweep_fn=...)``: (B, Nc, N) x (B,) x (B, N) in one
    kernel launch on the card."""
    def fn(inc, spare, p_sorted):
        return rm_sweep_batched(inc.contiguous(), spare.contiguous(),
                                p_sorted.contiguous())
    fn.__name__ = "gnep_sweep_batched(force_pallas=False)"
    return fn
