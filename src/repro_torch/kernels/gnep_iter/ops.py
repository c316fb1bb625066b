"""Plug-in for ``SolverConfig.iter_fn`` / the batched solvers' ``iter_fn=``.

Counterpart of ``repro.kernels.gnep_iter.ops``.  ``make_fused_iter_fn()``
returns the memoized :class:`FusedIterFn` whose ``prepare`` hoists the
iteration-invariant tensors out of the loop and whose ``step`` runs one
fused Alg. 4.1 iteration with the CUDA kernel as its middle.  On CPU
tensors the kernel wrapper runs its plain version, bit for bit the plain
middle of ``ref.iter_step``.
"""
from __future__ import annotations

import functools

from repro_torch.kernels.gnep_iter import ref
from repro_torch.kernels.gnep_iter.kernel import fused_iter_sweep


def _middle_kernel(prep: ref.IterPrep, cand, bids_sorted):
    """The kernel middle for ``ref.iter_step``: one launch, which already
    returns the winning fill row."""
    fill_best, _, best, rho = fused_iter_sweep(
        bids_sorted, prep.inc_max_sorted, prep.p_sorted, cand, prep.spare,
        prep.rho_bar, prep.sum_r_low, prep.p_r_low, prep.const)
    return fill_best, best, rho


class FusedIterFn:
    """The ``iter_fn`` plug-point object of the batched Alg. 4.1 solvers.

    Carries a stable ``__name__``, which ``SolverConfig.fingerprint()``
    records; obtain instances through :func:`make_fused_iter_fn`.

    Parameters
    ----------
    name : str
        Stable identifier recorded in the config fingerprint.
    middle_fn : callable or None
        Override of the O(B x Nc x N) middle passed to ``ref.iter_step``
        (None = the plain middle).
    """

    def __init__(self, name: str, middle_fn=None):
        self.__name__ = name
        self._middle_fn = middle_fn

    def prepare(self, scns, mask) -> ref.IterPrep:
        """Hoist the iteration-invariant prep (see ``ref.prepare``)."""
        return ref.prepare(scns, mask)

    def step(self, prep, scns, mask, r, bids, lam):
        """One fused Alg. 4.1 inner iteration (see ``ref.iter_step``);
        returns ``(r_new, rho, bids_new, eps)``."""
        return ref.iter_step(prep, scns, mask, r, bids, lam,
                             middle_fn=self._middle_fn)


@functools.lru_cache(maxsize=None)
def make_fused_iter_fn() -> FusedIterFn:
    """The fused-iteration plug-in for ``SolverConfig(iter_fn=...)``, with
    the CUDA kernel as its middle; memoized so every solve shares one
    object.  Its name is the JAX package's default one, so fingerprints
    agree across the two packages."""
    return FusedIterFn("gnep_iter(force_pallas=False)", _middle_kernel)
