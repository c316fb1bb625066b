"""Centralized solver for the reduced convex program (P3), in PyTorch.

Counterpart of ``repro.core.centralized``.  (P3) is separable with one
coupling constraint, so its KKT system is solved exactly by water-filling
on the capacity multiplier ``a``:

    r_i(a) = clip( sqrt(alpha_i K_i / (rho_bar + a)), r_i^low, r_i^up )

``sum_i r_i(a)`` is non-increasing in ``a``; a = 0 if the box solution fits
in R, else the root of ``sum r_i(a) = R`` by bisection.  The functions
broadcast over a leading batch dimension.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Scenario, ScenarioBatch, Solution, objective

_BISECT_ITERS = 120


def _r_of_a(scn: Scenario, a, valid):
    """Box-clipped stationarity solution r(a); masked classes pin to 0."""
    num = torch.where(valid, scn.alpha * scn.K, 0.0)
    r_unc = torch.sqrt(num / (scn.rho_bar + a)[..., None])
    return torch.clamp(r_unc, torch.where(valid, scn.r_low, 0.0),
                       torch.where(valid, scn.r_up, 0.0))


def solve_centralized(scn: Scenario, *, mask=None) -> Solution:
    """Exact optimum of (P3) + Prop. 3.3 recovery.

    Parameters
    ----------
    scn : Scenario
        One instance ((N,) class tensors) or stacked lanes ((B, N)).
    mask : torch.Tensor, optional
        Validity mask of the class tensors' shape; masked-off classes get
        r = sM = sR = 0, psi = psi_low and contribute nothing.

    Returns
    -------
    Solution
        ``aux`` carries the KKT capacity multiplier ``a`` (0 when capacity
        is slack), ``iters`` the fixed bisection budget, ``feasible`` flags
        ``sum(r_low) <= R`` and all E < 0.
    """
    valid = torch.ones_like(scn.A, dtype=torch.bool) if mask is None else mask
    r_low = torch.where(valid, scn.r_low, 0.0)
    feasible = (r_low.sum(-1) <= scn.R) & torch.all(
        torch.where(valid, scn.E < 0, True), dim=-1)

    fits = _r_of_a(scn, torch.zeros_like(scn.R), valid).sum(-1) <= scn.R

    # upper bracket: multiplier pushing every valid class to its lower bound
    a_hi = torch.amax(torch.where(
        valid, scn.alpha * scn.K / torch.clamp(r_low, min=1e-30) ** 2, 0.0),
        dim=-1) - scn.rho_bar + 1.0
    a_hi = torch.clamp(a_hi, min=1.0)

    lo, hi = torch.zeros_like(a_hi), a_hi
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        too_big = _r_of_a(scn, mid, valid).sum(-1) > scn.R
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    a = torch.where(fits, 0.0, hi)
    r = _r_of_a(scn, a, valid)

    # Prop. 3.3 recovery
    sM = torch.where(valid, scn.xiM * r, 0.0)
    sR = torch.where(valid, scn.xiR * r, 0.0)
    psi = torch.clamp(scn.K / torch.where(r > 0, r, 1.0), scn.psi_low,
                      scn.psi_up)
    psi = torch.where(valid, psi, scn.psi_low)

    cost = scn.rho_bar * r.sum(-1)
    penalty = torch.where(valid, scn.alpha * psi - scn.beta, 0.0).sum(-1)
    return Solution(r=r, psi=psi, sM=sM, sR=sR, cost=cost, penalty=penalty,
                    total=cost + penalty, feasible=feasible,
                    iters=torch.full_like(a, _BISECT_ITERS,
                                          dtype=torch.int64),
                    aux=a)


def solve_centralized_batch(batch: ScenarioBatch) -> Solution:
    """Exact (P3) optimum of every lane of a batch (leaves gain a B dim);
    ``aux`` is the per-lane KKT multiplier ``a``."""
    return solve_centralized(batch.scenarios, mask=batch.mask)


def kkt_residual(scn: Scenario, r, a) -> torch.Tensor:
    """Max KKT violation of a candidate (P3) solution of one instance
    (scale-normalised stationarity, sign, primal, box and complementary
    slackness terms); ~0 at the exact optimum."""
    g = scn.rho_bar + a - scn.alpha * scn.K / (r ** 2)
    tol_r = 1e-6 * torch.clamp(scn.r_up, min=1.0)
    at_low = r <= scn.r_low + tol_r
    at_up = r >= scn.r_up - tol_r
    interior = ~(at_low | at_up)
    scale = torch.clamp(scn.rho_bar + a, min=1.0)
    stat = torch.max(torch.where(interior, torch.abs(g), 0.0) / scale)
    sign_low = torch.max(torch.where(at_low, torch.clamp(-g, min=0.0), 0.0)
                         / scale)
    sign_up = torch.max(torch.where(at_up, torch.clamp(g, min=0.0), 0.0)
                        / scale)
    primal = torch.clamp(r.sum() - scn.R, min=0.0) / torch.clamp(scn.R,
                                                                 min=1.0)
    box = torch.max(torch.maximum(scn.r_low - r, r - scn.r_up)
                    / torch.clamp(scn.r_up, min=1.0))
    comp = (torch.abs(a * (r.sum() - scn.R))
            / torch.clamp(scn.R * scale, min=1.0))
    return torch.max(torch.stack([stat, sign_low, sign_up, primal, box,
                                  comp]))


def objective_of_r(scn: Scenario, r) -> torch.Tensor:
    """(P3a) objective for an arbitrary feasible r (psi via Prop. 3.3)."""
    psi = torch.clamp(scn.K / r, scn.psi_low, scn.psi_up)
    return objective(scn, r, psi)
