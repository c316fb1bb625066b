"""Algorithm 4.2 — integer solution heuristic (paper Sec. 4.5), in PyTorch.

Counterpart of ``repro.core.rounding``:

1. sort classes by increasing alpha;
2. r <- ceil(r_hat); decrement the first k classes in alpha-order, with
   k = max(0, sum(ceil(r_hat)) - floor(R)) (Prop. 4.2: one pass suffices);
3. s <- ceil(s_hat); per class, decrement s^R (then s^M if still violated)
   until s^M/c^M + s^R/c^R <= r, a loop of fixed bound (Prop. 4.3).

The functions broadcast over a leading batch dimension, so the batched form
needs no ``vmap``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import Scenario, ScenarioBatch


class IntegerSolution(NamedTuple):
    r: torch.Tensor
    sM: torch.Tensor
    sR: torch.Tensor
    h: torch.Tensor      # integer admitted concurrency after rounding
    psi: torch.Tensor
    cost: torch.Tensor
    penalty: torch.Tensor
    total: torch.Tensor


def round_solution(scn: Scenario, r_hat, sM_hat, sR_hat, psi_hat=None,
                   max_slot_iters: int = 8, mask=None) -> IntegerSolution:
    """Algorithm 4.2; returns an integer-feasible allocation.

    Admission h is kept at the continuous optimum (rounded half to even to
    the nearest integer in the SLA box), not re-tightened against the
    rounded slots (paper Sec. 4.5).  ``mask`` flags valid classes: padded
    classes keep r = sM = sR = h = 0, sort after every valid class, and
    contribute nothing to cost or penalty.
    """
    dt = r_hat.dtype
    valid = torch.ones_like(r_hat, dtype=torch.bool) if mask is None else mask
    vf = valid.to(dt)

    # ---- lines 1-7: capacity-feasible integer r -----------------------------
    r = torch.ceil(r_hat) * vf
    overshoot = torch.clamp(r.sum(-1) - torch.floor(scn.R), min=0.0)
    alpha_eff = torch.where(valid, scn.alpha, torch.inf)
    order = torch.argsort(alpha_eff, dim=-1, stable=True)   # increasing alpha
    rank = torch.argsort(order, dim=-1).to(dt)               # position of i
    r = r - ((rank < overshoot[..., None]) & valid).to(dt)

    # ---- lines 8-17: slot rounding ------------------------------------------
    sM = torch.ceil(sM_hat) * vf
    sR = torch.ceil(sR_hat) * vf
    for _ in range(max_slot_iters):
        viol = (sM / scn.cM + sR / scn.cR > r) & valid
        sR = sR - viol.to(dt)                                # line 12
        viol2 = sM / scn.cM + sR / scn.cR > r                # line 13
        sM = sM - (viol & viol2).to(dt)                      # line 14
    sM = torch.clamp(sM, min=1.0) * vf
    sR = torch.clamp(sR, min=1.0) * vf

    # ---- integer admission ---------------------------------------------------
    if psi_hat is None:
        r_safe = torch.where(r_hat > 0, r_hat, 1.0)
        psi_hat = torch.clamp(scn.K / r_safe, scn.psi_low, scn.psi_up)
    h = torch.clamp(torch.round(1.0 / psi_hat), scn.H_low, scn.H_up) * vf
    psi = torch.where(valid, 1.0 / torch.where(h > 0, h, 1.0), 1.0)

    cost = scn.rho_bar * r.sum(-1)
    penalty = torch.where(valid, scn.alpha * psi - scn.beta, 0.0).sum(-1)
    return IntegerSolution(r=r, sM=sM, sR=sR, h=h, psi=psi, cost=cost,
                           penalty=penalty, total=cost + penalty)


def round_solution_batch(batch: ScenarioBatch, r_hat, sM_hat, sR_hat,
                         psi_hat=None,
                         max_slot_iters: int = 8) -> IntegerSolution:
    """Algorithm 4.2 over every lane of a ScenarioBatch (leaves gain a B
    dim)."""
    scns = batch.scenarios
    if psi_hat is None:
        psi_hat = torch.clamp(scns.K / torch.where(r_hat > 0, r_hat, 1.0),
                              scns.psi_low, scns.psi_up)
    return round_solution(scns, r_hat, sM_hat, sR_hat, psi_hat,
                          max_slot_iters=max_slot_iters, mask=batch.mask)
