"""Bit-authoritative plain version of the fused Alg. 4.1 inner iteration.

Counterpart of ``repro.kernels.gnep_iter.ref``.  One best-reply iteration
is, per lane: the RM price sweep (candidate build -> greedy fill ->
objective -> argmax), the CM best responses and the bid escalation.

* :func:`prepare` hoists what Algorithm 4.1 never changes across iterations
  (the p-descending greedy permutation and its inverse, the permuted fill
  headroom, the slack, the r_low aggregates and the constant objective
  term) into one :class:`IterPrep`, computed once per solve;
* :func:`iter_step` is one full inner iteration over the whole batch.  Its
  middle is a running-sum scan over the class axis: each column updates
  the per-candidate accumulators ``cum`` / ``sum_fill`` / ``p_fill``, so
  the (B, Nc, N) fill tensor never exists, and the winning candidate's
  fill row is replayed afterwards (scan rows are independent, so the
  replay is bitwise the row the scan would have emitted).

Numerics contract: the CUDA kernel (``kernel.fused_iter_sweep``) is bitwise
equal to :func:`fused_middle_reference` at every shape — it runs the same
column recurrence in the same order with the same rounding (no FMA).
Against the unfused chain of ``core.game`` the fused path reorders the
prefix sums, so trajectories agree to rounding, not bitwise.

The JAX reference moves values with one-hot contractions to dodge a jax
0.4.37 gather miscompile; here plain ``torch.gather`` moves the same values.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.game import _lane_eps, cm_best_response, cm_bid_update


class IterPrep(NamedTuple):
    """Iteration-invariant tensors of the fused Alg. 4.1 inner loop.

    Attributes
    ----------
    order, inv : torch.Tensor
        (B, N) p-descending greedy permutation (stable) and its inverse.
    inc_max_sorted : torch.Tensor
        (B, N) fill headroom ``r_up - r_low`` (0 when masked), greedy order.
    p_sorted : torch.Tensor
        (B, N) masked unit penalty-rates ``p`` in greedy order.
    spare : torch.Tensor
        (B,) slack capacity ``R - sum(r_low)``.
    r_low_eff : torch.Tensor
        (B, N) masked guaranteed allocation (slot order).
    sum_r_low, p_r_low, const : torch.Tensor
        (B,) ``sum(r_low)``, ``sum(p * r_low)`` and ``sum(p * r_up)``.
    rho_bar : torch.Tensor
        (B,) on-demand floor price (the objective's reference price).
    """
    order: torch.Tensor
    inv: torch.Tensor
    inc_max_sorted: torch.Tensor
    p_sorted: torch.Tensor
    spare: torch.Tensor
    r_low_eff: torch.Tensor
    sum_r_low: torch.Tensor
    p_r_low: torch.Tensor
    const: torch.Tensor
    rho_bar: torch.Tensor


def prepare(scns, mask) -> IterPrep:
    """Hoist the iteration-invariant prep of the Alg. 4.1 inner loop
    (same quantities and reductions as ``game._rm_candidates`` /
    ``game._rm_pick`` for everything that does not depend on the bids)."""
    p_eff = torch.where(mask, scns.p, 0.0)
    order = torch.argsort(-p_eff, dim=1, stable=True)
    inc_max = torch.where(mask, scns.r_up - scns.r_low, 0.0)
    r_low_eff = torch.where(mask, scns.r_low, 0.0)
    return IterPrep(
        order=order,
        inv=torch.argsort(order, dim=1),
        inc_max_sorted=torch.gather(inc_max, 1, order).contiguous(),
        p_sorted=torch.gather(p_eff, 1, order).contiguous(),
        spare=scns.R - r_low_eff.sum(1),
        r_low_eff=r_low_eff,
        sum_r_low=r_low_eff.sum(1),
        p_r_low=(p_eff * r_low_eff).sum(1),
        const=(p_eff * torch.where(mask, scns.r_up, 0.0)).sum(1),
        rho_bar=scns.rho_bar.contiguous())


def _scan(cand, bids_sorted, inc_max_sorted, p_sorted, spare, *,
          emit_fill=False):
    """The per-class running-sum scan over all candidates.

    One step per greedy-ordered class column ``j``: admit
    (``bid_j >= cand``), advance ``cum``, clip the column's fill against the
    remaining slack, fold it into ``sum_fill`` / ``p_fill``.  Masked classes
    have zero headroom, so their columns add exactly 0.0.

    Returns
    -------
    tuple
        ``(sum_fill, p_fill)``, each (B, Nc), plus the (B, Nc, N) fill
        tensor when ``emit_fill``.
    """
    cum = torch.zeros_like(cand)
    sacc = torch.zeros_like(cand)
    pacc = torch.zeros_like(cand)
    spare = spare[:, None]
    cols = []
    for j in range(bids_sorted.shape[1]):
        inc = torch.where(bids_sorted[:, j, None] >= cand,
                          inc_max_sorted[:, j, None], 0.0)
        cum = cum + inc
        fill = torch.minimum(torch.clamp(spare - (cum - inc), min=0.0), inc)
        sacc = sacc + fill
        pacc = pacc + fill * p_sorted[:, j, None]
        if emit_fill:
            cols.append(fill)
    if emit_fill:
        return sacc, pacc, torch.stack(cols, dim=2)
    return sacc, pacc


def _objective(cand, sum_fill, p_fill, rho_bar, sum_r_low, p_r_low, const):
    """The (P5) objective of every candidate from the scan accumulators."""
    return ((cand - rho_bar[:, None]) * (sum_r_low[:, None] + sum_fill)
            + (p_r_low[:, None] + p_fill) - const[:, None])


def _fill_row(rho, bids_sorted, inc_max_sorted, spare):
    """Replay the winning candidate's fill row ((B, N), greedy order)."""
    cum = torch.zeros_like(rho)
    cols = []
    for j in range(bids_sorted.shape[1]):
        inc = torch.where(bids_sorted[:, j] >= rho, inc_max_sorted[:, j], 0.0)
        cum = cum + inc
        cols.append(torch.minimum(torch.clamp(spare - (cum - inc), min=0.0),
                                  inc))
    if not cols:
        return bids_sorted.new_zeros(bids_sorted.shape)
    return torch.stack(cols, dim=1)


def fused_middle_reference(bids_sorted, inc_max_sorted, p_sorted, cand,
                           spare, rho_bar, sum_r_low, p_r_low, const):
    """Plain version of ``kernel.fused_iter_sweep`` (same operands, same
    outputs): the winning fill row ``(B, N)``, the objective ``(B, Nc)``,
    the first-max winner ``best`` ``(B,)`` int64 and its price ``rho``."""
    sum_fill, p_fill = _scan(cand, bids_sorted, inc_max_sorted, p_sorted,
                             spare)
    obj = _objective(cand, sum_fill, p_fill, rho_bar, sum_r_low, p_r_low,
                     const)
    best = torch.argmax(obj, dim=1)
    rho = torch.gather(cand, 1, best[:, None])[:, 0]
    return _fill_row(rho, bids_sorted, inc_max_sorted, spare), obj, best, rho


def middle_reference(prep: IterPrep, cand, bids_sorted):
    """The O(B x Nc x N) middle with the full fill tensor materialized.

    Returns ``(fill (B, Nc, N), obj (B, Nc), best (B,), rho (B,))`` — the
    outputs of the JAX kernel, for comparisons that want every row.
    """
    sum_fill, p_fill, fill = _scan(cand, bids_sorted, prep.inc_max_sorted,
                                   prep.p_sorted, prep.spare, emit_fill=True)
    obj = _objective(cand, sum_fill, p_fill, prep.rho_bar, prep.sum_r_low,
                     prep.p_r_low, prep.const)
    best = torch.argmax(obj, dim=1)
    return fill, obj, best, torch.gather(cand, 1, best[:, None])[:, 0]


def candidates(scns, mask, bids):
    """``(bids_eff, cand)``: masked bids and the (B, N+2) candidate prices
    (all bids + the (P5e) interval ends ``rho_bar`` and ``rho_hat``)."""
    bids_eff = torch.where(mask, bids, scns.rho_bar[:, None])
    cand = torch.cat([bids_eff, scns.rho_bar[:, None], scns.rho_hat[:, None]],
                     dim=1)
    return bids_eff, cand


def iter_step(prep: IterPrep, scns, mask, r, bids, lam,
              middle_fn: Optional[Callable] = None):
    """One full Alg. 4.1 inner iteration over the batch (the fused body).

    Candidate build -> middle (fill / objective / argmax) -> allocation
    un-permute -> CM best responses -> bid escalation -> per-lane eps.

    Parameters
    ----------
    prep : IterPrep
        Invariants from :func:`prepare`.
    scns : Scenario
        Stacked scenario leaves.
    mask : torch.Tensor
        (B, n_max) class-validity mask.
    r, bids : torch.Tensor
        (B, n_max) current allocation and CM bids.
    lam : float
        Bid-escalation step.
    middle_fn : callable, optional
        ``middle_fn(prep, cand, bids_sorted) -> (fill_best, best, rho)`` —
        the CUDA kernel plugs in here; ``None`` runs the plain middle.

    Returns
    -------
    tuple
        ``(r_new, rho, bids_new, eps)``.
    """
    bids_eff, cand = candidates(scns, mask, bids)
    bids_sorted = torch.gather(bids_eff, 1, prep.order)
    if middle_fn is None:
        fill_best, _, best, rho = fused_middle_reference(
            bids_sorted, prep.inc_max_sorted, prep.p_sorted, cand, prep.spare,
            prep.rho_bar, prep.sum_r_low, prep.p_r_low, prep.const)
    else:
        fill_best, best, rho = middle_fn(prep, cand, bids_sorted)

    r_new = prep.r_low_eff + torch.gather(fill_best, 1, prep.inv)
    psi, _, _ = cm_best_response(scns, r_new, mask=mask)
    bids_new = cm_bid_update(scns, bids, rho, psi, lam, mask=mask)
    return r_new, rho, bids_new, _lane_eps(r_new, r, mask)
