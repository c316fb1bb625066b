"""Distributed game-theoretic formulation (paper Sec. 4) in PyTorch.

Counterpart of ``repro.core.game``.  Players: one Resource Manager (RM,
problem P5) and N Class Managers (CMs, problem P4).  Algorithm 4.1 iterates
best replies until the relative allocation change drops below ``eps_bar``.

* **CM (P4)** — closed form, Prop. 4.1:  s^M = xi^M r, s^R = xi^R r,
  psi = clip(K / r, psi_low, psi_up).
* **RM (P5)** — for a fixed price the optimum is the greedy knapsack in
  p-descending order; an exact sweep over the <= N+2 candidate prices solves
  P5 (one (Nc x N) masked prefix sum, the CUDA kernel of
  ``repro_torch.kernels.gnep_sweep`` on the card).

The RM helpers broadcast over leading batch dimensions: a single instance
has (N,) class tensors and 0-d scalars, a batch (B, N) and (B,), so the
batched solver needs no ``vmap``.  The ``while_loop`` of the reference is a
Python loop; its condition is read back to the host once per iteration.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.types import Scenario, ScenarioBatch, Solution

# --------------------------------------------------------------------------
# Resource Manager — problem (P5)
# --------------------------------------------------------------------------


def _rm_candidates(scn: Scenario, bids: torch.Tensor, mask):
    """Candidate prices + greedy-order increments for the (P5) sweep.

    ``mask`` flags valid classes; padded classes bid rho_bar (a candidate that
    is always present anyway) and expose zero increment, so they are inert.
    """
    rho_bar = scn.rho_bar[..., None]
    bids_eff = torch.where(mask, bids, rho_bar)
    p_eff = torch.where(mask, scn.p, 0.0)
    # Candidate prices: all bids + the interval ends [rho_bar, rho_hat] (P5e).
    cand = torch.cat([bids_eff, rho_bar, scn.rho_hat[..., None]], dim=-1)
    # y_i = 1 when CM i bids at least the price (free at equality).
    y = (bids_eff[..., None, :] >= cand[..., :, None]) & mask[..., None, :]

    # Greedy fill order: p descending, stable so ties and padding (p = 0)
    # keep their slot order.
    order = torch.argsort(-p_eff, dim=-1, stable=True)
    inc_max = torch.gather(torch.where(mask, scn.r_up - scn.r_low, 0.0),
                           -1, order)
    y_sorted = torch.gather(y, -1, order[..., None, :].expand(y.shape))
    inc = torch.where(y_sorted, inc_max[..., None, :], 0.0)    # (..., Nc, N)
    spare = scn.R - torch.where(mask, scn.r_low, 0.0).sum(-1)
    return cand, inc, spare, torch.gather(p_eff, -1, order), order


def _rm_pick(scn: Scenario, cand, fill, sum_fill, p_fill, order, mask):
    """Choose the best candidate row and undo the greedy permutation."""
    p_eff = torch.where(mask, scn.p, 0.0)
    r_low = torch.where(mask, scn.r_low, 0.0)
    sum_r = r_low.sum(-1)[..., None] + sum_fill
    p_r = (p_eff * r_low).sum(-1)[..., None] + p_fill
    const = (p_eff * torch.where(mask, scn.r_up, 0.0)).sum(-1)[..., None]
    obj = (cand - scn.rho_bar[..., None]) * sum_r + p_r - const

    best = torch.argmax(obj, dim=-1, keepdim=True)
    rho = torch.gather(cand, -1, best)[..., 0]
    inv = torch.argsort(order, dim=-1)
    idx = best[..., None].expand(*best.shape[:-1], 1, fill.shape[-1])
    fill_best = torch.gather(fill, -2, idx)[..., 0, :]
    r = r_low + torch.gather(fill_best, -1, inv)
    return rho, r, torch.gather(obj, -1, best)[..., 0]


def rm_solve(scn: Scenario, bids: torch.Tensor, *, mask=None, sweep_fn=None):
    """Exact solution of the Resource Manager's problem (P5) given CM bids.

    Parameters
    ----------
    scn : Scenario
        The instance (uses r_low/r_up/p/R/rho_bar/rho_hat).
    bids : torch.Tensor
        (N,) current CM bids rho_i^a, each in [rho_bar, rho_up_i] [cents].
    mask : torch.Tensor, optional
        (N,) validity mask — padded classes never receive capacity.
    sweep_fn : callable, optional
        Override of the candidate-sweep inner loop,
        ``sweep_fn(inc (Nc, N), spare (), p_sorted (N,)) -> (fill, sum_fill,
        p_fill)`` — ``kernels.gnep_sweep.ops.make_sweep_fn()`` plugs in here.

    Returns
    -------
    rho : torch.Tensor
        Optimal unit price (a bid or an interval end of (P5e)) [cents].
    r : torch.Tensor
        (N,) optimal allocation.
    objective : torch.Tensor
        The (P5) objective at (rho, r).
    """
    if mask is None:
        mask = torch.ones(bids.shape, dtype=torch.bool, device=bids.device)
    cand, inc, spare, p_sorted, order = _rm_candidates(scn, bids, mask)

    if sweep_fn is None:
        cum = torch.cumsum(inc, dim=-1)
        fill = torch.minimum(
            torch.clamp(spare[..., None, None] - (cum - inc), min=0.0), inc)
        sum_fill = fill.sum(-1)
        p_fill = (fill * p_sorted[..., None, :]).sum(-1)
    else:
        fill, sum_fill, p_fill = sweep_fn(inc, spare, p_sorted)

    return _rm_pick(scn, cand, fill, sum_fill, p_fill, order, mask)


# --------------------------------------------------------------------------
# Class Managers — problem (P4), Prop. 4.1 closed form
# --------------------------------------------------------------------------


def cm_best_response(scn: Scenario, r: torch.Tensor, *, mask=None):
    """Closed-form optimum of each CM's (P4) given its allocation (Prop 4.1).

    Returns ``(psi, sM, sR)``; with a ``mask``, padded classes (r = 0) get
    psi = psi_low and zero slots instead of the 0-division garbage.
    """
    if mask is None:
        sM = scn.xiM * r
        sR = scn.xiR * r
        psi = torch.clamp(scn.K / r, scn.psi_low, scn.psi_up)
        return psi, sM, sR
    r_safe = torch.where(r > 0, r, 1.0)
    psi = torch.clamp(scn.K / r_safe, scn.psi_low, scn.psi_up)
    psi = torch.where(mask, psi, scn.psi_low)
    sM = torch.where(mask, scn.xiM * r, 0.0)
    sR = torch.where(mask, scn.xiR * r, 0.0)
    return psi, sM, sR


def cm_bid_update(scn: Scenario, bids, rho, psi, lam: float, *, mask=None):
    """Alg. 4.1 lines 11-13: the bid escalation (pseudo-gradient) step.

    A CM still rejecting jobs (psi > psi_low) raises its bid by ``lam *
    rho_up`` from ``max(bid, rho)``, clipped to [rho_bar, rho_up]; satisfied
    CMs keep theirs.  ``rho`` is the scalar (or per-lane (B,)) posted price.
    """
    rejecting = psi > scn.psi_low * (1.0 + 1e-9)
    if mask is not None:
        rejecting = rejecting & mask
    raised = torch.minimum(torch.maximum(bids, rho[..., None]) + lam * scn.rho_up,
                           scn.rho_up)
    return torch.where(rejecting, raised, bids)


# --------------------------------------------------------------------------
# Algorithm 4.1 — best reply, one instance
# --------------------------------------------------------------------------


def solve_distributed(scn: Scenario, *, eps_bar: float = 0.03,
                      lam: float = 0.05, max_iters: int = 200) -> Solution:
    """Algorithm 4.1 (RM/CM best-reply) for one instance.

    Returns the GNEP equilibrium as a :class:`Solution`: ``aux`` carries the
    final RM price rho, ``iters`` the best-reply iterations run, ``feasible``
    flags ``sum(r_low) <= R`` and all E_i < 0.
    """
    feasible = (scn.r_low.sum() <= scn.R) & torch.all(scn.E < 0)
    r = scn.r_low
    bids = torch.full_like(scn.r_low, float(scn.rho_bar))
    rho = scn.rho_bar
    it = 0
    eps = float("inf")
    while eps >= eps_bar and it < max_iters:
        rho, r_new, _ = rm_solve(scn, bids)
        psi, _, _ = cm_best_response(scn, r_new)
        bids = cm_bid_update(scn, bids, rho, psi, lam)
        eps = float(torch.sum(torch.abs(r_new - r) / r))
        r = r_new
        it += 1

    psi, sM, sR = cm_best_response(scn, r)
    cost = scn.rho_bar * r.sum()
    penalty = torch.sum(scn.alpha * psi - scn.beta)
    return Solution(r=r, psi=psi, sM=sM, sR=sR, cost=cost, penalty=penalty,
                    total=cost + penalty, feasible=feasible,
                    iters=torch.tensor(it, device=r.device), aux=rho)


# --------------------------------------------------------------------------
# Batched Algorithm 4.1 — B scenarios in one loop with a leading batch dim
# --------------------------------------------------------------------------


class BatchWarmStart(NamedTuple):
    """Per-lane initial state for a warm-started ``solve_distributed_batch``.

    Lanes with ``active`` False are *frozen*: the loop never updates them,
    so their ``r`` / ``rho`` / ``lane_iters`` pass straight through to the
    returned :class:`Solution`.  Active lanes iterate Algorithm 4.1 from
    (``r``, ``bids``) exactly as the cold solver would from its own init.

    Attributes
    ----------
    r : torch.Tensor
        (B, n_max) initial allocation.
    bids : torch.Tensor
        (B, n_max) initial CM bids (``rho_bar`` reproduces the cold
        trajectory: bids only escalate during the game).
    rho : torch.Tensor
        (B,) initial RM price (pass-through value for frozen lanes).
    lane_iters : torch.Tensor
        (B,) starting iteration counters.
    active : torch.Tensor
        (B,) bool — True for lanes that should iterate.
    """
    r: torch.Tensor
    bids: torch.Tensor
    rho: torch.Tensor
    lane_iters: torch.Tensor
    active: torch.Tensor


def cold_start(batch: ScenarioBatch) -> BatchWarmStart:
    """The cold Algorithm 4.1 init for every lane of ``batch``: ``r = r_low``
    (masked), ``bids = rho = rho_bar``, zero counters, every lane active."""
    scns, mask = batch.scenarios, batch.mask
    r0 = torch.where(mask, scns.r_low, 0.0)
    B = batch.batch_size
    return BatchWarmStart(
        r=r0,
        bids=scns.rho_bar[:, None].expand(r0.shape).clone(),
        rho=scns.rho_bar.clone(),
        lane_iters=torch.zeros((B,), dtype=torch.int32, device=r0.device),
        active=torch.ones((B,), dtype=torch.bool, device=r0.device))


def _lane_eps(r_new, r_old, mask):
    """Alg. 4.1 convergence metric per lane, restricted to valid classes."""
    rel = torch.abs(r_new - r_old) / torch.where(r_old > 0, r_old, 1.0)
    return torch.where(mask, rel, 0.0).sum(-1)


def _solve_batch_core(batch: ScenarioBatch, eps_bar, lam, max_iters,
                      sweep_fn, init: Optional[BatchWarmStart],
                      iter_fn=None) -> Solution:
    """Body of the batched Algorithm 4.1 (see ``solve_distributed_batch``)."""
    scns, mask = batch.scenarios, batch.mask
    dt = scns.A.dtype
    feasible = ((torch.where(mask, scns.r_low, 0.0).sum(-1) <= scns.R)
                & torch.all(torch.where(mask, scns.E < 0, True), dim=-1))

    if iter_fn is not None:
        # fused path: the iteration-invariant prep is hoisted out of the
        # loop; each step is one fused iteration (repro_torch.kernels.gnep_iter)
        prep = iter_fn.prepare(scns, mask)

        def iterate(r, bids):
            return iter_fn.step(prep, scns, mask, r, bids, lam)
    else:
        def iterate(r, bids):
            if sweep_fn is None:
                rho, r_new, _ = rm_solve(scns, bids, mask=mask)
            else:
                cand, inc, spare, p_sorted, order = _rm_candidates(
                    scns, bids, mask)
                fill, sum_fill, p_fill = sweep_fn(inc, spare, p_sorted)
                rho, r_new, _ = _rm_pick(scns, cand, fill.to(dt),
                                         sum_fill.to(dt), p_fill.to(dt),
                                         order, mask)
            psi, _, _ = cm_best_response(scns, r_new, mask=mask)
            bids_new = cm_bid_update(scns, bids, rho, psi, lam, mask=mask)
            return r_new, rho, bids_new, _lane_eps(r_new, r, mask)

    if init is None:
        init = cold_start(batch)
    r, bids, rho, active = init.r, init.bids, init.rho, init.active
    lane_iters = init.lane_iters.to(torch.int32)
    it = 0
    # frozen lanes pass through unchanged, so this host read of the loop
    # condition could be taken every k steps without changing a bit
    while it < max_iters and bool(active.any()):
        r_new, rho_new, bids_new, eps = iterate(r, bids)
        keep = active[:, None]
        r = torch.where(keep, r_new, r)
        bids = torch.where(keep, bids_new, bids)
        rho = torch.where(active, rho_new, rho)
        lane_iters = lane_iters + active.to(torch.int32)
        active = active & (eps >= eps_bar)
        it += 1

    psi, sM, sR = cm_best_response(scns, r, mask=mask)
    cost = scns.rho_bar * r.sum(-1)
    pen = torch.where(mask, scns.alpha * psi - scns.beta, 0.0).sum(-1)
    return Solution(r=r, psi=psi, sM=sM, sR=sR, cost=cost, penalty=pen,
                    total=cost + pen, feasible=feasible, iters=lane_iters,
                    aux=rho)


def solve_distributed_batch(batch: ScenarioBatch, *, eps_bar: float = 0.03,
                            lam: float = 0.05, max_iters: int = 200,
                            sweep_fn=None,
                            init: Optional[BatchWarmStart] = None,
                            mesh=None, iter_fn=None) -> Solution:
    """Algorithm 4.1 for B stacked scenarios in one loop.

    Converged lanes are frozen by masking (their state and iteration counter
    stop) so every lane follows its own trajectory while the loop runs on
    for the stragglers; the loop exits when every lane has converged.

    Parameters
    ----------
    batch : ScenarioBatch
        B stacked (padded + masked) instances; runs where its tensors lie.
    eps_bar, lam, max_iters
        Stopping tolerance, bid-escalation step and iteration cap.
    sweep_fn : callable, optional
        *Batched* RM sweep taking ``(inc (B, Nc, N), spare (B,), p_sorted
        (B, N))`` — ``kernels.gnep_sweep.ops.make_batched_sweep_fn()``.
    init : BatchWarmStart, optional
        Warm start; lanes with ``init.active`` False are frozen.
    mesh : repro_torch.core.sharding.LaneMesh, optional
        1-D lane mesh (``sharding.lane_mesh``): the lanes are padded to a
        multiple of the device count with inert lanes and each contiguous
        slice runs its own loop (``sharding.solve_sharded_batch``).  None
        (default) solves the whole batch in one loop.
    iter_fn : object, optional
        Fused-iteration plug-in (``kernels.gnep_iter.ops
        .make_fused_iter_fn()``); takes precedence over ``sweep_fn``.

    Returns
    -------
    Solution
        r/psi/sM/sR are (B, n_max) with padded classes zero; cost, penalty,
        total, feasible, iters and aux (= final RM price rho) are (B,).
    """
    if mesh is not None:
        from repro_torch.core.sharding import solve_sharded_batch
        return solve_sharded_batch(batch, mesh, eps_bar=eps_bar, lam=lam,
                                   max_iters=max_iters, sweep_fn=sweep_fn,
                                   init=init, iter_fn=iter_fn)
    return _solve_batch_core(batch, eps_bar, lam, max_iters, sweep_fn, init,
                             iter_fn=iter_fn)


# --------------------------------------------------------------------------
# Paper-faithful serial implementation (Fig. 7 baseline), numpy
# --------------------------------------------------------------------------


def _np(x):
    return x.detach().cpu().numpy()


def _rm_solve_np(scn, bids):
    """Numpy RM solve (single price sweep), used by the serial baseline."""
    p = _np(scn.p)
    r_low, r_up = _np(scn.r_low), _np(scn.r_up)
    R = float(scn.R)
    rho_bar = float(scn.rho_bar)
    cand = np.concatenate([bids, [rho_bar, float(scn.rho_hat)]])
    order = np.argsort(-p, kind="stable")
    spare = R - r_low.sum()
    best_obj, best_rho, best_r = -np.inf, rho_bar, r_low.copy()
    const = (p * r_up).sum()
    for c in cand:
        y = bids >= c
        inc = np.where(y[order], (r_up - r_low)[order], 0.0)
        cum = np.cumsum(inc)
        fill = np.clip(spare - (cum - inc), 0.0, inc)
        r_sorted = r_low[order] + fill
        obj = (c - rho_bar) * r_sorted.sum() + (p[order] * r_sorted).sum() - const
        if obj > best_obj:
            best_obj, best_rho = obj, c
            best_r = np.empty_like(r_sorted)
            best_r[order] = r_sorted
    return best_rho, best_r


def solve_distributed_python(scn: Scenario, *, eps_bar: float = 0.03,
                             lam: float = 0.05, max_iters: int = 200,
                             per_cm_callback: Optional[Callable] = None):
    """Algorithm 4.1 exactly as written: a Python ``repeat`` loop, the RM
    solve, then one (P4) solve *per CM* in a Python for-loop (numpy).

    Returns
    -------
    sol : Solution
        The equilibrium, as tensors on ``scn``'s device.
    n_iters : int
        Best-reply iterations run.
    cm_seconds : list of float
        Wall-clock seconds of the serial CM loop, one entry per iteration.
    """
    n = scn.n
    E = _np(scn.E)
    K = _np(scn.K)
    xiM, xiR = _np(scn.xiM), _np(scn.xiR)
    psi_low, psi_up = _np(scn.psi_low), _np(scn.psi_up)
    rho_up = _np(scn.rho_up)
    rho_bar = float(scn.rho_bar)

    r = _np(scn.r_low).copy()
    bids = np.full(n, rho_bar)
    psi = psi_up.copy()
    cm_seconds = []
    it = 0
    rho = rho_bar
    while it < max_iters:
        r_old = r.copy()
        rho, r = _rm_solve_np(scn, bids)
        t0 = time.perf_counter()
        for i in range(n):  # executed in parallel by real CMs (paper Sec. 4.4)
            sMi = xiM[i] * r[i]
            sRi = xiR[i] * r[i]
            psi_i = min(max(K[i] / r[i], psi_low[i]), psi_up[i])
            psi[i] = psi_i
            if psi_i > psi_low[i] * (1 + 1e-9):
                bids[i] = min(max(bids[i], rho) + lam * rho_up[i], rho_up[i])
            if per_cm_callback is not None:
                per_cm_callback(i, r[i], sMi, sRi, psi_i)
        cm_seconds.append(time.perf_counter() - t0)
        it += 1
        eps = float(np.sum(np.abs(r - r_old) / r_old))
        if eps < eps_bar:
            break

    cost = rho_bar * r.sum()
    penalty = float((_np(scn.alpha) * psi - _np(scn.beta)).sum())
    dev, dt = scn.A.device, scn.A.dtype

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    sol = Solution(
        r=t(r), psi=t(psi), sM=t(xiM * r), sR=t(xiR * r), cost=t(cost),
        penalty=t(penalty), total=t(cost + penalty),
        feasible=torch.tensor(bool((_np(scn.r_low).sum() <= float(scn.R))
                                   and np.all(E < 0)), device=dev),
        iters=torch.tensor(it, device=dev), aux=t(rho))
    return sol, it, cm_seconds


def distributed_walltime_estimate(n_cms: int, iters: int,
                                  serial_cm_seconds: float,
                                  rm_seconds: float = 0.0,
                                  net_rtt_s: float = 1.3e-4) -> float:
    """Paper Sec. 5.3 timing model for true-distributed wall-clock.

    Parameters
    ----------
    n_cms : int
        Number of Class Managers (the CM solves run in parallel).
    iters : int
        Best-reply iterations of the run being estimated.
    serial_cm_seconds : float
        Total serial CM-loop seconds measured by
        :func:`solve_distributed_python`.
    rm_seconds : float, optional
        RM solve seconds (not divided: the RM is a single player).
    net_rtt_s : float, optional
        Per-iteration network round trip (the reference model's figure for
        a 100 Mb/s LAN, two floats each way).

    Returns
    -------
    float
        ``serial_cm_seconds / N + rm_seconds + iters * net_rtt_s``.
    """
    return serial_cm_seconds / max(n_cms, 1) + rm_seconds + iters * net_rtt_s
