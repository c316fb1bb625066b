"""Scenario / solution containers for the GNEP capacity-allocation problem.

PyTorch counterpart of ``repro.core.types``.  All per-class quantities are
(N,) tensors and scalars are 0-d tensors; a :class:`ScenarioBatch` stacks B
instances with a leading batch dimension.  Notation follows the paper
(Tables 1-4).  The stream events and :class:`WindowState` at the end are
what :mod:`repro_torch.core.streaming` applies and carries.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


@dataclass
class Scenario:
    """One allocation problem instance over N job classes (paper Tables 1, 5, 6).

    Raw SLA / profile parameters plus the derived constants of Props. 3.3/4.1.
    """
    # -- raw, per class (N,) -------------------------------------------------
    A: torch.Tensor          # map-phase profile coefficient           [s]
    B: torch.Tensor          # reduce/shuffle-phase profile coefficient[s]
    E: torch.Tensor          # C_i - D_i  (< 0 for feasibility)        [s]
    cM: torch.Tensor         # map slots per VM/chip
    cR: torch.Tensor         # reduce slots per VM/chip
    H_up: torch.Tensor       # max SLA concurrency
    H_low: torch.Tensor      # min SLA concurrency
    m: torch.Tensor          # penalty per rejected job                [cents]
    rho_up: torch.Tensor     # max bid CM i can place                  [cents]
    # -- raw, scalars --------------------------------------------------------
    R: torch.Tensor          # cluster capacity (number of VMs/chips)
    rho_bar: torch.Tensor    # unit-time cost of one VM/chip           [cents]
    # -- derived, per class (N,) ---------------------------------------------
    psi_low: torch.Tensor    # 1 / H_up
    psi_up: torch.Tensor     # 1 / H_low
    alpha: torch.Tensor      # penalty slope   (Eq. 17a)
    beta: torch.Tensor       # penalty offset  (Eq. 17b)
    xiM: torch.Tensor        # Eq. 7a
    xiR: torch.Tensor        # Eq. 7b
    K: torch.Tensor          # Eq. 7c: chips per job to meet deadline
    r_up: torch.Tensor       # Eq. 8a: K * H_up
    r_low: torch.Tensor      # Eq. 8b: K * H_low
    p: torch.Tensor          # Eq. 18: m / K
    rho_hat: torch.Tensor    # max_i rho_up  (scalar)

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


def derive(A, B, E, cM, cR, H_up, H_low, m, rho_up, R, rho_bar, *,
           device=None) -> Scenario:
    """Compute the closed-form constants (Props. 3.3, Eqs. 7/8/17/18).

    Every input follows ``A``'s dtype and device.  ``A`` given as a tensor
    keeps its device unless ``device`` is passed; anything else is placed
    on ``device`` (default ``"cuda"``).
    """
    if isinstance(A, torch.Tensor) and device is None:
        dev = A.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    A = torch.as_tensor(A, device=dev)
    if not A.is_floating_point():
        A = A.to(torch.float64)

    def like(x):
        return torch.as_tensor(x, dtype=A.dtype, device=dev)

    B, E, cM, cR = like(B), like(E), like(cM), like(cR)
    H_up, H_low, m, rho_up = like(H_up), like(H_low), like(m), like(rho_up)
    psi_low = 1.0 / H_up
    psi_up = 1.0 / H_low
    alpha = m * H_up * H_low
    beta = m * H_low
    xiM = cM / (1.0 + torch.sqrt(B * cM / (A * cR)))
    xiR = cR / (1.0 + torch.sqrt(A * cR / (B * cM)))
    K = (torch.sqrt(A / cM) + torch.sqrt(B / cR)) ** 2 / (-E)
    r_up = K * H_up
    r_low = K * H_low
    p = m / K
    return Scenario(
        A=A, B=B, E=E, cM=cM, cR=cR, H_up=H_up, H_low=H_low, m=m,
        rho_up=rho_up, R=like(R), rho_bar=like(rho_bar),
        psi_low=psi_low, psi_up=psi_up, alpha=alpha, beta=beta,
        xiM=xiM, xiR=xiR, K=K, r_up=r_up, r_low=r_low, p=p,
        rho_hat=torch.max(rho_up),
    )


@dataclass
class ScenarioBatch:
    """B independent allocation instances stacked for one batched solve.

    ``scenarios`` is a :class:`Scenario` whose per-class leaves are (B, n_max)
    and whose scalars are (B,).  Instances with fewer than ``n_max`` classes
    are padded with *neutral* classes (``r_low = r_up = p = alpha = beta = 0``)
    and flagged invalid in ``mask`` so every mask-aware solver step is an
    exact no-op on them.
    """
    scenarios: Scenario      # stacked leaves: (B, n_max) per class, (B,) scalars
    mask: torch.Tensor       # (B, n_max) bool — True where the class is real
    n_classes: torch.Tensor  # (B,) int64 — number of valid classes per instance

    @property
    def batch_size(self) -> int:
        return self.mask.shape[0]

    @property
    def n_max(self) -> int:
        return self.mask.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def take(self, lanes) -> "ScenarioBatch":
        """Gather a sub-batch of the given lane indices (order preserved)."""
        lanes = torch.as_tensor(np.asarray(lanes), dtype=torch.long,
                                device=self.device)
        return ScenarioBatch(
            scenarios=tree_map(lambda leaf: leaf[lanes], self.scenarios),
            mask=self.mask[lanes], n_classes=self.n_classes[lanes])

    def instance(self, b: int) -> Scenario:
        """Recover the b-th (unpadded) single-instance Scenario.

        Valid classes are gathered through the mask (slot order preserved),
        so this also works for windows whose free slots leave holes.
        """
        sel = self.mask[b]

        def pick(leaf):
            leaf = leaf[b]
            return leaf[sel] if leaf.ndim else leaf

        return tree_map(pick, self.scenarios)


#: Raw-parameter field names of :class:`Scenario` (per-class, user-settable).
RAW_CLASS_FIELDS = ("A", "B", "E", "cM", "cR", "H_up", "H_low", "m", "rho_up")


def neutral_class_values(rho_bar: float) -> dict:
    """Per-class values that make a padded / vacated slot solver-inert.

    Zero allocation bounds (``r_low = r_up = 0``), zero penalty slope
    (``alpha = beta = p = m = 0``), a unit work profile so divisions stay
    finite, and ``rho_up = rho_bar`` so the slot's bid is a price candidate
    that is always present anyway.

    Parameters
    ----------
    rho_bar : float
        The instance's unit-time chip cost (the neutral bid value).

    Returns
    -------
    dict
        Field name -> neutral scalar for every per-class field of
        :class:`Scenario` (raw and derived).
    """
    return {
        "A": 1.0, "B": 1.0, "E": -1.0, "cM": 1.0, "cR": 1.0,
        "H_up": 1.0, "H_low": 1.0, "m": 0.0, "rho_up": float(rho_bar),
        "psi_low": 1.0, "psi_up": 1.0, "alpha": 0.0, "beta": 0.0,
        "xiM": 1.0, "xiR": 1.0, "K": 1.0, "r_up": 0.0, "r_low": 0.0,
        "p": 0.0,
    }


def pad_scenario(scn: Scenario, n_max: int) -> Scenario:
    """Pad per-class tensors of ``scn`` to ``n_max`` with neutral classes."""
    n = scn.n
    if n > n_max:
        raise ValueError(f"scenario has {n} classes > n_max={n_max}")
    neutral = neutral_class_values(float(scn.rho_bar))
    kw = {}
    for f in dataclasses.fields(Scenario):
        leaf = getattr(scn, f.name)
        if f.name in neutral and leaf.ndim == 1:
            fill = leaf.new_full((n_max - n,), neutral[f.name])
            kw[f.name] = torch.cat([leaf, fill])
        else:
            kw[f.name] = leaf
    return Scenario(**kw)


def stack_scenarios(scns, n_max: int | None = None, *,
                    device="cuda") -> ScenarioBatch:
    """Stack a list of (possibly ragged) Scenarios into a ScenarioBatch on
    ``device``."""
    scns = list(scns)
    if not scns:
        raise ValueError("stack_scenarios needs at least one scenario")
    dev = resolve_device(device)
    ns = [s.n for s in scns]
    n_max = max(ns) if n_max is None else n_max
    padded = [tree_map(lambda t: t.to(dev), pad_scenario(s, n_max))
              for s in scns]
    stacked = Scenario(**{
        f.name: torch.stack([getattr(s, f.name) for s in padded])
        for f in dataclasses.fields(Scenario)})
    n_classes = torch.as_tensor(ns, dtype=torch.long, device=dev)
    mask = torch.arange(n_max, device=dev)[None, :] < n_classes[:, None]
    return ScenarioBatch(scenarios=stacked, mask=mask, n_classes=n_classes)


@dataclass
class Solution:
    """A (possibly fractional) solution of the allocation problem."""
    r: torch.Tensor       # chips per class
    psi: torch.Tensor     # 1 / concurrency
    sM: torch.Tensor      # map slots
    sR: torch.Tensor      # reduce slots
    cost: torch.Tensor    # rho_bar * sum(r)
    penalty: torch.Tensor  # sum(alpha * psi - beta)
    total: torch.Tensor   # cost + penalty   (objective P2a)
    feasible: torch.Tensor
    iters: torch.Tensor   # solver iterations (0 for closed-form)
    aux: torch.Tensor     # method-specific: KKT multiplier a / final price rho

    @property
    def h(self) -> torch.Tensor:
        return 1.0 / self.psi


def objective(scn: Scenario, r, psi) -> torch.Tensor:
    """Paper objective (P2a) = running cost + rejection penalties."""
    return scn.rho_bar * torch.sum(r) + torch.sum(scn.alpha * psi - scn.beta)


def deadline_lhs(scn: Scenario, psi, sM, sR) -> torch.Tensor:
    """LHS of (P2d): A/(sM psi) + B/(sR psi) + E  (<= 0 when deadline met)."""
    return scn.A / (sM * psi) + scn.B / (sR * psi) + scn.E


# --------------------------------------------------------------------------
# Streaming admission: events + per-window solver state
# --------------------------------------------------------------------------
#
# Events are plain host-side records of Python scalars: they mutate the
# AdmissionWindow (core.streaming) between solves; only the resulting padded
# ScenarioBatch reaches the solver.


@dataclass(frozen=True)
class ClassArrival:
    """A new job class entering ``lane``'s allocation game.

    ``params`` holds the raw per-class scalars (the :data:`RAW_CLASS_FIELDS`:
    A, B, E, cM, cR, H_up, H_low, m, rho_up); derived constants are computed
    by the window on admission.  The slot is chosen by the window (lowest
    free slot, growing ``n_max`` only when the lane's row is full).
    """
    lane: int
    params: dict


@dataclass(frozen=True)
class ClassDeparture:
    """Job class in (``lane``, ``slot``) leaves; its slot is recycled."""
    lane: int
    slot: int


@dataclass(frozen=True)
class SLAEdit:
    """In-place SLA / profile renegotiation for the class in (lane, slot).

    ``updates`` maps raw field names (subset of :data:`RAW_CLASS_FIELDS`) to
    new values; the window merges them and re-derives the class constants.
    """
    lane: int
    slot: int
    updates: dict


@dataclass(frozen=True)
class CapacityChange:
    """Lane capacity R changes (node failures / restores, paper Fig. 2)."""
    lane: int
    R: float


StreamEvent = Union[ClassArrival, ClassDeparture, SLAEdit, CapacityChange]


class WindowState(NamedTuple):
    """Last-equilibrium solver state an ``AdmissionWindow`` carries.

    Shapes: ``r`` is (B, n_max); ``rho`` / ``lane_iters`` / ``solved`` are
    (B,), all on the window's device.  ``solved`` marks lanes whose stored
    equilibrium is valid; the window's host-side *dirty* flags mark lanes
    whose scenario changed after the state was stored.  Clean solved lanes
    are frozen at their stored equilibrium, all others re-iterate from the
    cold Alg. 4.1 init (bids are not stored: they only escalate in the game,
    so carrying them over would steer a changed lane elsewhere).
    """
    r: torch.Tensor
    rho: torch.Tensor
    lane_iters: torch.Tensor
    solved: torch.Tensor
