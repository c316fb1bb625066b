"""Job-profile generation (paper Sec. 5.1, Tables 5/6) on a torch.Generator.

PyTorch counterpart of ``repro.core.profiles``.  The ranges are the
reference's; the draws come from a ``torch.Generator``, so instances match
the JAX ones in distribution, not bit for bit.  Draws are taken on the CPU
generator and then placed on ``device``, so one seed gives the same instance
on the CPU and on the card.  ``from_roofline`` fits the same profile form
from measured compute, collective and overhead seconds.

The ARIA-style profile form (DESIGN.md Sec. 6):

    A = n^M * M^avg                    (map-phase work, chip-seconds)
    B = n^R * (Sh^avg_typ + R^avg)     (shuffle+reduce-phase work)
    C = M^max + R^max + Sh^max_1 + Sh^max_typ   (constant tail)

with ``X^avg = 0.8 X^max`` exactly as in Table 6.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Scenario, derive
from repro_torch.utils import fdtype, resolve_device


def _u(gen, lo, hi, shape, dt):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dt)


def _ui(gen, lo, hi, shape, dt):  # inclusive integer uniform
    return torch.randint(lo, hi + 1, shape, generator=gen).to(dt)


def _table5_raw(gen: torch.Generator, shape, deadline_scale, dt) -> dict:
    """The paper's Table 5/6 class-parameter design, drawn once.

    Parameters
    ----------
    gen : torch.Generator
        CPU generator the 11 draws are taken from, in a fixed order.
    shape : tuple
        ``(n,)`` for a whole instance, ``()`` for one class.
    deadline_scale : float
        Multiplies the deadline D (< 1 tightens, paper Sec. 5.2.2).
    dt : torch.dtype
        Float dtype of the produced tensors.

    Returns
    -------
    dict
        The :data:`repro_torch.core.types.RAW_CLASS_FIELDS` tensors of
        ``shape`` (on the CPU).
    """
    rho_up = _u(gen, 5.0, 20.0, shape, dt)                  # [cents]
    H_up = _ui(gen, 5, 20, shape, dt)
    cM = _ui(gen, 1, 4, shape, dt)
    cR = _ui(gen, 1, 4, shape, dt)
    m = _u(gen, 15000.0, 30000.0, shape, dt)                # [cents]
    nM = _ui(gen, 70, 1120, shape, dt)
    nR = torch.full(shape, 64.0, dtype=dt)
    M_max = _u(gen, 16.0, 120.0, shape, dt)                 # [s]
    R_max = _u(gen, 15.0, 75.0, shape, dt)
    Sh1_max = _u(gen, 10.0, 30.0, shape, dt)
    Shtyp_max = _u(gen, 30.0, 150.0, shape, dt)
    D = _u(gen, 900.0, 1500.0, shape, dt) * deadline_scale  # [s]

    # Table 6 derivations (X^avg = 0.8 X^max)
    M_avg, R_avg, Shtyp_avg = 0.8 * M_max, 0.8 * R_max, 0.8 * Shtyp_max
    H_low = torch.clamp(torch.floor(0.8 * H_up), min=1.0)
    A = nM * M_avg
    B = nR * (Shtyp_avg + R_avg)
    C = M_max + R_max + Sh1_max + Shtyp_max
    return {"A": A, "B": B, "E": C - D, "cM": cM, "cR": cR, "H_up": H_up,
            "H_low": H_low, "m": m, "rho_up": rho_up}


def sample_scenario(gen: torch.Generator, n_classes: int, *,
                    capacity_factor: float = 1.1, capacity=None,
                    deadline_scale: float = 1.0, device="cuda",
                    dtype: torch.dtype | None = None) -> Scenario:
    """Random instance per the paper's design of experiments (Table 5).

    ``capacity_factor``: R = factor * R^o with R^o = sum(r_up) (Sec. 5.2.1).
    ``deadline_scale``: multiplies D_i (Sec. 5.2.2 uses < 1 to tighten).
    ``capacity``: overrides R directly when given.  The instance is placed
    on ``device`` (default the card) in ``dtype`` (default float64).
    """
    dev = resolve_device(device)
    dt = dtype or fdtype()
    raw = _table5_raw(gen, (n_classes,), deadline_scale, dt)

    # cost model, Eq. 15 (v=2 fixed; one draw per cluster)
    v = 2.0
    d = _u(gen, 3.0, 5.0, (), dt)
    pue = _u(gen, 1.2, 2.2, (), dt)
    energy = _u(gen, 0.06009, 0.06690, (), dt)
    srv = 2.0615
    rho_bar = (pue * energy + srv) * v / d

    raw = {k: t.to(dev) for k, t in raw.items()}
    scn = derive(**raw, R=0.0, rho_bar=rho_bar.to(dev))
    if capacity is None:
        capacity = capacity_factor * torch.sum(scn.r_up)
    return scn.replace(R=torch.as_tensor(capacity, dtype=dt, device=dev))


def sample_class_params(gen: torch.Generator, *,
                        deadline_scale: float = 1.0) -> dict:
    """Raw parameters of ONE job class per the paper's Table 5/6 design.

    Returns
    -------
    dict
        ``{A, B, E, cM, cR, H_up, H_low, m, rho_up}`` as python floats — the
        :data:`repro_torch.core.types.RAW_CLASS_FIELDS` of one class.
    """
    raw = _table5_raw(gen, (), deadline_scale, fdtype())
    return {k: float(v) for k, v in raw.items()}


def from_roofline(compute_s, collective_s, overhead_s, deadline_s, *,
                  chips_ref: float, H_up, H_low, m, rho_up, R,
                  rho_bar: float = 1.0, device="cuda") -> Scenario:
    """Fit the paper's job profiles from measured roofline terms.

    A tenant job profiled at ``chips_ref`` chips spends ``compute_s``
    seconds in math (the "map wave"), ``collective_s`` seconds in
    collectives (the "reduce wave") and ``overhead_s`` fixed time per SLA
    window.  Both wave terms scale as 1 / chips, the paper's ``A h / s``
    form with h = 1 job:

        T(r) = A / sM + B / sR + C,  sM = sR = r  (cM = cR = 1 slot a chip).

    Every argument is a scalar or a (N,) array of the classes; the result is
    a :class:`Scenario` in f64 on ``device`` (default the card).
    """
    dev = resolve_device(device)
    dt = fdtype()

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    A = t(compute_s) * chips_ref
    B = t(collective_s) * chips_ref
    E = t(overhead_s) - t(deadline_s)
    ones = torch.ones_like(A)
    return derive(A, B, E, ones, ones, t(H_up), t(H_low), t(m), t(rho_up),
                  R=t(R), rho_bar=t(rho_bar))
