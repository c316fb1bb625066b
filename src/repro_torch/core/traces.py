"""Shared workload-trace library: open-loop arrival schedules by regime.

Counterpart of ``repro.core.traces``, which imports numpy only; the port
keeps its own copy, bit for bit the reference's on the same seeds.  One
home for every synthetic arrival process, so the capacity planner
(:mod:`repro_torch.core.planning`) and the admission daemon
(:mod:`repro_torch.serving.allocd`) are driven by the same workloads.  The
regimes follow the managed-Hadoop utilization literature (PAPERS.md):

* :func:`poisson_times` — the steady baseline (memoryless arrivals);
* :func:`flash_crowd_times` — one hard mid-run rate step (the spike);
* :func:`diurnal_times` — smooth sinusoidal day/night modulation;
* :func:`bursty_times` — a two-state Markov-modulated Poisson process
  (quiet/burst phases with geometric dwell times), the "bursty" regime
  where load arrives in trains rather than one spike;
* :func:`straggler_times` — exponential arrivals with a heavy-tailed
  (Pareto-inflated) fraction of inter-arrival gaps: long quiet stretches
  punctuating normal traffic, the straggler-tail regime.

Every generator takes ``(seed, n, rate)`` and returns a monotone
``(n,)`` array of arrival offsets in seconds whose *mean* rate is the
requested ``rate`` in expectation (the modulated profiles normalize their
rate process so regime shape changes the arrival *pattern*, not the total
load — two profiles at the same ``rate`` are comparable experiments).
:data:`ARRIVAL_PROFILES` maps profile names to generators (the
``--arrival`` / ``PlanSpec.profile`` vocabulary).
"""
from __future__ import annotations

import numpy as np


def poisson_times(seed: int, n: int, rate: float) -> np.ndarray:
    """Open-loop Poisson arrival schedule: `n` times at `rate` events/s.

    Parameters
    ----------
    seed : int
        RNG seed (numpy Generator).
    n : int
        Number of arrivals.
    rate : float
        Mean arrival rate in events per second.

    Returns
    -------
    numpy.ndarray
        Monotone arrival offsets [s] from the run start, shape ``(n,)``.
    """
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def flash_crowd_times(seed: int, n: int, rate: float, *,
                      burst_factor: float = 8.0,
                      burst_frac: float = 0.4) -> np.ndarray:
    """Flash-crowd schedule: Poisson baseline with a mid-run burst.

    The middle ``burst_frac`` of events arrive ``burst_factor`` times
    faster than `rate` — the diurnal-spike regime the Hadoop utilization
    literature reports, compressed into one run.

    Parameters
    ----------
    seed : int
        RNG seed.
    n : int
        Number of arrivals.
    rate : float
        Baseline arrival rate in events per second.
    burst_factor : float, optional
        Rate multiplier inside the burst.
    burst_frac : float, optional
        Fraction of events (centered) arriving at the burst rate.

    Returns
    -------
    numpy.ndarray
        Monotone arrival offsets [s] from the run start, shape ``(n,)``.
    """
    rng = np.random.default_rng(seed)
    lo = int(n * (0.5 - burst_frac / 2.0))
    hi = int(n * (0.5 + burst_frac / 2.0))
    rates = np.full(n, rate, dtype=np.float64)
    rates[lo:hi] *= burst_factor
    return np.cumsum(rng.exponential(1.0, size=n) / rates)


def diurnal_times(seed: int, n: int, rate: float, *,
                  peak_factor: float = 4.0,
                  cycles: float = 2.0) -> np.ndarray:
    """Diurnal arrival schedule: sinusoidally modulated Poisson process.

    The day/night utilization cycle of the Hadoop trace studies, compressed
    into one run: the instantaneous rate swings between ``rate`` (the
    trough) and ``peak_factor * rate`` (the peak) along ``cycles`` full
    sine periods over the trace.  Unlike :func:`flash_crowd_times`'s one
    hard step, the load ramps smoothly — the regime where a deadline-aware
    flush scheduler has time to adapt its cadence.

    Parameters
    ----------
    seed : int
        RNG seed.
    n : int
        Number of arrivals.
    rate : float
        Trough arrival rate in events per second.
    peak_factor : float, optional
        Peak-to-trough rate ratio (>= 1).
    cycles : float, optional
        Number of full diurnal periods spanned by the trace.

    Returns
    -------
    numpy.ndarray
        Monotone arrival offsets [s] from the run start, shape ``(n,)``.
    """
    rng = np.random.default_rng(seed)
    phase = np.linspace(0.0, 2.0 * np.pi * cycles, n, endpoint=False)
    # rate(k) in [rate, peak_factor * rate], sinusoidal; thinning-free
    # construction: scale each exponential gap by its local rate
    rates = rate * (1.0 + (peak_factor - 1.0) * 0.5 * (1.0 - np.cos(phase)))
    return np.cumsum(rng.exponential(1.0, size=n) / rates)


def bursty_times(seed: int, n: int, rate: float, *,
                 burst_factor: float = 10.0,
                 p_enter: float = 0.05,
                 p_exit: float = 0.25) -> np.ndarray:
    """Bursty schedule: two-state Markov-modulated Poisson process (MMPP).

    A hidden quiet/burst state evolves as a Markov chain over events
    (geometric dwell times: a quiet phase lasts ``1/p_enter`` events on
    average, a burst ``1/p_exit``); inside a burst the instantaneous rate
    is ``burst_factor`` times the quiet rate.  Unlike
    :func:`flash_crowd_times`'s single deterministic spike, bursts recur
    at random throughout the trace — the "trains of arrivals" regime of
    the managed-Hadoop utilization study (PAPERS.md).

    The per-event rate sequence is normalized (conditionally on the
    sampled state path) so the expected trace duration is ``n / rate``:
    the *mean* load matches `rate` exactly, only its burst structure
    varies with the dwell parameters.

    Parameters
    ----------
    seed : int
        RNG seed.
    n : int
        Number of arrivals.
    rate : float
        Target mean arrival rate in events per second.
    burst_factor : float, optional
        Burst-to-quiet instantaneous rate ratio (>= 1).
    p_enter : float, optional
        Per-event probability of a quiet->burst transition.
    p_exit : float, optional
        Per-event probability of a burst->quiet transition.

    Returns
    -------
    numpy.ndarray
        Monotone arrival offsets [s] from the run start, shape ``(n,)``.
    """
    rng = np.random.default_rng(seed)
    flips = rng.random(n)
    state = np.empty(n, dtype=bool)        # True = burst phase
    s = False
    for k in range(n):
        s = (flips[k] < p_enter) if not s else (flips[k] >= p_exit)
        state[k] = s
    mult = np.where(state, burst_factor, 1.0)
    gaps = rng.exponential(1.0, size=n) / mult
    # conditional normalization: E[sum gaps | state path] == n / rate
    gaps *= (n / rate) / np.sum(1.0 / mult)
    return np.cumsum(gaps)


def straggler_times(seed: int, n: int, rate: float, *,
                    tail_frac: float = 0.1,
                    tail_index: float = 2.5) -> np.ndarray:
    """Straggler-tail schedule: Poisson arrivals with heavy-tailed gaps.

    A ``tail_frac`` fraction of inter-arrival gaps is inflated by a
    Pareto(``tail_index``) factor — occasional long quiet stretches
    (upstream stragglers holding back a wave of submissions) punctuating
    otherwise memoryless traffic.  ``tail_index > 2`` keeps the gap
    variance finite so the empirical mean rate of a finite trace still
    concentrates around `rate`; smaller values fatten the tail.

    Gaps are normalized by the mixture's closed-form mean
    ``1 - tail_frac + tail_frac * tail_index / (tail_index - 1)`` so the
    expected trace duration is ``n / rate`` — the target mean rate holds
    in expectation regardless of the tail parameters.

    Parameters
    ----------
    seed : int
        RNG seed.
    n : int
        Number of arrivals.
    rate : float
        Target mean arrival rate in events per second.
    tail_frac : float, optional
        Fraction of gaps drawn from the heavy tail (in (0, 1)).
    tail_index : float, optional
        Pareto shape of the tail factor (> 1; > 2 for finite variance).

    Returns
    -------
    numpy.ndarray
        Monotone arrival offsets [s] from the run start, shape ``(n,)``.
    """
    if not tail_index > 1.0:
        raise ValueError(f"tail_index={tail_index} must be > 1 "
                         "(the Pareto tail factor needs a finite mean)")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, size=n)
    heavy = rng.random(n) < tail_frac
    pareto = (1.0 - rng.random(n)) ** (-1.0 / tail_index)   # Pareto(a), >= 1
    gaps = np.where(heavy, gaps * pareto, gaps)
    mix_mean = 1.0 - tail_frac + tail_frac * tail_index / (tail_index - 1.0)
    return np.cumsum(gaps / (rate * mix_mean))


ARRIVAL_PROFILES = {
    "poisson": poisson_times,
    "flash": flash_crowd_times,
    "diurnal": diurnal_times,
    "bursty": bursty_times,
    "straggler": straggler_times,
}
"""Open-loop arrival schedule generators by profile name — the shared
``--arrival`` / ``PlanSpec.profile`` vocabulary of the admission daemon,
the capacity planner and the benchmarks (steady baseline, flash-crowd
step, diurnal sine, Markov-modulated bursts, heavy straggler tail)."""
