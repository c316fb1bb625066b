"""Always-on admission daemon over the CapacityEngine session layer.

Counterpart of ``repro.serving.allocd``.  The runtime half of the paper's
story: a long-running Resource Manager process that many tenants
(MapReduce user classes, one :class:`~repro_torch.core.engine.WindowSession`
each) submit admission events to, multiplexed over ONE shared
:class:`~repro_torch.core.engine.CapacityEngine`, whose device (the card
by default) every tenant's window lives on.

Design contract (what ``tests/test_torch_allocd.py`` pins down):

* **Bit-equal conformance.**  Per tenant, the daemon produces exactly the
  flush-boundary equilibria of an offline ``WindowSession.stream`` replay
  of that tenant's accepted events.  This holds because (a) intake uses
  ``WindowSession.offer`` which runs the very same flush-policy check as
  ``apply``, (b) once a session is *due* it receives no further events
  until flushed — so epoch boundaries cannot shift, and (c) tenant
  windows are independent, so cross-tenant scheduling order affects
  latency only, never equilibria.
* **Backpressure with rejection cost.**  The request queue is bounded;
  when full, a submitted event is rejected and charged the paper's
  rejection penalty (an arrival rejecting a whole class forfeits
  ``m * H_up`` — the per-job penalty times the upper job concurrency).
* **Deadline-aware cross-session flushing.**  Among due sessions, the one
  whose buffered events carry the tightest SLA slack
  (``WindowSession.pending_slack``) flushes first — the multi-tenant
  generalization of ``FlushPolicy.deadline``.
* **Fairness.**  Intake is round-robin with a one-event quantum and a
  rotating start tenant, so a chatty tenant cannot starve others out of
  the fold order.
* **Graceful drain.**  ``shutdown(drain=True)`` delivers every queued
  event and flushes every trailing partial epoch (the same trailing
  flush ``stream`` performs); ``drain=False`` aborts — queued and
  in-buffer events are discarded and their tickets cancelled, leaving
  each session at its last flushed state.

Everything runs on one asyncio event loop; solves execute inline in the
scheduler task (a flush ends in host reads of its report), with a
cooperative yield between flushes so submitters interleave.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import (CapacityEngine, TenantQuota,
                                     WindowSession, WindowSolveReport)
from repro_torch.core.types import ClassArrival, StreamEvent


def rejection_penalty(event: StreamEvent) -> float:
    """Paper rejection cost charged when backpressure drops `event`.

    Rejecting a :class:`~repro_torch.core.types.ClassArrival` forfeits the
    whole
    class: ``m * H_up`` (per-job rejection penalty times the upper bound on
    concurrent jobs).  Other event kinds mutate classes that were already
    admitted, so dropping them carries no admission penalty (the previous
    equilibrium simply persists).

    Parameters
    ----------
    event : StreamEvent
        The rejected event.

    Returns
    -------
    float
        The forfeited objective value (>= 0).
    """
    if isinstance(event, ClassArrival):
        m = float(event.params.get("m", 0.0))
        h_up = float(event.params.get("H_up", 0.0))
        return abs(m) * abs(h_up)
    return 0.0


@dataclass
class AdmissionTicket:
    """One submitted event's admission outcome, resolvable asynchronously.

    ``accepted`` is decided synchronously at :meth:`AllocDaemon.submit`
    (backpressure); ``slot`` / ``report`` land when the covering flush
    completes.  ``await ticket.wait()`` returns the flush report (``None``
    if the ticket was rejected or cancelled by an abort).
    """

    tenant: str
    event: StreamEvent
    seq: int
    accepted: bool
    penalty: float = 0.0
    t_submit: float = 0.0
    t_done: Optional[float] = None
    slot: Optional[int] = None
    report: Optional[WindowSolveReport] = None
    cancelled: bool = False
    _fut: Optional["asyncio.Future"] = field(default=None, repr=False)

    async def wait(self) -> Optional[WindowSolveReport]:
        """Block until the covering flush resolves this ticket.

        Returns
        -------
        WindowSolveReport or None
            The flush report, or ``None`` for rejected/cancelled tickets.
        """
        if self._fut is None:
            return self.report
        return await self._fut

    def _resolve(self, value) -> None:
        if self._fut is not None and not self._fut.done():
            self._fut.set_result(value)

    def _fail(self, exc: BaseException) -> None:
        if self._fut is not None and not self._fut.done():
            self._fut.set_exception(exc)


@dataclass
class _Tenant:
    """Internal per-tenant scheduling state."""

    name: str
    session: WindowSession
    queue: Deque[AdmissionTicket] = field(default_factory=deque)
    inflight: List[AdmissionTicket] = field(default_factory=list)
    due: bool = False
    reports: List[WindowSolveReport] = field(default_factory=list)
    quota: Optional[TenantQuota] = None
    on_flush: Optional[Callable] = None
    submitted: int = 0
    rejected: int = 0
    rejection_cost: float = 0.0

    @property
    def queued(self) -> int:
        """Not-yet-flushed events charged against this tenant's quota."""
        return len(self.queue) + len(self.inflight)


class AllocDaemon:
    """Asyncio admission daemon: many tenant sessions, one engine.

    Parameters
    ----------
    engine : CapacityEngine
        The shared solver.  Its flush policy decides per-tenant epoch
        boundaries; its compaction/rounding/cross-check policies apply to
        every tenant alike.
    queue_limit : int, optional
        Bound on the total not-yet-folded backlog across all tenants.
        Submits beyond it are rejected with :func:`rejection_penalty`.
        ``None`` disables backpressure.

    Notes
    -----
    All methods must be called from the daemon's event loop (the one
    :meth:`start` ran on).  ``submit`` is synchronous — the backpressure
    decision is immediate; only the flush outcome is awaited via the
    returned ticket.
    """

    def __init__(self, engine: CapacityEngine, *,
                 queue_limit: Optional[int] = 1024):
        self.engine = engine
        self.queue_limit = queue_limit
        self._tenants: Dict[str, _Tenant] = {}
        self._queued = 0
        self._seq = 0
        self._rr = 0
        self._closing = False
        self._abort = False
        self._task: Optional["asyncio.Task"] = None
        self._wake: Optional["asyncio.Event"] = None
        self._t_start: Optional[float] = None
        self._t_last_flush: Optional[float] = None
        # observability (tests + throughput reporting)
        self.latencies_s: List[float] = []
        self.fold_log: List[str] = []           # intake order, by tenant
        self.flush_log: List[Tuple[str, float]] = []  # (tenant, slack) order
        self.submitted = 0
        self.rejected = 0
        self.rejection_cost = 0.0
        self.flush_errors = 0

    # ------------------------------------------------------------ tenants
    def add_tenant(self, name: str, lanes, *,
                   n_max: Optional[int] = None,
                   quota: Optional[TenantQuota] = None,
                   on_flush: Optional[Callable] = None) -> WindowSession:
        """Register a tenant with its own WindowSession over the engine.

        Parameters
        ----------
        name : str
            Tenant key used by :meth:`submit` / :meth:`reports`.
        lanes : AdmissionWindow, Scenario, Sequence[Scenario] or ScenarioBatch
            Initial lane set, coerced by ``CapacityEngine.open_window``.
        n_max : int, optional
            Padded class capacity headroom for a fresh window.
        quota : TenantQuota, optional
            Per-tenant budget: submissions past ``max_queued`` not-yet-
            flushed events are rejected with the paper's rejection penalty
            (accounted per tenant, see :meth:`tenant_stats`), and the
            initial window must fit ``max_lanes``.  The daemon-wide
            ``queue_limit`` remains as a backstop across all tenants.
        on_flush : callable, optional
            ``on_flush(report_or_none, tickets)`` invoked after every flush
            covering this tenant — ``None`` report on a failed (poisoned)
            epoch.  The wire server uses it to push flush frames to socket
            tenants; it runs inline in the scheduler, so keep it cheap.

        Returns
        -------
        WindowSession
            The tenant's session (exposed for inspection; drive it through
            the daemon, not directly, or conformance breaks).

        Raises
        ------
        repro_torch.core.engine.QuotaExceededError
            When the initial lane set already exceeds ``quota.max_lanes``.
        """
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        session = self.engine.open_window(lanes, n_max=n_max, quota=quota)
        if self.engine.config.residency == "resident":
            # resident at registration, not at the first flush: placement
            # lands here instead of inside the first admission's latency,
            # and the tenant's state stays on the mesh for the daemon's life
            session.window.make_resident(self.engine.config.mesh)
        self._tenants[name] = _Tenant(name, session, quota=quota,
                                      on_flush=on_flush)
        return session

    def tenant_stats(self, name: str) -> Dict[str, float]:
        """Per-tenant admission accounting (the quota observability hook).

        Parameters
        ----------
        name : str
            Tenant key.

        Returns
        -------
        dict
            ``submitted`` / ``rejected`` / ``rejection_cost`` for this
            tenant alone, plus its live ``queued`` backlog, ``flushes``
            and ``events_folded``.
        """
        t = self._tenants[name]
        return {
            "submitted": float(t.submitted),
            "rejected": float(t.rejected),
            "rejection_cost": float(t.rejection_cost),
            "queued": float(t.queued),
            "flushes": float(t.session.flushes),
            "events_folded": float(t.session.events_folded),
        }

    def reports(self, name: str) -> List[WindowSolveReport]:
        """Flush-boundary reports produced so far for tenant `name`.

        Parameters
        ----------
        name : str
            Tenant key.

        Returns
        -------
        list of WindowSolveReport
            In flush order — the daemon-side sequence the conformance
            harness compares against an offline ``stream`` replay.
        """
        return self._tenants[name].reports

    @property
    def tenants(self) -> Tuple[str, ...]:
        """Registered tenant names, in registration order."""
        return tuple(self._tenants)

    # ------------------------------------------------------------ control
    async def start(self) -> None:
        """Start the scheduler task on the current event loop."""
        if self._task is not None:
            raise RuntimeError("daemon already started")
        self._wake = asyncio.Event()
        self._t_start = time.perf_counter()
        self._task = asyncio.get_running_loop().create_task(self._run())

    def submit(self, tenant: str, event: StreamEvent, *,
               t_submit: Optional[float] = None) -> AdmissionTicket:
        """Submit one event; decide backpressure now, flush later.

        Parameters
        ----------
        tenant : str
            Target tenant (must be registered).
        event : StreamEvent
            The admission event to fold into the tenant's window.
        t_submit : float, optional
            Scheduled arrival time on the ``time.perf_counter`` clock.
            Open-loop callers pass the *intended* arrival time so measured
            admission latency includes queueing delay; defaults to now.

        Returns
        -------
        AdmissionTicket
            ``accepted=False`` (with ``penalty`` set) when the tenant's
            quota (``TenantQuota.max_queued``) or the daemon-wide backstop
            (``queue_limit``) is exhausted; otherwise the ticket resolves
            at the covering flush.
        """
        if self._closing:
            raise RuntimeError("daemon is shutting down")
        t = self._tenants[tenant]
        now = time.perf_counter()
        self._seq += 1
        self.submitted += 1
        t.submitted += 1
        ticket = AdmissionTicket(
            tenant=tenant, event=event, seq=self._seq, accepted=True,
            t_submit=now if t_submit is None else t_submit)
        over_quota = (t.quota is not None
                      and not t.quota.admits_event(t.queued))
        if over_quota or (self.queue_limit is not None
                          and self._queued >= self.queue_limit):
            ticket.accepted = False
            ticket.penalty = rejection_penalty(event)
            ticket.t_done = now
            self.rejected += 1
            self.rejection_cost += ticket.penalty
            t.rejected += 1
            t.rejection_cost += ticket.penalty
            return ticket
        ticket._fut = asyncio.get_running_loop().create_future()
        t.queue.append(ticket)
        self._queued += 1
        if self._wake is not None:
            self._wake.set()
        return ticket

    async def shutdown(self, *, drain: bool = True) -> None:
        """Stop the daemon, gracefully or not.

        Parameters
        ----------
        drain : bool, optional
            ``True`` (graceful): deliver every queued event, then flush
            every trailing partial epoch — afterwards each tenant's report
            list equals the full offline replay of its accepted events.
            ``False`` (abort): discard queued and buffered events, cancel
            their tickets; each session stays at its last flushed state.
        """
        if self._task is None:
            return
        self._closing = True
        self._abort = not drain
        self._wake.set()
        await self._task
        self._task = None

    def request_flush(self, name: str) -> None:
        """Force one tenant's buffered epoch to flush at the next round.

        Marks the session due, so (by the due-sessions-receive-no-events
        invariant) no further intake lands before the flush — the epoch
        boundary moves *earlier*, exactly like an explicit
        ``WindowSession.flush`` call at this point of the tenant's trace.
        A no-op epoch (nothing pending) still produces a flush report
        (the session echoes its current equilibrium), so a wire ``flush``
        request is always answered by a flush frame.

        Parameters
        ----------
        name : str
            Tenant key.
        """
        t = self._tenants[name]
        t.due = True
        if self._wake is not None:
            self._wake.set()

    def detach_tenant(self, name: str) -> None:
        """Drop a tenant's ``on_flush`` callback (e.g. its socket died).

        The tenant stays registered and its reports remain inspectable;
        only the push channel is severed.

        Parameters
        ----------
        name : str
            Tenant key.
        """
        self._tenants[name].on_flush = None

    def drain_tenant(self, name: str) -> None:
        """Deliver ONE tenant's backlog now and flush its trailing partial.

        The single-tenant analog of a graceful shutdown, replaying exactly
        the scheduler's intake semantics (never offer a due session, flush
        between epochs) so the tenant's report list afterwards equals a
        full offline ``session.stream`` replay of its accepted events.
        The wire server calls this when a socket tenant disconnects
        mid-epoch: the accepted prefix is folded and flushed rather than
        left dangling, and later reconnects find a clean session.

        Parameters
        ----------
        name : str
            Tenant key; other tenants are untouched.
        """
        t = self._tenants[name]
        while t.queue:
            if t.due:
                self._flush(t)
            ticket = t.queue.popleft()
            self._queued -= 1
            t.inflight.append(ticket)
            self.fold_log.append(name)
            if t.session.offer(ticket.event):
                t.due = True
        if t.due or t.inflight or t.session.pending:
            self._flush(t)

    # ---------------------------------------------------------- scheduler
    async def _run(self) -> None:
        while True:
            if self._abort:
                break
            worked = self._step()
            if worked:
                # cooperative yield between solve batches so submitters
                # (and the shutdown call) interleave with the scheduler
                await asyncio.sleep(0)
                continue
            if self._closing:
                break
            self._wake.clear()
            if self._closing or self._abort:   # racing shutdown re-set it
                continue
            await self._wake.wait()
        if self._abort:
            self._cancel_outstanding()
        else:
            self._final_flushes()

    def _step(self) -> bool:
        """One fair intake round + slack-ordered flushes. True if worked."""
        worked = False
        names = list(self._tenants)
        if names:
            start = self._rr % len(names)
            self._rr += 1
            for name in names[start:] + names[:start]:
                t = self._tenants[name]
                if t.due or not t.queue:
                    continue
                ticket = t.queue.popleft()
                self._queued -= 1
                t.inflight.append(ticket)
                self.fold_log.append(name)
                if t.session.offer(ticket.event):
                    t.due = True
                worked = True
        due = [t for t in self._tenants.values() if t.due]
        for t in sorted(due, key=lambda t: (t.session.pending_slack(),
                                            t.name)):
            self._flush(t)
            worked = True
        return worked

    def _flush(self, t: _Tenant) -> None:
        tickets, t.inflight = t.inflight, []
        slack = t.session.pending_slack()
        try:
            report = t.session.flush()
        except Exception as exc:   # poisoned epoch: fail it, stay alive
            t.session.discard_pending()
            t.due = False
            self.flush_errors += 1
            for ticket in tickets:
                ticket.cancelled = True
                ticket._fail(exc)
            if t.on_flush is not None:
                t.on_flush(None, tickets)
            return
        now = time.perf_counter()
        self._t_last_flush = now
        t.due = False
        t.reports.append(report)
        self.flush_log.append((t.name, slack))
        slots = t.session.last_slots
        for i, ticket in enumerate(tickets):
            ticket.slot = slots[i] if i < len(slots) else None
            ticket.report = report
            ticket.t_done = now
            self.latencies_s.append(now - ticket.t_submit)
            ticket._resolve(report)
        if t.on_flush is not None:
            t.on_flush(report, tickets)

    def _final_flushes(self) -> None:
        """Graceful-drain tail: flush every trailing partial epoch."""
        trailing = [t for t in self._tenants.values()
                    if t.inflight or t.session.pending]
        for t in sorted(trailing, key=lambda t: (t.session.pending_slack(),
                                                 t.name)):
            self._flush(t)

    def _cancel_outstanding(self) -> None:
        """Abort tail: cancel queued + in-buffer tickets, drop buffers."""
        for t in self._tenants.values():
            t.session.discard_pending()
            t.due = False
            for ticket in list(t.queue) + t.inflight:
                ticket.cancelled = True
                ticket._resolve(None)
            self._queued -= len(t.queue)
            t.queue.clear()
            t.inflight = []

    # ------------------------------------------------------------- report
    def report(self) -> Dict[str, float]:
        """Throughput / latency summary for the run so far.

        Returns
        -------
        dict
            ``events_per_sec`` (folded events over active wall time),
            ``admission_p50_ms`` / ``admission_p99_ms`` (scheduled-arrival
            to flush-completion latency percentiles), plus counters
            (``submitted``, ``accepted``, ``rejected``,
            ``rejection_cost``, ``events_folded``, ``flushes``).
        """
        folded = sum(t.session.events_folded
                     for t in self._tenants.values())
        flushes = sum(t.session.flushes for t in self._tenants.values())
        elapsed = 0.0
        if self._t_start is not None and self._t_last_flush is not None:
            elapsed = max(self._t_last_flush - self._t_start, 1e-9)
        lat = np.asarray(self.latencies_s, dtype=np.float64)
        return {
            "submitted": float(self.submitted),
            "accepted": float(self.submitted - self.rejected),
            "rejected": float(self.rejected),
            "rejection_cost": float(self.rejection_cost),
            "events_folded": float(folded),
            "flushes": float(flushes),
            "elapsed_s": float(elapsed),
            "events_per_sec": float(folded / elapsed) if elapsed else 0.0,
            "admission_p50_ms": float(np.percentile(lat, 50) * 1e3)
            if lat.size else 0.0,
            "admission_p99_ms": float(np.percentile(lat, 99) * 1e3)
            if lat.size else 0.0,
        }


# ------------------------------------------------------------ open loop
# The arrival-schedule generators live in repro_torch.core.traces (the
# shared workload-trace library) so the capacity planner and the daemon are
# driven by identical workloads; re-exported here as the reference does.
from repro_torch.core.traces import (      # noqa: E402  (re-export)
    ARRIVAL_PROFILES,
    bursty_times,
    diurnal_times,
    flash_crowd_times,
    poisson_times,
    straggler_times,
)


async def drive_open_loop(daemon: AllocDaemon,
                          schedule: Sequence[Tuple[float, str, StreamEvent]],
                          ) -> List[AdmissionTicket]:
    """Submit a timed schedule open-loop and return the tickets.

    Arrivals are submitted at their scheduled offsets regardless of how
    far behind the daemon is (open-loop: queueing delay shows up in the
    measured admission latency, not in the arrival process).  If the
    submitter itself falls behind wall clock, the scheduled time is still
    used as the latency origin.

    Parameters
    ----------
    daemon : AllocDaemon
        A started daemon.
    schedule : sequence of (t_offset, tenant, event)
        Monotone-by-offset submission plan.

    Returns
    -------
    list of AdmissionTicket
        One per schedule entry, in submission order.
    """
    t0 = time.perf_counter()
    tickets: List[AdmissionTicket] = []
    for t_off, tenant, event in schedule:
        delay = (t0 + t_off) - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tickets.append(daemon.submit(tenant, event, t_submit=t0 + t_off))
    return tickets


def interleave_traces(traces: Dict[str, Sequence[StreamEvent]],
                      times: np.ndarray,
                      ) -> List[Tuple[float, str, StreamEvent]]:
    """Zip per-tenant traces round-robin onto a global arrival schedule.

    Per-tenant event order is preserved (required for replay validity);
    tenants take turns claiming the next global arrival slot until their
    traces are exhausted.

    Parameters
    ----------
    traces : dict of str to sequence of StreamEvent
        Per-tenant traces, in application order.
    times : numpy.ndarray
        Global arrival offsets, at least ``sum(len(t))`` long.

    Returns
    -------
    list of (float, str, StreamEvent)
        The open-loop schedule for :func:`drive_open_loop`.
    """
    cursors = {name: 0 for name in traces}
    order = list(traces)
    schedule: List[Tuple[float, str, StreamEvent]] = []
    k = 0
    while order:
        for name in list(order):
            seq = traces[name]
            i = cursors[name]
            if i >= len(seq):
                order.remove(name)
                continue
            schedule.append((float(times[k]), name, seq[i]))
            cursors[name] = i + 1
            k += 1
    return schedule
