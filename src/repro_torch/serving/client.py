"""Async client for the admission daemon's wire protocol.

Counterpart of ``repro.serving.client``.  The tenant-side half of
:mod:`repro_torch.serving.server`: connects to a
``repro_torch.launch.allocd --listen`` process (or a server of the
reference package, the frames being the same), registers tenants,
pipelines ``offer`` frames, and reassembles the server's pushed ``flush``
frames into :class:`~repro_torch.serving.wire.WireFlushReport` objects
whose arrays are bit-identical to the daemon's.  Scenarios are sent as
their raw fields from any device.

Usage sketch::

    client = await AllocClient.connect(host, port)
    await client.register_tenant("t0", lanes, quota=TenantQuota(8, 8))
    tickets = [client.offer("t0", ev) for ev in trace]
    for tk in tickets:
        if await tk.ack():            # admitted (vs quota-rejected)?
            report = await tk.result()  # covering flush's equilibrium
    await client.drain()              # fold + flush trailing partials
    await client.close()

``offer`` is deliberately synchronous-send / async-resolve, mirroring
:meth:`AllocDaemon.submit`: the frame goes out immediately, the returned
:class:`WireTicket` resolves in two stages (admission ack, then flush
report) as the server's replies arrive on the background reader task.
"""
from __future__ import annotations

import asyncio
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.core.engine import TenantQuota
from repro_torch.core.types import Scenario, StreamEvent
from repro_torch.serving import wire


@dataclass
class WireTicket:
    """Client-side admission ticket for one ``offer`` frame.

    Two-stage resolution: :meth:`ack` resolves when the server's
    ``ticket``/``reject`` reply lands (admission decision);
    :meth:`result` resolves when the covering ``flush`` frame lands
    (equilibrium).  A rejected or error-answered offer resolves both
    stages immediately (``result`` -> ``None``).

    Attributes
    ----------
    tenant : str
        Target tenant.
    cseq : int
        Client-side sequence number correlating the replies.
    event : StreamEvent
        The submitted event.
    accepted : bool or None
        Admission decision; ``None`` until the ack arrives.
    penalty : float
        Paper rejection cost (``m * H_up`` for a dropped arrival) when
        rejected.
    seq : int or None
        Daemon-side ticket sequence (accepted offers only).
    slot : int or None
        Granted class slot, from the covering flush frame.
    report : WireFlushReport or None
        The covering flush, once resolved.
    t_submit : float
        Scheduled submission time on the ``time.perf_counter`` clock
        (open-loop callers pass the intended arrival time so measured
        latency includes queueing delay).
    t_done : float or None
        When the admission outcome resolved client-side — reject reply
        or covering flush frame — so ``t_done - t_submit`` is the
        end-to-end socket admission latency.
    """

    tenant: str
    cseq: int
    event: StreamEvent
    accepted: Optional[bool] = None
    penalty: float = 0.0
    seq: Optional[int] = None
    slot: Optional[int] = None
    report: Optional[wire.WireFlushReport] = None
    t_submit: float = 0.0
    t_done: Optional[float] = None
    _ack: "asyncio.Future" = field(repr=False, default=None)
    _done: "asyncio.Future" = field(repr=False, default=None)

    async def ack(self) -> bool:
        """Await the admission decision.

        Returns
        -------
        bool
            ``True`` if the daemon accepted the event, ``False`` if it
            was rejected (see :attr:`penalty`).

        Raises
        ------
        repro_torch.serving.wire.RemoteError
            If the server answered the offer with an ``error`` frame.
        """
        return await asyncio.shield(self._ack)

    async def result(self) -> Optional[wire.WireFlushReport]:
        """Await the covering flush report.

        Returns
        -------
        WireFlushReport or None
            The flush-boundary equilibrium covering this offer, or
            ``None`` for rejected offers and failed (poisoned) epochs.
        """
        return await asyncio.shield(self._done)


class AllocClient:
    """Wire-protocol client: one connection, any number of tenants.

    Build via :meth:`connect`.  All coroutines must run on the event
    loop that created the client; replies are demultiplexed by a
    background reader task, so offers from several tenants can be
    pipelined without awaiting each other.

    Parameters
    ----------
    reader, writer : asyncio streams
        The established connection.
    max_frame : int, optional
        Frame-size bound (must not exceed the server's).
    """

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *,
                 max_frame: int = wire.MAX_FRAME_BYTES):
        self._reader = reader
        self._writer = writer
        self.max_frame = max_frame
        self._cseq = 0
        self._tickets: Dict[int, WireTicket] = {}
        self._by_tenant_seq: Dict[str, WireTicket] = {}
        self._reports: Dict[str, List[wire.WireFlushReport]] = \
            defaultdict(list)
        self._rpc: Dict[str, Deque["asyncio.Future"]] = defaultdict(deque)
        self._flush_waiters: Dict[str, List["asyncio.Future"]] = \
            defaultdict(list)
        self._closed = False
        self._error: Optional[BaseException] = None
        #: unsolicited ``error`` frames (no matching request), newest last
        self.errors: List[wire.RemoteError] = []
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop())

    @classmethod
    async def connect(cls, host: str, port: int, *,
                      max_frame: int = wire.MAX_FRAME_BYTES
                      ) -> "AllocClient":
        """Open a connection and start the reply reader.

        Parameters
        ----------
        host, port : str, int
            The server's listen address.
        max_frame : int, optional
            Frame-size bound for both directions.

        Returns
        -------
        AllocClient
            Ready for :meth:`register_tenant`.
        """
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer, max_frame=max_frame)

    # ------------------------------------------------------------- requests
    async def register_tenant(self, name: str, lanes: Sequence[Scenario], *,
                              n_max: Optional[int] = None,
                              quota: Optional[TenantQuota] = None) -> dict:
        """Register a tenant window on the server.

        Parameters
        ----------
        name : str
            Tenant key (server-wide unique).
        lanes : sequence of Scenario
            Initial lane scenarios, shipped raw and re-derived server-side
            (see :func:`repro_torch.serving.wire.encode_scenario`).
        n_max : int, optional
            Padded class capacity headroom.
        quota : TenantQuota, optional
            Per-tenant admission budget enforced by the daemon.

        Returns
        -------
        dict
            The server's acknowledgement frame.

        Raises
        ------
        repro_torch.serving.wire.RemoteError
            Duplicate name, quota-violating window, or undecodable lanes.
        """
        fut = self._expect("register_tenant")
        self._send({"type": "register_tenant", "tenant": name,
                    "lanes": [wire.encode_scenario(s) for s in lanes],
                    "n_max": n_max, "quota": wire.encode_quota(quota)})
        return await fut

    def offer(self, tenant: str, event: StreamEvent, *,
              t_submit: Optional[float] = None) -> WireTicket:
        """Submit one admission event (pipelined; returns immediately).

        Parameters
        ----------
        tenant : str
            A tenant previously registered on this connection.
        event : StreamEvent
            The event to fold into the tenant's window.
        t_submit : float, optional
            Scheduled arrival time on the ``time.perf_counter`` clock
            (latency origin for open-loop callers); defaults
            to now.

        Returns
        -------
        WireTicket
            Resolves in two stages as server replies arrive.
        """
        self._check_alive()
        self._cseq += 1
        loop = asyncio.get_running_loop()
        tk = WireTicket(tenant=tenant, cseq=self._cseq, event=event,
                        t_submit=(time.perf_counter() if t_submit is None
                                  else t_submit),
                        _ack=loop.create_future(),
                        _done=loop.create_future())
        self._tickets[self._cseq] = tk
        self._send({"type": "offer", "tenant": tenant, "cseq": tk.cseq,
                    "event": wire.encode_event(event)})
        return tk

    async def flush(self, tenant: str) -> wire.WireFlushReport:
        """Force the tenant's buffered epoch to flush; await its report.

        Returns the *next* flush frame for the tenant — if a policy-driven
        flush was already in motion, that one answers the request (the
        daemon's epoch boundaries are whatever the flush policy and this
        forcing produce; both are legal ``WindowSession.flush`` points).

        Parameters
        ----------
        tenant : str
            A tenant registered on this connection.

        Returns
        -------
        WireFlushReport
            The next flush-boundary report for the tenant.
        """
        self._check_alive()
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._flush_waiters[tenant].append(fut)
        self._send({"type": "flush", "tenant": tenant})
        return await fut

    async def drain(self) -> dict:
        """Fold and flush every trailing partial of this connection.

        Returns
        -------
        dict
            The server's ``drain`` acknowledgement (its trailing ``flush``
            frames are delivered first, so all tickets resolve before
            this returns).
        """
        fut = self._expect("drain")
        self._send({"type": "drain"})
        return await fut

    def reports(self, tenant: str) -> List[wire.WireFlushReport]:
        """Flush reports received so far for `tenant`, in flush order.

        Parameters
        ----------
        tenant : str
            Tenant key.

        Returns
        -------
        list of WireFlushReport
            The client-side mirror of ``AllocDaemon.reports(tenant)``.
        """
        return self._reports[tenant]

    async def close(self) -> None:
        """Close the connection and stop the reader task."""
        self._closed = True
        self._writer.close()
        self._reader_task.cancel()
        try:
            await self._reader_task
        except (asyncio.CancelledError, Exception):
            pass

    # ------------------------------------------------------------ internals
    def _send(self, msg) -> None:
        self._check_alive()
        self._writer.write(wire.encode_frame(msg, max_frame=self.max_frame))

    def _check_alive(self) -> None:
        if self._error is not None:
            raise self._error
        if self._closed:
            raise RuntimeError("client is closed")

    def _expect(self, reply_type: str) -> "asyncio.Future":
        self._check_alive()
        fut = asyncio.get_running_loop().create_future()
        self._rpc[reply_type].append(fut)
        return fut

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await wire.read_frame(self._reader,
                                            max_frame=self.max_frame)
                self._on_frame(msg)
        except asyncio.IncompleteReadError as exc:
            if exc.partial:           # closed mid-frame: truncation
                self._fail_all(wire.MalformedFrameError(
                    "connection closed mid-frame"))
            else:
                self._fail_all(ConnectionError("server closed connection"))
        except asyncio.CancelledError:
            raise
        except Exception as exc:      # framing violation from server side
            self._fail_all(exc)

    def _on_frame(self, msg) -> None:
        mtype = msg["type"]
        if mtype == "ticket":
            tk = self._tickets.get(msg.get("cseq"))
            if tk is not None:
                tk.accepted, tk.seq = True, msg.get("seq")
                self._by_tenant_seq[f"{tk.tenant}:{tk.seq}"] = tk
                if not tk._ack.done():
                    tk._ack.set_result(True)
        elif mtype == "reject":
            tk = self._tickets.get(msg.get("cseq"))
            if tk is not None:
                tk.accepted = False
                tk.penalty = float(msg.get("penalty", 0.0))
                tk.t_done = time.perf_counter()
                if not tk._ack.done():
                    tk._ack.set_result(False)
                if not tk._done.done():
                    tk._done.set_result(None)
        elif mtype == "flush":
            self._on_flush(msg)
        elif mtype in ("register_tenant", "drain"):
            waiters = self._rpc[mtype]
            if waiters:
                fut = waiters.popleft()
                if not fut.done():
                    fut.set_result(msg)
        elif mtype == "error":
            self._on_error(msg)

    def _on_flush(self, msg) -> None:
        tenant = msg.get("tenant")
        entries = [(e.get("cseq"), e.get("slot"))
                   for e in msg.get("tickets", [])]
        report = wire.decode_report(tenant, int(msg.get("flush_seq", 0)),
                                    msg.get("report"), entries,
                                    error=msg.get("error"))
        self._reports[tenant].append(report)
        for cseq, slot in entries:
            tk = self._tickets.get(cseq)
            if tk is None:
                continue
            tk.slot = slot
            tk.t_done = time.perf_counter()
            tk.report = None if report.error is not None else report
            if not tk._done.done():
                tk._done.set_result(tk.report)
        waiters, self._flush_waiters[tenant] = \
            self._flush_waiters[tenant], []
        for fut in waiters:
            if not fut.done():
                fut.set_result(report)

    def _on_error(self, msg) -> None:
        err = wire.RemoteError(msg.get("code", "error"),
                               msg.get("message", ""))
        req = msg.get("req")
        if req == "offer":
            tk = self._tickets.get(msg.get("cseq"))
            if tk is not None:
                if not tk._ack.done():
                    tk._ack.set_exception(err)
                if not tk._done.done():
                    tk._done.set_result(None)
                return
        waiters = self._rpc[req] if req in self._rpc else None
        if waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_exception(err)
            return
        # unsolicited error: record it — if it was connection-fatal the
        # server closes next and the EOF path fails outstanding futures
        self.errors.append(err)

    def _fail_all(self, exc: BaseException) -> None:
        if self._error is None:
            self._error = exc
        for tk in self._tickets.values():
            if not tk._ack.done():
                tk._ack.set_exception(exc)
            if not tk._done.done():
                tk._done.set_result(None)
        for waiters in self._rpc.values():
            while waiters:
                fut = waiters.popleft()
                if not fut.done():
                    fut.set_exception(exc)
        for tenant, waiters in self._flush_waiters.items():
            for fut in waiters:
                if not fut.done():
                    fut.set_exception(exc)
            self._flush_waiters[tenant] = []
