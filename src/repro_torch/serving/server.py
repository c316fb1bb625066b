"""Socket front-end for the admission daemon: asyncio stream server.

Counterpart of ``repro.serving.server``.  Binds
:mod:`repro_torch.serving.wire` frames onto a running
:class:`~repro_torch.serving.allocd.AllocDaemon`; scenarios and events
arriving on the wire are decoded onto the daemon engine's device.  One server owns one daemon;
each connection may register any number of tenants and pipelines ``offer``
frames for them.  Everything — connection handlers, the daemon scheduler,
flush push-backs — shares one event loop, and every daemon call the server
makes is synchronous (no ``await`` between read and reply), so wire
tenants keep the daemon's conformance story: the frames a client receives
describe exactly the same flush-boundary equilibria an offline
``WindowSession.stream`` replay of its accepted events produces.

Protocol-level violations (oversized / malformed / wrong-version frames)
earn one ``error`` frame and a closed connection — after a framing
violation the byte stream cannot be re-synchronized.  Application-level
errors (unknown tenant, duplicate registration, quota-violating window)
earn an ``error`` frame naming the offending request and the connection
stays up.

A connection dying with events still buffered (mid-epoch) triggers
:meth:`AllocDaemon.drain_tenant` for each tenant it registered: the
accepted prefix is folded and flushed, so the daemon-side report list
stays equal to an offline replay of exactly the events the client got
tickets for.
"""
from __future__ import annotations

import asyncio
from typing import Dict, Optional, Set, Tuple

from repro_torch.serving import wire
from repro_torch.serving.allocd import AllocDaemon


class AllocServer:
    """Serve an :class:`AllocDaemon` over length-prefixed JSON frames.

    Parameters
    ----------
    daemon : AllocDaemon
        The admission daemon to front.  If it has not been started yet,
        :meth:`start` starts it.
    host : str, optional
        Bind address (default loopback).
    port : int, optional
        Bind port; ``0`` picks an ephemeral port (see :attr:`address`).
    max_frame : int, optional
        Strict frame-size bound enforced on reads and writes.
    default_quota : TenantQuota, optional
        Per-tenant admission budget applied to wire tenants that register
        without one (operator-side quota sizing; a quota carried by the
        ``register_tenant`` frame wins).

    Notes
    -----
    Tenant names are first-registered-wins across connections; a tenant
    registered by a dead connection remains registered (its reports stay
    inspectable) but a later connection cannot re-register the name —
    real deployments namespace tenants per client identity.
    """

    def __init__(self, daemon: AllocDaemon, *, host: str = "127.0.0.1",
                 port: int = 0, max_frame: int = wire.MAX_FRAME_BYTES,
                 default_quota=None):
        self.daemon = daemon
        self.host = host
        self.port = port
        self.max_frame = max_frame
        self.default_quota = default_quota
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections = 0
        self.frame_errors = 0

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        """Start the daemon (if needed) and begin accepting connections."""
        if self.daemon._task is None:
            await self.daemon.start()
        self._server = await asyncio.start_server(
            self._handle, host=self.host, port=self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> Tuple[str, int]:
        """The bound ``(host, port)`` — port resolved after :meth:`start`."""
        return (self.host, self.port)

    async def close(self, *, drain: bool = True) -> None:
        """Stop accepting, close listener, shut the daemon down.

        Parameters
        ----------
        drain : bool, optional
            Forwarded to :meth:`AllocDaemon.shutdown` — graceful drain
            (default) or abort.
        """
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.daemon.shutdown(drain=drain)

    # ----------------------------------------------------------- connection
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        # per-connection state: which tenants this socket owns, and the
        # daemon-seq -> client-cseq map used to label flush frames
        tenants: Set[str] = set()
        cseq_by_seq: Dict[str, Dict[int, int]] = {}
        try:
            while True:
                try:
                    msg = await wire.read_frame(reader,
                                                max_frame=self.max_frame)
                except asyncio.IncompleteReadError:
                    break                      # disconnect (maybe mid-frame)
                except wire.WireError as exc:
                    # framing violation: stream unrecoverable — error+close
                    self.frame_errors += 1
                    code = ("frame_too_large"
                            if isinstance(exc, wire.FrameTooLargeError)
                            else "bad_version"
                            if isinstance(exc, wire.ProtocolVersionError)
                            else "malformed_frame")
                    self._send(writer, {"type": "error", "code": code,
                                        "message": str(exc)})
                    break
                if not self._dispatch(msg, writer, tenants, cseq_by_seq):
                    break
                await writer.drain()
        except ConnectionError:
            pass
        finally:
            for name in tenants:
                self.daemon.detach_tenant(name)
                self.daemon.drain_tenant(name)
            writer.close()

    def _dispatch(self, msg, writer, tenants: Set[str],
                  cseq_by_seq: Dict[str, Dict[int, int]]) -> bool:
        """Handle one decoded frame; False ends the connection."""
        mtype = msg["type"]
        if mtype == "register_tenant":
            return self._on_register(msg, writer, tenants, cseq_by_seq)
        if mtype == "offer":
            return self._on_offer(msg, writer, tenants, cseq_by_seq)
        if mtype == "flush":
            return self._on_flush_req(msg, writer, tenants)
        if mtype == "drain":
            return self._on_drain(msg, writer, tenants)
        self._send(writer, {"type": "error", "code": "unknown_type",
                            "message": f"unknown message type {mtype!r}",
                            "req": mtype})
        return True

    def _on_register(self, msg, writer, tenants, cseq_by_seq) -> bool:
        name = msg.get("tenant")
        try:
            lanes = [wire.decode_scenario(d, device=self.daemon.engine.device)
                     for d in msg["lanes"]]
            quota = wire.decode_quota(msg.get("quota"))
            if quota is None:
                quota = self.default_quota
            n_max = msg.get("n_max")
            self.daemon.add_tenant(
                name, lanes, n_max=n_max, quota=quota,
                on_flush=self._make_push(writer, name, cseq_by_seq))
        except wire.WireError as exc:
            self._send(writer, {"type": "error", "code": "bad_register",
                                "message": str(exc),
                                "req": "register_tenant", "tenant": name})
            return True
        except Exception as exc:   # duplicate name, quota-violating window
            self._send(writer, {"type": "error",
                                "code": type(exc).__name__,
                                "message": str(exc),
                                "req": "register_tenant", "tenant": name})
            return True
        tenants.add(name)
        cseq_by_seq[name] = {}
        self._send(writer, {"type": "register_tenant", "tenant": name,
                            "lanes": len(lanes), "n_max": n_max})
        return True

    def _on_offer(self, msg, writer, tenants, cseq_by_seq) -> bool:
        name, cseq = msg.get("tenant"), msg.get("cseq")
        if name not in tenants:
            self._send(writer, {"type": "error", "code": "unknown_tenant",
                                "message": f"tenant {name!r} not registered "
                                           "on this connection",
                                "req": "offer", "tenant": name,
                                "cseq": cseq})
            return True
        try:
            event = wire.decode_event(msg["event"],
                                      device=self.daemon.engine.device)
        except (KeyError, wire.WireError) as exc:
            self._send(writer, {"type": "error", "code": "bad_event",
                                "message": str(exc), "req": "offer",
                                "tenant": name, "cseq": cseq})
            return True
        ticket = self.daemon.submit(name, event)
        if ticket.accepted:
            cseq_by_seq[name][ticket.seq] = cseq
            self._send(writer, {"type": "ticket", "tenant": name,
                                "cseq": cseq, "seq": ticket.seq})
        else:
            self._send(writer, {"type": "reject", "tenant": name,
                                "cseq": cseq, "penalty": ticket.penalty})
        return True

    def _on_flush_req(self, msg, writer, tenants) -> bool:
        name = msg.get("tenant")
        if name not in tenants:
            self._send(writer, {"type": "error", "code": "unknown_tenant",
                                "message": f"tenant {name!r} not registered "
                                           "on this connection",
                                "req": "flush", "tenant": name})
            return True
        self.daemon.request_flush(name)
        return True                # the reply is the pushed flush frame

    def _on_drain(self, msg, writer, tenants) -> bool:
        for name in sorted(tenants):
            self.daemon.drain_tenant(name)
        self._send(writer, {"type": "drain", "tenants": sorted(tenants)})
        return True

    # ----------------------------------------------------------- push side
    def _make_push(self, writer, name: str, cseq_by_seq):
        """Build the daemon ``on_flush`` callback for one socket tenant."""
        flush_seq = [0]

        def push(report, tickets):
            seqmap = cseq_by_seq.get(name, {})
            entries = [{"cseq": seqmap.pop(t.seq, None), "slot": t.slot}
                       for t in tickets]
            msg = {"type": "flush", "tenant": name,
                   "flush_seq": flush_seq[0], "tickets": entries,
                   "report": None if report is None
                   else wire.encode_report(report)}
            if report is None:
                msg["error"] = "flush failed (epoch discarded)"
            flush_seq[0] += 1
            try:
                self._send(writer, msg)
            except (wire.WireError, ConnectionError):
                self.daemon.detach_tenant(name)

        return push

    def _send(self, writer, msg) -> None:
        """Write one frame (single synchronous write; no interleaving)."""
        if writer.is_closing():
            return
        writer.write(wire.encode_frame(msg, max_frame=self.max_frame))
