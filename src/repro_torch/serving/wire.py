"""Wire protocol for the admission daemon: length-prefixed JSON frames.

Counterpart of ``repro.serving.wire``, byte-compatible with it: the same
:data:`PROTOCOL_VERSION`, :data:`MAX_FRAME_BYTES`, framing and array
encoding, so a client of either package talks to a server of the other.
Tenants on remote processes submit class arrivals / SLA edits over a
socket and get admission tickets back, while the daemon end multiplexes
them onto its :class:`~repro_torch.serving.allocd.AllocDaemon`.  This
module is the *codec* layer only — pure functions over bytes and dicts, no
sockets; the asyncio halves live in :mod:`repro_torch.serving.server` and
:mod:`repro_torch.serving.client`.  Tensors are copied to the host before
they are encoded, and decoded scenarios are derived on the device the
caller names (the server engine's).

Framing
-------
One frame = a 4-byte big-endian unsigned payload length followed by a UTF-8
JSON object.  Frames larger than ``max_frame`` bytes are rejected without
buffering the payload (:class:`FrameTooLargeError`); payloads that fail to
parse into a JSON object with a string ``type`` are
:class:`MalformedFrameError`s.  Both are *connection-fatal*: after a framing
violation the byte stream cannot be trusted, so the peer sends one
``error`` frame and closes.

Messages
--------
Every message carries ``v`` (:data:`PROTOCOL_VERSION`) and ``type``:

======================  =========  =========================================
type                    direction  meaning
======================  =========  =========================================
``register_tenant``     c -> s     open a tenant window (lanes + quota);
                                   echoed back as the acknowledgement
``offer``               c -> s     submit one admission event (``cseq``
                                   correlates the replies)
``flush``               c -> s     force the tenant's buffered epoch to
                                   re-equilibrate now
``drain``               c -> s     fold + flush every trailing partial of
                                   this connection's tenants; echoed back
``ticket``              s -> c     offer accepted (daemon ``seq`` attached)
``reject``              s -> c     offer rejected: quota / backstop
                                   exhausted, carries the paper's
                                   rejection ``penalty``
``flush``               s -> c     one flush-boundary report: the covered
                                   tickets (``cseq`` + granted ``slot``)
                                   and the bit-exact equilibrium
``error``               s -> c     protocol or application error (``code``,
                                   ``message``, optional ``req``/``cseq``
                                   naming the request it answers)
======================  =========  =========================================

Exactness
---------
Conformance demands socket tenants see the *same bits* an offline
``WindowSession.stream`` replay produces, so arrays never pass through JSON
floats: every array leaf is encoded as ``{dtype, shape, base64(raw bytes)}``
(:func:`encode_array`), and scenarios cross the wire as their raw Table-5
fields with the derived constants recomputed by
:func:`~repro_torch.core.types.derive` on the receiving side —
deterministic, hence bit-identical between two ends of one package (and
equal up to the two packages' ``derive`` across them).  Python floats
inside event ``params`` round-trip exactly through JSON (``repr`` <->
``float``).
"""
from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import TenantQuota
from repro_torch.core.types import (CapacityChange, ClassArrival,
                                    ClassDeparture, Scenario, SLAEdit,
                                    Solution, StreamEvent, derive)

#: Protocol version stamped on (and required of) every frame.
PROTOCOL_VERSION = 1

#: Default strict frame-size bound [bytes] — a flush report at daemon scale
#: is a few KiB, so 1 MiB is generous headroom while still rejecting a
#: stream gone insane before buffering it.
MAX_FRAME_BYTES = 1 << 20

_HEADER = struct.Struct(">I")

#: Raw Scenario fields that cross the wire (derived constants recomputed).
_SCENARIO_RAW = ("A", "B", "E", "cM", "cR", "H_up", "H_low", "m", "rho_up",
                 "R", "rho_bar")

#: Solution fields carried by a flush report (every field, in field order,
#: so a decoded report walks identically to a local one).
_SOLUTION_FIELDS = ("r", "psi", "sM", "sR", "cost", "penalty", "total",
                    "feasible", "iters", "aux")


class WireError(Exception):
    """Base class for every wire-protocol failure."""


class FrameTooLargeError(WireError):
    """Declared frame length exceeds the negotiated ``max_frame`` bound."""


class MalformedFrameError(WireError):
    """Payload is not a JSON object with a string ``type`` field."""


class ProtocolVersionError(WireError):
    """Peer speaks a different :data:`PROTOCOL_VERSION`."""


class RemoteError(WireError):
    """An ``error`` frame from the peer, surfaced locally.

    Parameters
    ----------
    code : str
        Machine-readable error code (``unknown_tenant``, ``bad_version``,
        ``frame_too_large``, ...).
    message : str
        Human-readable detail from the peer.
    """

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


# --------------------------------------------------------------------- frames
def encode_frame(msg: Dict[str, Any], *,
                 max_frame: int = MAX_FRAME_BYTES) -> bytes:
    """Serialize one message dict into a length-prefixed frame.

    Parameters
    ----------
    msg : dict
        JSON-serializable message (``v`` is stamped in if absent).
    max_frame : int, optional
        Size bound the *sender* honors too — a frame we would refuse to
        read is refused at write time, loudly.

    Returns
    -------
    bytes
        4-byte big-endian length header + UTF-8 JSON payload.

    Raises
    ------
    FrameTooLargeError
        When the encoded payload exceeds ``max_frame``.
    """
    payload = json.dumps({"v": PROTOCOL_VERSION, **msg},
                         separators=(",", ":")).encode("utf-8")
    if len(payload) > max_frame:
        raise FrameTooLargeError(
            f"frame of {len(payload)} bytes exceeds max_frame={max_frame}")
    return _HEADER.pack(len(payload)) + payload


def decode_payload(payload: bytes) -> Dict[str, Any]:
    """Parse and validate one frame payload into a message dict.

    Parameters
    ----------
    payload : bytes
        The JSON bytes following a length header.

    Returns
    -------
    dict
        The message, guaranteed to be an object with a string ``type``.

    Raises
    ------
    MalformedFrameError
        Non-JSON, non-object, or missing/non-string ``type``.
    ProtocolVersionError
        ``v`` missing or not :data:`PROTOCOL_VERSION`.
    """
    try:
        msg = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise MalformedFrameError(f"undecodable frame payload: {exc}")
    if not isinstance(msg, dict) or not isinstance(msg.get("type"), str):
        raise MalformedFrameError(
            "frame payload must be a JSON object with a string 'type'")
    if msg.get("v") != PROTOCOL_VERSION:
        raise ProtocolVersionError(
            f"unsupported protocol version {msg.get('v')!r} "
            f"(this end speaks {PROTOCOL_VERSION})")
    return msg


async def read_frame(reader, *,
                     max_frame: int = MAX_FRAME_BYTES) -> Dict[str, Any]:
    """Read one frame from an asyncio stream reader.

    Partial reads are handled by ``readexactly`` — a frame split across
    arbitrarily many TCP segments reassembles transparently; a connection
    closing mid-frame raises ``asyncio.IncompleteReadError`` (truncation).

    Parameters
    ----------
    reader : asyncio.StreamReader
        The byte stream.
    max_frame : int, optional
        Strict payload bound; an oversized header is rejected *before*
        its payload is buffered.

    Returns
    -------
    dict
        The decoded, version-checked message.

    Raises
    ------
    FrameTooLargeError, MalformedFrameError, ProtocolVersionError
        Framing violations (connection-fatal; see module docstring).
    asyncio.IncompleteReadError
        The peer closed mid-frame (or cleanly at a frame boundary, in
        which case ``partial`` is empty).
    """
    header = await reader.readexactly(_HEADER.size)
    (length,) = _HEADER.unpack(header)
    if length > max_frame:
        raise FrameTooLargeError(
            f"declared frame length {length} exceeds max_frame={max_frame}")
    if length == 0:
        raise MalformedFrameError("zero-length frame")
    return decode_payload(await reader.readexactly(length))


# --------------------------------------------------------------------- arrays
def encode_array(x) -> Dict[str, Any]:
    """Encode one array (or scalar) leaf bit-exactly.

    Parameters
    ----------
    x : array-like
        A tensor (copied to the host first, on any device) or anything
        ``np.asarray`` accepts.

    Returns
    -------
    dict
        ``{"dtype": str, "shape": [...], "data": base64(raw C-order bytes)}``.
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": base64.b64encode(np.ascontiguousarray(arr).tobytes())
            .decode("ascii")}


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    """Decode :func:`encode_array` output back to a numpy array.

    Parameters
    ----------
    d : dict
        ``{"dtype", "shape", "data"}`` as produced by :func:`encode_array`.

    Returns
    -------
    numpy.ndarray
        Bit-identical to the encoded array.

    Raises
    ------
    MalformedFrameError
        On missing keys, bad base64, or a byte count inconsistent with
        ``dtype``/``shape``.
    """
    try:
        raw = base64.b64decode(d["data"], validate=True)
        arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
        return arr.reshape(d["shape"]).copy()
    except (KeyError, TypeError, ValueError) as exc:
        raise MalformedFrameError(f"bad array encoding: {exc}")


def _encode_value(v):
    """One event-param value: exact floats/ints pass as JSON scalars,
    array-ish values (incl. 0-d numpy scalars and 0-d tensors, as the
    reference treats a 0-d jax array) keep their dtype."""
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    if isinstance(v, float):
        return v                      # repr round-trips float64 exactly
    return {"__nd__": encode_array(v)}


def _decode_value(v, device=None):
    """Inverse of :func:`_encode_value`: an array-valued param comes back as
    numpy (a 0-d one as a numpy scalar), or as a tensor on ``device`` when
    one is named."""
    if isinstance(v, dict) and "__nd__" in v:
        arr = decode_array(v["__nd__"])
        if device is not None:
            return torch.as_tensor(arr, device=device)
        return arr[()] if arr.ndim == 0 else arr
    return v


# ------------------------------------------------------------------ scenarios
def encode_scenario(scn: Scenario) -> Dict[str, Any]:
    """Encode a lane scenario as its raw Table-5 fields.

    Derived constants (``K``, ``xiM``, ``alpha``, ...) are *not* shipped:
    the receiver recomputes them with :func:`repro_torch.core.types.derive`,
    which
    is deterministic, so both ends hold bit-identical scenarios while the
    frame stays minimal.

    Parameters
    ----------
    scn : Scenario
        The lane to encode.

    Returns
    -------
    dict
        Raw field name -> :func:`encode_array` payload.
    """
    return {f: encode_array(getattr(scn, f)) for f in _SCENARIO_RAW}


def decode_scenario(d: Dict[str, Any], *, device="cuda") -> Scenario:
    """Rebuild a :class:`~repro_torch.core.types.Scenario` from raw wire
    fields, on ``device``.

    Parameters
    ----------
    d : dict
        :func:`encode_scenario` output.
    device : str or torch.device, optional
        Where the scenario is derived (default the card; the server passes
        its engine's device).

    Returns
    -------
    Scenario
        With derived constants recomputed (bit-identical to a sender of
        this package on the same device).

    Raises
    ------
    MalformedFrameError
        On missing fields or undecodable arrays.
    """
    try:
        raw = {f: decode_array(d[f]) for f in _SCENARIO_RAW}
    except KeyError as exc:
        raise MalformedFrameError(f"scenario missing raw field {exc}")
    return derive(**raw, device=device)


# -------------------------------------------------------------------- events
_EVENT_KINDS = {
    "arrival": ClassArrival,
    "departure": ClassDeparture,
    "sla_edit": SLAEdit,
    "capacity": CapacityChange,
}


def encode_event(ev: StreamEvent) -> Dict[str, Any]:
    """Encode one admission event for an ``offer`` frame.

    Parameters
    ----------
    ev : StreamEvent
        ClassArrival / ClassDeparture / SLAEdit / CapacityChange.

    Returns
    -------
    dict
        ``{"kind", "lane", ...}`` with params/updates value-encoded
        exactly (:func:`_encode_value`).

    Raises
    ------
    TypeError
        For an unknown event class.
    """
    if isinstance(ev, ClassArrival):
        return {"kind": "arrival", "lane": int(ev.lane),
                "params": {k: _encode_value(v) for k, v in ev.params.items()}}
    if isinstance(ev, ClassDeparture):
        return {"kind": "departure", "lane": int(ev.lane),
                "slot": int(ev.slot)}
    if isinstance(ev, SLAEdit):
        return {"kind": "sla_edit", "lane": int(ev.lane), "slot": int(ev.slot),
                "updates": {k: _encode_value(v)
                            for k, v in ev.updates.items()}}
    if isinstance(ev, CapacityChange):
        return {"kind": "capacity", "lane": int(ev.lane), "R": float(ev.R)}
    raise TypeError(f"cannot encode event of type {type(ev).__name__!r}")


def decode_event(d: Dict[str, Any], *, device=None) -> StreamEvent:
    """Decode an ``offer`` frame's event back into its dataclass.

    Parameters
    ----------
    d : dict
        :func:`encode_event` output.
    device : str or torch.device, optional
        Where array-valued params / updates are placed as tensors (the
        server passes its engine's device); None keeps them numpy.

    Returns
    -------
    StreamEvent
        The event, with params/updates values bit-identical to the
        sender's.

    Raises
    ------
    MalformedFrameError
        On an unknown kind or missing fields.
    """
    try:
        kind = d["kind"]
        if kind == "arrival":
            return ClassArrival(lane=int(d["lane"]),
                                params={k: _decode_value(v, device)
                                        for k, v in d["params"].items()})
        if kind == "departure":
            return ClassDeparture(lane=int(d["lane"]), slot=int(d["slot"]))
        if kind == "sla_edit":
            return SLAEdit(lane=int(d["lane"]), slot=int(d["slot"]),
                           updates={k: _decode_value(v, device)
                                    for k, v in d["updates"].items()})
        if kind == "capacity":
            return CapacityChange(lane=int(d["lane"]), R=float(d["R"]))
    except (KeyError, TypeError, ValueError) as exc:
        raise MalformedFrameError(f"bad event encoding: {exc}")
    raise MalformedFrameError(f"unknown event kind {d.get('kind')!r}")


# -------------------------------------------------------------------- quotas
def encode_quota(quota: Optional[TenantQuota]) -> Optional[Dict[str, Any]]:
    """Encode a :class:`~repro_torch.core.engine.TenantQuota` (or None).

    Parameters
    ----------
    quota : TenantQuota or None
        The per-tenant budget.

    Returns
    -------
    dict or None
        ``{"max_queued", "max_lanes"}``.
    """
    if quota is None:
        return None
    return {"max_queued": quota.max_queued, "max_lanes": quota.max_lanes}


def decode_quota(d: Optional[Dict[str, Any]]) -> Optional[TenantQuota]:
    """Decode :func:`encode_quota` output.

    Parameters
    ----------
    d : dict or None
        The wire form.

    Returns
    -------
    TenantQuota or None
        The budget object.
    """
    if d is None:
        return None
    return TenantQuota(max_queued=d.get("max_queued"),
                       max_lanes=d.get("max_lanes"))


# ------------------------------------------------------------------- reports
@dataclass
class WireFlushReport:
    """One flush-boundary equilibrium as decoded on the client side.

    Mirrors the fields the conformance harness compares on a
    :class:`~repro_torch.core.engine.WindowSolveReport` — ``fractional``
    (the full :class:`~repro_torch.core.types.Solution`), ``mask`` and
    ``iters`` — so the same bit-equality assertions run against wire
    reports and offline replays.

    Attributes
    ----------
    tenant : str
        The tenant this flush belongs to.
    flush_seq : int
        0-based flush index within the tenant (wire frames may interleave
        across tenants; this orders them per tenant).
    fractional : Solution
        The flush's fractional equilibrium (numpy leaves, bit-identical
        to the daemon's).
    mask : numpy.ndarray
        (B, n_max) class-validity mask at the flush boundary.
    iters : numpy.ndarray
        Per-lane Algorithm 4.1 iteration counts.
    feasible : numpy.ndarray
        Per-lane feasibility flags.
    tickets : list of (int or None, int or None)
        ``(cseq, slot)`` per covered offer, in fold order.
    error : str or None
        Set when the covering flush failed (poisoned epoch) — all other
        payload fields are then None.
    """
    tenant: str
    flush_seq: int
    fractional: Optional[Solution]
    mask: Optional[np.ndarray]
    iters: Optional[np.ndarray]
    feasible: Optional[np.ndarray]
    tickets: List[Tuple[Optional[int], Optional[int]]] = field(
        default_factory=list)
    error: Optional[str] = None


def encode_report(report) -> Dict[str, Any]:
    """Encode the conformance-relevant slice of a flush report.

    Parameters
    ----------
    report : WindowSolveReport
        The daemon-side flush result.

    Returns
    -------
    dict
        ``fractional`` (field -> array), ``mask``, ``iters``, ``feasible``
        — every leaf bit-exact via :func:`encode_array`.
    """
    return {
        "fractional": {f: encode_array(getattr(report.fractional, f))
                       for f in _SOLUTION_FIELDS},
        "mask": encode_array(report.mask),
        "iters": encode_array(report.iters),
        "feasible": encode_array(report.feasible),
    }


def decode_report(tenant: str, flush_seq: int, d: Optional[Dict[str, Any]],
                  tickets: List[Tuple[Optional[int], Optional[int]]],
                  error: Optional[str] = None) -> WireFlushReport:
    """Decode a server ``flush`` frame into a :class:`WireFlushReport`.

    Parameters
    ----------
    tenant : str
        Tenant the frame names.
    flush_seq : int
        Per-tenant flush index from the frame.
    d : dict or None
        :func:`encode_report` output (None for a failed flush).
    tickets : list of (cseq, slot)
        Covered offers, in fold order.
    error : str, optional
        Failure text for a poisoned epoch.

    Returns
    -------
    WireFlushReport
        With ``fractional`` rebuilt as a
        :class:`~repro_torch.core.types.Solution` of numpy leaves.

    Raises
    ------
    MalformedFrameError
        On missing solution fields or undecodable arrays.
    """
    if d is None:
        return WireFlushReport(tenant=tenant, flush_seq=flush_seq,
                               fractional=None, mask=None, iters=None,
                               feasible=None, tickets=tickets, error=error)
    try:
        sol = Solution(**{f: decode_array(d["fractional"][f])
                          for f in _SOLUTION_FIELDS})
        return WireFlushReport(
            tenant=tenant, flush_seq=flush_seq, fractional=sol,
            mask=decode_array(d["mask"]), iters=decode_array(d["iters"]),
            feasible=decode_array(d["feasible"]), tickets=tickets,
            error=error)
    except KeyError as exc:
        raise MalformedFrameError(f"flush report missing field {exc}")
