"""Byte compatibility of the port's wire codec with the JAX package's.

``repro_torch.serving.wire`` must speak the reference's protocol: the same
scenario, event, quota and report encode to the same frame bytes in both
packages (a tensor on any device is copied to the host first; a 0-d tensor
encodes as a 0-d jax array does), each package decodes the other's
frames, and every malformed, oversized, zero-length, wrong-version or
truncated frame the reference rejects, the port rejects with the same
error.  Decoding is exact: arrays cross as raw bytes, so a decoded leaf
equals the encoded one bit for bit.
"""
import asyncio
import dataclasses
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_parity import np_, port_events, scenario_pairs
from repro.core import engine as je
from repro.core import streaming as js
from repro.core import types as jt
from repro.serving import wire as jw
from repro_torch.core import engine as te
from repro_torch.core import streaming as ts
from repro_torch.core import types as tt
from repro_torch.serving import wire as tw

NS, N_MAX = (4, 6, 3), 8


def frame(msg, wire):
    return wire.encode_frame(msg)


def read(data, wire=tw):
    """``wire.read_frame`` over a stream that holds ``data`` and then ends."""
    async def run():
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await wire.read_frame(reader)
    return asyncio.run(run())


def events_pair():
    """The same events of every kind, as (JAX, port) objects."""
    params = {"A": 1234.5, "B": 678.25, "E": -300.0, "cM": 2.0, "cR": 3.0,
              "H_up": 7.0, "H_low": 5.0, "m": 20000.0, "rho_up": 11.5}
    jev = [jt.ClassArrival(lane=1, params=params),
           jt.ClassArrival(lane=0, params={**params,
                                           "m": jnp.asarray(2.5e4)}),
           jt.ClassDeparture(lane=2, slot=3),
           jt.SLAEdit(lane=0, slot=1, updates={"H_up": 3.5, "E": -12.0}),
           jt.CapacityChange(lane=2, R=17.0)]
    tev = [tt.ClassArrival(lane=1, params=params),
           tt.ClassArrival(lane=0, params={**params,
                                           "m": torch.tensor(
                                               2.5e4, dtype=torch.float64)}),
           tt.ClassDeparture(lane=2, slot=3),
           tt.SLAEdit(lane=0, slot=1, updates={"H_up": 3.5, "E": -12.0}),
           tt.CapacityChange(lane=2, R=17.0)]
    return jev, tev


def reports_pair():
    """One flush report of each package over the same window and events."""
    sj, st = scenario_pairs(5, NS, capacity_factor=1.3)
    jwin = js.AdmissionWindow(sj, n_max=N_MAX)
    twin = ts.AdmissionWindow(st, n_max=N_MAX)
    events = js.sample_event_trace(3, jwin, 6)
    policies = dict(rounding=False)
    jeng = je.CapacityEngine(je.SolverConfig(), je.Policies(
        flush=js.FlushPolicy(max_events=100),
        rounding=je.RoundingPolicy(**{"enabled": policies["rounding"]})))
    teng = te.CapacityEngine(te.SolverConfig(), te.Policies(
        flush=ts.FlushPolicy(max_events=100),
        rounding=te.RoundingPolicy(enabled=False)), device="cpu")
    js_, ts_ = jeng.open_window(jwin), teng.open_window(twin)
    for ev, tev in zip(events, port_events(events)):
        js_.offer(ev)
        ts_.offer(tev)
    return js_.flush(), ts_.flush()


# --------------------------------------------------------------------------
# Same objects, same bytes
# --------------------------------------------------------------------------

def test_constants_match_the_reference():
    assert tw.PROTOCOL_VERSION == jw.PROTOCOL_VERSION == 1
    assert tw.MAX_FRAME_BYTES == jw.MAX_FRAME_BYTES
    assert tw._SCENARIO_RAW == jw._SCENARIO_RAW
    assert tw._SOLUTION_FIELDS == jw._SOLUTION_FIELDS


@pytest.mark.parametrize("seed", [0, 1])
def test_scenario_frames_are_byte_identical(seed):
    sj, st = scenario_pairs(seed, NS)
    for a, b in zip(sj, st):
        msg = {"type": "register_tenant", "tenant": "t0"}
        assert (frame({**msg, "lanes": [jw.encode_scenario(a)]}, jw)
                == frame({**msg, "lanes": [tw.encode_scenario(b)]}, tw))


@pytest.mark.parametrize("k", range(5))
def test_event_frames_are_byte_identical(k):
    jev, tev = events_pair()
    assert (frame({"type": "offer", "event": jw.encode_event(jev[k])}, jw)
            == frame({"type": "offer", "event": tw.encode_event(tev[k])}, tw))


@pytest.mark.parametrize("quota", [None, (3, None), (None, 2), (8, 4)])
def test_quota_frames_are_byte_identical(quota):
    jq = None if quota is None else je.TenantQuota(*quota)
    tq = None if quota is None else te.TenantQuota(*quota)
    assert json.dumps(jw.encode_quota(jq)) == json.dumps(tw.encode_quota(tq))
    assert tw.decode_quota(jw.encode_quota(jq)) == tq
    assert jw.decode_quota(tw.encode_quota(tq)) == jq


def test_report_frames_carry_the_reference_dtypes_and_bytes():
    """Real reports of the two packages over the same window: every leaf
    has the reference's dtype string and shape, and iterations, flags and
    mask the same bytes; the port report's values encoded through the JAX
    codec (as jax arrays) give the port's frame byte for byte."""
    rj, rt = reports_pair()
    ej, et = jw.encode_report(rj), tw.encode_report(rt)
    for name in tw._SOLUTION_FIELDS:
        a, b = ej["fractional"][name], et["fractional"][name]
        assert (a["dtype"], a["shape"]) == (b["dtype"], b["shape"]), name
    for name in ("mask", "iters", "feasible"):
        assert ej[name] == et[name], name
    assert ej["fractional"]["iters"] == et["fractional"]["iters"]
    assert ej["fractional"]["feasible"] == et["fractional"]["feasible"]
    as_jax = dataclasses.replace(
        rj, fractional=jt.Solution(**{
            f: jnp.asarray(np_(getattr(rt.fractional, f)))
            for f in tw._SOLUTION_FIELDS}),
        mask=jnp.asarray(np_(rt.mask)), iters=jnp.asarray(np_(rt.iters)),
        feasible=jnp.asarray(np_(rt.feasible)))
    assert frame({"type": "flush", "report": jw.encode_report(as_jax)}, jw) \
        == frame({"type": "flush", "report": et}, tw)


def test_zero_d_tensor_encodes_as_a_zero_d_jax_array():
    for jx, tx in [(jnp.asarray(1 / 3), torch.tensor(1 / 3,
                                                     dtype=torch.float64)),
                   (jnp.asarray(7, jnp.int32), torch.tensor(7,
                                                            dtype=torch.int32)),
                   (jnp.asarray(True), torch.tensor(True))]:
        assert jw._encode_value(jx) == tw._encode_value(tx)
    assert tw._encode_value(0.1) == jw._encode_value(0.1) == 0.1


# --------------------------------------------------------------------------
# Each package decodes the other's frames
# --------------------------------------------------------------------------

def test_each_package_decodes_the_others_scenarios():
    sj, st = scenario_pairs(2, NS)
    for a, b in zip(sj, st):
        got_t = tw.decode_scenario(
            read(frame({"type": "x", "s": jw.encode_scenario(a)}, jw))["s"],
            device="cpu")
        own_t = tw.decode_scenario(tw.encode_scenario(b), device="cpu")
        got_j = jw.decode_scenario(
            read(frame({"type": "x", "s": tw.encode_scenario(b)}, tw),
                 jw)["s"])
        for f in dataclasses.fields(tt.Scenario):
            assert_bitwise_equal(np_(getattr(got_t, f.name)),
                                 np_(getattr(own_t, f.name)), f.name)
            assert_bitwise_equal(np_(getattr(got_j, f.name)),
                                 np.asarray(getattr(a, f.name)), f.name)


def test_each_package_decodes_the_others_events():
    jev, tev = events_pair()
    for a, b in zip(jev, tev):
        got_t = tw.decode_event(read(frame(
            {"type": "offer", "event": jw.encode_event(a)}, jw))["event"])
        got_j = jw.decode_event(read(frame(
            {"type": "offer", "event": tw.encode_event(b)}, tw), jw)["event"])
        assert type(got_t).__name__ == type(b).__name__
        assert jw.encode_event(got_j) == tw.encode_event(got_t)
    on_dev = tw.decode_event(tw.encode_event(tev[1]), device="cpu")
    assert isinstance(on_dev.params["m"], torch.Tensor)
    assert float(on_dev.params["m"]) == 2.5e4


def test_each_package_decodes_the_others_reports():
    rj, rt = reports_pair()
    got_t = tw.decode_report("t0", 0, jw.encode_report(rj), [(1, 0)])
    got_j = jw.decode_report("t0", 0, tw.encode_report(rt), [(1, 0)])
    for f in tw._SOLUTION_FIELDS:
        assert_bitwise_equal(getattr(got_t.fractional, f),
                             np.asarray(getattr(rj.fractional, f)), f)
        assert_bitwise_equal(getattr(got_j.fractional, f),
                             np_(getattr(rt.fractional, f)), f)
    assert_bitwise_equal(got_t.mask, np.asarray(rj.mask), "mask")
    assert got_t.tickets == got_j.tickets == [(1, 0)]


# --------------------------------------------------------------------------
# Rejections (the reference's cases)
# --------------------------------------------------------------------------

def _payload(obj):
    raw = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    return struct.pack(">I", len(raw)) + raw


BAD_FRAMES = {
    "oversized": (struct.pack(">I", tw.MAX_FRAME_BYTES + 1),
                  "FrameTooLargeError"),
    "undecodable": (_payload(b"\x00\xff\xfenot json"), "MalformedFrameError"),
    "not an object": (_payload([1, 2, 3]), "MalformedFrameError"),
    "no type": (_payload({"v": 1, "no_type": True}), "MalformedFrameError"),
    "non-string type": (_payload({"v": 1, "type": 42}),
                        "MalformedFrameError"),
    "zero length": (struct.pack(">I", 0), "MalformedFrameError"),
    "bad version": (_payload({"v": 99, "type": "offer"}),
                    "ProtocolVersionError"),
    "truncated payload": (jw.encode_frame({"type": "offer"})[:-3],
                          "IncompleteReadError"),
    "truncated header": (jw.encode_frame({"type": "offer"})[:2],
                         "IncompleteReadError"),
}


@pytest.mark.parametrize("case", sorted(BAD_FRAMES))
def test_bad_frames_are_rejected_as_the_reference_rejects_them(case):
    data, error = BAD_FRAMES[case]
    for wire in (jw, tw):
        with pytest.raises(Exception) as exc:
            read(data, wire)
        assert type(exc.value).__name__ == error, (wire.__name__, case)


def test_oversized_frames_refused_at_write_time():
    with pytest.raises(tw.FrameTooLargeError):
        tw.encode_frame({"type": "offer", "blob": "x" * 4096}, max_frame=1024)


@pytest.mark.parametrize("enc", [
    {"dtype": "<f8", "shape": [4], "data": "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"},
    {"dtype": "<f8", "shape": [1], "data": "!!!"},
    {"dtype": "<f8", "shape": [1]},
])
def test_bad_array_payloads_rejected(enc):
    for wire in (jw, tw):
        with pytest.raises(wire.MalformedFrameError):
            wire.decode_array(enc)


def test_bad_scenario_and_event_encodings_rejected():
    with pytest.raises(tw.MalformedFrameError):
        tw.decode_scenario({"A": tw.encode_array(np.ones(2))}, device="cpu")
    with pytest.raises(tw.MalformedFrameError):
        tw.decode_event({"kind": "warp", "lane": 0})
    with pytest.raises(tw.MalformedFrameError):
        tw.decode_event({"kind": "departure", "lane": 0})
    with pytest.raises(TypeError):
        tw.encode_event(object())
