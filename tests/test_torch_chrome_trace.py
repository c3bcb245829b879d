"""The port's Chrome trace exporter (``infra/chrome_trace.py``) against
JAX's: the same hand-written ticks and records (pump ticks with and without
their phase split, a failed tick, health instants, a handoff marker,
requests on two replicas with engine, first-token and verify sections, a
record with node timings only) give equal traces, and ``flight_to_chrome``
over a recorder of each package driven by one script on one fake clock
gives equal traces too. The port copies a tick's ``graph_captures`` where
JAX copies ``xla_compiles``."""

import itertools
import json

import pytest

from sentio_tpu.infra import chrome_trace as jchrome
from sentio_tpu.infra import flight as jflight
from sentio_tpu_torch.infra import chrome_trace as tchrome
from sentio_tpu_torch.infra import flight as tflight

PHASES = {"inbox_drain": 0.05, "admission_build": 0.4, "prefill_dispatch": 1.2,
          "decode_dispatch": 2.0, "device_wait": 6.5, "deliver": 0.1, "other": 0.25}

TICKS = [
    {"tick": 1, "t_s": 0.0105, "replica": 0, "dur_ms": 10.0, "pump_ms": 10.5,
     "phase_ms": PHASES, "active_slots": 2, "queue_depth": 1, "inbox_depth": 0,
     "prefill_tokens": 64, "decode_tokens": 8, "free_pages": 100},
    {"tick": 2, "t_s": 0.02, "replica": 0, "dur_ms": 9.0, "active_slots": 2,
     "decode_tokens": 16},
    {"tick": 3, "t_s": 0.021, "event": "replica_health", "replica": 1, "state": "QUARANTINED",
     "prior": "HEALTHY", "reason": "tick failures"},
    {"tick": 4, "t_s": 0.03, "event": "tick_failure", "replica": 1, "dur_ms": 2.0,
     "pump_ms": 2.5, "phase_ms": {"inbox_drain": 0.5, "other": 2.0}},
    {"tick": 5, "t_s": 0.031, "event": "inbox_handoff", "replica": 1, "handed_off": 2},
    {"tick": 6, "t_s": 0.05, "replica": 1, "dur_ms": 4.0, "pump_ms": 4.25,
     "phase_ms": {**PHASES, "device_wait": 0.0}, "decode_tokens": 4},
]

RECORDS = [
    {"request_id": "a", "status": "done", "t_start_s": 0.001, "latency_ms": 45.0,
     "mode": "fast", "endpoint": "/chat", "question_chars": 12,
     "engine": {"tick_first": 0, "t_submit_s": 0.004, "replica_id": 0, "ttft_ms": 10.5,
                "tpot_ms": 0.75, "tokens": 20, "prompt_tokens": 300, "prefix_hit_tokens": 256,
                "finish_reason": "length"},
     "verify": {"mode": "async", "outcome": "pass", "verdict_ms": 12.0, "confidence": 0.5}},
    {"request_id": "b", "t_start_s": 0.002, "node_timings_ms": {"retrieve": 1.0,
                                                                "generate": 20.0},
     "engine": {"replica_id": 1, "t_submit_s": 0.003, "ttft_ms": 5.0}},
    {"request_id": "c", "status": "active", "t_start_s": 0.04},
    {"request_id": "d", "status": "done", "t_start_s": 0.005, "latency_ms": 10.0,
     "verify": {"mode": "gated", "skipped": "confident"}},
]


def test_build_chrome_trace_matches_jax():
    got = tchrome.build_chrome_trace(TICKS, RECORDS)
    assert got == jchrome.build_chrome_trace(TICKS, RECORDS)
    assert got == tchrome.build_chrome_trace(TICKS, RECORDS, label="sentio-tpu")
    names = [e["name"] for e in got["traceEvents"]]
    assert "tick 1" in names and "health:QUARANTINED" in names and "request a" in names
    assert "first_token" in names and "verify:pass" in names and "engine" in names
    json.dumps(got)


@pytest.mark.parametrize("label", ["sentio-tpu", "smoke"])
def test_empty_and_labelled_traces_match_jax(label):
    assert tchrome.build_chrome_trace([], [], label=label) == \
        jchrome.build_chrome_trace([], [], label=label)


def test_phases_tile_their_tick():
    trace = tchrome.build_chrome_trace(TICKS[:1], [])
    tick = next(e for e in trace["traceEvents"] if e["name"] == "tick 1")
    children = [e for e in trace["traceEvents"] if e["name"] in PHASES]
    assert children[0]["ts"] == tick["ts"]
    end = children[-1]["ts"] + children[-1]["dur"]
    assert abs(end - (tick["ts"] + tick["dur"])) < 1.0  # microseconds


def test_graph_captures_ride_the_tick_slice():
    tick = dict(TICKS[0], graph_captures=0)
    trace = tchrome.build_chrome_trace([tick], [])
    slice_ = next(e for e in trace["traceEvents"] if e["name"] == "tick 1")
    assert slice_["args"]["graph_captures"] == 0


def drive(recorder) -> None:
    recorder.start_request("q1", endpoint="/chat", mode="fast", question_chars=5)
    recorder.note_engine_submit("q1", replica_id=0)
    for i in range(3):
        tick = recorder.record_tick(replica=0, dur_ms=1.0 + i, active_slots=1,
                                    decode_tokens=4)
        recorder.amend_tick(tick, pump_ms=1.5 + i, phase_ms={"deliver": 0.5,
                                                            "other": 1.0 + i})
    recorder.finish_engine("q1", ttft_ms=1.5, tpot_ms=0.5, tokens=12, finish_reason="length")
    recorder.note_verify("q1", mode="sync", outcome="warn", verdict_ms=2.0)
    recorder.finish_request("q1", status="done")
    recorder.record_tick(event="replica_health", replica=0, state="HEALTHY")


def test_flight_to_chrome_matches_jax():
    out = []
    for fmod, cmod in ((tflight, tchrome), (jflight, jchrome)):
        recorder = fmod.FlightRecorder()
        counter = itertools.count()
        recorder._now = lambda c=counter: next(c) * 0.001
        drive(recorder)
        out.append((cmod.flight_to_chrome(recorder), cmod.flight_to_chrome(recorder, "q1"),
                    cmod.flight_to_chrome(recorder, "missing")))
    assert out[0] == out[1]
    whole, one, missing = out[0]
    assert missing is None and len(whole["traceEvents"]) > len(one["traceEvents"]) > 3
