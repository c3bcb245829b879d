"""The port's flight recorder (``infra/flight.py``) against JAX's
``FlightRecorder``: one scripted sequence of request, engine and tick calls
— two admissions under one id (answer and verify), a window past
``MAX_TICKS_PER_RECORD`` ticks, health events on the same ring, amends of
kept and evicted ticks, LRU eviction of records and of the ring — goes
through both, and everything a reader sees is equal with the wall-clock
stamps (``t_s``, ``t_submit_s``, ``t_start_s``) dropped; then the same
script on a shared fake clock, stamps included."""

import itertools

import pytest

from sentio_tpu.infra import flight as jflight
from sentio_tpu_torch.infra import flight as tflight

STAMPS = ("t_s", "t_submit_s", "t_start_s")


def strip(value):
    """``value`` with every wall-clock stamp dropped, recursively."""
    if isinstance(value, dict):
        return {k: strip(v) for k, v in value.items() if k not in STAMPS}
    if isinstance(value, (list, tuple)):
        return [strip(v) for v in value]
    return value


def drive(recorder) -> dict:
    """One scripted sequence; returns what a reader of ``recorder`` sees."""
    seen = {}
    recorder.start_request("a", endpoint="/chat", mode="fast", question_chars=9)
    recorder.note_engine_submit("a", replica_id=1)
    first = recorder.record_tick(replica=1, dur_ms=2.5, active_slots=1, decode_tokens=0,
                                 prefill_tokens=40)
    seen["amend_kept"] = recorder.amend_tick(first, pump_ms=3.0,
                                             phase_ms={"inbox_drain": 0.5, "other": 2.5})
    recorder.record_tick(event="replica_health", replica=0, state_from="HEALTHY",
                         state_to="QUARANTINED")
    for i in range(5):
        recorder.record_tick(replica=1, dur_ms=1.0, decode_tokens=4, active_slots=1)
    recorder.finish_engine("a", ttft_ms=12.5, tpot_ms=1.25, tokens=20, prompt_tokens=40,
                           finish_reason="length")
    seen["a_answer"] = recorder.get("a")
    # the verify's admission under the same id: the first replica stays
    recorder.note_engine_submit("a", replica_id=0)
    for i in range(300):
        recorder.record_tick(replica=0, dur_ms=1.0, decode_tokens=1, active_slots=2)
    recorder.finish_engine("a", ttft_ms=3.0, tpot_ms=None, tokens=8, finish_reason="stop")
    recorder.note_verify("a", mode="sync", outcome="pass", verdict_ms=4.0)
    recorder.finish_request("a", status="done", latency_ms=30.0)
    # ticks after the window are not the request's
    recorder.record_tick(replica=0, dur_ms=1.0, decode_tokens=9)
    seen["a"] = recorder.get("a")
    # a rejected admission closes its window at once
    recorder.start_request("b")
    recorder.note_engine_submit("b", replica_id=0)
    recorder.finish_engine("b", finish_reason="rejected")
    recorder.record_tick(replica=0, dur_ms=1.0)
    seen["b"] = recorder.get("b")
    # an open window takes every tick so far
    recorder.note_engine_submit("c", replica_id=2)
    recorder.record_tick(replica=2, dur_ms=1.0, decode_tokens=3)
    seen["c_open"] = recorder.get("c")
    seen["amend_gone"] = recorder.amend_tick(1, restamp=False, pump_ms=9.0)
    for i in range(6):
        recorder.start_request(f"r{i}")
    seen["r0"] = recorder.get("r0")
    seen["records"] = recorder.records()
    seen["highwater"] = recorder.highwater()
    seen["timeline_tail"] = recorder.timeline(last=3)
    snapshot = recorder.snapshot()
    seen["snapshot"] = {k: v for k, v in snapshot.items() if k != "ticks"}
    seen["snapshot_ticks"] = len(snapshot["ticks"])
    seen["dropped"] = recorder.dropped_requests
    recorder.clear()
    seen["after_clear"] = (recorder.get("a"), recorder.highwater(), recorder.record_tick())
    return seen


def make(module):
    return module.FlightRecorder(max_ticks=300, max_requests=4)


def test_scripted_sequence_matches_jax():
    got, want = strip(drive(make(tflight))), strip(drive(make(jflight)))
    assert got == want
    # the script reached what it meant to: a truncated window of two
    # admissions, the first replica kept, an evicted amend
    assert got["a"]["ticks_truncated"] > 0
    assert len(got["a"]["ticks"]) == tflight.MAX_TICKS_PER_RECORD
    engine = got["a"]["engine"]
    assert engine["replica_id"] == 1 and len(engine["admissions"]) == 2
    assert engine["tokens"] == 20 and engine["finish_reason"] == "length"
    assert got["amend_kept"] == 1 and got["amend_gone"] == 0
    assert got["dropped"] > 0 and got["r0"] is None


def test_the_same_clock_gives_equal_stamps():
    """On one fake clock (each read a step later) the stamps agree too."""
    def fake_clock():
        counter = itertools.count()
        return lambda: next(counter) * 0.001

    recorders = []
    for module in (tflight, jflight):
        recorder = make(module)
        recorder._now = fake_clock()
        recorders.append(recorder)
    assert drive(recorders[0]) == drive(recorders[1])


def test_events_helper_reads_the_tick_ring():
    recorder = tflight.FlightRecorder()
    n = recorder.record_tick(event="replica_health", replica=0, state_to="HEALTHY")
    recorder.record_tick(replica=0, dur_ms=1.0)
    events = recorder.events("replica_health")
    assert [e["tick"] for e in events] == [n] and events[0]["state_to"] == "HEALTHY"
    assert len(recorder.events()) == 2


@pytest.mark.parametrize("max_ticks", [4, 300])
def test_ring_bound_matches_jax(max_ticks):
    seen = []
    for module in (tflight, jflight):
        recorder = module.FlightRecorder(max_ticks=max_ticks)
        recorder.note_engine_submit("x", replica_id=0)
        for i in range(10):
            recorder.record_tick(replica=0, decode_tokens=i)
        seen.append(strip((recorder.get("x"), recorder.timeline(), recorder.highwater())))
    assert seen[0] == seen[1]
