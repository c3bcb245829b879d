"""Chrome / Perfetto trace export of flight-recorder timelines —
``build_chrome_trace`` and ``flight_to_chrome`` of
``sentio_tpu/infra/chrome_trace.py``.

The flight recorder's tick ring and request table in the Chrome Trace
Event Format (the JSON ``ui.perfetto.dev`` and ``chrome://tracing`` open):
one process row per replica (``pid``), the pump's ticks as slices on
``tid 0`` with their named phases (``infra/phases.py``) laid out inside in
canonical order (the phases sum to the tick's ``pump_ms``, so they tile
it), health transitions as instants there too, and each request on a lane
of its own (``tid 1..``): its wall span, the engine span (submit → finish),
a ``first_token`` instant at submit + TTFT and the verify verdict as a
slice trailing the answer. Pure functions over the plain dicts that
``FlightRecorder.timeline()`` / ``records()`` return; timestamps are the
recorder's seconds × 1e6 (microseconds).

A tick's ``graph_captures`` (CUDA graphs captured in it) takes the place
of JAX's ``xla_compiles`` among the arguments copied onto its slice.
"""

from __future__ import annotations

from typing import Optional

from sentio_tpu_torch.infra.phases import TICK_PHASES

__all__ = ["build_chrome_trace", "flight_to_chrome"]

# tick fields copied onto the tick slice
_TICK_ARGS = (
    "active_slots", "queue_depth", "inbox_depth", "prefill_tokens",
    "decode_tokens", "free_pages", "graph_captures",
)

_PUMP_TID = 0
_REQUEST_TID_BASE = 1


def _us(seconds: float) -> float:
    """Timeline seconds → Chrome microseconds (rounded to 0.1 µs)."""
    return round(float(seconds) * 1e6, 1)


def _tick_events(ticks: list[dict]) -> list[dict]:
    events: list[dict] = []
    for tick in ticks:
        pid = int(tick.get("replica", 0))
        if tick.get("event") == "replica_health":
            events.append({
                "name": f"health:{tick.get('state', '?')}",
                "ph": "i", "s": "p", "pid": pid, "tid": _PUMP_TID,
                "ts": _us(tick["t_s"]),
                "args": {k: v for k, v in tick.items()
                         if k in ("state", "prior", "reason", "tick")},
            })
            continue
        phase_ms = tick.get("phase_ms")
        pump_ms = tick.get("pump_ms", tick.get("dur_ms"))
        if pump_ms is None:
            continue  # not a pump tick (an inbox_handoff marker, ...)
        # stamped at the END of the span it covers
        t_end = tick["t_s"]
        t_start = t_end - pump_ms / 1e3
        events.append({
            "name": f"tick {tick.get('tick', '?')}",
            "ph": "X", "pid": pid, "tid": _PUMP_TID,
            "ts": _us(t_start), "dur": round(float(pump_ms) * 1e3, 1),
            "args": {k: tick[k] for k in _TICK_ARGS if k in tick},
        })
        if not phase_ms:
            continue
        cursor = t_start
        for phase in TICK_PHASES:
            dur_ms = phase_ms.get(phase)
            if not dur_ms:
                continue
            events.append({
                "name": phase, "ph": "X", "pid": pid, "tid": _PUMP_TID,
                "ts": _us(cursor), "dur": round(float(dur_ms) * 1e3, 1), "args": {},
            })
            cursor += dur_ms / 1e3
    return events


def _request_events(records: list[dict]) -> tuple[list[dict], dict]:
    """Request spans, one lane per record per replica; also {pid: the next
    free tid} for the lanes' names."""
    events: list[dict] = []
    lanes: dict[int, int] = {}
    for record in records:
        engine = record.get("engine") or {}
        pid = int(engine.get("replica_id", 0))
        tid = lanes.get(pid, _REQUEST_TID_BASE)
        lanes[pid] = tid + 1
        rid = record.get("request_id", "?")
        t_start = record.get("t_start_s")
        latency_ms = record.get("latency_ms")
        if latency_ms is None:
            # a record no HTTP handler finished (the CLI's trace): its node
            # timings are the span
            timings = record.get("node_timings_ms")
            if timings:
                latency_ms = sum(timings.values())
        if t_start is not None and latency_ms is not None:
            events.append({
                "name": f"request {rid}", "ph": "X", "pid": pid, "tid": tid,
                "ts": _us(t_start), "dur": round(float(latency_ms) * 1e3, 1),
                "args": {k: record[k] for k in ("status", "mode", "endpoint", "question_chars")
                         if k in record},
            })
            t_finish = t_start + latency_ms / 1e3
        else:
            t_finish = t_start
        t_submit = engine.get("t_submit_s")
        ttft_ms = engine.get("ttft_ms")
        if t_submit is not None and t_finish is not None and t_finish > t_submit:
            events.append({
                "name": "engine", "ph": "X", "pid": pid, "tid": tid,
                "ts": _us(t_submit), "dur": _us(t_finish - t_submit),
                "args": {k: engine[k] for k in ("tokens", "prompt_tokens", "prefix_hit_tokens",
                                                "finish_reason", "tpot_ms") if k in engine},
            })
        if t_submit is not None and ttft_ms is not None:
            events.append({
                "name": "first_token", "ph": "i", "s": "t", "pid": pid, "tid": tid,
                "ts": _us(t_submit + ttft_ms / 1e3), "args": {"ttft_ms": ttft_ms},
            })
        verify = record.get("verify")
        if verify and t_finish is not None:
            verdict_ms = verify.get("verdict_ms") or 0.0
            events.append({
                "name": f"verify:{verify.get('outcome', 'pending')}",
                "ph": "X", "pid": pid, "tid": tid, "ts": _us(t_finish),
                "dur": round(float(verdict_ms) * 1e3, 1),
                "args": {k: verify[k] for k in ("mode", "confidence", "skipped", "verdict")
                         if k in verify},
            })
    return events, lanes


def build_chrome_trace(ticks: list[dict], records: list[dict],
                       label: str = "sentio-tpu") -> dict:
    """The Chrome Trace Event Format (as a dict) of flight tick events and
    request records: deterministic, the same inputs give the same output."""
    events: list[dict] = []
    pids: set[int] = set()
    tick_events = _tick_events(ticks)
    request_events, lanes = _request_events(records)
    for event in tick_events + request_events:
        pids.add(event["pid"])
    for pid in sorted(pids):
        events.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                       "args": {"name": f"replica {pid}"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": _PUMP_TID,
                       "args": {"name": "pump"}})
        for tid in range(_REQUEST_TID_BASE, lanes.get(pid, _REQUEST_TID_BASE)):
            events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                           "args": {"name": f"request lane {tid}"}})
    events.extend(sorted(tick_events + request_events,
                         key=lambda e: (e["pid"], e["tid"], e.get("ts", 0.0), e["name"])))
    return {"displayTimeUnit": "ms", "otherData": {"source": label}, "traceEvents": events}


def flight_to_chrome(recorder=None, request_id: Optional[str] = None,
                     label: str = "sentio-tpu") -> Optional[dict]:
    """A live recorder's whole timeline (the CLI's ``trace --chrome``), or
    one request's record and its tick window; None when the id has no
    record."""
    if recorder is None:
        from sentio_tpu_torch.infra.flight import get_flight_recorder

        recorder = get_flight_recorder()
    if request_id is not None:
        record = recorder.get(request_id)
        if record is None:
            return None
        return build_chrome_trace(record.pop("ticks", []), [record], label=label)
    return build_chrome_trace(recorder.timeline(), recorder.records(), label=label)
