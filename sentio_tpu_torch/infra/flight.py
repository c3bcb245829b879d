"""Request flight recorder: per-request traces and per-tick serving
telemetry — ``sentio_tpu/infra/flight.py::FlightRecorder``.

Two bounded, thread-safe stores:

* a **tick ring** — one event per pump tick of every generation service
  (``replica``, wall time, batch occupancy, queue and inbox depth, the
  tick's prefill / decode / spec / prefix-hit token deltas, the page
  pool's levels, the overload totals, and after delivery the tick's
  ``pump_ms`` and its ``phase_ms`` split), keyed ``tick`` from one
  sequence. The same ring carries the replica tier's vocabulary:
  ``replica_health``, ``inbox_handoff``, ``pump_stall``, ``tick_failure``
  and ``stream_resumed``;
* a **request table** — one record per request, keyed by the serving
  layer's ``query_id``: the pipeline's node timings and path, the HTTP
  layer's status and latency, the ``engine`` section (where the request
  entered the engine and, per admission, its TTFT, TPOT, tokens and finish
  reason) and the ``verify`` section a verify writes when it ends. Under
  ``VERIFY_MODE=async|gated`` the answer's record closes before the
  detached audit lands, so :meth:`FlightRecorder.note_verify` works on
  finished records too. Records are LRU-evicted past ``max_requests``.

:meth:`FlightRecorder.get` returns a record with the ticks of its engine
window (``tick_first < tick <= tick_last``, the last
``MAX_TICKS_PER_RECORD`` of them). Writers hold one short lock; the pump
appends one small dict per tick. Everything stored is plain JSON data.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

from sentio_tpu_torch.analysis.sanitizer import assert_held, guard_locksets, make_lock

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder",
           "MAX_TICKS_PER_RECORD"]

# tick events returned inline with one request's record; the whole ring is
# timeline()'s
MAX_TICKS_PER_RECORD = 256


@guard_locksets
class FlightRecorder:
    """Bounded, thread-safe flight store: every method is a short dict or
    deque operation under one lock, safe from HTTP threads, pipeline
    threads, detached verify threads and the pumps at once."""

    def __init__(self, max_ticks: int = 4096, max_requests: int = 512) -> None:
        self._lock = make_lock("FlightRecorder._lock")
        self._ticks: deque = deque(maxlen=max_ticks)  # guarded-by: _lock
        self._tick_seq = 0  # guarded-by: _lock
        self._records: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock
        self.max_requests = max_requests
        self.dropped_requests = 0  # guarded-by: _lock
        self._t0 = time.perf_counter()  # the timeline's origin

    # ------------------------------------------------------------- requests

    def _ensure_locked(self, request_id: str) -> dict:
        """Fetch or create a record (lock held): any layer may be the first
        to see an id."""
        assert_held(self._lock)
        record = self._records.get(request_id)
        if record is None:
            record = {"request_id": request_id, "status": "active",
                      "t_start_s": round(self._now(), 6)}
            self._records[request_id] = record
            self._evict_locked()
        return record

    def start_request(self, request_id: str, **fields: Any) -> None:
        """Open a record; extra fields merge in. A finished record under the
        same id (a pinned ``thread_id``) is replaced, not merged."""
        if not request_id:
            return
        with self._lock:
            prior = self._records.get(request_id)
            if prior is not None and prior.get("status") != "active":
                del self._records[request_id]
            self._ensure_locked(request_id).update(fields)
            self._records.move_to_end(request_id)

    def annotate(self, request_id: str, **fields: Any) -> None:
        """Merge fields into an existing or new record."""
        if not request_id:
            return
        with self._lock:
            self._ensure_locked(request_id).update(fields)

    def add_node_timings(self, request_id: str, timings: dict,
                         graph_path: Optional[list] = None) -> None:
        """Add per-node wall times (summed when a node runs again under the
        same id) and the node path."""
        if not request_id or not timings:
            return
        with self._lock:
            record = self._ensure_locked(request_id)
            merged = dict(record.get("node_timings_ms", {}))
            for node, ms in timings.items():
                merged[node] = round(merged.get(node, 0.0) + float(ms), 3)
            record["node_timings_ms"] = merged
            if graph_path:
                record["graph_path"] = list(graph_path)

    def note_engine_submit(self, request_id: str, **fields: Any) -> None:
        """Mark where the request enters a generation service: its tick
        window starts after the last tick recorded so far. Extra fields
        (``replica_id``) merge into the ``engine`` section; the first
        admission's values win, so a verify's later admission under the
        same id keeps the answer's replica."""
        if not request_id:
            return
        with self._lock:
            engine = self._ensure_locked(request_id).setdefault("engine", {})
            engine.setdefault("tick_first", self._tick_seq)
            # the submit time on the ticks' clock (t_start_s is the HTTP
            # layer's open), for the Chrome trace's engine span
            engine.setdefault("t_submit_s", round(self._now(), 6))
            for key, value in fields.items():
                engine.setdefault(key, value)

    def finish_engine(self, request_id: str, **fields: Any) -> None:
        """Close one engine admission and pin the end of the tick window.
        Every admission under the id appends to ``engine.admissions``; the
        headline scalars keep the first admission's values (the answer)."""
        if not request_id:
            return
        with self._lock:
            record = self._ensure_locked(request_id)
            engine = record.setdefault("engine", {})
            engine.setdefault("admissions", []).append(
                dict(fields, tick_last=self._tick_seq))
            for key, value in fields.items():
                engine.setdefault(key, value)
            engine["tick_last"] = self._tick_seq
            self._records.move_to_end(request_id)

    def note_verify(self, request_id: str, **fields: Any) -> None:
        """Merge fields into the record's ``verify`` section — on finished
        records too (a detached verdict lands after the answer's record
        closed)."""
        if not request_id:
            return
        with self._lock:
            record = self._ensure_locked(request_id)
            record.setdefault("verify", {}).update(fields)
            self._records.move_to_end(request_id)

    def finish_request(self, request_id: str, **fields: Any) -> None:
        if not request_id:
            return
        with self._lock:
            record = self._records.get(request_id)
            if record is None:
                return
            if record.get("status") == "active":
                record["status"] = "done"
            record.update(fields)
            record["latency_ms"] = fields.get(
                "latency_ms",
                round((self._now() - record.get("t_start_s", self._now())) * 1e3, 1))
            self._records.move_to_end(request_id)

    # ---------------------------------------------------------------- ticks

    def record_tick(self, **fields: Any) -> int:
        """Append one event (a pump tick, or ``event=`` another kind);
        returns its ``tick`` number. A pump records its tick before
        delivering results, so a request finishing in it has a
        ``tick_last`` that includes it."""
        with self._lock:
            self._tick_seq += 1
            event = {"tick": self._tick_seq, "t_s": round(self._now(), 4)}
            event.update(fields)
            self._ticks.append(event)
            return self._tick_seq

    def amend_tick(self, tick: int, restamp: bool = True, **fields: Any) -> int:
        """Merge late fields (the completed phase split) into a recorded
        event; ``restamp`` moves ``t_s`` to now, so a tick's stamp marks the
        end of the span it covers. Returns 1 if the event was still in the
        ring, else 0."""
        with self._lock:
            for event in reversed(self._ticks):
                if event["tick"] == tick:
                    event.update(fields)
                    if restamp:
                        event["t_s"] = round(self._now(), 4)
                    return 1
        return 0

    def events(self, kind: Optional[str] = None) -> list[dict]:
        """Copies of the retained events, oldest first; only ``kind``'s
        (their ``event`` field) when given."""
        with self._lock:
            return [dict(e) for e in self._ticks if kind is None or e.get("event") == kind]

    # ---------------------------------------------------------------- reads

    def get(self, request_id: str) -> Optional[dict]:
        """A copy of one request's record, with the retained ticks of its
        engine window (``ticks``; ``ticks_truncated`` counts those cut
        past ``MAX_TICKS_PER_RECORD``), or None."""
        with self._lock:
            record = self._records.get(request_id)
            if record is None:
                return None
            out = dict(record)
            if "verify" in out:
                out["verify"] = dict(out["verify"])
            engine = record.get("engine")
            if engine:
                out["engine"] = dict(engine)
                first = engine.get("tick_first")
                last = engine.get("tick_last", self._tick_seq)
                if first is not None:
                    window = [dict(e) for e in self._ticks if first < e["tick"] <= last]
                    if len(window) > MAX_TICKS_PER_RECORD:
                        out["ticks_truncated"] = len(window) - MAX_TICKS_PER_RECORD
                        window = window[-MAX_TICKS_PER_RECORD:]
                    out["ticks"] = window
            return out

    def timeline(self, last: Optional[int] = None) -> list[dict]:
        """The tick ring, oldest first (only the last ``last`` when given)."""
        with self._lock:
            events = [dict(e) for e in self._ticks]
        return events[-last:] if last else events

    def records(self) -> list[dict]:
        """Shallow copies of every retained record, oldest first (the
        Chrome trace's request spans)."""
        with self._lock:
            return [dict(record, engine=dict(record["engine"])) if "engine" in record
                    else dict(record) for record in self._records.values()]

    def origin(self) -> float:
        """The timeline's zero as a raw ``perf_counter`` value."""
        return self._t0

    def highwater(self) -> dict:
        """Ring and table occupancy only."""
        with self._lock:
            return {"ticks_recorded": self._tick_seq, "ticks_retained": len(self._ticks),
                    "requests_retained": len(self._records),
                    "requests_dropped": self.dropped_requests}

    def snapshot(self) -> dict:
        """The occupancy counters and every retained tick."""
        with self._lock:
            ticks = [dict(e) for e in self._ticks]
            n_records, dropped, seq = len(self._records), self.dropped_requests, self._tick_seq
        return {"ticks_recorded": seq, "ticks_retained": len(ticks),
                "requests_retained": n_records, "requests_dropped": dropped, "ticks": ticks}

    def clear(self) -> None:
        with self._lock:
            self._ticks.clear()
            self._records.clear()
            self._tick_seq = 0
            self.dropped_requests = 0

    # -------------------------------------------------------------- private

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _evict_locked(self) -> None:
        assert_held(self._lock)
        while len(self._records) > self.max_requests:
            self._records.popitem(last=False)
            self.dropped_requests += 1


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _recorder
    with _recorder_lock:
        _recorder = recorder
