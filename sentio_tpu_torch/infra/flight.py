"""Request flight records — the request table of
``sentio_tpu/infra/flight.py::FlightRecorder``.

One record per request, keyed by the serving layer's ``query_id``: the
pipeline's node timings and path, the HTTP layer's status and latency,
and the ``verify`` section that a verify writes when it ends (mode,
outcome, confidence, verdict ms, why it was skipped). Under
``VERIFY_MODE=async|gated`` the answer's record closes before the
detached audit lands, so :meth:`FlightRecorder.note_verify` works on
finished records too: ``GET /debug/flight/{id}`` is where a caller holding
``verify_pending`` reads the late verdict. Records are LRU-evicted past
``max_requests``.

Beside the request table, a bounded ring of serving events
(:meth:`FlightRecorder.record_tick`): the replica tier's health
transitions (``replica_health``), inbox handoffs (``inbox_handoff``),
stall detections (``pump_stall``) and stream resumes (``stream_resumed``),
each with a sequence number and a time. The JAX recorder also puts one
event per engine tick there; the port's pumps do not yet.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

__all__ = ["FlightRecorder", "get_flight_recorder", "set_flight_recorder"]


class FlightRecorder:
    """Bounded, thread-safe request table: every method is a short dict
    operation under one lock, safe from HTTP threads, pipeline threads and
    detached verify threads at once."""

    def __init__(self, max_requests: int = 512, max_events: int = 4096) -> None:
        self._lock = threading.Lock()
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self.max_requests = max_requests
        self.dropped_requests = 0
        self._events: deque = deque(maxlen=max_events)
        self._seq = 0
        self._t0 = time.perf_counter()

    def record_tick(self, **fields: Any) -> int:
        """Append one serving event (``event=`` names its kind) to the
        ring; returns its sequence number."""
        with self._lock:
            self._seq += 1
            self._events.append({"seq": self._seq, "t_s": round(self._now(), 6), **fields})
            return self._seq

    def events(self, kind: Optional[str] = None) -> list[dict]:
        """Copies of the retained events, oldest first; only ``kind``'s
        when given."""
        with self._lock:
            return [dict(e) for e in self._events if kind is None or e.get("event") == kind]

    def _ensure_locked(self, request_id: str) -> dict:
        """Fetch or create a record (lock held): any layer may be the first
        to see an id."""
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

    def get(self, request_id: str) -> Optional[dict]:
        """A copy of one request's record, or None."""
        with self._lock:
            record = self._records.get(request_id)
            if record is None:
                return None
            out = dict(record)
            if "verify" in out:
                out["verify"] = dict(out["verify"])
            return out

    def records(self) -> list[dict]:
        """Shallow copies of every retained record, oldest first."""
        with self._lock:
            return [dict(record) for record in self._records.values()]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._events.clear()
            self.dropped_requests = 0

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _evict_locked(self) -> None:
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
