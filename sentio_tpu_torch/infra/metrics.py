"""Prometheus metrics of the HTTP layer and the generation service, with
the names, types and labels of ``sentio_tpu/infra/metrics.py``, written in
the Prometheus text format 0.0.4 by this module itself (the machine with
the card has no ``prometheus_client``).

Families: ``sentio_requests_total`` and ``sentio_request_latency_seconds``
(every request, by endpoint and status, fed by the server),
``sentio_inflight_requests``, ``sentio_embeddings_total`` (``/embed`` and
``/upload``), ``sentio_retrieval_latency_seconds`` (the ``/chat``
retrieve stage), ``sentio_tpu_serving_stat`` and
``sentio_tpu_serving_events_total`` (published from ``service.stats()``
at scrape time), ``sentio_tpu_shed_total`` (the service's sheds and
expiries by reason), ``sentio_tpu_tick_phase_seconds`` (each pump
iteration by phase) and ``sentio_tpu_pump_duty_cycle``.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

from sentio_tpu_torch.infra.phases import TICK_PHASES

# prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
                   7.5, 10.0)


def _value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _escape(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels(names: Sequence[str], values: Sequence[str], extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    """One metric family: children by label values, under one lock."""

    kind = ""

    def __init__(self, name: str, doc: str, labels: Sequence[str] = ()) -> None:
        self.name, self.doc, self.label_names = name, doc, tuple(labels)
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, values: Sequence) -> tuple[str, ...]:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(f"{self.name} takes labels {self.label_names}, got {key}")
        return key

    def header(self) -> list[str]:
        return [f"# HELP {self.name} {self.doc}", f"# TYPE {self.name} {self.kind}"]


class Counter(_Family):
    kind = "counter"

    def inc(self, *labels, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [*self.header(), *(f"{self.name}{_labels(self.label_names, k)} {_value(v)}"
                                  for k, v in items)]


class Gauge(_Family):
    kind = "gauge"

    def set(self, *labels, value: float) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [*self.header(), *(f"{self.name}{_labels(self.label_names, k)} {_value(v)}"
                                  for k, v in items)]


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, doc, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets)) + (math.inf,)

    def observe(self, *labels, value: float) -> None:
        key = self._key(labels)
        with self._lock:
            counts, total = self._children.get(key, ([0] * len(self.buckets), 0.0))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._children[key] = (counts, total + float(value))

    def render(self) -> list[str]:
        with self._lock:
            items = sorted((k, (list(c), s)) for k, (c, s) in self._children.items())
        lines = self.header()
        for key, (counts, total) in items:
            for bound, n in zip(self.buckets, counts):
                le = f'le="{_value(bound)}"'
                lines.append(f"{self.name}_bucket{_labels(self.label_names, key, le)} "
                             f"{_value(n)}")
            lines.append(f"{self.name}_count{_labels(self.label_names, key)} "
                         f"{_value(counts[-1])}")
            lines.append(f"{self.name}_sum{_labels(self.label_names, key)} {_value(total)}")
        return lines


class MetricsCollector:
    """One per process (:func:`get_metrics`)."""

    def __init__(self) -> None:
        self.requests = Counter("sentio_requests_total", "HTTP requests", ["endpoint", "status"])
        self.request_latency = Histogram(
            "sentio_request_latency_seconds", "request latency", ["endpoint"],
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10))
        self.embeddings = Counter("sentio_embeddings_total", "texts embedded", ["provider"])
        self.retrieval_latency = Histogram("sentio_retrieval_latency_seconds",
                                           "retrieval latency", ["strategy"])
        self.serving_stat = Gauge(
            "sentio_tpu_serving_stat",
            "decode service point-in-time stats (occupancy, queue depth, pages)", ["stat"])
        self.serving_total = Counter("sentio_tpu_serving_events_total",
                                     "decode service lifetime totals", ["event"])
        self.shed = Counter("sentio_tpu_shed_total",
                            "requests shed / expired / cancelled by the decode service",
                            ["reason"])
        self.inflight = Gauge("sentio_inflight_requests", "requests currently being served")
        self.pump_duty_cycle = Gauge(
            "sentio_tpu_pump_duty_cycle",
            "fraction of wall time the decode pump spends per state (host / device / idle; "
            "sums to 1 per replica)", ["replica", "state"])
        self.tick_phase = Histogram(
            "sentio_tpu_tick_phase_seconds", "pump-iteration time per named phase", ["phase"],
            buckets=(1e-5, 1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1, 5))
        self.verify = Counter("sentio_tpu_verify_total",
                              "answer verifications by mode and outcome", ["mode", "outcome"])
        self.verify_confidence = Histogram(
            "sentio_tpu_verify_confidence", "confidence-gate score per scored answer",
            buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0))
        self._families = (self.requests, self.request_latency, self.embeddings,
                          self.retrieval_latency, self.serving_stat, self.serving_total,
                          self.shed, self.inflight, self.pump_duty_cycle, self.tick_phase,
                          self.verify, self.verify_confidence)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._serving_last: dict[str, float] = {}
        self._serving_lock = threading.Lock()

    def record_request(self, endpoint: str, status: int, latency_s: float) -> None:
        self.requests.inc(endpoint, str(status))
        self.request_latency.observe(endpoint, value=latency_s)

    def record_embeddings(self, provider: str, n_texts: int) -> None:
        self.embeddings.inc(provider, amount=n_texts)

    def record_retrieval(self, strategy: str, latency_s: float) -> None:
        self.retrieval_latency.observe(strategy, value=latency_s)

    def record_verify(self, mode: str, outcome: str,
                      confidence: Optional[float] = None) -> None:
        """One verification outcome (``mode``: sync | async | gated;
        ``outcome``: pass | warn | fail | skipped_confident |
        skipped_deadline | skipped_empty) and the gate's confidence score
        when one was computed."""
        self.verify.inc(mode, outcome)
        if confidence is not None:
            self.verify_confidence.observe(value=float(confidence))

    def record_shed(self, reason: str, n: int = 1) -> None:
        """``reason``: queue_full | draining | deadline | expired | crash."""
        self.shed.inc(reason, amount=n)

    def record_tick_phases(self, phase_s: dict) -> None:
        """One pump iteration's seconds by phase; keys outside
        ``TICK_PHASES`` are dropped (the label set stays bounded)."""
        for key in TICK_PHASES:
            value = phase_s.get(key)
            if value is not None:
                self.tick_phase.observe(key, value=float(value))

    def record_duty_cycle(self, replica: int, fractions: dict) -> None:
        for state in ("host", "device", "idle"):
            self.pump_duty_cycle.set(str(replica), state, value=float(fractions.get(state, 0.0)))

    def adjust_inflight(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight = max(self._inflight + delta, 0)
            self.inflight.set(value=float(self._inflight))

    def set_serving_stat(self, key: str, value: float) -> None:
        self.serving_stat.set(key, value=value)

    def bump_serving_total(self, event: str, lifetime_total: float) -> None:
        """Publish a service lifetime total as a counter: only the growth
        since the last scrape is added."""
        with self._serving_lock:
            last = self._serving_last.get(event, 0.0)
            self._serving_last[event] = lifetime_total
        delta = max(lifetime_total - last, 0.0)
        if delta:
            self.serving_total.inc(event, amount=delta)

    def export_prometheus(self) -> bytes:
        lines = [line for family in self._families for line in family.render()]
        return ("\n".join(lines) + "\n").encode()


_collector: Optional[MetricsCollector] = None
_collector_lock = threading.Lock()


def get_metrics() -> MetricsCollector:
    global _collector
    with _collector_lock:
        if _collector is None:
            _collector = MetricsCollector()
        return _collector


def set_metrics(collector: Optional[MetricsCollector]) -> None:
    global _collector
    with _collector_lock:
        _collector = collector
