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
iteration by phase) and ``sentio_tpu_pump_duty_cycle``; and the replica
tier's: ``sentio_tpu_tenant_admitted_total`` and
``sentio_tpu_tenant_shed_total`` (WFQ outcomes by tenant and reason),
``sentio_tpu_replica_stat`` (per-replica occupancy, queue and pool rows
published at scrape time), ``sentio_tpu_replica_health`` (1 on each
replica's current health state), ``sentio_tpu_pump_heartbeat_age_seconds``
(the stall watchdog's reading) and ``sentio_tpu_stream_resumes_total``
(by outcome); and the LLM and device families, registered whatever the
settings as JAX registers them: ``sentio_llm_tokens_total`` and
``sentio_llm_latency_seconds`` (the remote provider's calls),
``sentio_circuit_breaker_state``, ``sentio_tpu_hbm_bytes_in_use``
(:meth:`MetricsCollector.collect_device_memory`: the card's allocated
bytes), ``sentio_tpu_batch_occupancy``,
``sentio_tpu_decode_tokens_per_second``, ``sentio_tpu_ttft_seconds`` and
``sentio_tpu_tpot_seconds`` (each engine admission, by ``path``: paged or
stream) and ``sentio_tpu_tick_duration_seconds`` (each pump tick). A family
JAX feeds nowhere on the default path (the breaker, the batch occupancy,
device memory) stays registered and empty here too. The process tier's
families (``worker_*``, ``fleet_*``, ``autoscale_*``,
``replica_worker_deaths``) and ``xla_compiles`` are not ported.

A family without labels has its one series from the start (at 0), as
``prometheus_client`` renders it. :meth:`MetricsCollector.export_json`
is the JSON snapshot ``/metrics/performance`` serves: counters and gauges
by ``name(labels)``, histograms with their count, mean and the p50 / p95
of the last ``WINDOW`` observations.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Optional, Sequence

from sentio_tpu_torch.infra.phases import TICK_PHASES

# observations per histogram series kept for export_json's quantiles
WINDOW = 1000

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
        if not self.label_names:
            self._children[()] = self._zero()

    def _zero(self):
        return 0.0

    def _key(self, values: Sequence) -> tuple[str, ...]:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(f"{self.name} takes labels {self.label_names}, got {key}")
        return key

    def values(self) -> dict:
        """{label values: the series' value} (a histogram's: counts, sum)."""
        with self._lock:
            return dict(self._children)

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
        self.buckets = tuple(sorted(float(b) for b in buckets)) + (math.inf,)
        self._window: dict[tuple[str, ...], deque] = {}
        super().__init__(name, doc, labels)

    def _zero(self):
        return ([0] * len(self.buckets), 0.0)

    def observe(self, *labels, value: float) -> None:
        key = self._key(labels)
        with self._lock:
            counts, total = self._children.get(key) or self._zero()
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
            self._children[key] = (counts, total + float(value))
            self._window.setdefault(key, deque(maxlen=WINDOW)).append(float(value))

    def summary(self) -> dict:
        """{labels: count, mean, the p50 / p95 of the retained window and
        how many observations fell out of it} for every observed series."""
        out = {}
        with self._lock:
            for key, (counts, total) in self._children.items():
                if not counts[-1]:
                    continue
                window = sorted(self._window.get(key, ()))
                out[key] = {"count": counts[-1], "window": len(window),
                            "dropped": counts[-1] - len(window),
                            "p50": window[len(window) // 2] if window else 0.0,
                            "p95": window[min(int(len(window) * 0.95), len(window) - 1)]
                            if window else 0.0,
                            "mean": total / counts[-1]}
        return out

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
        self.tenant_admitted = Counter("sentio_tpu_tenant_admitted_total",
                                       "requests admitted through weighted fair queueing",
                                       ["tenant"])
        self.tenant_shed = Counter("sentio_tpu_tenant_shed_total",
                                   "requests shed by weighted fair queueing",
                                   ["tenant", "reason"])
        self.replica_stat = Gauge("sentio_tpu_replica_stat",
                                  "per-replica decode service point-in-time stats",
                                  ["replica", "stat"])
        self.replica_health = Gauge(
            "sentio_tpu_replica_health",
            "replica health state machine position (1 = current state)", ["replica", "state"])
        self.pump_heartbeat_age = Gauge("sentio_tpu_pump_heartbeat_age_seconds",
                                        "decode pump heartbeat age under pending work",
                                        ["replica"])
        self.stream_resumes = Counter(
            "sentio_tpu_stream_resumes_total",
            "mid-flight stream resume outcomes (resumed = delivered prefix spliced onto a "
            "survivor; exhausted = resume budget spent, typed error surfaced; failed = no "
            "survivor could take the splice; opt_out = caller disabled resumption)",
            ["outcome"])
        self.llm_tokens = Counter("sentio_llm_tokens_total", "tokens generated", ["kind"])
        self.llm_latency = Histogram("sentio_llm_latency_seconds", "LLM call latency", ["op"])
        self.breaker_state = Gauge("sentio_circuit_breaker_state",
                                   "0 closed / 1 half-open / 2 open", ["name"])
        self.hbm_bytes = Gauge("sentio_tpu_hbm_bytes_in_use", "device memory in use",
                               ["device"])
        self.batch_occupancy = Histogram("sentio_tpu_batch_occupancy",
                                         "coalesced batch fill fraction", ["batcher"],
                                         buckets=(0.125, 0.25, 0.5, 0.75, 1.0))
        self.tokens_per_s = Gauge("sentio_tpu_decode_tokens_per_second", "decode throughput")
        # TTFT: submit → the first sampled token visible on the host; TPOT:
        # mean seconds per output token after the first
        self.ttft = Histogram("sentio_tpu_ttft_seconds", "time to first token", ["path"],
                              buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30))
        self.tpot = Histogram("sentio_tpu_tpot_seconds", "time per output token", ["path"],
                              buckets=(0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
                                       2.5))
        self.tick_duration = Histogram("sentio_tpu_tick_duration_seconds",
                                       "engine pump tick wall time",
                                       buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                                                0.5, 1, 5))
        # JAX's keys for each family (its collector's and export_json's)
        self._families = {
            "requests": self.requests, "request_latency": self.request_latency,
            "embeddings": self.embeddings, "retrieval_latency": self.retrieval_latency,
            "llm_tokens": self.llm_tokens, "llm_latency": self.llm_latency,
            "breaker_state": self.breaker_state, "hbm_bytes": self.hbm_bytes,
            "batch_occupancy": self.batch_occupancy, "serving_stat": self.serving_stat,
            "serving_total": self.serving_total, "tokens_per_s": self.tokens_per_s,
            "ttft": self.ttft, "tpot": self.tpot, "tick_duration": self.tick_duration,
            "shed": self.shed, "inflight": self.inflight,
            "tenant_admitted": self.tenant_admitted, "tenant_shed": self.tenant_shed,
            "replica_stat": self.replica_stat, "replica_health": self.replica_health,
            "verify_total": self.verify, "verify_confidence": self.verify_confidence,
            "pump_heartbeat_age": self.pump_heartbeat_age,
            "pump_duty_cycle": self.pump_duty_cycle, "tick_phase": self.tick_phase,
            "stream_resumes": self.stream_resumes,
        }
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

    def record_llm(self, op: str, latency_s: float, tokens: int = 0) -> None:
        """One LLM call (``op``: ``remote_chat`` from the remote provider)
        and the tokens it generated; the throughput gauge is tokens over the
        call's seconds."""
        self.llm_latency.observe(op, value=latency_s)
        if tokens:
            self.llm_tokens.inc(op, amount=tokens)
            if latency_s > 0:
                self.tokens_per_s.set(value=tokens / latency_s)

    def record_ttft(self, seconds: float, path: str = "paged") -> None:
        """Time to the first token of one admission (``path``: paged |
        stream)."""
        self.ttft.observe(path, value=seconds)

    def record_tpot(self, seconds: float, path: str = "paged") -> None:
        """Mean time per output token of one admission, the first token
        excluded."""
        self.tpot.observe(path, value=seconds)

    def record_tick(self, duration_s: float, active_slots: int, queue_depth: int) -> None:
        """One pump tick: its wall time, and the occupancy and queue depth
        as point-in-time serving stats."""
        self.tick_duration.observe(value=duration_s)
        self.set_serving_stat("tick_active_slots", float(active_slots))
        self.set_serving_stat("tick_queue_depth", float(queue_depth))

    def record_breaker(self, name: str, state: str) -> None:
        self.breaker_state.set(name, value={"closed": 0.0, "half_open": 1.0,
                                            "open": 2.0}.get(state, 0.0))

    def record_batch_occupancy(self, batcher: str, occupancy: float) -> None:
        self.batch_occupancy.observe(batcher, value=occupancy)

    def collect_device_memory(self) -> None:
        """Each card's allocated bytes (``torch.cuda.memory_stats()``'s
        current allocation, in place of JAX's ``bytes_in_use``) into the
        device-memory gauge; nothing without a card."""
        try:
            import torch

            if not torch.cuda.is_available():
                return
            for dev in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(dev)
                if "allocated_bytes.all.current" in stats:
                    self.hbm_bytes.set(str(dev), value=stats["allocated_bytes.all.current"])
        except Exception:  # noqa: BLE001 — a device-memory scrape is best-effort telemetry
            pass

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

    def record_tenant_admitted(self, tenant: str) -> None:
        self.tenant_admitted.inc(tenant)

    def record_tenant_shed(self, tenant: str, reason: str) -> None:
        """``reason``: tenant_quota | priority_batch | tenant_deficit."""
        self.tenant_shed.inc(tenant, reason)

    def set_replica_stat(self, replica: int, key: str, value: float) -> None:
        self.replica_stat.set(str(replica), key, value=value)

    def record_replica_health(self, replica: int, state: str) -> None:
        """The new state's series goes to 1, every other state's to 0."""
        from sentio_tpu_torch.runtime.replica import HEALTH_STATES

        for name in HEALTH_STATES:
            self.replica_health.set(str(replica), name, value=1.0 if name == state else 0.0)

    def record_heartbeat_age(self, replica: int, age_s: float) -> None:
        self.pump_heartbeat_age.set(str(replica), value=float(age_s))

    def record_stream_resume(self, outcome: str) -> None:
        """``outcome``: resumed | exhausted | failed | opt_out."""
        self.stream_resumes.inc(outcome)

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
        lines = [line for family in self._families.values() for line in family.render()]
        return ("\n".join(lines) + "\n").encode()

    def export_json(self) -> dict[str, Any]:
        """``{"counters", "histograms", "gauges"}``, each series keyed
        ``name(labels)`` under JAX's family keys."""
        out: dict[str, Any] = {"counters": {}, "histograms": {}, "gauges": {}}
        for name, family in self._families.items():
            if isinstance(family, Histogram):
                for key, summary in family.summary().items():
                    out["histograms"][f"{name}{key}"] = summary
            else:
                section = out["counters" if isinstance(family, Counter) else "gauges"]
                for key, value in family.values().items():
                    section[f"{name}{key}"] = value
        return out


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
