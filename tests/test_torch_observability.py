"""The port's observability against the JAX package's: ``/metrics``'
families (names, types, labels, help and buckets read from JAX's
``prometheus_client`` registry), the recorders, ``ObservabilityConfig``,
tracing and the profile window, the monitors, and a live tiny pipeline
behind the port's HTTP server on the CPU: ``/debug/flight/{id}`` carries
the engine section and the tick window (its keys those of a tiny JAX
service's record, the compile / capture fields aside; each tick's phases
summing to its ``pump_ms``; the window's decode tokens those of its two
admissions), ``?format=chrome``, the TTFT / TPOT / tick counts against the
admissions and ticks, ``/debug/profile`` (200, a file, 409 while a window
is open, 422 out of range) and ``/metrics/performance``; and the CLI's
``info`` and ``trace`` in a subprocess. Every pipeline built here is
closed."""

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from sentio_tpu.config import ObservabilityConfig as JObservabilityConfig
from sentio_tpu.infra import flight as jflight
from sentio_tpu.infra import monitoring as jmonitoring
from sentio_tpu.infra.metrics import MetricsCollector as JMetricsCollector
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu_torch import __main__ as cli
from sentio_tpu_torch.config import (
    GeneratorConfig,
    ObservabilityConfig,
    RetrievalConfig,
    ServeConfig,
    Settings,
)
from sentio_tpu_torch.infra import monitoring, tracing
from sentio_tpu_torch.infra.metrics import Counter, Gauge, Histogram, MetricsCollector
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.serve.app import create_server

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0
# JAX's families the port does not register: the XLA compile counters,
# router and worker (the port counts CUDA graph captures on each tick and in
# each worker's sentio_tpu_replica_stat rows)
NOT_PORTED = {
    "sentio_tpu_xla_compiles_total", "sentio_tpu_worker_compiles_total",
}
NINE = ("sentio_llm_tokens_total", "sentio_llm_latency_seconds", "sentio_circuit_breaker_state",
        "sentio_tpu_hbm_bytes_in_use", "sentio_tpu_batch_occupancy",
        "sentio_tpu_decode_tokens_per_second", "sentio_tpu_ttft_seconds",
        "sentio_tpu_tpot_seconds", "sentio_tpu_tick_duration_seconds")
# tick fields only one package records: JAX's XLA compiles, the port's
# CUDA graph captures
COMPILE_FIELDS = {"xla_compiles", "compile_events"}
CAPTURE_FIELDS = {"graph_captures"}
KINDS = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


# ---------------------------------------------------------------- /metrics


def jax_families() -> dict:
    """{exposed name: (type, labels, help, buckets)} of JAX's collector."""
    out = {}
    for metric in JMetricsCollector()._prom.values():
        name = metric._name + ("_total" if metric._type == "counter" else "")
        buckets = tuple(getattr(metric, "_upper_bounds", ()) or ())
        out[name] = (metric._type, tuple(metric._labelnames), metric._documentation, buckets)
    return out


def port_families() -> dict:
    out = {}
    for family in MetricsCollector()._families.values():
        buckets = tuple(getattr(family, "buckets", ()) or ())
        out[family.name] = (KINDS[type(family)], family.label_names, family.doc, buckets)
    return out


def test_every_port_family_is_jaxs():
    ours, theirs = port_families(), jax_families()
    for name, spec in ours.items():
        assert spec == theirs.get(name), name
    assert set(theirs) - set(ours) == NOT_PORTED
    assert set(NINE) <= set(ours)


def test_families_render_and_parse():
    m = MetricsCollector()
    m.record_ttft(0.2)
    m.record_ttft(0.02, path="stream")
    m.record_tpot(0.004)
    m.record_tick(0.03, active_slots=3, queue_depth=1)
    m.record_llm("remote_chat", 0.5, tokens=20)
    m.record_breaker("qdrant", "open")
    m.record_batch_occupancy("embedder", 0.5)
    m.collect_device_memory()  # no card here: nothing
    text = m.export_prometheus().decode()
    families = {f.name: f for f in text_string_to_metric_families(text)}
    for name in NINE:
        assert f"# TYPE {name} " in text
    count = {s.labels["path"]: s.value for s in families["sentio_tpu_ttft_seconds"].samples
             if s.name.endswith("_count")}
    assert count == {"paged": 1.0, "stream": 1.0}
    ticks = [s.value for s in families["sentio_tpu_tick_duration_seconds"].samples
             if s.name.endswith("_count")]
    assert ticks == [1.0]
    tps = families["sentio_tpu_decode_tokens_per_second"].samples
    assert [s.value for s in tps] == [40.0]
    state = {s.labels["name"]: s.value for s in families["sentio_circuit_breaker_state"].samples}
    assert state == {"qdrant": 2.0}
    stats = {s.labels["stat"]: s.value for s in families["sentio_tpu_serving_stat"].samples}
    assert stats["tick_active_slots"] == 3.0 and stats["tick_queue_depth"] == 1.0
    assert not [s for s in families["sentio_tpu_hbm_bytes_in_use"].samples]


def test_recorders_feed_the_json_export_as_jax():
    """The same calls on both collectors: equal counters and gauges, and
    equal histogram counts and means."""
    ours, theirs = MetricsCollector(), JMetricsCollector()
    for m in (ours, theirs):
        m.record_ttft(0.25)
        m.record_ttft(0.5)
        m.record_tpot(0.01, path="stream")
        m.record_tick(0.05, 2, 0)
        m.record_llm("remote_chat", 0.25, tokens=5)
        m.record_breaker("b", "half_open")
    got, want = ours.export_json(), theirs.export_json()
    want_gauges = {k.replace("serving_tick_", "serving_stat('tick_").replace("()", "',)")
                   if k.startswith("serving_tick_") else k: v
                   for k, v in want["gauges"].items()}
    assert got["counters"] == want["counters"]
    assert {k: v for k, v in got["gauges"].items() if k != "inflight()"} == want_gauges
    for key, summary in want["histograms"].items():
        assert {k: got["histograms"][key][k] for k in ("count", "mean", "p50")} == \
            {k: summary[k] for k in ("count", "mean", "p50")}


# ------------------------------------------------------ config and tracing


def test_observability_config_matches_jax(monkeypatch):
    ours, theirs = (dataclasses.asdict(ObservabilityConfig()),
                    dataclasses.asdict(JObservabilityConfig()))
    # MONITOR_INTERVAL_S: read by nothing in either package, left out
    assert set(theirs) - set(ours) == {"monitor_interval_s"}
    assert ours == {k: theirs[k] for k in ours}
    env = {"TRACING_ENABLED": "1", "OTEL_EXPORTER_OTLP_ENDPOINT": "http://127.0.0.1:4317",
           "OTEL_CONSOLE": "1", "OTEL_SERVICE_NAME": "svc", "METRICS_ENABLED": "0",
           "MONITOR_INTERVAL_S": "5", "JAX_PROFILER_DIR": "/tmp/profiles"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ours = dataclasses.asdict(ObservabilityConfig.from_env())
    theirs = dataclasses.asdict(JObservabilityConfig.from_env())
    assert ours == {k: theirs[k] for k in ours}
    monkeypatch.delenv("TRACING_ENABLED")
    monkeypatch.setenv("OTEL_ENABLED", "1")
    assert ObservabilityConfig.from_env().tracing_enabled is True
    assert Settings.from_env().observability.profiler_dir == "/tmp/profiles"


def test_metrics_disabled_is_refused(monkeypatch):
    """``METRICS_ENABLED=0`` is no longer refused: JAX reads it and serves
    with its families recorded, and so does the port (the side-by-side
    server test in ``test_torch_serve.py`` serves under it)."""
    from sentio_tpu_torch.serve.app import check_serve_settings

    monkeypatch.setenv("METRICS_ENABLED", "0")
    settings = Settings.from_env()
    assert settings.observability.metrics_enabled is False
    assert JObservabilityConfig.from_env().metrics_enabled is False
    check_serve_settings(settings)
    check_serve_settings(Settings())


def test_tracing_degrades_to_mock_spans():
    manager = tracing.TracingManager(ObservabilityConfig(tracing_enabled=True))
    # no OpenTelemetry SDK in this environment: a no-op, as in JAX
    assert manager.enabled is False
    with manager.span("x", a=1) as span:
        assert isinstance(span, tracing.MockSpan)
    with pytest.raises(KeyError):
        with manager.profile_step("decode_tick", step=3):
            raise KeyError("the body's own error propagates unchanged")


def test_profile_window_writes_a_trace_and_is_single_flight(tmp_path):
    out: dict = {}
    first = threading.Thread(target=lambda: out.update(
        first=tracing.profile_window(1.0, str(tmp_path / "a"))), daemon=True)
    first.start()
    time.sleep(0.3)
    second = tracing.profile_window(0.1, str(tmp_path / "b"))
    first.join(timeout=TIMEOUT_S)
    assert second["started"] is False and "already active" in second["error"]
    assert out["first"] == {"started": True, "seconds": 1.0, "log_dir": str(tmp_path / "a")}
    traces = list((tmp_path / "a").glob("profile-*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())


def test_profile_window_records_other_threads_ranges(tmp_path):
    """The pump opens its ``decode_tick#N`` ranges on its own thread, not
    on the thread that opens the window."""
    assert tracing.warm_profiler() is True
    manager = tracing.TracingManager(ObservabilityConfig())
    stop = threading.Event()

    def pump() -> None:
        step = 0
        while not stop.is_set():
            with manager.profile_step("decode_tick", step):
                time.sleep(0.002)
            step += 1

    worker = threading.Thread(target=pump, daemon=True)
    worker.start()
    try:
        outcome = tracing.profile_window(0.3, str(tmp_path))
    finally:
        stop.set()
        worker.join(timeout=TIMEOUT_S)
    assert outcome["started"] is True
    (trace,) = tmp_path.glob("profile-*.json")
    names = [str(e.get("name", "")) for e in json.loads(trace.read_text())["traceEvents"]]
    assert sum(n.startswith("decode_tick#") for n in names) > 0


def test_monitors_match_jax():
    ours, theirs = monitoring.PerformanceMonitor(), jmonitoring.PerformanceMonitor()
    for m in (ours, theirs):
        m.set_threshold("latency", 3.0, "critical")
        for v in (1.0, 2.0, 5.0, 4.0):
            m.record("latency", v)
    assert [(a.metric, a.value, a.threshold, a.severity) for a in ours.recent_alerts()] == \
        [(a.metric, a.value, a.threshold, a.severity) for a in theirs.recent_alerts()] == \
        [("latency", 5.0, 3.0, "critical"), ("latency", 4.0, 3.0, "critical")]
    verdict = monitoring.ResourceMonitor(monitoring.PerformanceMonitor()).health_verdict()
    want = jmonitoring.ResourceMonitor(jmonitoring.PerformanceMonitor()).health_verdict()
    assert set(verdict) == set(want) and set(verdict["system"]) == {
        k for k in want["system"] if not k.startswith("hbm_percent")}
    # /metrics/performance hands its one collection to the verdict
    given = monitoring.ResourceMonitor(monitoring.PerformanceMonitor()).health_verdict(
        {"memory_percent": 95.0})
    assert given["system"] == {"memory_percent": 95.0}
    assert given["recommendations"] == ["host memory pressure: shrink caches or batch sizes"]


# -------------------------------------------------------- a live pipeline


class Client:
    def __init__(self, port: int) -> None:
        self.port = port

    def request(self, method: str, path: str, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT_S)
        try:
            conn.request(method, path, body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def json(self, method: str, path: str, body=None):
        status, data = self.request(method, path, body)
        return status, json.loads(data)


def samples(client) -> dict:
    text = client.request("GET", "/metrics")[1].decode()
    out: dict = {}
    for family in text_string_to_metric_families(text):
        for s in family.samples:
            out[s.name] = out.get(s.name, 0.0) + s.value
    return out


@pytest.fixture(scope="module")
def live():
    settings = Settings(
        retrieval=RetrievalConfig(strategy="dense"),
        generator=GeneratorConfig(model_preset="tiny", max_new_tokens=12,
                                  verifier_max_tokens=8, kv_page_size=16,
                                  kv_max_pages_per_seq=32, max_batch_size=2,
                                  decode_steps_per_tick=4, decode_max_tick_steps=4,
                                  context_token_budget=120, dtype="float32"),
        serve=ServeConfig(replica_supervise=False))
    pipeline = build_pipeline(settings, device="cpu", seed=4)
    pipeline.ingest([Document(text=f"passage {i} about pages and slots number {i}",
                              metadata={"source": f"doc-{i}"}) for i in range(6)])
    server = create_server(settings, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name="obs-test-server",
                              daemon=True)
    thread.start()
    try:
        yield pipeline, Client(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10.0)
        pipeline.close()


@pytest.fixture(scope="module")
def jax_record():
    """A tiny JAX service's flight record of two admissions under one id."""
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(6), jcfg))
    engine = JEngine(model_config=jcfg, params=tree, max_slots=2, page_size=16,
                     max_pages_per_seq=8, steps_per_tick=4, max_tick_steps=4)
    service = JService(engine, default_timeout_s=TIMEOUT_S)
    try:
        for prompt in ("the answer's prompt", "the verify's prompt"):
            service.generate(prompt, max_new_tokens=8, request_id="jax-keys")
        return jflight.get_flight_recorder().get("jax-keys")
    finally:
        service.close()


def chat(client, thread_id: str, stream: bool = False) -> None:
    body = {"question": "what links pages to slots?", "thread_id": thread_id}
    if stream:
        body["stream"] = True
        status, data = client.request("POST", "/chat", body)
        assert status == 200 and b"[DONE]" in data
    else:
        status, data = client.json("POST", "/chat", body)
        assert status == 200 and not data["metadata"]["degraded"], data


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_flight_record_carries_the_engine_window(live, jax_record, stream):
    pipeline, client = live
    rid = f"obs-{'sse' if stream else 'json'}"
    before = samples(client)
    ticks0 = pipeline.service.stats()["ticks"]
    chat(client, rid, stream)
    pipeline.replica_set.wait_idle()
    after = samples(client)
    status, record = client.json("GET", f"/debug/flight/{rid}")
    assert status == 200 and record["engine_window"] == "local"
    engine, ticks = record["engine"], record["ticks"]
    admissions = engine["admissions"]
    assert len(admissions) == 2 and engine["replica_id"] == 0 and ticks
    # the key sets of JAX's record, the compile / capture fields aside
    jengine = jax_record["engine"]
    assert set(engine) == set(jengine)
    assert [set(a) for a in admissions] == [set(a) for a in jengine["admissions"]]
    jtick = set(jax_record["ticks"][0]) - COMPILE_FIELDS
    for tick in ticks:
        assert set(tick) - CAPTURE_FIELDS == jtick
        assert abs(sum(tick["phase_ms"].values()) - tick["pump_ms"]) <= 0.01
        assert tick["graph_captures"] == 0  # no graphs on the CPU
    # the window's decode tokens: every token of both admissions, and the
    # EOS a "stop" admission folded without emitting it
    decoded = sum(t["decode_tokens"] for t in ticks)
    assert decoded == sum(a["tokens"] + (a["finish_reason"] == "stop") for a in admissions)
    # /metrics: one TTFT per admission, one TPOT per admission with tokens
    # after its first tick, one tick-duration sample per pump tick
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after}
    assert delta["sentio_tpu_ttft_seconds_count"] == 2
    assert delta["sentio_tpu_tpot_seconds_count"] == sum(a["tpot_ms"] is not None
                                                         for a in admissions)
    assert delta["sentio_tpu_tick_duration_seconds_count"] == \
        pipeline.service.stats()["ticks"] - ticks0
    status, trace = client.json("GET", f"/debug/flight/{rid}?format=chrome")
    names = [e["name"] for e in trace["traceEvents"]]
    assert status == 200 and any(n.startswith("tick ") for n in names)
    assert f"request {rid}" in names


def test_debug_profile_window(live, tmp_path):
    _, client = live
    status, body = client.json("GET", f"/debug/profile?seconds=0.2&dir={tmp_path / 'one'}")
    assert status == 200 and body == {"started": True, "seconds": 0.2,
                                      "log_dir": str(tmp_path / "one")}
    assert list((tmp_path / "one").glob("profile-*.json"))
    out: dict = {}
    first = threading.Thread(target=lambda: out.update(first=client.json(
        "GET", f"/debug/profile?seconds=1.5&dir={tmp_path / 'two'}")), daemon=True)
    first.start()
    time.sleep(0.5)
    status, body = client.json("GET", f"/debug/profile?seconds=0.2&dir={tmp_path / 'three'}")
    first.join(timeout=TIMEOUT_S)
    assert status == 409 and body["started"] is False
    assert out["first"][0] == 200


@pytest.mark.parametrize("raw,error", [("100", "must be within [0.1, 60]"),
                                       ("0.05", "must be within [0.1, 60]"),
                                       ("abc", "must be a number")])
def test_debug_profile_refuses_bad_seconds(live, raw, error):
    _, client = live
    status, body = client.json("GET", f"/debug/profile?seconds={raw}")
    assert status == 422
    assert body == {"error": "validation_error", "details": [{"field": "seconds",
                                                             "error": error}]}


def test_metrics_performance_has_jaxs_keys(live):
    _, client = live
    chat(client, "obs-perf")
    status, body = client.json("GET", "/metrics/performance")
    assert status == 200 and set(body) == {"metrics", "system", "verdict", "serving"}
    assert set(body["metrics"]) == {"counters", "histograms", "gauges"}
    assert any(k.startswith("ttft(") for k in body["metrics"]["histograms"])
    assert body["serving"]["replicas"][0]["replica"] == 0
    assert set(body["verdict"]) == {"status", "system", "recent_alerts", "recommendations"}


# -------------------------------------------------------------------- CLI


def run_cli(tmp_path, *args, extra_env=None):
    env = dict(os.environ, HOME=str(tmp_path), PYTHONUNBUFFERED="1", **(extra_env or {}))
    return subprocess.run([sys.executable, "-m", "sentio_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)


def test_cli_info(tmp_path):
    proc = run_cli(tmp_path, "info", "--device", "cpu", "--tiny")
    assert proc.returncode == 0, proc.stderr[-2000:]
    info = json.loads(proc.stdout)
    assert set(info) == {"version", "devices", "retrieval", "generator", "mesh"}
    assert info["devices"] == [{"platform": "cpu", "kind": "cpu"}]
    assert info["generator"] == "tiny" and info["mesh"] == {"dp": 0, "tp": 1, "sp": 1}


def test_cli_trace_writes_the_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    proc = run_cli(tmp_path, "trace", "what is a page", "--tiny", "--device", "cpu",
                   "--chrome", str(out), "--documents",
                   extra_env={"LLM_MAX_TOKENS": "8", "VERIFIER_MAX_TOKENS": "8"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    trace = json.loads(proc.stdout)
    assert {"query", "request_id", "graph_path", "node_timings_ms", "num_retrieved",
            "num_reranked", "num_selected", "answer", "evaluation", "metadata", "flight",
            "selected_documents"} == set(trace)
    assert len(trace["flight"]["engine"]["admissions"]) == 2 and trace["flight"]["ticks"]
    chrome = json.loads(out.read_text())
    assert any(e["name"].startswith("tick ") for e in chrome["traceEvents"])


def test_cli_trace_fleet_falls_back_in_thread_mode(tmp_path, capsys, monkeypatch):
    """``trace --chrome --fleet`` with no worker replicas writes the local
    timeline and says so, as JAX's CLI does (the worker fleet's lanes:
    tests/test_torch_elastic.py)."""
    monkeypatch.setenv("LLM_MAX_TOKENS", "8")
    monkeypatch.setenv("VERIFIER_MAX_TOKENS", "8")
    out = tmp_path / "fleet.json"
    assert cli.main(["trace", "q", "--fleet", "--chrome", str(out), "--tiny", "--device",
                     "cpu"]) == 0
    captured = capsys.readouterr()
    assert "--fleet: no worker replicas" in captured.err
    chrome = json.loads(out.read_text())
    assert any(e["name"].startswith("tick ") for e in chrome["traceEvents"])
    assert json.loads(captured.out)["flight"]["engine"]["admissions"]


def test_worker_series_merge_matches_jax():
    """A router merging workers' cumulative telemetry: the same frames
    into each package's collector give the same ``{replica}`` fleet
    series — deltas between frames, a late frame of an older epoch dropped
    (``stale_epoch``), a new pid (a respawn) restarting the baselines, a
    heal (same pid, higher epoch) keeping them, a malformed key dropped."""
    frames = [
        (1, 10, {"counters": {"verify('sync', 'pass')": 2.0, "shed('queue_full',)": 1.0},
                 "histo_count": {"tick_phase('admit',)": 3},
                 "histo_sum": {"tick_phase('admit',)": 0.3}}),
        (1, 10, {"counters": {"verify('sync', 'pass')": 5.0, "shed('queue_full',)": 1.0,
                              "bad(key": 1.0},
                 "histo_count": {"tick_phase('admit',)": 4, "ttft('paged',)": 2},
                 "histo_sum": {"tick_phase('admit',)": 0.5, "ttft('paged',)": 0.25}}),
        (0, 10, {"counters": {"verify('sync', 'pass')": 9.0}}),
        (2, 10, {"counters": {"verify('sync', 'pass')": 6.0}}),
        (3, 11, {"counters": {"verify('sync', 'pass')": 1.0, "verify('async', 'warn')": 2.0}}),
    ]
    ours, theirs = MetricsCollector(), JMetricsCollector()
    got = [(ours.merge_worker_series(1, s, epoch=e, pid=p),
            theirs.merge_worker_series(1, s, epoch=e, pid=p)) for e, p, s in frames]
    assert [a for a, _ in got] == [b for _, b in got]
    assert ours.worker_telemetry_epoch(1) == theirs.worker_telemetry_epoch(1) == 3
    names = {"worker_verify": ours.worker_verify, "worker_events": ours.worker_events,
             "worker_tick_phase_seconds": ours.worker_tick_phase_seconds,
             "worker_tick_phase_ticks": ours.worker_tick_phase_ticks,
             "worker_observed_sum": ours.worker_observed_sum,
             "worker_observed_count": ours.worker_observed_count,
             "worker_telemetry_dropped": ours.worker_telemetry_dropped}
    mine = {f"{name}{key}": round(v, 9) for name, fam in names.items()
            for key, v in fam.values().items()}
    jax_side = {k: round(v, 9) for k, v in theirs.memory.counters.items()
                if k.split("(")[0] in names}
    assert mine == jax_side
    assert mine["worker_verify('1', 'sync', 'pass')"] == 5.0 + 1.0 + 1.0
