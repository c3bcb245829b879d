"""The HTTP server — the routes and behaviours of ``sentio_tpu/serve/app.py``
on the standard library's ``http.server.ThreadingHTTPServer`` (one thread
per connection; the machine with the card has no aiohttp).

Routes: ``POST /chat`` (JSON, or SSE with ``"stream": true``), ``POST
/embed``, ``POST /upload`` (multipart, parsed with ``email.parser``),
``POST /clear``, ``GET /health``, ``/health/ready``, ``/health/live``,
``/health/detailed``, ``/info``, ``/metrics`` (Prometheus text),
``/metrics/performance`` (the metrics' JSON snapshot, the host's and the
card's memory, the resource monitor's verdict and the serving stats),
``/debug/flight/{id}`` (a request's flight record in JSON — its node
timings, the ``verify`` section a detached verdict lands in, the
``engine`` section with each admission's TTFT, TPOT and tokens, and the
pump ticks of its window, ``engine_window: "local"``; with
``?format=chrome`` the same as a Chrome / Perfetto trace) and
``/debug/profile?seconds=N&dir=D`` (a ``torch.profiler`` window of N
seconds, 0.1–60, 3 by default, over the whole process — CPU and the card's
kernels — written as a Chrome trace under D, ``PROFILER_DIR`` or a
temporary directory; 409 while another window is open; it runs on the
request's own thread, so the server keeps answering). As in JAX: per-IP
sliding-window rate limits (``/embed`` and ``/upload`` share the tight
bucket), security headers on every response, 422 bodies listing each bad
field, typed errors mapped by ``ErrorHandler`` with ``Retry-After`` on
sheds and rate limits, the caller's deadline from ``deadline_ms`` or
``X-Deadline-Ms`` (else ``DEADLINE_MS``), request counts and latencies
recorded by endpoint and status. The replica tier's request headers:
``X-Tenant`` (a header-safe key; else the shared tenant) and ``X-Priority:
batch`` pick the WFQ tenant and tier a chat's admissions charge;
``X-Resumable: 0`` (or the body's ``resumable: false``) opts a stream out
of resume-by-replay. ``/health`` is ``degraded`` (200) while some replica
serves and ``unhealthy`` (503) at none; ``/metrics`` carries a
``sentio_tpu_replica_stat`` row set per replica; ``/info`` names the
replica count and mode under ``generator.replicas``.

SSE: admission (the tenant's WFQ test and the routed replica's own
check) is checked before the 200 is committed; the body is
chunked, one flush per event (``data: {"sources": ...}``, ``data:
{"token": ...}``…, ``data: {"verdict": ...}``, ``data: [DONE]``; under
``VERIFY_MODE=async|gated`` ``data: [DONE]`` as soon as the answer is
complete, then ``data: {"verify": ...}``), with a
``: keepalive`` comment after ``SSE_KEEPALIVE_S`` of silence. A client
that goes away closes the event generator, which cancels the service's
ticket and frees its slot.

:func:`create_server` builds the server over a pipeline; :func:`run_server`
(``python -m sentio_tpu_torch serve``) builds the pipeline, warms it up,
loads ``--index`` / ``INDEX_PATH``, serves until SIGINT or SIGTERM, then
drains the generation service. Left out: auth and ``/auth/token``, and
the UI page at ``/``; ``AUTH_ENABLED=1`` raises, as does
``METRICS_ENABLED=0``.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import select
import signal
import socket
import sys
import tempfile
import threading
import time
import uuid
from email import policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Optional
from urllib.parse import parse_qsl, urlsplit

from sentio_tpu_torch import __version__
from sentio_tpu_torch.config import Settings
from sentio_tpu_torch.infra.caching import CacheManager
from sentio_tpu_torch.infra.chrome_trace import build_chrome_trace
from sentio_tpu_torch.infra.exceptions import ErrorHandler, SentioError
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.infra.monitoring import performance_monitor, resource_monitor
from sentio_tpu_torch.infra.security import SECURITY_HEADERS, IPRateLimiter, RateLimitConfig
from sentio_tpu_torch.infra.tracing import profile_window, warm_profiler
from sentio_tpu_torch.ops.ingest import SUPPORTED_SUFFIXES
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.pipeline import ChatPipeline, check_replica_settings, check_verify_mode
from sentio_tpu_torch.runtime.replica import (
    DEFAULT_TENANT,
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
)
from sentio_tpu_torch.serve.handlers import ChatHandler, HealthHandler
from sentio_tpu_torch.serve.schemas import (
    MAX_DEADLINE_MS,
    SchemaError,
    parse_chat_request,
    parse_embed_request,
)

logger = logging.getLogger(__name__)

__all__ = ["create_server", "run_server", "check_serve_settings", "SentioHTTPServer"]

# a JSON body past this is refused with 413, as aiohttp's default
# client_max_size refuses it
MAX_JSON_BODY = 1024 ** 2
# multipart framing (boundaries, part headers) read beyond the upload cap
UPLOAD_SLACK = 1024 ** 2
# how often a silent SSE stream checks whether its client went away
SSE_POLL_S = 0.25
FLIGHT_PREFIX = "/debug/flight/"
_REQUEST_ID_RE = re.compile(r"[A-Za-z0-9._:-]{1,128}")


class _Response:
    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: Optional[dict] = None) -> None:
        self.status, self.body, self.content_type = status, body, content_type
        self.headers = headers or {}


def _json(payload: Any, status: int = 200, headers: Optional[dict] = None) -> _Response:
    return _Response(status, json.dumps(payload).encode(), "application/json; charset=utf-8",
                     headers)


def _text(text: str, status: int) -> _Response:
    return _Response(status, text.encode(), "text/plain; charset=utf-8")


class _Streamed:
    """The handler wrote the response itself (SSE)."""

    status = 200


def check_serve_settings(settings: Settings) -> None:
    """Refuse the settings the port's server cannot honour."""
    if settings.auth.enabled:
        raise NotImplementedError("AUTH_ENABLED=1: auth and /auth/token are not ported")
    if not settings.observability.metrics_enabled:
        raise NotImplementedError("METRICS_ENABLED=0: the metric families are always recorded")
    if settings.cache.backend == "multi_tier":
        raise NotImplementedError("CACHE_BACKEND=multi_tier: the Redis L2 cache is not ported")
    check_verify_mode(settings.generator.verify_mode)
    check_replica_settings(settings.serve)


class SentioHTTPServer(ThreadingHTTPServer):
    """The server and what its handlers share."""

    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: socketserver's 5 resets connections of a burst
    # that arrives while the accept loop waits for the interpreter lock
    # (aiohttp, the JAX server, listens with 128)
    request_queue_size = 128

    def handle_error(self, request, client_address) -> None:
        """A client that went away between requests (an SSE client closes
        after ``[DONE]``) is not a server error."""
        if isinstance(sys.exc_info()[1], (ConnectionResetError, BrokenPipeError)):
            logger.debug("client %s went away", client_address)
            return
        super().handle_error(request, client_address)

    def __init__(self, address, settings: Settings, pipeline: ChatPipeline,
                 cache_manager: Optional[CacheManager] = None,
                 fallback: Optional[tuple] = None) -> None:
        self.settings = settings
        self.pipeline = pipeline
        self.chat_handler = ChatHandler(pipeline, cache_manager=cache_manager,
                                        fallback=fallback)
        self.health_handler = HealthHandler(pipeline)
        self.rate_limiter = IPRateLimiter(
            default=RateLimitConfig(per_minute=settings.serve.rate_limit_default_per_min))
        self.rate_limiter.configure("/embed", settings.serve.rate_limit_embed_per_min)
        super().__init__(address, _Handler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def create_server(settings: Optional[Settings], pipeline: ChatPipeline,
                  host: Optional[str] = None, port: Optional[int] = None,
                  cache_manager: Optional[CacheManager] = None,
                  fallback: Optional[tuple] = None) -> SentioHTTPServer:
    """A server over ``pipeline`` bound to ``host``:``port`` (the serve
    settings' by default; port 0 picks a free one), not yet serving: run
    ``serve_forever()`` on a thread and ``shutdown()`` from another. The
    profiler is warmed first (once a process), so ``/debug/profile``'s
    first window opens when it is asked for."""
    settings = settings or pipeline.settings
    check_serve_settings(settings)
    warm_profiler()
    host = settings.serve.host if host is None else host
    port = settings.serve.port if port is None else port
    return SentioHTTPServer((host, port), settings, pipeline, cache_manager=cache_manager,
                            fallback=fallback)


# ---------------------------------------------------------------- handlers


def _resolve_deadline_ts(headers, req, serve_cfg) -> Optional[float]:
    """Absolute perf_counter deadline: body ``deadline_ms`` beats the
    ``X-Deadline-Ms`` header beats the serve default (0 = none). A
    malformed header is ignored."""
    deadline_ms = req.deadline_ms
    if deadline_ms is None:
        raw = headers.get("X-Deadline-Ms", "")
        if raw:
            try:
                value = float(raw)
                if 0 < value <= MAX_DEADLINE_MS:
                    deadline_ms = value
            except ValueError:
                pass
    if deadline_ms is None and serve_cfg.default_deadline_ms > 0:
        deadline_ms = serve_cfg.default_deadline_ms
    if deadline_ms is None:
        return None
    return time.perf_counter() + deadline_ms / 1e3


_TENANT_RE = re.compile(r"[A-Za-z0-9._:-]{1,64}")


def _request_tenant(headers) -> tuple[str, str]:
    """(tenant, priority): a header-safe ``X-Tenant`` value, else the
    shared tenant (auth principals are not ported); ``X-Priority: batch``
    picks the shed-earlier tier, anything else is interactive."""
    raw = headers.get("X-Tenant", "").strip()
    tenant = raw if raw and _TENANT_RE.fullmatch(raw) else DEFAULT_TENANT
    batch = headers.get("X-Priority", "").strip().lower() == "batch"
    return tenant, PRIORITY_BATCH if batch else PRIORITY_INTERACTIVE


def _resolve_resumable(headers, req) -> bool:
    """The body's ``resumable`` beats ``X-Resumable`` beats the default
    (resume); only the explicit falsy header values opt out."""
    if req.resumable is not None:
        return bool(req.resumable)
    return headers.get("X-Resumable", "").strip().lower() not in ("0", "false", "no", "off")


def _device_stats(pipeline: ChatPipeline) -> dict:
    """``/info``'s device section, in the JAX engine's ``device_stats``
    shape."""
    import torch

    engine = pipeline.generator.provider.engine
    cfg = getattr(engine, "cfg", None) or engine.model_config
    dev = pipeline.embedder.device
    cuda = dev.type == "cuda"
    stats = {"platform": "gpu" if cuda else dev.type,
             "n_devices": torch.cuda.device_count() if cuda else 1, "mesh": None,
             "model": {"layers": cfg.n_layers, "dim": cfg.dim, "vocab": cfg.vocab_size}}
    if cuda:
        stats["memory"] = {"bytes_in_use": torch.cuda.memory_allocated(dev),
                           "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}
    return stats


_SERVING_STATS = ("active_slots", "queued", "queued_inbox", "free_pages", "avg_active_slots",
                  "max_active_slots", "ttft_p50_ms", "ttft_p95_ms", "spec_tokens_per_verify",
                  "prefix_hit_token_ratio", "prefix_cache_pages", "prefix_cache_nodes",
                  "max_queue", "draining", "pool_hbm_bytes")
_SERVING_EVENTS = ("ticks", "completed", "ttft_count", "prefix_hits", "prefix_misses",
                   "prefix_hit_tokens", "prefix_miss_tokens", "spec_verifies", "spec_emitted",
                   "shed", "expired", "cancelled", "requeued", "tick_failures", "pump_leaked",
                   "failovers")
_REPLICA_STATS = ("active_slots", "queued", "queued_inbox", "free_pages", "prefix_cache_pages",
                  "prefix_hit_token_ratio", "pool_hbm_bytes", "ttft_p50_ms", "completed",
                  "shed")


def publish_serving_gauges(pipeline: ChatPipeline) -> Optional[dict]:
    """Refresh the generation tier's metrics at scrape time (occupancy,
    queue depth, free pages, lifetime totals, each replica's duty cycle and
    its ``sentio_tpu_replica_stat`` rows); returns the stats (None without
    a service)."""
    service = pipeline.generator.provider.service
    if service is None:
        return None
    stats = service.stats()
    m = get_metrics()
    for key in _SERVING_STATS:
        if key in stats:
            m.set_serving_stat(key, float(stats[key]))
    for event in _SERVING_EVENTS:
        if event in stats:
            m.bump_serving_total(event, float(stats[event]))
    for row in stats.get("replicas") or [stats]:
        if row.get("duty_cycle"):
            m.record_duty_cycle(row.get("replica", 0), row["duty_cycle"])
    for row in stats.get("replicas", ()):
        for key in _REPLICA_STATS:
            if key in row:
                m.set_replica_stat(row.get("replica", 0), key, float(row[key]))
    return stats


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: SentioHTTPServer
    # a response's headers and body are two writes; with Nagle's algorithm
    # the body would wait for the client's delayed ACK (aiohttp, the JAX
    # server, sets TCP_NODELAY as well)
    disable_nagle_algorithm = True

    # ------------------------------------------------------------ plumbing

    def log_message(self, fmt, *args) -> None:  # noqa: D102 — route to logging
        logger.debug("%s %s", self.address_string(), fmt % args)

    def do_GET(self) -> None:  # noqa: N802 — http.server's naming
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def _routes(self) -> dict[str, tuple[str, Callable[[], Any]]]:
        return {
            "/chat": ("POST", self._chat),
            "/embed": ("POST", self._embed),
            "/upload": ("POST", self._upload),
            "/clear": ("POST", self._clear),
            "/health": ("GET", self._health),
            "/health/ready": ("GET", self._health_ready),
            "/health/live": ("GET", self._health_live),
            "/health/detailed": ("GET", self._health_detailed),
            "/info": ("GET", self._info),
            "/metrics": ("GET", self._metrics),
            "/metrics/performance": ("GET", self._metrics_performance),
            "/debug/profile": ("GET", self._debug_profile),
        }

    def _query(self) -> dict:
        return dict(parse_qsl(urlsplit(self.path).query))

    def _client_ip(self) -> str:
        ip = self.client_address[0] if self.client_address else "unknown"
        if self.server.settings.serve.trust_proxy_headers:
            forwarded = self.headers.get("X-Forwarded-For", "").split(",")[0].strip()
            if forwarded:
                ip = forwarded
        return ip

    def _dispatch(self, method: str) -> None:
        path = urlsplit(self.path).path
        metrics = get_metrics()
        t0 = time.perf_counter()
        status = 500
        work = not path.startswith(("/health", "/metrics"))
        if work:
            metrics.adjust_inflight(+1)
        self._body_read = False
        try:
            try:
                if work and path != "/":
                    # uploads are ingest work: they share /embed's bucket
                    endpoint = "/embed" if path in ("/embed", "/upload") else "*"
                    self.server.rate_limiter.check(self._client_ip(), endpoint)
                route = self._routes().get(path)
                if route is None and path.startswith(FLIGHT_PREFIX):
                    route = ("GET", lambda: self._debug_flight(path[len(FLIGHT_PREFIX):]))
                if route is None:
                    response = _text("404: Not Found", 404)
                elif route[0] != method:
                    response = _text("405: Method Not Allowed", 405)
                    response.headers["Allow"] = route[0]
                else:
                    response = route[1]()
            except _TooLarge as exc:
                response = exc.response()
            except SchemaError as exc:
                response = _json({"error": "validation_error", "details": exc.errors}, 422)
            except SentioError as exc:
                response = _json(exc.to_dict(), exc.status)
                retry = exc.details.get("retry_after_s")
                if retry:
                    response.headers["Retry-After"] = str(max(int(retry), 1))
            except Exception as exc:  # noqa: BLE001 — opaque 500, internals never leak
                code, body = ErrorHandler.handle(exc)
                response = _json(body, code)
            status = response.status
            if not isinstance(response, _Streamed):
                self._send(response)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
        finally:
            if work:
                metrics.adjust_inflight(-1)
            metrics.record_request(path, status, time.perf_counter() - t0)

    def _send(self, response: _Response) -> None:
        if not self._body_read:
            self._drain_body()
        self.send_response(response.status)
        self.send_header("Content-Type", response.content_type)
        self.send_header("Content-Length", str(len(response.body)))
        for key, value in {**SECURITY_HEADERS, **response.headers}.items():
            self.send_header(key, value)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(response.body)
        self.wfile.flush()

    def _content_length(self) -> int:
        try:
            return max(int(self.headers.get("Content-Length", "0") or 0), 0)
        except ValueError:
            return 0

    def _read_body(self, limit: int) -> tuple[bytes, bool]:
        """The body, at most ``limit`` bytes; whether it was cut (the
        connection then closes after the response)."""
        n = self._content_length()
        cut = n > limit
        body = self.rfile.read(min(n, limit)) if n else b""
        self._body_read = True
        if cut:
            self.close_connection = True
        return body, cut

    def _drain_body(self) -> None:
        """Read a body no handler read, so the connection can carry the
        next request; a large one closes the connection instead."""
        n = self._content_length()
        if n > MAX_JSON_BODY:
            self.close_connection = True
        elif n:
            self.rfile.read(n)
        self._body_read = True

    def _json_body(self) -> Any:
        """Malformed JSON is a 422 with a field list, not a 500."""
        if self._content_length() > MAX_JSON_BODY:
            self._read_body(0)
            raise _TooLarge(self._content_length())
        body, _cut = self._read_body(MAX_JSON_BODY)
        if not body:
            return {}
        try:
            return json.loads(body.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise SchemaError([{"field": "body", "error": f"invalid JSON: {exc}"}]) from exc

    # ------------------------------------------------------------- routes

    def _chat(self):
        settings = self.server.settings
        req = parse_chat_request(self._json_body(), settings.serve)
        deadline_ts = _resolve_deadline_ts(self.headers, req, settings.serve)
        tenant, priority = _request_tenant(self.headers)
        if req.stream:
            # shed before the 200 is committed: after it a stream can only
            # end with a typed error event
            service = self.server.pipeline.generator.provider.service
            if service is not None:
                # the tenant's WFQ test and the routed replica's admission,
                # as the submit will see them
                service.check_admission(deadline_ts, tenant=tenant, priority=priority,
                                        prompt=req.question)
            return self._chat_stream(req, deadline_ts, tenant, priority,
                                     _resolve_resumable(self.headers, req))
        return _json(self.server.chat_handler.process_chat_request_sync(
            question=req.question, top_k=req.top_k, temperature=req.temperature,
            mode=req.mode, thread_id=req.thread_id, deadline_ts=deadline_ts,
            tenant=tenant, priority=priority))

    def _chat_stream(self, req, deadline_ts: Optional[float], tenant: str, priority: str,
                     resumable: bool) -> _Streamed:
        """SSE: the handler's events are produced on a thread of their own
        into a bounded queue; this thread writes them, one chunk and one
        flush each, with a keepalive comment after ``sse_keepalive_s`` of
        silence, and stops early when the client goes away."""
        request_id = (req.thread_id if req.thread_id and _REQUEST_ID_RE.fullmatch(req.thread_id)
                      else uuid.uuid4().hex[:12])
        self.send_response(200)
        for key, value in {**SECURITY_HEADERS, "Content-Type": "text/event-stream",
                           "Cache-Control": "no-cache", "Connection": "keep-alive",
                           "X-Request-Id": request_id, "Transfer-Encoding": "chunked"}.items():
            self.send_header(key, value)
        self.end_headers()
        events: queue.Queue = queue.Queue(maxsize=256)
        stop = threading.Event()

        def put(item) -> bool:
            # backpressure with a way out: a consumer that stopped draining
            # (client gone) sets ``stop`` and the producer returns
            while not stop.is_set():
                try:
                    events.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            stream = self.server.chat_handler.stream_chat_sync(
                question=req.question, top_k=req.top_k, temperature=req.temperature,
                mode=req.mode, deadline_ts=deadline_ts, request_id=request_id,
                tenant=tenant, priority=priority, resumable=resumable)
            try:
                for item in stream:
                    if not put(item):
                        return
                put(("eos", ""))
            except Exception as exc:  # noqa: BLE001 — the stream ends with an error event
                logger.exception("SSE producer failed")
                put(("error", {"code": "INTERNAL_ERROR", "message": str(exc),
                               "retryable": False}))
                put(("eos", ""))
            finally:
                stream.close()  # a stream left early cancels its ticket

        producer = threading.Thread(target=produce, name=f"sse-{request_id}", daemon=True)
        producer.start()
        keepalive_s = self.server.settings.serve.sse_keepalive_s
        last_write = time.perf_counter()
        ended = wrote_done = False
        try:
            while True:
                try:
                    kind, payload = events.get(timeout=SSE_POLL_S)
                except queue.Empty:
                    if self._client_gone():
                        break
                    if keepalive_s and keepalive_s > 0 \
                            and time.perf_counter() - last_write >= keepalive_s:
                        self._write_chunk(b": keepalive\n\n")
                        last_write = time.perf_counter()
                    continue
                if kind == "done":
                    # the answer is complete; the connection stays open for
                    # the trailing verify event (keepalives bridge the audit)
                    self._write_chunk(b"data: [DONE]\n\n")
                    wrote_done = True
                    last_write = time.perf_counter()
                    continue
                if kind == "eos":
                    if not wrote_done:
                        self._write_chunk(b"data: [DONE]\n\n")
                    ended = True
                    break
                self._write_chunk(f"data: {json.dumps({kind: payload})}\n\n".encode())
                last_write = time.perf_counter()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            stop.set()
            while True:  # unblock a producer waiting to put
                try:
                    events.get_nowait()
                except queue.Empty:
                    break
        if ended:
            try:
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except OSError:
                self.close_connection = True
        else:
            self.close_connection = True
        return _Streamed()

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _client_gone(self) -> bool:
        """Whether the peer closed the connection (readable at EOF)."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            if not readable:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _embed(self):
        server = self.server
        req = parse_embed_request(self._json_body(), server.settings.serve)
        stats = server.pipeline.ingestor.ingest_document(req.content, req.metadata)
        get_metrics().record_embeddings(server.settings.embedder.provider, stats.chunks_embedded)
        return _json({"status": "ok", "stats": stats.to_dict()})

    def _upload(self):
        """Multipart ingest: each file part is parsed by its suffix's
        reader, chunked, embedded and indexed; results are per file, and
        one bad document never fails the batch. Every part's bytes count
        toward the ``max_upload_mb`` cap; past it the request stops with
        413 and the results so far."""
        server = self.server
        ctype = self.headers.get("Content-Type", "")
        if not ctype.split(";")[0].strip().lower().startswith("multipart/"):
            raise SchemaError([{"field": "body", "error": "multipart/form-data required"}])
        cap_mb = server.settings.serve.max_upload_mb
        cap = cap_mb * 1024 * 1024
        raw, cut = self._read_body(cap + UPLOAD_SLACK)
        message = BytesParser(policy=policy.HTTP).parsebytes(
            b"Content-Type: " + ctype.encode("latin-1") + b"\r\n\r\n" + raw)
        parts = list(message.iter_parts()) if message.is_multipart() else []
        ingestor = server.pipeline.ingestor
        files: list[dict] = []
        total = 0
        for i, part in enumerate(parts):
            filename = part.get_filename()
            keep = filename is not None
            name = os.path.basename(filename) if keep else ""
            suffix = Path(name).suffix.lower()
            if keep and suffix not in SUPPORTED_SUFFIXES:
                files.append({"filename": name, "error": f"unsupported type {suffix!r}"})
                keep = False
            data = part.get_payload(decode=True) or b""
            total += len(data)
            # a body cut short ends inside its last part, which then crossed the cap
            over = total > cap or (cut and i == len(parts) - 1)
            if not keep and not over:
                continue
            if over:
                files.append({"filename": name,
                              "error": f"upload exceeds {cap_mb} MB request cap"})
                return _json({"status": "error", "files": files}, 413)
            with tempfile.TemporaryDirectory(prefix="sentio-upload-") as tmp:
                # the original name: the reader dispatches on its suffix
                path = Path(tmp) / name
                path.write_bytes(data)
                try:
                    docs = ingestor.load_file(path)
                    for doc in docs:
                        doc.metadata["source"] = name  # not the temp path
                    stats = ingestor.ingest_documents(docs)
                except Exception as exc:  # noqa: BLE001 — per-file isolation
                    files.append({"filename": name, "error": str(exc)})
                    continue
            entry = {"filename": name, **stats.to_dict()}
            if stats.errors:
                entry["error"] = "; ".join(str(e) for e in stats.errors[:3])
            files.append(entry)
            get_metrics().record_embeddings(server.settings.embedder.provider,
                                            stats.chunks_embedded)
        if not files:
            raise SchemaError([{"field": "file", "error": "no file parts in form data"}])
        ok = any("error" not in f for f in files)
        return _json({"status": "ok" if ok else "error", "files": files}, 200 if ok else 422)

    def _clear(self):
        n = self.server.pipeline.ingestor.clear()
        return _json({"status": "ok", "documents_removed": n})

    def _health(self):
        report = self.server.health_handler.basic()
        return _json(report, 503 if report["status"] == "unhealthy" else 200)

    def _health_ready(self):
        report = self.server.health_handler.ready()
        return _json(report, 200 if report["ready"] else 503)

    def _health_live(self):
        return _json(self.server.health_handler.live())

    def _health_detailed(self):
        return _json(self.server.health_handler.detailed(_device_stats(self.server.pipeline)))

    def _info(self):
        settings, pipeline = self.server.settings, self.server.pipeline
        return _json({
            "service": "sentio-tpu",
            "version": __version__,
            "retrieval": {
                "strategy": settings.retrieval.strategy,
                "fusion": settings.retrieval.fusion_method,
                "top_k": settings.retrieval.top_k,
                "corpus_size": pipeline.index.size,
            },
            "reranker": {"enabled": settings.rerank.enabled, "kind": settings.rerank.kind},
            "generator": {
                "provider": settings.generator.provider,
                "preset": settings.generator.model_preset,
                "verifier": settings.generator.use_verifier,
                "speculative": pipeline.speculative_info,
                "replicas": ({"count": pipeline.replica_set.replicas,
                              "mode": "thread"} if pipeline.replica_set is not None
                             else None),
            },
            "device": _device_stats(pipeline),
        })

    def _debug_flight(self, request_id: str):
        """One request's flight record: its node timings, status, latency,
        the verify section a detached verdict lands in, and the engine
        section with the ticks of its window (thread-mode replicas share
        the process's recorder: ``engine_window`` is ``local``); with
        ``?format=chrome`` a Chrome trace of the window and the request."""
        record = get_flight_recorder().get(request_id)
        if record is None:
            return _json({"error": f"no flight record for {request_id!r}"}, 404)
        record["engine_window"] = "local"
        if self._query().get("format") == "chrome":
            return _json(build_chrome_trace(record.pop("ticks", []), [record]))
        return _json(record)

    def _debug_profile(self):
        """A profiler window of ``?seconds=`` (0.1–60, default 3) written
        under ``?dir=``, ``PROFILER_DIR`` or a temporary directory; 409 when
        one is already open."""
        query = self._query()
        try:
            seconds = float(query.get("seconds", "3"))
        except ValueError:
            raise SchemaError([{"field": "seconds", "error": "must be a number"}]) from None
        if not 0.1 <= seconds <= 60.0:
            raise SchemaError([{"field": "seconds", "error": "must be within [0.1, 60]"}])
        log_dir = (query.get("dir") or self.server.settings.observability.profiler_dir
                   or tempfile.mkdtemp(prefix="sentio-torch-profile-"))
        outcome = profile_window(seconds, log_dir)
        return _json(outcome, 200 if outcome.get("started") else 409)

    def _metrics(self):
        publish_serving_gauges(self.server.pipeline)
        return _Response(200, get_metrics().export_prometheus(), "text/plain; charset=utf-8")

    def _metrics_performance(self):
        serving = publish_serving_gauges(self.server.pipeline)
        system = performance_monitor.collect_system()
        return _json({"metrics": get_metrics().export_json(), "system": system,
                      "verdict": resource_monitor.health_verdict(system),
                      "serving": serving})


class _TooLarge(Exception):
    def __init__(self, size: int) -> None:
        super().__init__(size)
        self.size = size

    def response(self) -> _Response:
        return _text(f"Maximum request body size {MAX_JSON_BODY} exceeded, actual body size "
                     f"{self.size}", 413)


# --------------------------------------------------------------- entry point


def run_server(settings: Optional[Settings] = None, device=None, seed: int = 0,
               host: Optional[str] = None, port: Optional[int] = None) -> None:
    """Build the pipeline on ``device`` (the card by default), warm it up,
    load ``retrieval.index_path`` when its files exist, and serve until
    SIGINT or SIGTERM; then stop admitting, drain the generation service
    for up to ``DRAIN_DEADLINE_S`` and close."""
    from sentio_tpu_torch.pipeline import build_pipeline

    settings = settings or Settings.from_env()
    check_serve_settings(settings)
    pipeline = build_pipeline(settings, device=device, seed=seed)
    try:
        pipeline.warmup()
        path = settings.retrieval.index_path
        if path and Path(path).with_suffix(".json").exists():
            logger.info("loaded %d documents from %s", pipeline.load_index(path), path)
        server = create_server(settings, pipeline, host=host, port=port)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        thread = threading.Thread(target=server.serve_forever, name="http-server",
                                  daemon=True)
        thread.start()
        print(f"serving on {server.url}", flush=True)
        while not stop.wait(0.5):
            pass
        server.shutdown()
        server.server_close()
        thread.join(timeout=10.0)
        if pipeline.generator.provider.service is not None:
            outcome = pipeline.generator.provider.service.drain(settings.serve.drain_deadline_s)
            if not outcome.get("drained", True):
                logger.warning("shutdown drain abandoned %d in-flight request(s)",
                               outcome.get("abandoned", 0))
    finally:
        pipeline.close()
