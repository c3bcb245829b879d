"""Process and socket replica workers — ``sentio_tpu/runtime/worker.py`` on
the card: one engine + service + pump per OS process.

* :func:`worker_main` runs in a child process (**spawn** start method: CUDA,
  like JAX, is not fork-safe) and owns a private
  ``ContinuousBatchingEngine`` + ``PagedGenerationService`` + pump thread,
  with its own page pool, radix tree, CUDA stream and CUDA graphs. It
  serves a small RPC protocol over the spawn pipe and pushes unsolicited
  **status frames** (heartbeat age, backlog, breaker signals) at a fixed
  cadence, so the router's supervisor probes never pay a round trip.
* :class:`ProcessReplica` is the router-side shim: the surface of a
  ``PagedGenerationService`` (``generate``, ``generate_stream``,
  ``check_admission``, ``peek_prefix``, ``warmup``, ``drain``, ``stats``,
  ``close``), so the ``ReplicaSet``'s routing, WFQ, supervision and failover
  drive it unchanged. Streams arrive as token frames; a worker's death
  (SIGKILL, OOM, crash) is a broken pipe or a dead process, and every
  in-flight call fails with a typed :class:`ReplicaUnavailable`.
* the supervisor rebuilds a dead replica by **respawning the process**
  (:meth:`ProcessReplica.respawn`, which ``ReplicaSet._rebuild`` takes in
  place of an in-process rebuild).
* **weights once per card** (where JAX maps a checkpoint once per host):
  the router's weight tensors ride in the spawn arguments
  (``WorkerSpec.factory_kwargs["params"]``), which pickle through the
  reductions ``torch.multiprocessing`` registers, so a CUDA tensor reaches
  the worker as a CUDA IPC handle onto the router's memory (a CPU tensor as
  shared memory). The router holds the tensors for its life, so a worker's
  view stays valid across a sibling's SIGKILL and respawn; workers never
  write to them. A worker that :func:`worker_serve` starts on its own
  (``REPLICA_WORKERS``) loads or makes its own copy, as JAX's does. The
  router builds the CUDA kernels before it spawns, so a worker only loads
  the libraries.

**Router-side ticket shadowing**: the router mirrors every admitted but
unanswered request as a real ``_Ticket`` keyed by its RPC id; a request
leaves the shadow at its first answer frame (a stream's first token frame,
a generate's result). Once the fronting ``ReplicaSet`` supervises
(:meth:`ProcessReplica.enable_shadow_handoff`), a worker's death or
quarantine hands the shadowed tickets to a survivor through the set's
``_handoff_inbox`` → :meth:`ProcessReplica.adopt` instead of failing their
callers; a live quarantined worker names exactly its never-dispatched inbox
tickets. Without a supervising set, death fails fast, typed.

**Transports**: ``REPLICA_MODE=process`` runs the spawn pipe;
``REPLICA_MODE=socket`` runs the same frames over TCP
(``runtime/transport.py``): spawned workers register with the router's
``WorkerRegistry`` listener (:func:`worker_main_socket`), or the router
dials workers serving elsewhere (``REPLICA_WORKERS`` → :func:`worker_serve`).
Every (re)registration is a fresh **incarnation epoch** stamped into frame
headers, and the dispatcher drops stale-epoch frames. Socket liveness is
status staleness past ``partition_timeout_s``, a broken ping write or EOF;
recovery prefers **heal** (the live worker re-registers, keeping its warm
engine) over respawn.

**The elastic fleet**: a socket worker spawned with ``slot=-1`` (the
autoscaler's launcher) asks the registry for a slot and adopts the one the
``hello_ack`` grants, so every redial keeps that identity; the router wraps
the queued registration in a ``ProcessReplica(adopt_registration=True)``,
which neither spawned nor reaps the process (its close shuts the worker
down). A worker asked to :meth:`~ProcessReplica.request_leave` sends the
unsolicited **deregister** frame and keeps serving; the set's supervisor
sees :attr:`~ProcessReplica.deregister_requested` and retires it
gracefully (drain, handoff, close, slot release).

Semantic differences from thread mode, as in JAX: a stream's cancel reaches
the worker at chunk granularity; generates still shadowed at a worker's
death may run again on the survivor (no partial output ever reached their
caller); the worker's launch counts, graph captures and memory live in its
process and come back in :meth:`ProcessReplica.stats` under ``worker``.
"""

from __future__ import annotations

import logging
import os
import queue as _queue
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.models.moe import decoder_config, family
from sentio_tpu_torch.infra.exceptions import (
    DeadlineExceededError,
    ReplicaUnavailable,
    SentioError,
)
from sentio_tpu_torch.runtime.paged import PagedResult
from sentio_tpu_torch.runtime.service import StreamProgress, _Ticket, finish_ticket_error
from sentio_tpu_torch.runtime.transport import (
    DEFAULT_FRAME_TIMEOUT_S,
    DEFAULT_MAX_FRAME_BYTES,
    ClockSync,
    FrameProtocolError,
    PipeTransport,
    SocketTransport,
    TransportClosed,
    TransportError,
    dial,
    expect_hello,
    send_hello,
)

logger = logging.getLogger(__name__)

__all__ = [
    "WorkerSpec", "ProcessReplica", "worker_main", "worker_main_socket", "worker_serve",
    "default_service_factory", "REPLICA_MODE_THREAD", "REPLICA_MODE_PROCESS",
    "REPLICA_MODE_SOCKET", "STREAM_CHUNK_POINT",
]

REPLICA_MODE_THREAD = "thread"
REPLICA_MODE_PROCESS = "process"
REPLICA_MODE_SOCKET = "socket"

# the fault point a worker hits between two delivered stream chunks (drills
# arm a stall or kill_process there through the inject_fault RPC)
STREAM_CHUNK_POINT = "worker.stream_chunk"

# worker → router frame kinds (req_id 0 is reserved for unsolicited frames)
_F_READY = "ready"
_F_STATUS = "status"
_F_OK = "ok"
_F_ERR = "err"
_F_TOK = "tok"
_F_END = "end"
# low-priority unsolicited frames: the worker's cumulative metrics and duty
# snapshot every telemetry_interval_s; a pong answers a stamped ping with
# the worker's clock (one ClockSync sample)
_F_TELEMETRY = "telemetry"
_F_PONG = "pong"
# the elastic fleet: a voluntary deregister (req_id 0); the worker serves on
# until the router's supervisor retires it, so no in-flight work is dropped
_F_DEREGISTER = "deregister"

# the stats subset a telemetry frame carries; graph_captures stands where
# JAX's worker compiles stand (a capture is the port's compile)
_TELEMETRY_STAT_KEYS = (
    "phase_seconds", "duty_elapsed_s", "duty_cycle", "active_slots", "queued",
    "queued_inbox", "free_pages", "total_pages", "pool_hbm_bytes", "graph_captures",
)


@dataclass(frozen=True)
class WorkerSpec:
    """Everything a spawned worker needs to build its replica; pickled into
    the spawn arguments (tensors in ``factory_kwargs`` travel as IPC
    handles). ``factory`` is a ``"module:function"`` path resolved in the
    worker that returns a ready ``PagedGenerationService``."""

    factory: str = "sentio_tpu_torch.runtime.worker:default_service_factory"
    factory_kwargs: dict = field(default_factory=dict)
    # cadence of unsolicited status frames (the supervisor's probe source)
    status_interval_s: float = 0.1
    # cadence of telemetry frames; 0 turns the plane off (no telemetry
    # thread, no pongs, bare pings)
    telemetry_interval_s: float = 1.0
    # ---- socket transport ----
    auth_token: str = ""
    max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES
    frame_timeout_s: float = DEFAULT_FRAME_TIMEOUT_S
    # redial the registry with backoff when the link dies: each reconnection
    # is a fresh incarnation; reconnect_deadline_s of failed dials and the
    # worker exits rather than orphan itself
    reconnect: bool = False
    reconnect_backoff_s: float = 0.5
    reconnect_max_backoff_s: float = 5.0
    reconnect_deadline_s: float = 60.0
    # a socket worker that hears nothing from the router (requests, pings)
    # for this long treats the link as partitioned and redials; 0 = never
    router_silence_timeout_s: float = 3.0


def _resolve_factory(path: str):
    import importlib

    mod_name, _, fn_name = path.partition(":")
    if not fn_name:
        raise ValueError(f"factory {path!r} is not 'module:function'")
    return getattr(importlib.import_module(mod_name), fn_name)


def default_service_factory(
    model_family: str = "llama",
    model_config: Optional[dict] = None,
    checkpoint_path: str = "",
    tokenizer_path: str = "",
    draft_checkpoint_path: str = "",
    rng_seed: int = 0,
    engine_kwargs: Optional[dict] = None,
    service_kwargs: Optional[dict] = None,
    warm_prefix_text: str = "",
    params: Optional[dict] = None,
    draft_params: Optional[dict] = None,
    draft_config: Optional[dict] = None,
    device: Optional[str] = None,
) -> Any:
    """Build the worker's engine and service on ``device`` (the card by
    default). The weights are, in order: ``params`` (the router's tensors,
    shared through the spawn arguments), a ``checkpoint_path`` loaded here,
    or random ones from ``model_config`` of ``model_family`` (``llama`` or
    ``moe``) drawn as ``build_pipeline`` draws them (the family's init on a
    generator seeded ``rng_seed + 3`` on the device), so a worker started
    on its own from the same seed holds the same weights. A checkpoint must
    hold ``model_family`` (JAX's ``expect_family``). The draft likewise:
    ``draft_params`` + ``draft_config``, or ``draft_checkpoint_path`` (a
    llama model). ``tokenizer_path`` is the checkpoint's tokenizer
    directory, loaded here as the router loaded it (JAX's workers load it
    beside their checkpoint)."""
    import torch

    from sentio_tpu_torch import resolve_device
    from sentio_tpu_torch.models.llama import LlamaConfig
    from sentio_tpu_torch.models.moe import init_decoder
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
    from sentio_tpu_torch.runtime.service import PagedGenerationService
    from sentio_tpu_torch.runtime.weights import load_draft, load_model, load_tokenizer

    dev = resolve_device(device)
    cfg = decoder_config(model_family, model_config) if model_config is not None else None
    if params is None:
        if checkpoint_path:
            params, cfg = load_model(checkpoint_path, expect_family=model_family, device=dev)
        else:
            cfg = cfg or LlamaConfig.llama3_8b()
            gen = torch.Generator(device=dev)
            gen.manual_seed(rng_seed + 3)
            params = init_decoder(cfg, gen, dev)
    engine_kwargs = dict(engine_kwargs or {})
    if draft_params is not None:
        engine_kwargs.update(draft_params=draft_params,
                             draft_config=LlamaConfig(**draft_config))
    elif draft_checkpoint_path:
        dparams, dcfg = load_draft(draft_checkpoint_path, device=dev)
        engine_kwargs.update(draft_params=dparams, draft_config=dcfg)
    tokenizer = load_tokenizer(tokenizer_path, cfg)
    engine = ContinuousBatchingEngine(model_config=cfg, params=params, rng_seed=rng_seed,
                                      device=dev, tokenizer=tokenizer, **engine_kwargs)
    if warm_prefix_text:
        engine.warm_prefix(warm_prefix_text)
    return PagedGenerationService(engine, **(service_kwargs or {}))


# --------------------------------------------------------------------------
# exception codec: typed errors survive the process boundary

def _encode_exc(exc: BaseException) -> dict:
    data = {"cls": type(exc).__name__, "module": type(exc).__module__, "message": str(exc)}
    if isinstance(exc, SentioError):
        data.update(status=exc.status, details=exc.details, retryable=exc.retryable,
                    code=exc.code.value)
    return data


def _decode_exc(data: dict) -> BaseException:
    """Rebuild the worker's exception router-side: a ``SentioError``
    subclass with its status, details and retryability (so HTTP mapping and
    failover behave as in thread mode); the service's ``GenerationTimeout``
    and builtins by name; anything else a ``RuntimeError`` naming the type
    (a worker bug must not pass for a retryable 503)."""
    from sentio_tpu_torch.infra import exceptions as exc_mod
    from sentio_tpu_torch.runtime.service import GenerationTimeout

    name, message = data.get("cls", ""), data.get("message", "")
    cls = getattr(exc_mod, name, None)
    if isinstance(cls, type) and issubclass(cls, exc_mod.SentioError):
        err = cls.__new__(cls)
        Exception.__init__(err, message)
        err.message = message
        err.status = data.get("status", 500)
        err.details = data.get("details") or {}
        err.retryable = bool(data.get("retryable", False))
        err.error_id = ""
        err.timestamp = 0.0
        try:
            err.code = exc_mod.ErrorCode(data.get("code", cls.code.value))
        except ValueError:
            pass
        return err
    if name == "GenerationTimeout":
        return GenerationTimeout(message)
    import builtins

    builtin = getattr(builtins, name, None)
    if isinstance(builtin, type) and issubclass(builtin, Exception):
        try:
            return builtin(message)
        except Exception:  # noqa: BLE001 — an odd constructor signature
            pass
    return RuntimeError(f"worker raised {name}: {message}")


# --------------------------------------------------------------------------
# worker side

def _foreign_modules() -> list[str]:
    """Modules of the JAX package or of JAX loaded in this process (a
    worker must have none)."""
    roots = ("jax", "jaxlib", "flax", "optax", "sentio_tpu")
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in roots)


def worker_report(svc) -> dict:
    """The worker's own counters, which live in its process: each kernel
    wrapper's launches, on the card the device functions' own counts
    (``CudaKernel.device_launches``), the memory its allocator holds, its
    graphs, whether its engine is sanitized, and the foreign modules it
    loaded."""
    import torch

    from sentio_tpu_torch.kernels import KERNELS

    eng = svc.engine
    out: dict = {
        "pid": os.getpid(),
        "launches": {k.name: k.launches for k in KERNELS},
        "graph_variants": len(eng.graph_variants),
        "graphs_captured": len(getattr(eng, "_graphs", {})),
        "graphs_frozen": bool(eng.graphs_frozen),
        # the engine was built under SENTIO_SANITIZE=1 (inherited from the
        # router): its entry points and every tick check themselves
        "sanitized": eng._san is not None,
        "foreign_modules": _foreign_modules(),
    }
    if eng.device.type == "cuda":
        out["device_launches"] = {k.name: list(k.device_launches()) for k in KERNELS
                                  if k._fn is not None}
        out["memory"] = {"allocated": torch.cuda.memory_allocated(eng.device),
                         "reserved": torch.cuda.memory_reserved(eng.device),
                         "max_allocated": torch.cuda.max_memory_allocated(eng.device),
                         "max_reserved": torch.cuda.max_memory_reserved(eng.device)}
    return out


class _WorkerServer:
    """Runs in the child process: one recv loop handing RPC frames to
    handler threads, a status thread pushing liveness, a telemetry thread.
    Transport-agnostic: the spawn pipe and a TCP socket serve the same
    protocol. One instance serves ONE connection (incarnation); a socket
    worker's reconnect loop hands the built service to the next one."""

    def __init__(self, transport, spec: WorkerSpec, svc=None) -> None:
        self.transport = transport
        self.spec = spec
        self.svc = svc
        self._stop = threading.Event()
        # why run() returned: "shutdown", "link_lost" or "fatal"
        self.outcome = ""
        self._cancelled: set[int] = set()  # guarded-by: _cancel_lock
        self._cancel_lock = threading.Lock()
        # generate and stream handlers still sending their answers: a drain
        # replies only after their last frames (the router closes on it)
        self._answering = 0
        self._answered = threading.Condition()

    def _send(self, req_id: int, kind: str, payload: Any) -> None:
        try:
            self.transport.send((req_id, kind, payload))
        except TransportError:
            # the router link is gone: this incarnation stops
            self._stop.set()

    # ------------------------------------------------------------- handlers

    def _status_loop(self) -> None:
        interval = max(self.spec.status_interval_s, 0.02)
        due = time.perf_counter() + interval
        while not self._stop.wait(max(due - time.perf_counter(), 0.0)):
            # how late this wake-up ran (the GIL held elsewhere, the CPU
            # busy): what every RPC handler of this worker waits as well
            lag = time.perf_counter() - due
            due = time.perf_counter() + interval
            svc = self.svc
            if svc is None:
                continue
            try:
                status = {
                    "lag_s": lag,
                    "heartbeat_age": svc.heartbeat_age(), "backlog": svc.backlog(),
                    "projected_wait": svc.projected_wait(), "broken": svc.broken,
                    "closed": svc.closed, "tick_failure_count": svc.tick_failure_count,
                    "pump_leaked": svc.pump_leaked_count, "duty_cycle": svc.duty_cycle(),
                    "pid": os.getpid(),
                }
            except Exception:  # noqa: BLE001 — status is best-effort
                continue
            self._send(0, _F_STATUS, status)

    def _telemetry_loop(self) -> None:
        """The worker's CUMULATIVE metrics (the router differences them, so
        a lost frame loses nothing), the stats subset, the flight ring's
        high-water marks and the clock stamps, every
        ``telemetry_interval_s``."""
        from sentio_tpu_torch.infra.flight import get_flight_recorder
        from sentio_tpu_torch.infra.metrics import get_metrics

        interval = max(self.spec.telemetry_interval_s, 0.05)
        recorder = get_flight_recorder()
        while not self._stop.wait(interval):
            svc = self.svc
            if svc is None:
                continue
            try:
                stats = svc.stats()
            except Exception:  # noqa: BLE001 — stats mid-teardown
                stats = {}
            try:
                payload = {
                    "series": get_metrics().export_worker_series(),
                    "stats": {k: stats[k] for k in _TELEMETRY_STAT_KEYS if k in stats},
                    "flight": recorder.highwater(), "pid": os.getpid(),
                    "origin_s": recorder.origin(), "t_worker": time.perf_counter(),
                }
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                continue
            self._send(0, _F_TELEMETRY, payload)

    def _handle(self, req_id: int, method: str, kwargs: dict) -> None:
        if method not in ("generate", "stream_open"):
            self._dispatch(req_id, method, kwargs)
            return
        with self._answered:
            self._answering += 1
        try:
            self._dispatch(req_id, method, kwargs)
        finally:
            with self._answered:
                self._answering -= 1
                self._answered.notify_all()

    def _drain(self, deadline_s: float = 30.0) -> dict:
        """The service's drain, then up to the rest of its deadline (and a
        2 s grace for the typed errors of what it abandoned) for the
        answers' last frames: a stream's tail can trail its engine, and a
        reply sent ahead of it would let the router close on it."""
        t_end = time.perf_counter() + max(deadline_s, 0.0) + 2.0
        out = self.svc.drain(deadline_s=deadline_s)
        with self._answered:
            self._answered.wait_for(lambda: self._answering == 0,
                                    timeout=max(t_end - time.perf_counter(), 0.0))
        return out

    def _dispatch(self, req_id: int, method: str, kwargs: dict) -> None:
        svc = self.svc
        try:
            if method == "generate":
                self._send(req_id, _F_OK, svc.generate(**kwargs))
            elif method == "stream_open":
                self._handle_stream(req_id, kwargs)
            elif method == "check_admission":
                rel = kwargs.get("deadline_rel_s")
                svc.check_admission(time.perf_counter() + rel if rel is not None else None)
                self._send(req_id, _F_OK, None)
            elif method == "peek_prefix":
                self._send(req_id, _F_OK, svc.engine.peek_prefix(kwargs["toks"]))
            elif method == "stats":
                self._send(req_id, _F_OK, {**svc.stats(), "worker": worker_report(svc)})
            elif method == "warmup":
                out = svc.warmup(**kwargs)
                head = self.spec.factory_kwargs.get("warm_prefix_text")
                if head:
                    # warmup's own prompts can evict the template head
                    out["head_tokens"] = svc.warm_prefix(head)
                self._send(req_id, _F_OK, out)
            elif method == "wait_idle":
                self._send(req_id, _F_OK, svc.wait_idle(**kwargs))
            elif method == "drain":
                self._send(req_id, _F_OK, self._drain(**kwargs))
            elif method == "abandon":
                # admitted tickets fail typed in here (their err frames are
                # on their way); the inbox comes back by shadow id
                tickets = svc.abandon(kwargs.get("reason", "abandoned by router"))
                self._send(req_id, _F_OK, self._shadow_ids(tickets))
            elif method == "extract_inbox":
                self._send(req_id, _F_OK, self._shadow_ids(svc.extract_inbox()))
            elif method == "duty_cycle":
                self._send(req_id, _F_OK, svc.duty_cycle())
            elif method == "fetch_flight":
                from sentio_tpu_torch.infra.flight import get_flight_recorder

                recorder = get_flight_recorder()
                payload = {"pid": os.getpid(), "origin_s": recorder.origin(),
                           "t_worker": time.perf_counter()}
                if kwargs.get("t_tx") is not None:
                    # echoed: the reply doubles as a clock sample
                    payload["t_tx"] = kwargs["t_tx"]
                rid = kwargs.get("request_id")
                if rid is not None:
                    payload["record"] = recorder.get(rid)
                else:
                    payload["ticks"] = recorder.timeline(kwargs.get("last"))
                    payload["records"] = recorder.records()
                self._send(req_id, _F_OK, payload)
            elif method == "reset_duty_cycle":
                svc.reset_duty_cycle()
                self._send(req_id, _F_OK, None)
            elif method == "inject_fault":
                kwargs = dict(kwargs)
                point = kwargs.pop("point")
                faults.arm(point, faults.FaultRule(**kwargs))
                self._send(req_id, _F_OK, None)
            elif method == "reset_faults":
                faults.reset()
                self._send(req_id, _F_OK, None)
            elif method == "ping":
                self._send(req_id, _F_OK, os.getpid())
            elif method == "leave":
                # the deregister frame, then serving goes on: the router's
                # retire owns the drain, the handoff and the close
                self._send(0, _F_DEREGISTER, {"reason": kwargs.get("reason", "leave"),
                                              "pid": os.getpid()})
                self._send(req_id, _F_OK, None)
            else:
                raise ValueError(f"unknown worker method {method!r}")
        except BaseException as exc:  # noqa: BLE001 — every failure goes back typed
            self._send(req_id, _F_ERR, _encode_exc(exc))

    @staticmethod
    def _shadow_ids(tickets: list) -> list:
        return [t.shadow_id for t in tickets if t.shadow_id is not None]

    def _handle_stream(self, req_id: int, kwargs: dict) -> None:
        """Token frames of one stream, each ``(piece, token-id delta)`` so
        the router holds the delivered prefix a resume re-admits; the end
        frame carries the final ids. :data:`STREAM_CHUNK_POINT` is hit
        between delivered chunks."""
        stats_out: dict = {}
        progress = StreamProgress()
        it = self.svc.generate_stream(stats_out=stats_out, progress=progress, **kwargs)
        self._send(req_id, _F_OK, None)
        sent = 0
        delivered = False
        try:
            for piece in it:
                if delivered:
                    faults.hit(STREAM_CHUNK_POINT)
                with self._cancel_lock:
                    if req_id in self._cancelled:
                        self._cancelled.discard(req_id)
                        it.close()  # cancels the ticket
                        return
                toks = list(progress.tokens)
                self._send(req_id, _F_TOK, (piece, toks[sent:]))
                sent = len(toks)
                delivered = True
            self._send(req_id, _F_END, (stats_out, list(progress.tokens)))
        except BaseException as exc:  # noqa: BLE001 — every failure goes back typed
            self._send(req_id, _F_ERR, _encode_exc(exc))
        finally:
            with self._cancel_lock:
                self._cancelled.discard(req_id)

    # ----------------------------------------------------------------- main

    def run(self) -> str:
        """Serve this connection until shutdown or link loss; returns the
        outcome. The service is left open: its owner closes it."""
        if self.svc is None:
            try:
                self.svc = _resolve_factory(self.spec.factory)(**self.spec.factory_kwargs)
            except BaseException as exc:  # noqa: BLE001 — reported typed, then the worker exits
                logger.exception("worker service factory failed")
                self._send(0, _F_ERR, _encode_exc(exc))
                self.outcome = "fatal"
                return self.outcome
        eng = self.svc.engine
        import dataclasses

        self._send(0, _F_READY, {
            "pid": os.getpid(), "page_size": eng.page_size, "max_slots": eng.max_slots,
            "max_queue": self.svc.max_queue, "default_timeout_s": self.svc.default_timeout_s,
            "default_deadline_s": self.svc.default_deadline_s,
            "retry_budget": self.svc.retry_budget,
            "tick_stall_budget_s": self.svc.tick_stall_budget_s,
            "warmup_budget_s": self.svc.warmup_budget_s,
            "model_config": dataclasses.asdict(eng.cfg), "model_family": family(eng.cfg),
            "device": str(eng.device), "worker": worker_report(self.svc),
        })
        threading.Thread(target=self._status_loop, name="worker-status", daemon=True).start()
        if self.spec.telemetry_interval_s > 0:
            threading.Thread(target=self._telemetry_loop, name="worker-telemetry",
                             daemon=True).start()
        # router silence (socket links only): a half-open partition leaves
        # this side's reads idle while its writes still land
        silence_s = (self.spec.router_silence_timeout_s
                     if isinstance(self.transport, SocketTransport) else 0.0)
        poll_s = 0.25 if silence_s > 0 else None
        last_rx = time.perf_counter()
        self.outcome = "link_lost"
        while not self._stop.is_set():
            try:
                got = self.transport.recv(timeout_s=poll_s)
            except FrameProtocolError:
                if isinstance(self.transport, PipeTransport):
                    # a pipe keeps message boundaries: one bad frame does not
                    # poison the next
                    logger.exception("worker dropped an undecodable frame")
                    continue
                logger.exception("worker dropped the connection on a protocol error")
                break
            except TransportError:
                break  # the router died or closed
            if got is None:
                if silence_s > 0 and time.perf_counter() - last_rx > silence_s:
                    logger.warning("router silent for %.1fs; treating the link as partitioned",
                                   time.perf_counter() - last_rx)
                    break
                continue
            frame, _epoch = got
            last_rx = time.perf_counter()
            try:
                req_id, method, kwargs = frame
            except (TypeError, ValueError):
                self._send(0, _F_ERR, _encode_exc(FrameProtocolError(
                    f"malformed request frame: {frame!r}")))
                continue
            if method == "__shutdown__":
                self.outcome = "shutdown"
                break
            if method == "__ping__":
                # a stamped ping (telemetry on) gets a pong with this clock
                t_tx = kwargs.get("t_tx") if isinstance(kwargs, dict) else None
                if t_tx is not None:
                    from sentio_tpu_torch.infra.flight import get_flight_recorder

                    self._send(0, _F_PONG, {"t_tx": t_tx, "t_worker": time.perf_counter(),
                                            "origin_s": get_flight_recorder().origin(),
                                            "pid": os.getpid()})
                continue
            if method == "stream_cancel":
                with self._cancel_lock:
                    self._cancelled.add(int(kwargs["stream_id"]))
                continue
            threading.Thread(target=self._handle, args=(req_id, method, kwargs),
                             name=f"worker-rpc-{req_id}", daemon=True).start()
        self._stop.set()
        return self.outcome


def _close_and_exit(svc) -> None:
    if svc is not None:
        try:
            svc.close()
        except Exception:  # noqa: BLE001 — exiting anyway
            logger.exception("worker service close failed")
    # skip interpreter teardown: daemon threads (the pump, RPC handlers) may
    # still be inside a CUDA call
    os._exit(0)


def worker_main(conn, spec: WorkerSpec) -> None:
    """Child-process entry point of a ``process``-mode worker."""
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    logging.basicConfig(level=logging.WARNING)
    server = _WorkerServer(PipeTransport(conn), spec)
    server.run()
    _close_and_exit(server.svc)


def worker_main_socket(addr, spec: WorkerSpec, slot: int) -> None:
    """Child-process entry point of a ``socket``-mode worker: dial the
    router's registry, register (the versioned handshake grants an epoch),
    serve — and with ``spec.reconnect`` redial with exponential backoff
    whenever the link dies, a fresh incarnation each time (the engine and
    service survive). A definitive rejection ends the worker. ``slot=-1``
    is an elastic join: the worker adopts the slot the ack grants, for
    every redial and for its service's replica id."""
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    logging.basicConfig(level=logging.WARNING)
    svc = None
    backoff = max(spec.reconnect_backoff_s, 0.05)
    give_up_at = None
    while True:
        try:
            transport = dial(addr, max_frame_bytes=spec.max_frame_bytes,
                             frame_timeout_s=spec.frame_timeout_s, fault_scope="worker")
            ack = send_hello(transport, spec.auth_token, slot, os.getpid())
            acked = ack.get("slot") if isinstance(ack, dict) else None
            if isinstance(acked, int) and acked >= 0 and acked != slot:
                slot = acked
                service_kwargs = spec.factory_kwargs.get("service_kwargs")
                if isinstance(service_kwargs, dict):
                    service_kwargs["replica_id"] = slot
        except FrameProtocolError as exc:
            logger.error("worker registration rejected: %s", exc)
            break
        except TransportError as exc:
            now = time.perf_counter()
            if give_up_at is None:
                give_up_at = now + max(spec.reconnect_deadline_s, 1.0)
            if svc is None and not spec.reconnect:
                logger.error("worker registration failed: %s", exc)
                break
            if now >= give_up_at:
                logger.error("router unreachable for %.0fs; worker exiting",
                             spec.reconnect_deadline_s)
                break
            time.sleep(backoff)
            backoff = min(backoff * 2.0, spec.reconnect_max_backoff_s)
            continue
        give_up_at = None
        backoff = max(spec.reconnect_backoff_s, 0.05)
        server = _WorkerServer(transport, spec, svc=svc)
        outcome = server.run()
        svc = server.svc
        transport.close()
        if outcome in ("shutdown", "fatal") or not spec.reconnect:
            break
        logger.warning("worker slot %d lost its router link; redialing", slot)
    _close_and_exit(svc)


def _push_final_err(transport, exc: BaseException) -> None:
    """One unsolicited typed err frame outside any RPC loop."""
    transport.send((0, _F_ERR, _encode_exc(exc)))


def worker_serve(bind_host: str, bind_port: int, spec: WorkerSpec,
                 stop_event: Optional[threading.Event] = None, bound_cb=None) -> None:
    """An advertised worker (``REPLICA_WORKERS=host:port,...``): listen on
    ``bind_host:bind_port`` and serve router connections. The router dials
    in and authenticates (its hello carries the epoch it assigned). The
    accept loop keeps accepting while a connection is live: the newest
    handshake wins, the superseded link gets a typed final error and
    closes, and the one service (built once, on the accept thread, at the
    first connection) carries over. A router's ``__shutdown__`` closes the
    connection only: the worker belongs to its operator. ``bound_cb``
    receives the bound ``(host, port)``."""
    import socket as _socket

    stop = stop_event or threading.Event()
    listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    listener.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
    listener.settimeout(0.2)
    listener.bind((bind_host, int(bind_port)))
    listener.listen(4)
    if bound_cb is not None:
        bound_cb(listener.getsockname())
    svc = None
    current: dict = {"server": None, "transport": None, "thread": None}

    def _serve_conn(server: _WorkerServer, transport) -> None:
        try:
            server.run()
        except Exception:  # noqa: BLE001 — one connection, not the listener
            logger.exception("router connection serving crashed")
        finally:
            transport.close()

    try:
        while not stop.is_set():
            try:
                conn, _peer = listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                break
            transport = SocketTransport(conn, max_frame_bytes=spec.max_frame_bytes,
                                        frame_timeout_s=spec.frame_timeout_s,
                                        fault_scope="worker")
            try:
                hello = expect_hello(transport, spec.auth_token, timeout_s=10.0)
                epoch = int(hello.get("epoch", 0))
                transport.epoch = epoch
                transport.send((0, "hello_ack", {"epoch": epoch, "pid": os.getpid()}))
            except TransportError as exc:
                logger.warning("rejected router connection: %s", exc)
                transport.close()
                continue
            except Exception:  # noqa: BLE001 — a hostile hello must not kill the listener
                logger.exception("router handshake crashed; connection dropped")
                transport.close()
                continue
            if svc is None:
                try:
                    svc = _resolve_factory(spec.factory)(**spec.factory_kwargs)
                except BaseException as exc:  # noqa: BLE001 — reported typed; the listener ends
                    logger.exception("worker service factory failed")
                    try:
                        _push_final_err(transport, exc)
                    except TransportError:
                        pass
                    transport.close()
                    break
            prev = current["server"]
            if prev is not None and not prev._stop.is_set():
                try:
                    _push_final_err(current["transport"], ReplicaUnavailable(
                        "superseded by a newer router connection", retryable=False))
                except TransportError:
                    pass  # the stale link is already dead
                prev._stop.set()
                current["transport"].close()
            if current["thread"] is not None:
                current["thread"].join(timeout=5.0)
            server = _WorkerServer(transport, spec, svc=svc)
            thread = threading.Thread(target=_serve_conn, args=(server, transport),
                                      name="worker-serve-conn", daemon=True)
            current.update(server=server, transport=transport, thread=thread)
            thread.start()
    finally:
        try:
            listener.close()
        except OSError:
            pass
        server = current["server"]
        if server is not None:
            server._stop.set()
            current["transport"].close()
            if current["thread"] is not None:
                current["thread"].join(timeout=5.0)
        if svc is not None:
            try:
                svc.close()
            except Exception:  # noqa: BLE001 — shutting down anyway
                logger.exception("worker service close failed")


# --------------------------------------------------------------------------
# router side

class _PendingCall:
    __slots__ = ("q", "streaming")

    def __init__(self, streaming: bool = False) -> None:
        self.q: _queue.Queue = _queue.Queue()
        # a stream stays registered past its open ack: its token frames
        # reuse the req_id
        self.streaming = streaming


class _EngineFacade:
    """The engine surface the router touches on a replica: the routing
    probe, the tokenizer, the geometry and the model config (``/info``)."""

    def __init__(self, owner: "ProcessReplica", tokenizer, ready: dict) -> None:
        self._owner = owner
        self.tokenizer = tokenizer
        self.page_size = ready["page_size"]
        self.max_slots = ready["max_slots"]
        self.cfg = decoder_config(ready["model_family"], ready["model_config"])

    def peek_prefix(self, toks) -> int:
        return self._owner._peek_prefix(toks)


class ProcessReplica:
    """Router-side shim over one worker process with the
    ``PagedGenerationService`` surface. The worker pushes status frames
    every ``spec.status_interval_s``; every probe (``backlog``,
    ``heartbeat_age``, ``broken``...) reads the last one. Death is seen at
    EOF on the transport, a dead process, a worker-reported ``broken`` or
    (socket) status frames stale past ``partition_timeout_s``; pending calls
    then fail with a typed :class:`ReplicaUnavailable`, or, with shadow
    handoff on, shadowed tickets wait for the supervisor's handoff."""

    def __init__(self, spec: WorkerSpec, tokenizer, replica_id: int = 0,
                 build_timeout_s: float = 600.0, transport_mode: str = REPLICA_MODE_PROCESS,
                 registry=None, connect_addr: Optional[tuple] = None,
                 partition_timeout_s: float = 2.0, ping_interval_s: float = 0.5,
                 heal_grace_s: float = 5.0, adopt_registration: bool = False,
                 _adopt_state: Optional[dict] = None) -> None:
        self.spec = spec
        self.replica_id = replica_id
        self.build_timeout_s = build_timeout_s
        self._tokenizer = tokenizer
        self._transport_mode = (REPLICA_MODE_SOCKET if transport_mode == REPLICA_MODE_SOCKET
                                else REPLICA_MODE_PROCESS)
        self._registry = registry
        self._connect_addr = connect_addr
        self.partition_timeout_s = max(float(partition_timeout_s), 0.0)
        self.ping_interval_s = max(float(ping_interval_s), 0.0)
        self.heal_grace_s = max(float(heal_grace_s), 0.0)
        if self._transport_mode == REPLICA_MODE_SOCKET and registry is None:
            raise ValueError("socket transport needs a WorkerRegistry (it owns the "
                             "incarnation epochs and the stale-frame fence)")
        self._mutex = threading.Lock()
        self._calls: dict[int, _PendingCall] = {}  # guarded-by: _mutex
        self._next_id = 1  # guarded-by: _mutex
        # the router-side shadow of unanswered generates and streams, by RPC
        # id; passive until a supervising set enables handoff
        self._handoff_enabled = False  # guarded-by: _mutex
        self._shadow: dict[int, tuple[_Ticket, _PendingCall]] = {}  # guarded-by: _mutex
        # tickets adopted from a dead sibling: the dispatcher finishes them
        self._adopted: dict[int, dict] = {}  # guarded-by: _mutex
        self._dead = False  # guarded-by: _mutex
        self._death_reason = ""  # guarded-by: _mutex
        self._death_kind = ""  # guarded-by: _mutex
        self._closed = False  # guarded-by: _mutex
        self._status: dict = {}
        self._status_ts = 0.0
        self._last_stats: dict = {}
        self._telemetry: dict = {}
        self._telemetry_ts = 0.0
        self._worker_origin_s: Optional[float] = None
        # the reason of the worker's voluntary deregister frame (None until
        # one arrives; written by the dispatcher only)
        self._deregister_reason: Optional[str] = None
        # the routing probe's outcomes (answered, skipped on a stale status,
        # failed or timed out), its slowest answer, and the largest status
        # lag a worker reported: how fresh the router's view of it is
        self._peeks = {"answered": 0, "stale": 0, "failed": 0}
        # the generates and streams this router has in flight on the worker
        # (RPC ids): the routing backlog, exact at each decision
        self._work: set[int] = set()
        self._peek_max_s = 0.0
        self._status_lag_max_s = 0.0
        self._clock = ClockSync()
        self.epoch = 0  # this connection's incarnation epoch (socket)
        self._proc = None
        self._transport = None
        if _adopt_state is not None:
            # heal: a live worker re-registered; keep its process
            self._proc = _adopt_state.get("proc")
            self._transport = _adopt_state["transport"]
            self.epoch = _adopt_state["epoch"]
        elif self._transport_mode == REPLICA_MODE_PROCESS:
            ctx = _spawn_context()
            conn, child_conn = ctx.Pipe()
            self._proc = ctx.Process(target=worker_main, args=(child_conn, spec),
                                     name=f"sentio-replica-worker-{replica_id}", daemon=True)
            self._proc.start()
            child_conn.close()  # the worker holds its own end
            self._transport = PipeTransport(conn)
        elif connect_addr is not None:
            # REPLICA_WORKERS: the router dials and owns the epoch
            self._transport, self.epoch = self._dial_advertised(build_timeout_s)
        elif adopt_registration:
            # an elastic join: the worker already registered (slot -1) and
            # holds the granted slot; its process is not this shim's to reap
            self._transport, _hello, self.epoch = registry.await_registration(
                replica_id, build_timeout_s)
        else:
            ctx = _spawn_context()
            self._proc = ctx.Process(target=worker_main_socket,
                                     args=(tuple(registry.address), spec, replica_id),
                                     name=f"sentio-replica-worker-{replica_id}", daemon=True)
            self._proc.start()
            try:
                self._transport, _hello, self.epoch = registry.await_registration(
                    replica_id, build_timeout_s)
            except BaseException:
                self._reap(join_timeout_s=5.0)
                raise
        # registered before the dispatcher starts, so a factory that fails
        # at once cannot race its err frame past an unregistered req_id 0
        ready_call = _PendingCall()
        self._calls[0] = ready_call
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name=f"replica-worker-rx-{replica_id}", daemon=True)
        self._dispatcher.start()
        ready = self._wait_ready(ready_call, build_timeout_s)
        self.ready_info = ready
        self.engine = _EngineFacade(self, tokenizer, ready)
        self.max_queue = ready["max_queue"]
        self.default_timeout_s = ready["default_timeout_s"]
        self.default_deadline_s = ready["default_deadline_s"]
        self.retry_budget = ready["retry_budget"]
        self.tick_stall_budget_s = ready["tick_stall_budget_s"]
        self.warmup_budget_s = ready["warmup_budget_s"]
        if self._transport_mode == REPLICA_MODE_SOCKET:
            # pings feed the worker's silence watch, and a ping whose write
            # breaks is the broken-write death; the handshake is the
            # partition detector's first baseline
            self._status_ts = time.perf_counter()
            if self.ping_interval_s > 0:
                threading.Thread(target=self._ping_loop,
                                 name=f"replica-worker-ping-{replica_id}", daemon=True).start()

    def _dial_advertised(self, build_timeout_s: float):
        """Dial a ``REPLICA_WORKERS`` worker with backoff; the registry
        assigns the epoch the hello carries. A rejected handshake fails at
        once (configuration, not a network fault)."""
        deadline = time.perf_counter() + max(build_timeout_s, 1.0)
        backoff = 0.25
        last: Optional[Exception] = None
        while time.perf_counter() < deadline:
            transport = None
            try:
                transport = dial(self._connect_addr, max_frame_bytes=self.spec.max_frame_bytes,
                                 frame_timeout_s=self.spec.frame_timeout_s,
                                 fault_scope=f"r{self.replica_id}")
                epoch = self._registry.assign_epoch(self.replica_id)
                send_hello(transport, self.spec.auth_token, self.replica_id, os.getpid(),
                           epoch=epoch)
                return transport, epoch
            except FrameProtocolError as exc:
                if transport is not None:
                    transport.close()
                raise ReplicaUnavailable(
                    f"advertised worker {self._connect_addr} rejected the handshake: {exc}",
                    retryable=False,
                    details={"replica": self.replica_id, "reason": "handshake_rejected"},
                ) from exc
            except TransportError as exc:
                last = exc
                if transport is not None:
                    transport.close()
                time.sleep(min(backoff, max(deadline - time.perf_counter(), 0.0)))
                backoff = min(backoff * 2.0, 5.0)
        raise ReplicaUnavailable(
            f"advertised worker {self._connect_addr} unreachable within "
            f"{build_timeout_s:.0f}s: {last}", retry_after_s=2.0,
            details={"replica": self.replica_id, "reason": "dial_failed"})

    def _ping_loop(self) -> None:
        stamp = self.spec.telemetry_interval_s > 0
        while True:
            time.sleep(self.ping_interval_s)
            with self._mutex:
                if self._dead or self._closed:
                    return
            try:
                self._send_frame((0, "__ping__", {"t_tx": time.perf_counter()} if stamp else {}))
            except (TransportError, OSError):
                self._on_death("worker link broken on ping (broken write)", kind="partition")
                return

    # ------------------------------------------------------------- plumbing

    def _wait_ready(self, call: _PendingCall, timeout_s: float) -> dict:
        try:
            kind, payload = call.q.get(timeout=timeout_s)
        except _queue.Empty:
            self.close()
            raise ReplicaUnavailable(f"worker did not come up within {timeout_s:.0f}s",
                                     retryable=False) from None
        if kind == _F_ERR:
            self.close()
            raise _decode_exc(payload)
        if kind != _F_READY:
            self.close()
            raise ReplicaUnavailable(f"worker handshake sent {kind!r} before ready",
                                     retryable=False)
        return payload

    def _dispatch_loop(self) -> None:
        transport = self._transport
        while True:
            try:
                got = transport.recv()
            except TransportError as exc:
                # the read side is spent: close it so a dead incarnation
                # parks no open descriptor
                transport.close()
                self._on_death(f"worker connection lost: {exc}")
                return
            frame, epoch = got
            if self._registry is not None and \
                    epoch != self._registry.current_epoch(self.replica_id):
                # the incarnation fence: a frame of an earlier incarnation
                # (buffered behind a partition that healed) is counted, never
                # delivered
                self._registry.note_stale_frame(self.replica_id)
                continue
            req_id, kind, payload = frame
            if kind == _F_STATUS:
                self._status = payload
                self._status_ts = time.perf_counter()
                self._status_lag_max_s = max(self._status_lag_max_s,
                                             float(payload.get("lag_s") or 0.0))
                continue
            if kind == _F_TELEMETRY:
                self._ingest_telemetry(payload, epoch)
                continue
            if kind == _F_PONG:
                self._ingest_pong(payload)
                continue
            if kind == _F_DEREGISTER:
                # a voluntary leave, latched for the supervisor's retire
                reason = (payload.get("reason", "deregister") if isinstance(payload, dict)
                          else "deregister")
                self._deregister_reason = str(reason)
                logger.info("replica %d worker requested deregistration (%s)",
                            self.replica_id, reason)
                continue
            call = None
            with self._mutex:
                adopted = self._adopted.get(req_id)
                if adopted is not None:
                    if kind in (_F_ERR, _F_END) or (kind == _F_OK and not adopted["streaming"]):
                        self._adopted.pop(req_id, None)
                else:
                    call = self._calls.get(req_id)
                    if call is not None and (kind in (_F_ERR, _F_END, _F_READY)
                                             or (kind == _F_OK and not call.streaming)):
                        self._calls.pop(req_id, None)
                    # a request leaves the shadow at its first answer frame
                    # (a stream's open ack only means the iterator exists)
                    if kind in (_F_TOK, _F_END, _F_ERR) or (
                            kind == _F_OK and call is not None and not call.streaming):
                        self._shadow.pop(req_id, None)
            if adopted is not None:
                self._finish_adopted(adopted, kind, payload)
            elif call is not None:
                call.q.put((kind, payload))

    def _on_death(self, reason: str, *, process_death: bool = True,
                  keep_shadow: Optional[bool] = None, kind: str = "") -> None:
        """Latch dead and wake every waiter, except shadowed ones while
        handoff is on: their tickets wait for the supervisor to hand them
        to a survivor. ``kind="partition"`` marks a link death of a worker
        that may be alive: the rebuild then waits for it to re-register."""
        with self._mutex:
            if self._dead:
                return
            self._dead = True
            self._death_reason = reason
            self._death_kind = kind
            keep = (self._handoff_enabled and not self._closed
                    if keep_shadow is None else keep_shadow)
            shadow_entries: list[tuple[_Ticket, _PendingCall]] = []
            if keep:
                for rid in self._shadow:
                    self._calls.pop(rid, None)
            else:
                for rid, entry in list(self._shadow.items()):
                    self._calls.pop(rid, None)
                    shadow_entries.append(entry)
                self._shadow.clear()
            adopted = list(self._adopted.values())
            self._adopted.clear()
            pending = list(self._calls.values())
            self._calls.clear()
            closed = self._closed
        exc = self._death_error()
        payload = _encode_exc(exc)
        for call in pending:
            call.q.put((_F_ERR, payload))
        for ticket, call in shadow_entries:
            call.q.put((_F_ERR, payload))
            finish_ticket_error(ticket, exc, "failed_over")
        for state in adopted:
            finish_ticket_error(state["ticket"], exc, "failed_over")
        if not closed:
            logger.warning("replica %d worker died: %s", self.replica_id, reason)
            if process_death:
                try:
                    from sentio_tpu_torch.infra.metrics import get_metrics

                    get_metrics().record_worker_death(self.replica_id)
                except Exception:  # noqa: BLE001 — telemetry is best-effort
                    pass

    def _death_error(self) -> ReplicaUnavailable:
        reason = self._death_reason or "killed"
        return ReplicaUnavailable(f"replica worker process died: {reason}", retry_after_s=2.0,
                                  details={"replica": self.replica_id, "reason": "worker_dead"})

    def _send_frame(self, frame: tuple) -> None:
        self._transport.send(frame)

    def _call(self, method: str, kwargs: dict, timeout_s: Optional[float],
              shadow_ticket: Optional[_Ticket] = None, work: bool = False) -> Any:
        """One blocking RPC. A dead worker, before or during the call, or
        one silent past ``timeout_s`` raises the typed death error. With a
        ``shadow_ticket`` (handoff on) the call is mirrored: a handoff wakes
        it with ``("handoff", ticket)`` and it waits on the ticket."""
        call = _PendingCall()
        shadowed = False
        with self._mutex:
            if self._dead:
                raise self._death_error()
            req_id = self._next_id
            self._next_id += 1
            self._calls[req_id] = call
            if work:
                self._work.add(req_id)
            if shadow_ticket is not None and self._handoff_enabled:
                shadow_ticket.shadow_id = req_id
                self._shadow[req_id] = (shadow_ticket, call)
                kwargs = {**kwargs, "shadow_id": req_id}
                shadowed = True
        try:
            t0 = time.perf_counter()
            try:
                self._send_frame((req_id, method, kwargs))
            except (TransportClosed, BrokenPipeError, OSError):
                self._on_death("worker pipe broken on send")
                if not shadowed:
                    with self._mutex:
                        self._calls.pop(req_id, None)
                    raise self._death_error() from None
                # shadowed: the worker never saw it; the handoff wakes us below
            wait = timeout_s if timeout_s and timeout_s > 0 else None
            try:
                kind, payload = call.q.get(timeout=wait)
            except _queue.Empty:
                with self._mutex:
                    self._calls.pop(req_id, None)
                    # unanswered and not handed off: a late handoff must not
                    # run work whose caller left
                    self._shadow.pop(req_id, None)
                raise ReplicaUnavailable(
                    f"worker RPC {method!r} unanswered after {timeout_s:.0f}s",
                    retry_after_s=2.0,
                    details={"replica": self.replica_id, "reason": "rpc_timeout"}) from None
            if kind == "handoff":
                ticket: _Ticket = payload
                remaining = (max(wait - (time.perf_counter() - t0), 1.0)
                             if wait is not None else None)
                if not ticket.event.wait(remaining):
                    raise ReplicaUnavailable(
                        f"handed-off {method!r} unanswered after {timeout_s:.0f}s",
                        retry_after_s=2.0,
                        details={"replica": self.replica_id, "reason": "handoff_timeout"})
                if ticket.error is not None:
                    raise ticket.error
                return ticket.result
            if kind == _F_ERR:
                raise _decode_exc(payload)
            return payload
        finally:
            with self._mutex:
                self._work.discard(req_id)

    @staticmethod
    def _rel_deadline(deadline_s: Optional[float],
                      deadline_ts: Optional[float]) -> Optional[float]:
        """Clocks do not compare across processes: an absolute deadline
        crosses as remaining seconds. An expired one raises here (a
        non-positive remainder would read as the no-deadline opt-out)."""
        if deadline_ts is not None:
            rel = deadline_ts - time.perf_counter()
            if rel <= 0:
                raise DeadlineExceededError("deadline expired before submit")
            return rel
        return deadline_s

    # ------------------------------------------------------------------ api

    def generate(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                 timeout_s: Optional[float] = None, request_id: Optional[str] = None,
                 deadline_s: Optional[float] = None, deadline_ts: Optional[float] = None,
                 top_k: int = 0, tenant: Optional[str] = None, priority: Optional[str] = None,
                 cost_tokens: int = 0, seed: Optional[int] = None):
        wait = (timeout_s or self.default_timeout_s) + 30.0
        rel = self._rel_deadline(deadline_s, deadline_ts)
        shadow = None
        if self._handoff_enabled:
            shadow = _Ticket(prompt, max_new_tokens, temperature, top_k=top_k,
                             request_id=request_id, t_submit=time.perf_counter(),
                             deadline_ts=(time.perf_counter() + rel if rel else None),
                             tenant=tenant, priority=priority, cost_tokens=int(cost_tokens),
                             seed=seed)
        result = self._call("generate", dict(
            prompt=prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            timeout_s=timeout_s, request_id=request_id, deadline_s=rel, top_k=top_k,
            tenant=tenant, priority=priority, cost_tokens=cost_tokens, seed=seed,
        ), timeout_s=wait, shadow_ticket=shadow, work=True)
        if shadow is not None and shadow.result is result:
            return result  # handed off: the survivor stamped its replica
        result.replica_id = self.replica_id
        return result

    def generate_stream(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                        timeout_s: Optional[float] = None, request_id: Optional[str] = None,
                        deadline_s: Optional[float] = None,
                        deadline_ts: Optional[float] = None, top_k: int = 0,
                        tenant: Optional[str] = None, priority: Optional[str] = None,
                        cost_tokens: int = 0, stats_out: Optional[dict] = None,
                        prior_tokens: Optional[list] = None, seed: Optional[int] = None,
                        progress: Optional[StreamProgress] = None) -> Iterator[str]:
        """Lazy, as in thread mode: the ``stream_open`` RPC (admission and
        decode) waits for the first ``next()``, so the set may discard a
        not yet started iterator at no cost. The call-time ``top_k`` check
        moves to the first ``next()``. ``progress`` mirrors the token ids
        behind every piece; ``prior_tokens`` and ``seed`` reach the worker's
        service, so a resume works across the boundary."""
        wait = (timeout_s or self.default_timeout_s) + 30.0
        return self._stream_open_and_pump(dict(
            prompt=prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            timeout_s=timeout_s, request_id=request_id, deadline_s=deadline_s,
            deadline_ts=deadline_ts, top_k=top_k, tenant=tenant, priority=priority,
            cost_tokens=cost_tokens,
            prior_tokens=(list(prior_tokens) if prior_tokens else None), seed=seed,
        ), wait, stats_out, progress)

    def _stream_open_and_pump(self, req: dict, wait: float, stats_out: Optional[dict],
                              progress: Optional[StreamProgress]) -> Iterator[str]:
        # generator body: nothing runs before the first next()
        abs_deadline = req["deadline_ts"]
        req["deadline_s"] = self._rel_deadline(req.pop("deadline_s"), req.pop("deadline_ts"))
        if abs_deadline is None and req["deadline_s"]:
            abs_deadline = time.perf_counter() + req["deadline_s"]
        call = _PendingCall(streaming=True)
        shadowed = False
        with self._mutex:
            if self._dead:
                raise self._death_error()
            req_id = self._next_id
            self._next_id += 1
            self._calls[req_id] = call
            self._work.add(req_id)
            if self._handoff_enabled:
                # leaves the shadow at its first token frame: a stream that
                # delivered rides the set's resume, not the handoff
                ticket = _Ticket(req["prompt"], req["max_new_tokens"], req["temperature"],
                                 top_k=req["top_k"], stream_q=_queue.Queue(),
                                 request_id=req.get("request_id"), t_submit=time.perf_counter(),
                                 deadline_ts=abs_deadline, tenant=req.get("tenant"),
                                 priority=req.get("priority"),
                                 cost_tokens=int(req.get("cost_tokens") or 0),
                                 prior_tokens=req.get("prior_tokens"), seed=req.get("seed"),
                                 shadow_id=req_id)
                self._shadow[req_id] = (ticket, call)
                req["shadow_id"] = req_id
                shadowed = True
        try:
            try:
                self._send_frame((req_id, "stream_open", req))
            except (TransportClosed, BrokenPipeError, OSError):
                self._on_death("worker pipe broken on send")
                if not shadowed:
                    with self._mutex:
                        self._calls.pop(req_id, None)
                    raise self._death_error() from None
            try:
                kind, payload = call.q.get(timeout=wait)
            except _queue.Empty:
                with self._mutex:
                    self._calls.pop(req_id, None)
                    self._shadow.pop(req_id, None)
                raise ReplicaUnavailable(
                    f"worker stream open unanswered after {wait:.0f}s", retry_after_s=2.0,
                    details={"replica": self.replica_id, "reason": "rpc_timeout"}) from None
            if kind == "handoff":
                with self._mutex:
                    self._work.discard(req_id)  # a survivor serves it now
                yield from self._drain_adopted_stream(payload, wait, stats_out, progress)
                return
            if kind == _F_ERR:
                raise _decode_exc(payload)
            yield from self._stream_frames(req_id, call, wait, stats_out, progress)
        finally:
            with self._mutex:
                self._work.discard(req_id)

    def _stream_frames(self, req_id: int, call: _PendingCall, wait: float,
                       stats_out: Optional[dict],
                       progress: Optional[StreamProgress]) -> Iterator[str]:
        done = False
        emitted: list[int] = []
        try:
            while True:
                try:
                    kind, payload = call.q.get(timeout=wait)
                except _queue.Empty:
                    raise ReplicaUnavailable(
                        f"worker stream stalled for {wait:.0f}s", retry_after_s=2.0,
                        details={"replica": self.replica_id, "reason": "rpc_timeout"},
                    ) from None
                if kind == "handoff":
                    # moved to a survivor before any token frame
                    done = True
                    yield from self._drain_adopted_stream(payload, wait, stats_out, progress)
                    return
                if kind == _F_TOK:
                    piece, delta = payload
                    emitted.extend(delta)
                    if progress is not None:
                        # rebound before the yield, as the service's mirror
                        progress.tokens = list(emitted)
                    yield piece
                elif kind == _F_END:
                    done = True
                    stats, final_toks = payload
                    if progress is not None and final_toks is not None:
                        progress.tokens = list(final_toks)
                    if stats_out is not None and isinstance(stats, dict):
                        stats["replica_id"] = self.replica_id
                        stats_out.update(stats)
                    return
                else:  # _F_ERR
                    done = True
                    raise _decode_exc(payload)
        finally:
            with self._mutex:
                self._calls.pop(req_id, None)
                self._shadow.pop(req_id, None)
                dead = self._dead
            if not done and not dead:
                # the consumer left mid-stream: the worker cancels between
                # token frames
                try:
                    self._send_frame((0, "stream_cancel", {"stream_id": req_id}))
                except (TransportClosed, BrokenPipeError, OSError):
                    pass

    def _drain_adopted_stream(self, ticket: _Ticket, wait: float, stats_out: Optional[dict],
                              progress: Optional[StreamProgress]) -> Iterator[str]:
        """Consume a stream ticket a survivor adopted (its pump, or its
        adopting dispatcher, feeds ``ticket.stream_q``): nothing was
        delivered, so decoding starts clean, UTF-8 safe as the service's."""
        tokenizer = self._tokenizer
        emitted: list[int] = []
        flushed = ""
        done = False
        try:
            while True:
                try:
                    kind, payload = ticket.stream_q.get(timeout=wait)
                except _queue.Empty:
                    raise ReplicaUnavailable(
                        f"handed-off stream stalled for {wait:.0f}s", retry_after_s=2.0,
                        details={"replica": self.replica_id, "reason": "handoff_timeout"},
                    ) from None
                if kind == "err":
                    done = True
                    raise payload
                if kind == "toks":
                    emitted.extend(payload)
                else:  # "done"
                    done = True
                    result = payload
                    if result.finish_reason == "error":
                        raise ReplicaUnavailable(
                            "paged decode failed mid-stream", retry_after_s=2.0,
                            details={"replica": self.replica_id, "reason": "mid_stream"})
                    emitted = list(result.tokens)
                    if stats_out is not None:
                        stats_out.update(result.stats_dict())
                if progress is not None:
                    progress.tokens = list(emitted)
                text = tokenizer.decode(emitted)
                if kind == "done":
                    if len(text) > len(flushed):
                        yield text[len(flushed):]
                    return
                safe = text[:-1] if text.endswith("�") else text
                if len(safe) > len(flushed):
                    yield safe[len(flushed):]
                    flushed = safe
        finally:
            # abandoned: the adopting side reads the flag (an expired ticket
            # is left to its deadline sweep)
            if not done and not (ticket.deadline_ts is not None
                                 and time.perf_counter() >= ticket.deadline_ts):
                ticket.cancelled = True

    def check_admission(self, deadline_ts: Optional[float] = None) -> None:
        self._call("check_admission",
                   {"deadline_rel_s": self._rel_deadline(None, deadline_ts)}, timeout_s=10.0)

    def _peek_prefix(self, toks) -> int:
        """Routing probe: never fails or stalls a request. A worker whose
        status is stale reads as a cold cache; a live one answers within a
        short timeout."""
        stale_after = max(10 * self.spec.status_interval_s, 0.5)
        if self._status_ts <= 0.0 or time.perf_counter() - self._status_ts > stale_after:
            self._peeks["stale"] += 1
            return 0
        t0 = time.perf_counter()
        try:
            hit = int(self._call("peek_prefix", {"toks": list(toks)}, timeout_s=0.5))
        except Exception:  # noqa: BLE001 — the prefix peek is an optional routing hint
            self._peeks["failed"] += 1
            return 0
        self._peeks["answered"] += 1
        self._peek_max_s = max(self._peek_max_s, time.perf_counter() - t0)
        return hit

    def warmup(self, max_new_tokens: int = 4) -> dict:
        """The worker's service warmup (every graph variant captured in the
        worker), then the template head warmed again; ``head_tokens`` in the
        result."""
        return self._call("warmup", {"max_new_tokens": max_new_tokens},
                          timeout_s=self.build_timeout_s)

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        try:
            return bool(self._call("wait_idle", {"timeout_s": timeout_s},
                                   timeout_s=timeout_s + 10.0))
        except ReplicaUnavailable:
            return True  # a dead worker's pump is idle

    def backlog(self) -> int:
        """The generates and streams this router has in flight on the
        worker, adopted tickets included: exact at each routing decision
        (the worker's status frame is up to an interval old, and a burst
        routed inside one interval would all land on one worker)."""
        with self._mutex:
            return len(self._work) + len(self._adopted)

    def projected_wait(self) -> Optional[float]:
        """The worker's TTFT average (from its last status frame) scaled
        by the current backlog, as the service projects it."""
        status = self._status
        wait = status.get("projected_wait")
        if wait is None:
            return None
        slots = max(self.engine.max_slots, 1)
        ema = wait / (1.0 + int(status.get("backlog") or 0) / slots)
        return ema * (1.0 + self.backlog() / slots)

    def heartbeat_age(self) -> Optional[float]:
        """The worker's pump heartbeat age plus the status frame's own
        staleness; a worker whose status stopped while calls are pending
        is wedged itself, and that staleness is the age."""
        with self._mutex:
            if self._dead:
                return None
            pending = len(self._calls)
        if self._status_ts <= 0.0:
            return None
        stale = time.perf_counter() - self._status_ts
        age = self._status.get("heartbeat_age")
        if age is not None:
            return float(age) + stale
        interval = max(self.spec.status_interval_s, 0.02)
        if pending > 0 and stale > max(10 * interval, 2.0):
            return stale
        return None

    def duty_cycle(self) -> dict:
        return self._status.get("duty_cycle") or {"host": 0.0, "device": 0.0, "idle": 1.0}

    def reset_duty_cycle(self) -> None:
        try:
            self._call("reset_duty_cycle", {}, timeout_s=10.0)
        except Exception:  # noqa: BLE001 — telemetry re-basing, best-effort
            pass

    @property
    def broken(self) -> bool:
        with self._mutex:
            if self._dead:
                return True
        if self._proc is not None and not self._proc.is_alive():
            self._on_death(f"worker exited (code {self._proc.exitcode})")
            return True
        if self._transport_mode == REPLICA_MODE_SOCKET and self.partition_timeout_s > 0 \
                and self._status_ts > 0:
            # a half-open partition gives no EOF and no broken write here:
            # only the worker's status stream going silent
            stale = time.perf_counter() - self._status_ts
            if stale > self.partition_timeout_s:
                self._on_death(f"partition suspected: no worker frames for {stale:.1f}s "
                               f"(budget {self.partition_timeout_s:.1f}s)",
                               process_death=False, kind="partition")
                return True
        return bool(self._status.get("broken"))

    @property
    def closed(self) -> bool:
        with self._mutex:
            if self._closed:
                return True
        return bool(self._status.get("closed"))

    @property
    def deregister_requested(self) -> Optional[str]:
        """The reason of the worker's voluntary deregister frame, or None;
        the set's supervisor polls it."""
        return self._deregister_reason

    def request_leave(self, reason: str = "leave") -> None:
        """Ask the worker to send its deregister frame; it keeps serving
        until the supervisor's retire drains and closes it."""
        self._call("leave", {"reason": reason}, timeout_s=10.0)

    @property
    def tick_failure_count(self) -> int:
        return int(self._status.get("tick_failure_count") or 0)

    @property
    def pump_leaked_count(self) -> int:
        return int(self._status.get("pump_leaked") or 0)

    @property
    def pid(self) -> Optional[int]:
        if self._proc is not None:
            return self._proc.pid
        return self._status.get("pid") or self.ready_info.get("pid")

    @property
    def transport_mode(self) -> str:
        return self._transport_mode

    def _proc_alive(self) -> bool:
        if self._proc is not None:
            return self._proc.is_alive()
        with self._mutex:
            return not self._dead

    def _transport_stats(self) -> dict:
        if self._transport_mode != REPLICA_MODE_SOCKET:
            return {}
        out = {"transport": "socket", "incarnation": self.epoch}
        if self._registry is not None:
            out["stale_frames"] = self._registry.stale_frames(self.replica_id)
        return out

    def stats(self) -> dict:
        try:
            self._last_stats = self._call("stats", {}, timeout_s=10.0)
        except Exception:  # noqa: BLE001 — a dead worker: its last known stats
            out = {**self._last_stats, **self._transport_stats(), "replica": self.replica_id,
                   "worker_dead": 1}
            cached = (self._telemetry.get("stats") if self._telemetry else None) or {}
            for key in ("phase_seconds", "duty_elapsed_s", "duty_cycle"):
                if key not in out and key in cached:
                    out[key] = cached[key]
            return out
        self._last_stats.update(self._transport_stats())
        self._last_stats.update(self._clock_stats())
        self._last_stats["router_view"] = {
            "peeks": dict(self._peeks), "peek_max_s": round(self._peek_max_s, 4),
            "status_lag_max_s": round(self._status_lag_max_s, 4)}
        return self._last_stats

    # ------------------------------------------------------------ telemetry

    def _ingest_telemetry(self, payload: dict, epoch: int) -> None:
        """Merge the worker's cumulative series into the router's fleet
        families (epoch-fenced there), then cache the frame."""
        from sentio_tpu_torch.infra.metrics import get_metrics

        metrics = get_metrics()
        try:
            res = metrics.merge_worker_series(self.replica_id, payload.get("series") or {},
                                              epoch=epoch, pid=payload.get("pid"))
        except Exception:  # noqa: BLE001 — telemetry must not kill the dispatcher
            logger.debug("replica %d telemetry merge failed", self.replica_id, exc_info=True)
            return
        if not res.get("accepted"):
            return
        self._telemetry = payload
        self._telemetry_ts = time.perf_counter()
        origin = payload.get("origin_s")
        if origin is not None:
            self._worker_origin_s = float(origin)
        try:
            metrics.record_telemetry_age(self.replica_id, 0.0)
            stats = payload.get("stats") or {}
            for key in ("pool_hbm_bytes", "free_pages", "active_slots", "queued",
                        "graph_captures"):
                if stats.get(key) is not None:
                    metrics.set_replica_stat(self.replica_id, key, float(stats[key]))
        except Exception:  # noqa: BLE001 — gauges are best-effort
            pass

    def _ingest_pong(self, payload: dict) -> None:
        try:
            self._clock.add_sample(float(payload["t_tx"]), time.perf_counter(),
                                   float(payload["t_worker"]))
            origin = payload.get("origin_s")
            if origin is not None:
                self._worker_origin_s = float(origin)
        except (KeyError, TypeError, ValueError):
            pass

    def clock_sync(self) -> Optional[dict]:
        return self._clock.estimate()

    def telemetry_age(self) -> Optional[float]:
        """Seconds since the last accepted telemetry frame (None before
        one)."""
        if self._telemetry_ts <= 0:
            return None
        return time.perf_counter() - self._telemetry_ts

    def _clock_stats(self) -> dict:
        out: dict = {}
        age = self.telemetry_age()
        if age is not None:
            out["telemetry_age_s"] = round(age, 3)
        est = self._clock.estimate()
        if est is not None:
            out["clock_offset_s"] = round(est["offset_s"], 6)
            out["clock_uncertainty_s"] = round(est["uncertainty_s"], 6)
        return out

    def fetch_flight(self, request_id: Optional[str] = None, last: Optional[int] = None,
                     timeout_s: float = 5.0) -> dict:
        """The worker's flight data on demand: one request's record, or the
        tick window and record table. The reply echoes the transmit stamp,
        so each fetch is a clock sample too."""
        reply = self._call("fetch_flight", {"request_id": request_id, "last": last,
                                            "t_tx": time.perf_counter()}, timeout_s=timeout_s)
        t_rx = time.perf_counter()
        try:
            if reply.get("t_tx") is not None:
                self._clock.add_sample(float(reply["t_tx"]), t_rx, float(reply["t_worker"]))
            if reply.get("origin_s") is not None:
                self._worker_origin_s = float(reply["origin_s"])
        except (TypeError, ValueError, KeyError):
            pass
        reply.update(replica=self.replica_id, epoch=self.epoch, clock=self._clock.estimate())
        return reply

    def flight_shift_s(self, router_origin_s: float) -> tuple:
        """``(shift_s, uncertainty_s)`` mapping this worker's flight timeline
        onto the router's (``t_router = t_worker + shift``): each recorder
        stamps from its own ``perf_counter`` origin, so the shift is
        ``worker_origin - offset - router_origin`` (offset: the worker's
        clock minus the router's, from :class:`ClockSync`). The uncertainty
        is None until a clock sample exists (the offset then counts as
        0)."""
        if self._worker_origin_s is None:
            return 0.0, None
        est = self._clock.estimate()
        offset = est["offset_s"] if est else 0.0
        return (self._worker_origin_s - offset - router_origin_s,
                est["uncertainty_s"] if est else None)

    def cached_flight_lane(self, router_origin_s: float, status: str) -> dict:
        """A fleet-trace lane for this incarnation from its last telemetry
        frame, for a worker that is dead or retired (``fetch_flight`` no
        longer answers): usually name-only, so the incarnation stays on the
        fleet timeline marked ``status``."""
        shift, bound = self.flight_shift_s(router_origin_s)
        flight = (self._telemetry or {}).get("flight")
        ticks: list = []
        records: list = []
        if isinstance(flight, dict):
            ticks = list(flight.get("ticks") or [])
            records = list(flight.get("records") or [])
        return {"replica": self.replica_id, "epoch": self.epoch, "shift_s": shift,
                "uncertainty_s": bound, "ticks": ticks, "records": records,
                "status": status}

    # ------------------------------------------------ quarantine / handoff

    def enable_shadow_handoff(self) -> None:
        """Arm ticket shadowing; a supervising ``ReplicaSet`` calls it."""
        with self._mutex:
            self._handoff_enabled = True

    def _pop_shadow(self, ids: Optional[list] = None) -> list:
        """Take shadowed tickets (all, or exactly ``ids``) for handoff, wake
        their callers with the handoff sentinel and drop their calls, so a
        straggler frame of the old worker cannot answer twice."""
        entries: list[tuple[_Ticket, _PendingCall]] = []
        with self._mutex:
            take = (list(self._shadow) if ids is None
                    else [i for i in ids if i in self._shadow])
            for rid in take:
                entries.append(self._shadow.pop(rid))
                self._calls.pop(rid, None)
        out = []
        for ticket, call in entries:
            call.q.put(("handoff", ticket))
            out.append(ticket)
        return out

    def _fail_shadow(self, exc: ReplicaUnavailable) -> None:
        """A typed end for any shadowed or adopted residue (close())."""
        with self._mutex:
            entries = list(self._shadow.values())
            self._shadow.clear()
            adopted = list(self._adopted.values())
            self._adopted.clear()
        payload = _encode_exc(exc)
        for ticket, call in entries:
            call.q.put((_F_ERR, payload))
            finish_ticket_error(ticket, exc, "failed_over")
        for state in adopted:
            finish_ticket_error(state["ticket"], exc, "failed_over")

    def abandon(self, reason: str) -> list:
        """Stall quarantine: the worker (whose RPC loop outlives a wedged
        pump) abandons — admitted tickets fail typed in the worker, the
        inbox comes back by shadow id — then this shim latches dead. If the
        RPC fails, every shadowed ticket is handed off."""
        with self._mutex:
            dead = self._dead
            enabled = self._handoff_enabled
        ids: Optional[list] = None
        if not dead:
            try:
                ids = self._call("abandon", {"reason": reason}, timeout_s=10.0)
            except Exception as exc:  # noqa: BLE001 — latch and hand off below
                logger.warning("replica %d worker abandon RPC failed (%s: %s); latching dead "
                               "and handing off every shadowed ticket", self.replica_id,
                               type(exc).__name__, exc)
        tickets = self._pop_shadow(ids) if enabled else []
        self._on_death(f"abandoned: {reason}", process_death=not self._proc_alive(),
                       keep_shadow=False)
        return tickets

    def extract_inbox(self) -> list:
        """Quarantine handoff: a live worker names its never-dispatched
        inbox tickets; a dead one hands off every shadowed ticket."""
        with self._mutex:
            enabled = self._handoff_enabled
            dead = self._dead
        if not enabled:
            return []
        ids: Optional[list] = None
        if not dead and self._proc_alive():
            try:
                ids = self._call("extract_inbox", {}, timeout_s=10.0)
            except Exception:  # noqa: BLE001 — unresponsive is dead here
                logger.warning("replica %d extract_inbox RPC failed; handing off every "
                               "shadowed ticket", self.replica_id)
                ids = None
        return self._pop_shadow(ids)

    def adopt(self, ticket: _Ticket) -> None:
        """Admit a ticket handed off from a quarantined sibling on this
        worker. Its caller still waits on the ticket; the dispatcher
        finishes it from the worker's answer frames. A shed raises here."""
        self.check_admission(ticket.deadline_ts)
        streaming = ticket.stream_q is not None
        req = dict(prompt=ticket.prompt, max_new_tokens=ticket.max_new_tokens,
                   temperature=ticket.temperature, top_k=ticket.top_k, timeout_s=None,
                   request_id=ticket.request_id,
                   deadline_s=self._rel_deadline(None, ticket.deadline_ts),
                   tenant=ticket.tenant, priority=ticket.priority,
                   cost_tokens=ticket.cost_tokens, seed=ticket.seed)
        if streaming:
            req["prior_tokens"] = ticket.prior_tokens
        with self._mutex:
            if self._dead:
                raise self._death_error()
            req_id = self._next_id
            self._next_id += 1
            req["shadow_id"] = req_id
            self._adopted[req_id] = {"ticket": ticket, "emitted": [], "streaming": streaming,
                                     "req_id": req_id}
        try:
            self._send_frame((req_id, "stream_open" if streaming else "generate", req))
        except (TransportClosed, BrokenPipeError, OSError):
            with self._mutex:
                self._adopted.pop(req_id, None)
            self._on_death("worker pipe broken on adopt send")
            raise self._death_error() from None

    def _finish_adopted(self, state: dict, kind: str, payload) -> None:
        """The adopting dispatcher's side of :meth:`adopt`: the worker's
        answer frames into the ticket's end state (the ticket is this
        replica's alone: its old service is dead)."""
        ticket: _Ticket = state["ticket"]
        if kind == _F_OK:
            if state["streaming"]:
                return  # the open ack
            result = payload
            result.replica_id = self.replica_id
            if ticket.event.is_set():
                return
            ticket.result = result
            ticket.event.set()
        elif kind == _F_TOK:
            _piece, delta = payload
            state["emitted"].extend(delta)
            if ticket.cancelled and not state.get("cancel_sent"):
                # the consumer left: no pump here reads the flag, so forward
                # the worker's chunk-granular cancel
                state["cancel_sent"] = True
                try:
                    self._send_frame((0, "stream_cancel", {"stream_id": state["req_id"]}))
                except (TransportClosed, BrokenPipeError, OSError):
                    pass
            if ticket.stream_q is not None:
                ticket.stream_q.put(("toks", list(delta)))
        elif kind == _F_END:
            stats, final_toks = payload
            stats = stats if isinstance(stats, dict) else {}
            result = PagedResult(
                request_id=-1, text="",
                tokens=list(final_toks if final_toks is not None else state["emitted"]),
                prompt_tokens=0, finish_reason=str(stats.get("finish_reason") or "stop"),
                logprob_sum=float(stats.get("logprob_sum") or 0.0),
                logprob_min=float(stats.get("logprob_min") or 0.0),
                logprob_count=int(stats.get("logprob_count") or 0),
                replica_id=self.replica_id)
            if ticket.event.is_set():
                return
            ticket.result = result
            if ticket.stream_q is not None:
                ticket.stream_q.put(("done", result))
            ticket.event.set()
        else:  # _F_ERR
            exc = _decode_exc(payload)
            if not isinstance(exc, Exception):
                exc = RuntimeError(str(exc))
            finish_ticket_error(ticket, exc, "failed_over")

    # ------------------------------------------------------------ lifecycle

    def respawn(self) -> "ProcessReplica":
        """A fresh incarnation, the supervisor's rebuild. Pipe mode spawns
        a fresh process. Socket mode heals when the (link-partitioned)
        worker re-registers within ``heal_grace_s`` (its process, engine
        and graphs kept), else reaps it and spawns a fresh one; a dialed
        ``REPLICA_WORKERS`` worker is redialed."""
        if self._transport_mode == REPLICA_MODE_SOCKET:
            fresh = self._respawn_socket()
        else:
            fresh = ProcessReplica(self.spec, self._tokenizer, replica_id=self.replica_id,
                                   build_timeout_s=self.build_timeout_s)
        with self._mutex:
            enabled = self._handoff_enabled
        if enabled:
            fresh.enable_shadow_handoff()
        return fresh

    def _respawn_socket(self) -> "ProcessReplica":
        common = dict(replica_id=self.replica_id, build_timeout_s=self.build_timeout_s,
                      transport_mode=REPLICA_MODE_SOCKET, registry=self._registry,
                      partition_timeout_s=self.partition_timeout_s,
                      ping_interval_s=self.ping_interval_s, heal_grace_s=self.heal_grace_s)
        if self._connect_addr is not None:
            if self._transport is not None:
                self._transport.close()
            fresh = ProcessReplica(self.spec, self._tokenizer,
                                   connect_addr=self._connect_addr, **common)
            outcome = "reconnected"
        else:
            adopt = None
            if self._proc is not None and self._proc.is_alive() and self.heal_grace_s > 0:
                try:
                    transport, _hello, epoch = self._registry.await_registration(
                        self.replica_id, self.heal_grace_s)
                    adopt = {"proc": self._proc, "transport": transport, "epoch": epoch}
                except ReplicaUnavailable:
                    adopt = None
            if adopt is not None:
                fresh = ProcessReplica(self.spec, self._tokenizer, _adopt_state=adopt, **common)
                outcome = "heal"
                logger.info("replica %d healed: worker pid %s re-registered at epoch %d",
                            self.replica_id, fresh.pid, fresh.epoch)
            else:
                if self._transport is not None:
                    self._transport.close()
                self._reap(join_timeout_s=5.0)
                fresh = ProcessReplica(self.spec, self._tokenizer, **common)
                outcome = "respawn"
        try:
            from sentio_tpu_torch.infra.metrics import get_metrics

            get_metrics().record_worker_reconnect(outcome)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass
        return fresh

    def _reap(self, join_timeout_s: float = 5.0) -> None:
        """Make sure the local worker is gone: SIGTERM, then SIGKILL."""
        proc = self._proc
        if proc is None:
            return
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=max(join_timeout_s, 0.5))
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=max(join_timeout_s, 0.5))
        if not proc.is_alive():
            proc.join(timeout=0.1)

    def kill(self) -> None:
        """SIGKILL the worker: a real replica death."""
        if self._proc is not None and self._proc.pid:
            try:
                os.kill(self._proc.pid, signal.SIGKILL)
            except (ProcessLookupError, OSError):
                pass

    def inject_fault(self, point: str, **rule_kwargs) -> None:
        """Arm a fault rule in the worker's process (``kill_process=True``
        at :data:`STREAM_CHUNK_POINT` or ``paged.step`` is a SIGKILL
        there)."""
        self._call("inject_fault", {"point": point, **rule_kwargs}, timeout_s=10.0)

    def reset_faults(self) -> None:
        try:
            self._call("reset_faults", {}, timeout_s=10.0)
        except Exception:  # noqa: BLE001 — the worker may be dead already
            pass

    def _heal_candidate(self) -> bool:
        """A live, socket-spawned, reconnect-armed worker that died of a
        partition: its re-registration is awaited, not reaped."""
        with self._mutex:
            dead, kind = self._dead, self._death_kind
        return (self._transport_mode == REPLICA_MODE_SOCKET and self._connect_addr is None
                and self.spec.reconnect and dead and kind == "partition"
                and self._proc is not None and self._proc.is_alive())

    def drain(self, deadline_s: float = 30.0) -> dict:
        """The worker's graceful drain, then close. A partitioned worker
        that may heal gets no shutdown frame and is not reaped; its
        transport stays open so the pre-partition frames drain into the
        stale-frame fence."""
        heal = self._heal_candidate()
        result = {"drained": False, "abandoned": 0}
        if not heal:
            try:
                result = self._call("drain", {"deadline_s": deadline_s},
                                    timeout_s=deadline_s + 30.0)
            except Exception:  # noqa: BLE001 — a dead worker has nothing to drain
                pass
        self.close(join_timeout_s=max(deadline_s, 1.0), reap=not heal)
        return result

    def close(self, join_timeout_s: float = 10.0, reap: bool = True) -> None:
        """Shut the worker down and reap it (shutdown frame, SIGTERM,
        SIGKILL): a closed set leaks no process. A dialed worker's shutdown
        closes the connection only. ``reap=False`` is the heal window."""
        with self._mutex:
            self._closed = True
        proc = self._proc
        if reap:
            try:
                self._send_frame((0, "__shutdown__", {}))
            except (TransportClosed, BrokenPipeError, OSError):
                pass
            if proc is not None:
                proc.join(timeout=max(join_timeout_s, 0.5))
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
            if self._transport is not None:
                self._transport.close()
        self._on_death("closed", keep_shadow=False)
        # a death that kept the shadow for a handoff that never came
        self._fail_shadow(ReplicaUnavailable(
            "replica worker closed before handoff", retry_after_s=2.0,
            details={"replica": self.replica_id, "reason": "closed"}))


def _spawn_context():
    """``torch.multiprocessing``'s spawn context: its pickler reduces CUDA
    tensors to IPC handles and CPU tensors to shared memory."""
    import torch.multiprocessing as tmp

    return tmp.get_context("spawn")
