"""Continuous batching as the live decode path — the core of
``sentio_tpu/runtime/service.py::PagedGenerationService``.

Every caller's :meth:`~PagedGenerationService.generate` drops a ticket into
an inbox and blocks on its own event; one pump thread owns the
:class:`~sentio_tpu_torch.runtime.paged.ContinuousBatchingEngine` outright
— drain the inbox → admit → one decode tick → deliver — for as long as any
request is live. Concurrent callers therefore share decode ticks: a request
joins the slot batch at whatever step the others have reached.

Thread-safety: only the pump touches the engine. Submitters and the pump
meet at ``_mutex``, held for quick inbox and bookkeeping work, never across
a tick. A caller that drives the engine directly first waits for the pump
to stop (:meth:`~PagedGenerationService.wait_idle`).

Overload and failure, as in JAX:

* **admission control** — the inbox plus the admitted set is bounded by
  ``max_queue``; a submit past it, while draining, or whose deadline the
  projected wait (TTFT EMA × backlog) already exceeds raises a typed
  :class:`ServiceOverloaded` (or :class:`DeadlineExceededError`);
* **deadlines** — a request carries an absolute deadline; the pump drops
  expired tickets before admission and cancels expired admitted ones;
* **crash containment** — a failed tick resets the engine; when the reset
  works, innocent waiters are requeued (each ticket has a retry budget),
  and only exhausted ones get an ``error`` result; when it fails the
  service latches ``broken``;
* **graceful drain** — :meth:`~PagedGenerationService.drain` stops
  admitting and lets in-flight work finish within a deadline.

:meth:`~PagedGenerationService.warmup` runs before traffic: one admission
per prefill shape and tick rung, a concurrent burst, and on the card every
CUDA graph variant the engine can ask for, after which a capture under
traffic is an error. Each shed or expiry is counted in
``sentio_tpu_shed_total`` by reason and each pump iteration's phases in
``sentio_tpu_tick_phase_seconds`` (``infra/metrics.py``).

The replica-facing half (a fronting :class:`~sentio_tpu_torch.runtime.
replica.ReplicaSet`): each service has a ``replica_id``; the pump stamps a
heartbeat every loop iteration, which :meth:`~PagedGenerationService.
heartbeat_age` reports while work is pending (the stall watchdog's signal,
stood down during warmup up to ``warmup_budget_s``); tickets carry the
WFQ metadata (``tenant``, ``priority``, ``cost_tokens``) the quarantine
handoff needs; :meth:`~PagedGenerationService.extract_inbox`,
:meth:`~PagedGenerationService.adopt` and
:meth:`~PagedGenerationService.abandon` move never-dispatched tickets to a
sibling or give up on a wedged pump; a stream mirrors its delivered token
ids into a caller-owned :class:`StreamProgress` and admits ``prior_tokens``
after the prompt, which is how a stream is resumed on a survivor. The pump
runs on the engine's own CUDA stream (``engine.step`` enters it).

Telemetry, as in JAX: an admission under a ``request_id`` opens the
request's engine section on the flight recorder (``note_engine_submit``,
the replica id); every tick records one event before delivery — the
replica, the step's seconds, occupancy, queue and inbox depth, the tick's
prefill / decode / spec / prefix-hit / prefix-miss token deltas, the radix
cache's and the pool's pages, the overload totals and ``graph_captures``
(CUDA graphs captured in the tick, in place of JAX's ``xla_compiles``; 0
under traffic once warmup froze the graphs) — and amends it after delivery
with ``pump_ms`` and its ``phase_ms`` split (which sums to ``pump_ms``); a
failed tick records a ``tick_failure`` event with its partial phases.
Each admission's TTFT and TPOT (by ``path``: paged or stream) go to
``/metrics`` and, with its tokens and finish reason, to ``finish_engine``
on every path that ends a ticket (a result, an error, an expiry, a cancel,
a failed handoff, an abandon). Every field is a host integer or time the
engine already keeps: no device read. The telemetry is best-effort and
never stops the pump. With tracing on (``TRACING_ENABLED``) each
``engine.step()`` runs inside a ``record_function`` range
``decode_tick#N``.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

from sentio_tpu_torch.analysis.sanitizer import (
    assert_held,
    bind_engine_owner,
    guard_locksets,
    make_lock,
)
from sentio_tpu_torch.infra.exceptions import (
    DeadlineExceededError,
    ReplicaUnavailable,
    ServiceOverloaded,
)
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.infra.phases import TICK_PHASES, duty_fractions, phases_to_ms
from sentio_tpu_torch.infra.tracing import get_tracing
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, PagedResult

logger = logging.getLogger(__name__)

__all__ = ["PagedGenerationService", "GenerationTimeout", "ServiceOverloaded",
           "DeadlineExceededError", "ReplicaUnavailable", "StreamProgress",
           "finish_ticket_error"]


class GenerationTimeout(Exception):
    pass


class StreamProgress:
    """The token ids behind every text piece one stream has yielded so far.
    The stream rebinds ``tokens`` right before each yield (and to the
    result's tokens at completion), so a consumer that sees a yield, or
    catches the stream's mid-stream error, reads the exact delivered
    prefix: what a resume re-admits on a survivor as ``prior_tokens``.
    Producer and consumer are the same caller thread, so no lock."""

    __slots__ = ("tokens",)

    def __init__(self) -> None:
        self.tokens: list[int] = []

    def reset(self) -> None:
        self.tokens = []


@dataclass
class _Ticket:
    prompt: str
    max_new_tokens: int
    temperature: float
    top_k: int = 0
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[PagedResult] = None
    # terminal typed failure raised to the caller instead of a result
    error: Optional[Exception] = None
    # streaming callers: the pump pushes ("toks", [ids]) after each tick,
    # ("done", result) at retirement and ("err", exc) on a typed failure
    stream_q: Optional[_queue.Queue] = None
    sent_tokens: int = 0
    # the caller gave up (timeout, closed stream): the pump cancels it
    cancelled: bool = False
    deadline_ts: Optional[float] = None
    # requeues left after failed ticks whose engine reset worked
    retries_left: int = 0
    t_submit: float = 0.0
    t_first: float = 0.0
    # tokens visible when t_first was stamped: TPOT divides the interval
    # after it by the tokens made in it (a tick emits several at once)
    tokens_first: int = 0
    prior_tokens: Optional[list] = None
    seed: Optional[int] = None
    # the serving layer's flight-record id (None: untraced)
    request_id: Optional[str] = None
    # WFQ metadata a fronting ReplicaSet stamps; the service never reads
    # it, a quarantine handoff re-charges the reservation with it
    tenant: Optional[str] = None
    priority: Optional[str] = None
    cost_tokens: int = 0
    # the router's RPC id of a request a worker process serves (runtime/
    # worker.py): an inbox handoff names its tickets by it
    shadow_id: Optional[int] = None

    @property
    def path(self) -> str:
        """The TTFT / TPOT label: a blocking call or a stream."""
        return "stream" if self.stream_q is not None else "paged"


def finish_ticket_error(ticket: _Ticket, exc: Exception, finish_reason: str) -> None:
    """End a ticket with a typed error, exactly once: the error, the flight
    record's engine outcome, a stream's ``("err", exc)``, the event. The
    caller owns the ticket: it holds the owning service's mutex, or holds
    the ticket off every service's books (a quarantine handoff)."""
    if ticket.event.is_set():
        return
    ticket.error = exc
    if ticket.request_id:
        get_flight_recorder().finish_engine(ticket.request_id, finish_reason=finish_reason,
                                            error=str(exc))
    if ticket.stream_q is not None:
        ticket.stream_q.put(("err", exc))
    ticket.event.set()


@guard_locksets
class PagedGenerationService:
    """Thread-safe submit/wait facade and pump thread over the paged engine."""

    def __init__(self, engine: ContinuousBatchingEngine, default_timeout_s: float = 600.0,
                 max_queue: Optional[int] = None, default_deadline_s: Optional[float] = None,
                 retry_budget: int = 1, replica_id: int = 0,
                 tick_stall_budget_s: float = 120.0, warmup_budget_s: float = 600.0) -> None:
        self.engine = engine
        self.default_timeout_s = default_timeout_s
        # position in a ReplicaSet (0 for a standalone service)
        self.replica_id = int(replica_id)
        # a pump iteration longer than this with work pending reads as a
        # wedged dispatch to the watchdog (0 disables); warmup ticks are
        # exempt for up to warmup_budget_s (0: for all of warmup)
        self.tick_stall_budget_s = max(float(tick_stall_budget_s), 0.0)
        self.warmup_budget_s = max(float(warmup_budget_s), 0.0)
        # deep by default (8x the slots): shedding protects the tail against
        # pile-ups, it is not routine backpressure
        self.max_queue = (int(max_queue) if max_queue is not None
                          else max(8 * engine.max_slots, 64))
        self.default_deadline_s = default_deadline_s
        self.retry_budget = max(int(retry_budget), 0)
        # inbox and bookkeeping only, never device work
        self._mutex = make_lock("PagedGenerationService._mutex")
        self._inbox: list[_Ticket] = []  # guarded-by: _mutex
        self._tickets: dict[int, _Ticket] = {}  # guarded-by: _mutex
        self._pump: Optional[threading.Thread] = None  # guarded-by: _mutex
        self._pump_running = False  # guarded-by: _mutex
        self._closed = False  # guarded-by: _mutex
        self._broken = False  # guarded-by: _mutex
        self._draining = False  # guarded-by: _mutex
        self._shed = 0  # guarded-by: _mutex
        self._expired = 0  # guarded-by: _mutex
        self._cancelled = 0  # guarded-by: _mutex
        self._requeued = 0  # guarded-by: _mutex
        self._tick_failures = 0  # guarded-by: _mutex
        self._pump_leaked = 0  # guarded-by: _mutex
        # the pump's liveness stamp (perf_counter), set each loop iteration
        self._heartbeat_ts = 0.0  # guarded-by: _mutex
        # latched by abandon(): the replica tier gave up on a wedged pump
        self._abandoned = False  # guarded-by: _mutex
        # warmup in progress: the watchdog stands down (warmup_budget_s)
        self._warming = False  # guarded-by: _mutex
        self._warming_since = 0.0  # guarded-by: _mutex
        # the engine is lent to a caller's thread (warm_prefix): no pump
        # starts meanwhile, submits wait in the inbox
        self._engine_lent = False  # guarded-by: _mutex
        # EMA of recent TTFT seconds: the projected wait admission weighs
        # against a deadline
        self._ttft_ema = 0.0  # guarded-by: _mutex
        self._ticks = 0  # guarded-by: _mutex
        self._active_sum = 0  # guarded-by: _mutex
        self._max_active = 0  # guarded-by: _mutex
        # ticks that more than one request shared
        self._shared_ticks = 0  # guarded-by: _mutex
        self._completed = 0  # guarded-by: _mutex
        # cumulative seconds per phase, written by the pump only
        self._phase_totals = dict.fromkeys(TICK_PHASES, 0.0)  # guarded-by: pump-thread
        self._duty_t0 = time.perf_counter()  # guarded-by: pump-thread

    # ------------------------------------------------------------------ api

    def generate(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                 timeout_s: Optional[float] = None, deadline_s: Optional[float] = None,
                 deadline_ts: Optional[float] = None, top_k: int = 0,
                 seed: Optional[int] = None, request_id: Optional[str] = None,
                 tenant: Optional[str] = None, priority: Optional[str] = None,
                 cost_tokens: int = 0, shadow_id: Optional[int] = None) -> PagedResult:
        """Submit one request and block until it is done; any number of
        threads may call at once (that concurrency is the batch).
        ``deadline_ts`` (absolute ``time.perf_counter()``) or ``deadline_s``
        (relative) bound the wait: admission sheds an unmeetable deadline
        and the pump cancels the request once it passes. Raises
        :class:`ServiceOverloaded`, :class:`DeadlineExceededError` or
        :class:`GenerationTimeout`; with a draft on the engine, ``top_k > 0``
        raises ``ValueError``. ``tenant``, ``priority`` and ``cost_tokens``
        are a fronting ReplicaSet's WFQ metadata, kept on the ticket for a
        quarantine handoff (``shadow_id``, a worker's router-side RPC id,
        too); a bare service ignores them."""
        self._check_top_k(top_k)
        deadline_ts = self._resolve_deadline(deadline_s, deadline_ts)
        ticket = _Ticket(prompt, max_new_tokens, temperature, top_k=top_k,
                         t_submit=time.perf_counter(), deadline_ts=deadline_ts,
                         retries_left=self.retry_budget, seed=seed, request_id=request_id,
                         tenant=tenant, priority=priority, cost_tokens=int(cost_tokens),
                         shadow_id=shadow_id)
        self._submit(ticket)
        wait_s = self._wait_budget(timeout_s, deadline_ts)
        if not ticket.event.wait(wait_s):
            # completion happens under the mutex, so deciding under it is
            # race-free: work that finished after the wait is returned
            expired = deadline_ts is not None and time.perf_counter() >= deadline_ts
            with self._mutex:
                finished = ticket.event.is_set()
                # an expired ticket is the pump's to cancel and count
                if not finished and not expired:
                    ticket.cancelled = True
            if not finished:
                if expired:
                    raise DeadlineExceededError("deadline expired before the result was ready")
                raise GenerationTimeout(f"generation did not finish within {wait_s:.0f}s")
        if ticket.error is not None:
            raise ticket.error
        assert ticket.result is not None
        return ticket.result

    def generate_stream(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                        timeout_s: Optional[float] = None, deadline_s: Optional[float] = None,
                        deadline_ts: Optional[float] = None, top_k: int = 0,
                        stats_out: Optional[dict] = None,
                        prior_tokens: Optional[list] = None,
                        seed: Optional[int] = None, request_id: Optional[str] = None,
                        tenant: Optional[str] = None, priority: Optional[str] = None,
                        cost_tokens: int = 0,
                        progress: Optional[StreamProgress] = None,
                        shadow_id: Optional[int] = None) -> Iterator[str]:
        """Yield decoded text increments as the shared decode batch makes
        them (up to a tick's tokens at a time), UTF-8 safe. ``top_k`` is
        checked at the call; admission runs at the first ``next()``.
        ``stats_out`` gets the finished request's ``stats_dict()`` before
        the last piece; ``prior_tokens`` are admitted after the prompt as
        context already generated, and only what follows them is yielded;
        ``progress`` mirrors the token ids behind every yield. A deadline
        that passes mid-stream raises :class:`DeadlineExceededError` from
        the iterator; a decode failure after delivered tokens raises a
        typed :class:`ReplicaUnavailable`, which a fronting ReplicaSet
        resumes on a sibling."""
        # here, not in the generator body, which runs only at the first
        # next(): an SSE handler would have committed its 200 by then
        self._check_top_k(top_k)
        ticket = _Ticket(prompt, max_new_tokens, temperature, top_k=top_k,
                         stream_q=_queue.Queue(),
                         retries_left=self.retry_budget,
                         prior_tokens=list(prior_tokens) if prior_tokens else None, seed=seed,
                         request_id=request_id, tenant=tenant, priority=priority,
                         cost_tokens=int(cost_tokens), shadow_id=shadow_id)
        return self._stream(ticket, timeout_s, deadline_s, deadline_ts, stats_out, progress)

    def _stream(self, ticket: _Ticket, timeout_s: Optional[float],
                deadline_s: Optional[float], deadline_ts: Optional[float],
                stats_out: Optional[dict],
                progress: Optional[StreamProgress]) -> Iterator[str]:
        ticket.deadline_ts = deadline_ts = self._resolve_deadline(deadline_s, deadline_ts)
        ticket.t_submit = time.perf_counter()
        self._submit(ticket)
        tokenizer = self.engine.tokenizer
        wait_s = self._wait_budget(timeout_s, deadline_ts)
        emitted: list[int] = []
        flushed = ""
        try:
            while True:
                try:
                    kind, payload = ticket.stream_q.get(timeout=wait_s)
                except _queue.Empty:
                    if ticket.deadline_ts is not None \
                            and time.perf_counter() >= ticket.deadline_ts:
                        raise DeadlineExceededError(
                            "deadline expired before the stream produced anything") from None
                    raise GenerationTimeout(f"stream produced nothing for {wait_s:.0f}s") from None
                if kind == "err":
                    raise payload
                if kind == "toks":
                    emitted.extend(payload)
                else:  # "done"
                    result: PagedResult = payload
                    if result.finish_reason == "error":
                        # this service cannot restart a stream that has
                        # delivered tokens; a fronting ReplicaSet resumes it
                        # on a sibling from ``progress``
                        raise ReplicaUnavailable(
                            "paged decode failed mid-stream", retry_after_s=2.0,
                            details={"replica": self.replica_id, "reason": "mid_stream"})
                    emitted = list(result.tokens)
                    if stats_out is not None:
                        stats_out.update(result.stats_dict())
                if progress is not None:
                    # rebound before the yield: a consumer of this piece (or
                    # of this iteration's error) reads exactly its tokens
                    progress.tokens = list(emitted)
                text = tokenizer.decode(emitted)
                if kind == "done":
                    if len(text) > len(flushed):
                        yield text[len(flushed):]
                    return
                # hold back at most a trailing replacement character: it may
                # be an incomplete UTF-8 sequence the next token resolves
                safe = text[:-1] if text.endswith("�") else text
                if len(safe) > len(flushed):
                    yield safe[len(flushed):]
                    flushed = safe
        finally:
            # abandoned mid-decode: the pump cancels instead of decoding for
            # nobody (an expired stream is left to its deadline sweep)
            if ticket.result is None and ticket.error is None and not (
                    ticket.deadline_ts is not None
                    and time.perf_counter() >= ticket.deadline_ts):
                ticket.cancelled = True

    # ------------------------------------------------------------ admission

    def _submit(self, ticket: _Ticket) -> None:
        """Open the request's engine window on the flight recorder and admit
        the ticket; a refused admission closes the window again (an open
        one would absorb every later tick)."""
        recorder = get_flight_recorder()
        if ticket.request_id:
            recorder.note_engine_submit(ticket.request_id, replica_id=self.replica_id)
        try:
            with self._mutex:
                self._admit_ticket_locked(ticket)
        except Exception:
            if ticket.request_id:
                recorder.finish_engine(ticket.request_id, finish_reason="rejected")
            raise

    def _check_top_k(self, top_k: int) -> None:
        """The engine's submit-time rule, raised at the service's API instead
        of inside the pump."""
        if top_k > 0 and self.engine.draft_params is not None:
            raise ValueError("top_k sampling is not supported with paged speculation "
                             "(the spec tick's accept/correct rule is temperature-only)")

    def _resolve_deadline(self, deadline_s: Optional[float],
                          deadline_ts: Optional[float]) -> Optional[float]:
        """The absolute deadline from the caller's absolute or relative
        form, else the service default; a relative 0 or less means none."""
        if deadline_ts is not None:
            return deadline_ts
        rel = deadline_s if deadline_s is not None else self.default_deadline_s
        if rel is None or rel <= 0:
            return None
        return time.perf_counter() + rel

    def _wait_budget(self, timeout_s: Optional[float], deadline_ts: Optional[float]) -> float:
        """How long a caller blocks: its timeout, capped near its deadline
        (+ grace, so the pump's typed deadline error wins the race)."""
        wait = timeout_s or self.default_timeout_s
        if deadline_ts is not None:
            wait = min(wait, max(deadline_ts - time.perf_counter(), 0.0) + 5.0)
        return wait

    def backlog(self) -> int:
        """Requests waiting here (inbox + admitted, not yet done)."""
        with self._mutex:
            return len(self._inbox) + len(self._tickets)

    def projected_wait(self) -> Optional[float]:
        """Projected first-token wait for a request submitted now (None
        while cold)."""
        with self._mutex:
            return self._projected_wait_locked(len(self._inbox) + len(self._tickets))

    def heartbeat_age(self) -> Optional[float]:
        """Seconds since the pump last began a loop iteration, or None when
        there is nothing to detect: no pump, an abandoned service, no
        pending work, or warmup within ``warmup_budget_s``. An age past
        ``tick_stall_budget_s`` means a pump wedged inside a dispatch that
        raises nothing: the watchdog's only signal for a hang."""
        with self._mutex:
            if not self._pump_running or self._abandoned:
                return None
            if self._warming and not (
                    self.warmup_budget_s > 0 and self._warming_since > 0.0
                    and time.perf_counter() - self._warming_since > self.warmup_budget_s):
                return None
            if not self._inbox and not self._tickets:
                return None
            if self._heartbeat_ts <= 0.0:
                return None
            return max(time.perf_counter() - self._heartbeat_ts, 0.0)

    def extract_inbox(self) -> list[_Ticket]:
        """Remove and return every inbox ticket not yet handed to the engine
        (the quarantine handoff: they hold no KV, a sibling can adopt them
        whole). Cancelled and expired ones are closed here instead. Safe
        against a wedged pump, which blocks outside the mutex."""
        now = time.perf_counter()
        out: list[_Ticket] = []
        with self._mutex:
            for ticket in self._inbox:
                if ticket.event.is_set():
                    continue
                if ticket.cancelled:
                    self._close_cancelled_locked(ticket)
                    continue
                if ticket.deadline_ts is not None and now >= ticket.deadline_ts:
                    self._expired += 1
                    get_metrics().record_shed("expired")
                    finish_ticket_error(ticket, DeadlineExceededError(
                        "deadline expired before admission"), "expired")
                    continue
                out.append(ticket)
            self._inbox.clear()
        return out

    def adopt(self, ticket: _Ticket) -> None:
        """Admit a ticket handed off from a quarantined sibling, through
        the normal admission checks (which raise the typed errors a fresh
        submit would). The request's engine section keeps its first
        replica."""
        if ticket.request_id:
            get_flight_recorder().note_engine_submit(ticket.request_id,
                                                     replica_id=self.replica_id)
        with self._mutex:
            self._admit_ticket_locked(ticket)

    def abandon(self, reason: str) -> list[_Ticket]:
        """Give up on this service because its pump is wedged: latch broken
        (admissions answer 503), fail every admitted ticket with a typed
        :class:`ReplicaUnavailable` (their KV dies with the engine: callers
        fail over, delivered-token streams resume), and return the inbox
        tickets for handoff. Never joins the pump; ``close()`` counts it in
        ``pump_leaked`` if it outlives the join."""
        exc = ReplicaUnavailable(f"replica abandoned: {reason}", retry_after_s=2.0,
                                 details={"replica": self.replica_id, "reason": "stalled"})
        with self._mutex:
            self._abandoned = True
            self._broken = True
            for ticket in list(self._tickets.values()):
                finish_ticket_error(ticket, exc, "stalled")
            self._tickets.clear()
        return self.extract_inbox()

    @property
    def broken(self) -> bool:
        """Latched after a failed tick whose engine reset also failed, or by
        :meth:`abandon`."""
        with self._mutex:
            return self._broken

    @property
    def closed(self) -> bool:
        with self._mutex:
            return self._closed

    @property
    def tick_failure_count(self) -> int:
        """Lifetime failed decode ticks (the supervisor's burst breaker)."""
        with self._mutex:
            return self._tick_failures

    @property
    def pump_leaked_count(self) -> int:
        """Pumps that outlived their close() join (a wedged dispatch)."""
        with self._mutex:
            return self._pump_leaked

    def check_admission(self, deadline_ts: Optional[float] = None) -> None:
        """Raise what a submit right now would raise, without enqueuing."""
        with self._mutex:
            self._check_available_locked()
            self._check_admission_locked(deadline_ts)

    def _check_available_locked(self) -> None:
        assert_held(self._mutex)
        if self._closed:
            raise ReplicaUnavailable("generation service is closed", retry_after_s=5.0,
                                     details={"replica": self.replica_id, "reason": "closed"})
        if self._broken:
            raise ReplicaUnavailable(
                "paged decode engine is down (reset failed; awaiting supervised rebuild)",
                retry_after_s=5.0, details={"replica": self.replica_id, "reason": "broken"})

    def _admit_ticket_locked(self, ticket: _Ticket) -> None:
        assert_held(self._mutex)
        self._check_available_locked()
        self._check_admission_locked(ticket.deadline_ts)
        self._inbox.append(ticket)
        self._ensure_pump()

    def _check_admission_locked(self, deadline_ts: Optional[float]) -> None:
        """Shed (typed, fast) instead of queueing work the service cannot
        finish; every rejection is counted."""
        assert_held(self._mutex)
        if self._draining:
            self._shed += 1
            get_metrics().record_shed("draining")
            raise ServiceOverloaded("generation service is draining", status=503,
                                    retry_after_s=5.0)
        pending = len(self._inbox) + len(self._tickets)
        if pending >= self.max_queue:
            self._shed += 1
            get_metrics().record_shed("queue_full")
            raise ServiceOverloaded(
                f"decode queue full ({pending}/{self.max_queue} waiting)", status=429,
                retry_after_s=max(self._projected_wait_locked(pending) or 0.0, 1.0))
        if deadline_ts is not None:
            remaining = deadline_ts - time.perf_counter()
            if remaining <= 0:
                self._shed += 1
                get_metrics().record_shed("deadline")
                raise DeadlineExceededError("deadline expired before submit")
            projected = self._projected_wait_locked(pending)
            if projected is not None and projected > remaining:
                self._shed += 1
                get_metrics().record_shed("deadline")
                raise ServiceOverloaded(
                    f"projected wait {projected:.2f}s exceeds remaining deadline budget "
                    f"{remaining:.2f}s", status=503, retry_after_s=1.0)

    def _projected_wait_locked(self, pending: int) -> Optional[float]:
        """Recent TTFT (EMA) scaled by the backlog against the slot count;
        None until the first completion, so a cold service never sheds on
        projection."""
        assert_held(self._mutex)
        if self._ttft_ema <= 0.0:
            return None
        return self._ttft_ema * (1.0 + pending / max(self.engine.max_slots, 1))

    # ------------------------------------------------------------ lifecycle

    def drain(self, deadline_s: float = 30.0) -> dict:
        """Stop admitting (new submits shed with 503), let queued and
        in-flight work finish for up to ``deadline_s``, then close."""
        with self._mutex:
            self._draining = True
        t_end = time.perf_counter() + max(deadline_s, 0.0)
        while True:
            with self._mutex:
                pending = len(self._inbox) + len(self._tickets)
            if pending == 0 or time.perf_counter() >= t_end:
                break
            time.sleep(0.02)
        self.close(join_timeout_s=max(t_end - time.perf_counter(), 1.0))
        return {"drained": pending == 0, "abandoned": pending}

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop: the pump fails every waiter with the closed-service error
        and exits; a pump that outlives the join is counted as leaked."""
        with self._mutex:
            self._closed = True
            pump = self._pump
        if pump is None:
            return
        pump.join(timeout=max(join_timeout_s, 0.0))
        if pump.is_alive():
            logger.warning("paged decode pump did not exit within %.1fs", join_timeout_s)
            with self._mutex:
                self._pump_leaked += 1
        with self._mutex:
            if self._pump is pump:
                self._pump = None

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Wait for the pump to stop (it stops when nothing is queued or
        decoding), so the caller may drive the engine directly until its
        next submit. Returns whether it stopped in time."""
        with self._mutex:
            pump = self._pump
        if pump is None:
            return True
        pump.join(timeout=timeout_s)
        return not pump.is_alive()

    def warm_prefix(self, text: str, timeout_s: float = 60.0) -> int:
        """Warm ``text`` into the engine's radix tree on the calling thread
        (:meth:`ContinuousBatchingEngine.warm_prefix`), once the pump is
        gone and while no new one may start: submits made meanwhile wait in
        the inbox, and their pump starts after. Returns the tokens cached,
        or 0 when the pump did not stop within ``timeout_s``."""
        deadline = time.perf_counter() + max(timeout_s, 0.0)
        while True:
            if not self.wait_idle(max(deadline - time.perf_counter(), 0.0)):
                logger.warning("template head not warmed: the pump did not stop within %.0fs",
                               timeout_s)
                return 0
            with self._mutex:
                pump = self._pump
                # a submit may have started a fresh pump since the join
                if not self._pump_running and (pump is None or not pump.is_alive()):
                    self._engine_lent = True
                    break
        try:
            return self.engine.warm_prefix(text)
        finally:
            with self._mutex:
                self._engine_lent = False
                if self._inbox:
                    self._ensure_pump()

    def duty_cycle(self) -> dict:
        """host/device/idle fractions of wall time since construction (or
        :meth:`reset_duty_cycle`), summing to 1."""
        return duty_fractions(dict(self._phase_totals), time.perf_counter() - self._duty_t0)

    def reset_duty_cycle(self) -> None:
        for key in self._phase_totals:
            self._phase_totals[key] = 0.0
        self._duty_t0 = time.perf_counter()

    def stats(self) -> dict:
        engine_stats = self.engine.stats()
        phase_seconds = {k: round(v, 6) for k, v in self._phase_totals.items()}
        duty = self.duty_cycle()
        duty_elapsed = round(time.perf_counter() - self._duty_t0, 6)
        with self._mutex:
            return {
                **engine_stats,
                "replica": self.replica_id,
                "queued_inbox": len(self._inbox),
                "ticks": self._ticks,
                "completed": self._completed,
                "avg_active_slots": (round(self._active_sum / self._ticks, 3)
                                     if self._ticks else 0.0),
                "max_active_slots": self._max_active,
                "shared_ticks": self._shared_ticks,
                "max_queue": self.max_queue,
                "draining": int(self._draining),
                "shed": self._shed,
                "expired": self._expired,
                "cancelled": self._cancelled,
                "requeued": self._requeued,
                "tick_failures": self._tick_failures,
                "pump_leaked": self._pump_leaked,
                "broken": int(self._broken),
                "abandoned": int(self._abandoned),
                "tick_stall_budget_s": self.tick_stall_budget_s,
                "warmup_budget_s": self.warmup_budget_s,
                "phase_seconds": phase_seconds,
                "duty_elapsed_s": duty_elapsed,
                "duty_cycle": duty,
            }

    def warmup(self, max_new_tokens: int = 4) -> dict:
        """Run the engine's shapes before traffic, through the normal submit
        path (the pump keeps sole ownership of the engine):

        * one cold admission per prefill width;
        * a radix head chain, then one admission per (prior pages × suffix
          width) pair sharing that many pages with the head;
        * one short generation per tick-ladder rung (``force_tick_steps``);
        * one sampled generation without and (with no draft) one with
          top-k, so that on the card every variant of ``graph_variants`` is
          captured — after which a tick that would capture another raises;
        * a concurrent burst for the multi-row admission buckets.

        Returns the prompt count, the seconds, and the graph captures and
        capture seconds it took. The stall watchdog stands down meanwhile
        (for up to ``warmup_budget_s``)."""
        with self._mutex:
            self._warming = True
            self._warming_since = time.perf_counter()
        try:
            return self._warmup(max_new_tokens)
        finally:
            with self._mutex:
                self._warming = False
                self._warming_since = 0.0

    def _warmup(self, max_new_tokens: int) -> dict:
        eng = self.engine
        t0 = time.perf_counter()
        captures0, capture_s0 = eng.graph_captures, eng.graph_capture_s
        page = eng.page_size
        window = eng.max_pages_per_seq * page
        reserve = max_new_tokens + 2  # admission keeps this much headroom
        widths, priors = eng.prefill_shapes()
        prompts = 0

        def run(text: str, **kwargs) -> None:
            nonlocal prompts
            # deadline_s=0: warmup opts out of the default deadline
            self.generate(text, max_new_tokens=max_new_tokens, deadline_s=0,
                          **{"temperature": 0.0, **kwargs})
            prompts += 1

        # ByteTokenizer: a (w - 1)-char prompt plus BOS admits at width w;
        # each width its own digit, so no width hits the previous one's pages
        for i, width in enumerate(widths):
            n = min(width, window - reserve) - 1
            if n >= 1:
                run(str(i % 10) * n)
        head_chars = min(window - reserve, max(priors) * page + 2) - 1
        if head_chars >= page:
            head = "h" * head_chars
            run(head)  # seeds the chain the pairs match into
            run(head)  # a full match
            pair = 0
            for prior in priors:
                keep = prior * page - 1  # BOS + keep chars = prior pages
                if keep < 1 or keep > len(head):
                    continue
                for width in widths:
                    if prior * page + width > window - reserve:
                        continue
                    fill = "abcdefgijklmnopqrstuvwxyz"[pair % 25]
                    run(head[:keep] + fill * width)
                    pair += 1
        n_short = max(min(widths[0], window - reserve) - 1, 1)
        try:
            for rung in eng.tick_step_sizes():
                eng.force_tick_steps = rung
                run("r" * n_short)
        finally:
            eng.force_tick_steps = None
        run("s" * n_short, temperature=0.7)
        if eng.draft_params is None:
            run("k" * n_short, temperature=0.7, top_k=4)
        burst_n = min(3 * eng.max_slots, 4 * max(eng.ADMIT_BUCKETS))
        threads = [threading.Thread(target=self.generate, args=("b" * n_short,),
                                    kwargs={"max_new_tokens": max_new_tokens, "deadline_s": 0},
                                    name=f"paged-warmup-{k}", daemon=True)
                   for k in range(burst_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.default_timeout_s + 60.0)
        prompts += len(threads)
        if eng.device.type == "cuda" and eng.cuda_graphs:
            missing = [v for v in eng.graph_variants if v not in eng._graphs]
            if missing:
                raise RuntimeError(f"warmup left graph variants uncaptured: {missing}")
            eng.graphs_frozen = True
        with self._mutex:
            # warmup TTFTs would shed the first real deadlines
            self._ttft_ema = 0.0
        return {"prompts": prompts, "seconds": time.perf_counter() - t0,
                "graph_captures": eng.graph_captures - captures0,
                "graph_capture_s": eng.graph_capture_s - capture_s0}

    # ----------------------------------------------------------------- pump

    def _ensure_pump(self) -> None:
        assert_held(self._mutex)
        if not self._pump_running and not self._engine_lent:
            self._pump_running = True
            # a fresh burst's liveness: the previous burst's last stamp would
            # read as a stall in the new pump's spawn window
            self._heartbeat_ts = time.perf_counter()
            self._pump = threading.Thread(target=self._run, name="paged-decode-pump",
                                          daemon=True)
            self._pump.start()

    def _run(self) -> None:
        # pumps are born per burst: each new one takes the engine over from
        # the last (the sanitizer's single-driver guard)
        bind_engine_owner(self.engine)
        # short ticks while callers wait in the inbox, not just the engine
        # queue (a GIL-atomic length read: a hint, not a lock)
        self.engine.pressure_hint = lambda: len(self._inbox)
        recorder = get_flight_recorder()
        metrics = get_metrics()
        # resolved once a pump: with tracing off a tick pays one bool test
        tracing = get_tracing()
        # the engine's lifetime counters at this pump's start: each tick
        # records its own deltas
        last = self._engine_totals()
        while True:
            t_iter = now = time.perf_counter()
            with self._mutex:
                # the watchdog's liveness stamp: a tick wedged in the dispatch
                # below leaves it ageing while work waits
                self._heartbeat_ts = now
                for ticket in self._inbox:
                    if ticket.cancelled:
                        self._close_cancelled_locked(ticket)
                        continue
                    if ticket.deadline_ts is not None and now >= ticket.deadline_ts:
                        self._expired += 1
                        metrics.record_shed("expired")
                        finish_ticket_error(ticket, DeadlineExceededError(
                            "deadline expired before admission"), "expired")
                        continue
                    rid = self.engine.submit(
                        ticket.prompt, max_new_tokens=ticket.max_new_tokens,
                        temperature=ticket.temperature, deadline_ts=ticket.deadline_ts,
                        top_k=ticket.top_k, prior_tokens=ticket.prior_tokens,
                        seed=ticket.seed)
                    self._tickets[rid] = ticket
                self._inbox.clear()
                # abandoned or expired callers: stop decoding for nobody
                for rid, ticket in list(self._tickets.items()):
                    if ticket.cancelled:
                        self.engine.cancel(rid)
                        self._tickets.pop(rid, None)
                        self._close_cancelled_locked(ticket)
                    elif ticket.deadline_ts is not None and now >= ticket.deadline_ts:
                        self.engine.cancel(rid)
                        self._tickets.pop(rid, None)
                        self._expired += 1
                        metrics.record_shed("expired")
                        finish_ticket_error(ticket, DeadlineExceededError(
                            "deadline expired mid-decode; request cancelled"), "expired")
                if self._closed or not self.engine.has_work:
                    # flips under the mutex: a racing submit either landed
                    # above or sees the pump stopped and starts a new one
                    self._pump_running = False
                    if self._closed:
                        self._fail_all_locked("service closed")
                    return
            # the tick runs without any lock: only the pump thread drives the
            # engine, and submitters never wait on a tick
            t_drain = time.perf_counter()
            try:
                if tracing.enabled:
                    with tracing.profile_step("decode_tick", step=self._ticks + 1):
                        finished = self.engine.step()
                else:
                    finished = self.engine.step()
                tick_dur_s = time.perf_counter() - t_drain
            except Exception:  # noqa: BLE001 — crash containment below
                t_fail = time.perf_counter()
                logger.exception("paged decode tick failed; attempting crash containment")
                phase_s = dict.fromkeys(TICK_PHASES, 0.0)
                phase_s.update(self.engine.partial_step_phases())
                phase_s["inbox_drain"] = t_drain - t_iter
                phase_s["other"] += max(t_fail - t_iter - sum(phase_s.values()), 0.0)
                try:
                    recorder.record_tick(event="tick_failure", replica=self.replica_id,
                                         dur_ms=round((t_fail - t_drain) * 1e3, 3),
                                         pump_ms=round((t_fail - t_iter) * 1e3, 3),
                                         phase_ms=phases_to_ms(phase_s))
                except Exception:  # noqa: BLE001 — telemetry is best-effort
                    logger.debug("failed-tick telemetry failed", exc_info=True)
                self._add_phases(phase_s)
                if self._contain_crash():
                    continue
                return
            active = self.engine.last_tick_active
            # the tick's event goes on the ring BEFORE delivery: a request
            # finishing in this tick pins a tick_last that includes it; the
            # phase split is amended once delivery is done
            tick_seq = None
            try:
                tick_seq, last = self._record_tick(recorder, metrics, last, tick_dur_s,
                                                   active)
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                logger.debug("tick telemetry failed", exc_info=True)
            t_deliver = now = time.perf_counter()
            with self._mutex:
                self._heartbeat_ts = now  # the tick came back
                self._ticks += 1
                self._active_sum += active
                self._max_active = max(self._max_active, active)
                self._shared_ticks += active > 1
                for slot in self.engine.slots:
                    ticket = self._tickets.get(slot.request_id) if slot.active else None
                    if ticket is None:
                        continue
                    if slot.emitted and ticket.t_first == 0.0:
                        ticket.t_first = now
                        ticket.tokens_first = len(slot.emitted)
                        metrics.record_ttft(now - ticket.t_submit, path=ticket.path)
                        self._note_ttft_locked(now - ticket.t_submit)
                    if ticket.stream_q is not None and len(slot.emitted) > ticket.sent_tokens:
                        ticket.stream_q.put(("toks", list(slot.emitted[ticket.sent_tokens:])))
                        ticket.sent_tokens = len(slot.emitted)
                for result in finished:
                    result.replica_id = self.replica_id
                    ticket = self._tickets.pop(result.request_id, None)
                    if ticket is None:
                        continue
                    if result.finish_reason == "expired":
                        # the engine dropped it while queued for a slot
                        self._expired += 1
                        metrics.record_shed("expired")
                        finish_ticket_error(ticket, DeadlineExceededError(
                            "deadline expired while queued for a slot"), "expired")
                        continue
                    self._completed += 1
                    if ticket.t_first == 0.0:
                        self._note_ttft_locked(now - ticket.t_submit)
                    self._note_finished(ticket, result, now, metrics, recorder)
                    ticket.result = result
                    if ticket.stream_q is not None:
                        ticket.stream_q.put(("done", result))
                    ticket.event.set()
            t_end = time.perf_counter()
            phase_s = dict.fromkeys(TICK_PHASES, 0.0)
            phase_s.update(self.engine.last_step_phases)
            phase_s["inbox_drain"] = t_drain - t_iter
            phase_s["deliver"] = t_end - t_deliver
            # the residual (the tick record, call overhead, mutex waits) is
            # "other", so the phases sum to the iteration by construction
            phase_s["other"] += max(t_end - t_iter - sum(phase_s.values()), 0.0)
            try:
                if tick_seq is not None:
                    recorder.amend_tick(tick_seq, pump_ms=round((t_end - t_iter) * 1e3, 3),
                                        phase_ms=phases_to_ms(phase_s))
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                logger.debug("phase telemetry failed", exc_info=True)
            # the amend's own cost rides the duty cycle's totals as "other"
            phase_s["other"] += time.perf_counter() - t_end
            self._add_phases(phase_s)

    def _engine_totals(self) -> dict:
        """The engine's lifetime counters a tick event records deltas of."""
        eng = self.engine
        return {"prefill_tokens": eng.prefill_tokens_total,
                "decode_tokens": eng.decode_tokens_total,
                "spec_accepted": eng.spec_emitted_total,
                "prefix_hit_tokens": eng.prefix_hit_tokens_total,
                "prefix_miss_tokens": eng.prefix_miss_tokens_total,
                "graph_captures": eng.graph_captures}

    def _record_tick(self, recorder, metrics, last: dict, tick_dur_s: float,
                     active: int) -> tuple[int, dict]:
        """Put one tick's event on the flight recorder (JAX's fields, with
        ``graph_captures`` for ``xla_compiles``) and its wall time into
        ``/metrics``; host integers only. Returns the event's number and
        the counters the next tick's deltas start from."""
        eng = self.engine
        totals = self._engine_totals()
        queued = len(eng._queue)
        inbox = len(self._inbox)  # a GIL-atomic depth read
        free = eng.allocator.free_pages
        radix = eng._radix
        seq = recorder.record_tick(
            replica=self.replica_id, dur_ms=round(tick_dur_s * 1e3, 3),
            active_slots=int(active), queue_depth=queued, inbox_depth=inbox,
            **{k: totals[k] - last[k] for k in totals},
            prefix_cache_pages=radix.pages_held if radix is not None else 0,
            free_pages=free, used_pages=eng.allocator.num_pages - 1 - free,
            # lifetime totals, GIL-atomic reads: the difference between two
            # ticks attributes sheds to a window
            shed_total=self._shed, expired_total=self._expired,
            cancelled_total=self._cancelled)
        metrics.record_tick(tick_dur_s, int(active), queued + inbox)
        return seq, totals

    @staticmethod
    def _note_finished(ticket: _Ticket, result: PagedResult, now: float, metrics,
                       recorder) -> None:
        """One admission's completion telemetry: its TTFT if it finished
        within its first tick, its TPOT over the tokens after the first
        tick (none for an answer that ended there), and the flight record's
        engine admission. Best-effort."""
        try:
            n = len(result.tokens)
            if ticket.t_first == 0.0:
                ticket.t_first = now
                ticket.tokens_first = n
                metrics.record_ttft(now - ticket.t_submit, path=ticket.path)
            tail = n - ticket.tokens_first
            tpot_s = (now - ticket.t_first) / tail if tail > 0 else None
            if tpot_s is not None:
                metrics.record_tpot(tpot_s, path=ticket.path)
            if ticket.request_id:
                recorder.finish_engine(
                    ticket.request_id,
                    ttft_ms=round((ticket.t_first - ticket.t_submit) * 1e3, 2),
                    tpot_ms=round(tpot_s * 1e3, 3) if tpot_s is not None else None,
                    tokens=n, prompt_tokens=result.prompt_tokens,
                    prefill_tokens=result.prefill_tokens,
                    prefix_hit_tokens=result.prefix_hit_tokens,
                    finish_reason=result.finish_reason)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            logger.debug("completion telemetry failed", exc_info=True)

    def _add_phases(self, phase_s: dict) -> None:
        get_metrics().record_tick_phases(phase_s)
        for key, val in phase_s.items():
            self._phase_totals[key] += val

    def _contain_crash(self) -> bool:
        """After a failed tick: reset the engine; requeue admitted tickets
        that have retries left (inbox tickets never ran, so they requeue
        free) and give the rest an ``error`` result. Returns whether the
        pump goes on."""
        reset_ok = True
        try:
            self.engine.reset()
        except Exception:  # noqa: BLE001 — latches broken below
            logger.exception("paged engine reset failed; paged path disabled")
            reset_ok = False
        with self._mutex:
            self._tick_failures += 1
            if not reset_ok:
                self._pump_running = False
                self._broken = True
                self._fail_all_locked("decode tick failed; engine reset failed")
                return False
            survivors: list[_Ticket] = []
            for ticket in self._tickets.values():
                if ticket.event.is_set():
                    continue
                if ticket.cancelled:
                    self._close_cancelled_locked(ticket)
                    continue
                # a stream that delivered tokens cannot restart without
                # duplicating them
                resumable = ticket.stream_q is None or ticket.sent_tokens == 0
                if resumable and ticket.retries_left > 0:
                    ticket.retries_left -= 1
                    self._requeued += 1
                    survivors.append(ticket)
                else:
                    get_metrics().record_shed("crash")
                    self._fail_ticket_locked(ticket, "decode tick failed")
            for ticket in self._inbox:
                if ticket.cancelled:
                    self._close_cancelled_locked(ticket)
                elif not ticket.event.is_set():
                    survivors.append(ticket)
            self._tickets.clear()
            self._inbox[:] = survivors
            if self._closed:
                self._pump_running = False
                self._fail_all_locked("service closed")
                return False
            if not self._inbox:
                self._pump_running = False
                return False
        return True

    def _note_ttft_locked(self, ttft_s: float) -> None:
        """Fold one TTFT into the EMA admission projects from (alpha 0.2)."""
        assert_held(self._mutex)
        if self._ttft_ema <= 0.0:
            self._ttft_ema = ttft_s
        else:
            self._ttft_ema = 0.8 * self._ttft_ema + 0.2 * ttft_s

    def _close_cancelled_locked(self, ticket: _Ticket) -> None:
        """Count one ticket its caller gave up on and pin the end of its
        engine window (an open one would absorb every later tick)."""
        assert_held(self._mutex)
        self._cancelled += 1
        if ticket.request_id:
            get_flight_recorder().finish_engine(ticket.request_id,
                                                finish_reason="cancelled")

    def _fail_ticket_locked(self, ticket: _Ticket, reason: str) -> None:
        """End a ticket with the ``finish_reason="error"`` result."""
        assert_held(self._mutex)
        if ticket.event.is_set():
            return
        ticket.result = PagedResult(request_id=-1, text="", tokens=[], prompt_tokens=0,
                                    finish_reason="error")
        if ticket.request_id:
            get_flight_recorder().finish_engine(ticket.request_id, finish_reason="error",
                                                error=reason)
        if ticket.stream_q is not None:
            ticket.stream_q.put(("done", ticket.result))
        ticket.event.set()

    def _fail_all_locked(self, reason: str) -> None:
        """A stopping pump leaves no caller waiting."""
        assert_held(self._mutex)
        for ticket in list(self._tickets.values()) + self._inbox:
            self._fail_ticket_locked(ticket, reason)
        self._tickets.clear()
        self._inbox.clear()
