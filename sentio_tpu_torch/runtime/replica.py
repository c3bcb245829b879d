"""The thread-mode replica tier — ``sentio_tpu/runtime/replica.py``'s
``TenantFairQueue`` and ``ReplicaSet`` on the card.

A :class:`ReplicaSet` fronts N independent engine + service replicas
(each its own page pool, radix tree, CUDA stream, graph pool and pump
thread; the weights are shared) with the call surface of one
:class:`~sentio_tpu_torch.runtime.service.PagedGenerationService`:

* **weighted fair queueing** (:class:`TenantFairQueue`) in front: each
  tenant (``X-Tenant``; one shared tenant by default) may hold a
  weight-proportional share of the set's queue capacity minus a headroom
  kept for a tenant not seen yet, a ``batch`` tier sheds before
  ``interactive``, and optional token deficits rate-limit contended
  tenants; every shed is a typed :class:`ServiceOverloaded` naming the
  tenant and the reason;
* **two-stage routing**: the longest radix-prefix hit among the eligible
  replicas (``peek_prefix``; the first of replicas tied at it) while that
  replica's backlog is within ``affinity_stickiness`` x its slots, else
  the least projected wait;
* **supervision**: each replica moves HEALTHY → DEGRADED → QUARANTINED →
  REBUILDING → HEALTHY. A breaker quarantines a replica on a latched
  broken service, a burst of tick failures or a caller-observed error
  rate; a watchdog quarantines one whose pump heartbeat is stale with work
  pending (a stall raises nothing). At quarantine the replica's
  never-dispatched inbox tickets are handed to a survivor (their WFQ
  reservation re-charged), and a stalled service is abandoned. A rebuild
  (on a worker thread) drains the old service, frees its engine's device
  memory when its pump has exited (``ContinuousBatchingEngine.release``),
  spawns a fresh engine on the same weights, runs the full service warmup
  — every CUDA graph variant captured while the siblings serve — and only
  then swaps it into rotation;
* **failover**: a generate whose replica dies under it, or a stream that
  dies before delivering anything, is re-admitted on a survivor within
  ``failover_budget``; a stream that dies after delivering tokens is
  **resumed by replay**: the survivor admits the prompt plus the delivered
  token ids (``prior_tokens``) and only the continuation is yielded,
  re-decoded over the whole sequence so no character is lost or repeated.

``health_summary()`` feeds ``/health``: ``degraded`` while at least one
replica serves, ``unhealthy`` at none. Health transitions, handoffs,
stalls and resumes are events on the flight recorder; the tier's series
are in :mod:`sentio_tpu_torch.infra.metrics`.

The process and socket tier (``REPLICA_MODE=process|socket``): each
replica is a :class:`~sentio_tpu_torch.runtime.worker.ProcessReplica` over
a worker process, driven through the same surface. A supervising set arms
their router-side ticket shadow (``enable_shadow_handoff``), so a dead
worker's unanswered tickets go through :meth:`ReplicaSet._handoff_inbox`
to a survivor's ``adopt``, and a rebuild respawns (or, over a socket,
heals) the worker. :class:`WorkerRegistry` is the socket workers'
registration listener and incarnation-epoch book.

The elastic fleet: the set's membership changes at runtime.
:meth:`ReplicaSet.add_replica` wires a new replica into rotation (a
RETIRED slot is reused), :meth:`ReplicaSet.retire` takes one out
gracefully (RETIRING: its inbox handed to survivors, its in-flight work
drained, then closed and parked RETIRED, its registry slot released), and
the WFQ capacity follows the live members. A socket worker that registers
with ``slot=-1`` gets a slot from the registry (the lowest released one,
else a new one; a released slot's epoch is kept, so the fence holds
across reuse); the membership source, polled on the set's own
``replica-join`` thread, wraps and warms such joins, the supervisor wires
the warmed ones in at the top of each pass (a failed one gives its slot
back), and retires a worker that sent a
voluntary deregister frame on its rebuild pool. ``runtime/autoscaler.py``
drives both from the fleet's load.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from sentio_tpu_torch.analysis.sanitizer import assert_held, guard_locksets, make_lock
from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.infra.exceptions import ReplicaUnavailable, SentioError, ServiceOverloaded
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.infra.phases import duty_fractions, sum_phase_totals
from sentio_tpu_torch.runtime.service import (
    PagedGenerationService,
    StreamProgress,
    finish_ticket_error,
)

logger = logging.getLogger(__name__)

__all__ = [
    "ReplicaSet", "TenantFairQueue", "WorkerRegistry", "DEFAULT_TENANT", "PRIORITY_INTERACTIVE",
    "PRIORITY_BATCH", "HEALTH_HEALTHY", "HEALTH_DEGRADED", "HEALTH_QUARANTINED",
    "HEALTH_REBUILDING", "HEALTH_RETIRING", "HEALTH_RETIRED", "HEALTH_STATES",
]

DEFAULT_TENANT = "shared"
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"

# the health state machine; the values are the /metrics label and the
# flight events' vocabulary
HEALTH_HEALTHY = "HEALTHY"
HEALTH_DEGRADED = "DEGRADED"
HEALTH_QUARANTINED = "QUARANTINED"
HEALTH_REBUILDING = "REBUILDING"
# the elastic fleet's states: RETIRING drains a replica leaving the set on
# purpose (never routed to; its in-flight work finishes), RETIRED is its
# terminal state (closed; the slot kept for reuse, invisible to /health and
# stats)
HEALTH_RETIRING = "RETIRING"
HEALTH_RETIRED = "RETIRED"
HEALTH_STATES = (HEALTH_HEALTHY, HEALTH_DEGRADED, HEALTH_QUARANTINED,
                 HEALTH_REBUILDING, HEALTH_RETIRING, HEALTH_RETIRED)
_OUT_OF_ROTATION = (HEALTH_QUARANTINED, HEALTH_REBUILDING)
_LEAVING = (HEALTH_RETIRING, HEALTH_RETIRED)
_SERVING = (HEALTH_HEALTHY, HEALTH_DEGRADED)
# the elastic fleet's fault points
JOIN_POINT = "replica.join"
RETIRE_POINT = "replica.retire"
ELASTIC_JOIN_POINT = "registry.elastic_join"


@dataclass
class _ReplicaHealth:
    """One replica's supervision state, guarded by the set's mutex."""

    state: str = HEALTH_HEALTHY
    since: float = 0.0            # perf_counter of the last transition
    last_reason: str = ""
    # caller-observed outcomes (perf_counter, ok) inside the breaker window:
    # replica failures only, never sheds
    outcomes: deque = field(default_factory=lambda: deque(maxlen=512))
    # perf_counter stamps of observed tick-failure increments
    tick_fails: deque = field(default_factory=lambda: deque(maxlen=64))
    ticks_seen: int = 0           # the service's tick-failure count so far
    quarantined_at: float = 0.0
    next_rebuild_at: float = 0.0  # earliest perf_counter of a rebuild try
    rebuild_attempts: int = 0     # failed attempts this quarantine
    rebuilds: int = 0             # successful in-place rebuilds
    # queued on or running on the rebuild pool: not to be queued again
    rebuild_inflight: bool = False


@dataclass
class _TenantState:
    """One tenant's book-keeping, guarded by the queue's mutex."""

    weight: float = 1.0
    pending: int = 0          # admitted and not yet released
    deficit: float = 0.0      # token credit (refill mode only)
    last_refill: float = 0.0
    admitted: int = 0
    shed: int = 0
    tokens: int = 0           # tokens consumed (prompt + generated)


@guard_locksets
class TenantFairQueue:
    """Weighted fair admission across tenants over one queue capacity.

    * **quota** — tenant ``t`` holds at most ``max(min_quota, (capacity -
      headroom) * w_t / Σ w_active)`` pending requests, the active set being
      every tenant with pending work plus the requester; the headroom is the
      room a second tenant's first request always finds;
    * **deficit** (``refill_tokens_per_s > 0``) — credit refills at ``rate x
      weight`` tokens/s up to ``burst x weight``; under contention an
      admission needs a non-negative credit and debits its estimated cost
      (corrected at release); a lone tenant is never limited;
    * **priority** — ``batch`` sheds once total pending crosses
      ``batch_shed_fraction x capacity``.
    """

    # tenant keys past this many share one overflow bucket (bounded labels)
    MAX_TRACKED = 256
    OVERFLOW_TENANT = "overflow"

    def __init__(self, capacity: int, weights: Optional[dict[str, float]] = None,
                 default_weight: float = 1.0, refill_tokens_per_s: float = 0.0,
                 burst_tokens: int = 8192, batch_shed_fraction: float = 0.8,
                 headroom: Optional[int] = None, min_quota: int = 1) -> None:
        self.capacity = max(int(capacity), 1)
        self.default_weight = max(float(default_weight), 1e-3)
        self.refill_tokens_per_s = max(float(refill_tokens_per_s), 0.0)
        self.burst_tokens = max(int(burst_tokens), 1)
        self.batch_shed_fraction = min(max(float(batch_shed_fraction), 0.0), 1.0)
        self.min_quota = max(int(min_quota), 1)
        self._explicit_headroom = headroom is not None
        self.headroom = int(headroom) if headroom is not None else max(1, self.capacity // 8)
        self.headroom = min(self.headroom, self.capacity - 1)
        self._weights = dict(weights or {})
        self._mutex = make_lock("TenantFairQueue._mutex")
        self._tenants: dict[str, _TenantState] = {}  # guarded-by: _mutex

    def _state_locked(self, tenant: str) -> tuple[str, _TenantState]:
        assert_held(self._mutex)
        if tenant not in self._tenants and len(self._tenants) >= self.MAX_TRACKED:
            tenant = self.OVERFLOW_TENANT
        state = self._tenants.get(tenant)
        if state is None:
            state = _TenantState(weight=max(self._weights.get(tenant, self.default_weight), 1e-3))
            if self.refill_tokens_per_s > 0:
                state.deficit = self.burst_tokens * state.weight
                state.last_refill = time.perf_counter()
            self._tenants[tenant] = state
        return tenant, state

    def _refill_locked(self, state: _TenantState, now: float) -> None:
        assert_held(self._mutex)
        if self.refill_tokens_per_s <= 0:
            return
        dt = max(now - state.last_refill, 0.0)
        state.last_refill = now
        state.deficit = min(state.deficit + self.refill_tokens_per_s * state.weight * dt,
                            self.burst_tokens * state.weight)

    def _quota_locked(self, tenant: str, state: _TenantState) -> int:
        assert_held(self._mutex)
        active_weight = state.weight if state.pending == 0 else 0.0
        for other in self._tenants.values():
            if other.pending > 0:
                active_weight += other.weight
        share = (self.capacity - self.headroom) * state.weight / max(active_weight,
                                                                      state.weight)
        return max(self.min_quota, int(share))

    def _shed_locked(self, tenant: str, state: _TenantState, reason: str, message: str,
                     status: int, retry_after_s: float) -> None:
        assert_held(self._mutex)
        state.shed += 1
        metrics = get_metrics()
        metrics.record_shed(reason)
        metrics.record_tenant_shed(tenant, reason)
        raise ServiceOverloaded(message, status=status, retry_after_s=retry_after_s,
                                details={"tenant": tenant, "shed_reason": reason})

    def set_capacity(self, capacity: int) -> None:
        """Re-derive the capacity (an explicit headroom is kept, clamped;
        the default one follows the capacity). Held reservations stay."""
        with self._mutex:
            self.capacity = max(int(capacity), 1)  # guarded-by: _mutex
            if not self._explicit_headroom:
                self.headroom = max(1, self.capacity // 8)  # guarded-by: _mutex
            self.headroom = min(self.headroom, self.capacity - 1)  # guarded-by: _mutex

    def admit(self, tenant: str, cost_tokens: int, priority: str = PRIORITY_INTERACTIVE,
              reserve: bool = True) -> str:
        """Admit (or, with ``reserve=False``, only test) one request of
        ``tenant`` with an estimated token cost; raises a typed
        :class:`ServiceOverloaded` with the tenant and the shed reason.
        Returns the key actually charged (possibly the overflow bucket),
        which the caller passes back to :meth:`release`."""
        now = time.perf_counter()
        with self._mutex:
            tenant, state = self._state_locked(tenant)
            self._refill_locked(state, now)
            total_pending = sum(s.pending for s in self._tenants.values())
            quota = self._quota_locked(tenant, state)
            if state.pending >= quota:
                self._shed_locked(
                    tenant, state, "tenant_quota",
                    f"tenant {tenant!r} is at its fair-share quota "
                    f"({state.pending}/{quota} of {self.capacity} total)",
                    status=429, retry_after_s=1.0)
            if priority == PRIORITY_BATCH and total_pending + 1 > \
                    self.batch_shed_fraction * self.capacity:
                self._shed_locked(
                    tenant, state, "priority_batch",
                    f"batch-tier request shed at {total_pending}/{self.capacity} pending "
                    "(batch yields to interactive)",
                    status=503, retry_after_s=2.0)
            contended = total_pending - state.pending > 0
            if self.refill_tokens_per_s > 0 and contended and state.deficit < 0:
                wait = -state.deficit / (self.refill_tokens_per_s * state.weight)
                self._shed_locked(
                    tenant, state, "tenant_deficit",
                    f"tenant {tenant!r} exhausted its token deficit ({state.deficit:.0f}); "
                    f"refilling at {self.refill_tokens_per_s * state.weight:.0f} tok/s",
                    status=429, retry_after_s=max(wait, 0.5))
            if reserve:
                state.pending += 1
                state.admitted += 1
                if self.refill_tokens_per_s > 0:
                    state.deficit -= max(int(cost_tokens), 0)
                get_metrics().record_tenant_admitted(tenant)
            return tenant

    def recharge(self, tenant: str, cost_tokens: int,
                 priority: str = PRIORITY_INTERACTIVE) -> None:
        """Release and re-admit one held reservation at once (the inbox
        handoff's move): the quota and priority rules are tested as if it
        were granted now; on success pending is unchanged and one admission
        is recorded, on a shed the reservation is restored before the typed
        error raises. The deficit is untouched."""
        now = time.perf_counter()
        with self._mutex:
            state = self._tenants.get(tenant)
            if state is None or state.pending == 0:
                return  # already released: nothing held
            self._refill_locked(state, now)
            state.pending -= 1
            try:
                total_pending = sum(s.pending for s in self._tenants.values())
                quota = self._quota_locked(tenant, state)
                if state.pending >= quota:
                    self._shed_locked(
                        tenant, state, "tenant_quota",
                        f"tenant {tenant!r} is over its fair-share quota at handoff "
                        f"({state.pending + 1}/{quota} of {self.capacity} total)",
                        status=429, retry_after_s=1.0)
                if priority == PRIORITY_BATCH and total_pending + 1 > \
                        self.batch_shed_fraction * self.capacity:
                    self._shed_locked(
                        tenant, state, "priority_batch",
                        f"batch-tier handoff shed at {total_pending + 1}/{self.capacity} "
                        "pending (batch yields to interactive)",
                        status=503, retry_after_s=2.0)
            finally:
                state.pending += 1
            state.admitted += 1
            get_metrics().record_tenant_admitted(tenant)

    def release(self, tenant: str, cost_tokens: int,
                actual_tokens: Optional[int] = None) -> None:
        """Return one admission; ``actual_tokens`` corrects the estimated
        debit."""
        with self._mutex:
            state = self._tenants.get(tenant)
            if state is None:
                return
            state.pending = max(state.pending - 1, 0)
            if actual_tokens is not None:
                state.tokens += int(actual_tokens)
                if self.refill_tokens_per_s > 0:
                    state.deficit += max(int(cost_tokens), 0) - max(int(actual_tokens), 0)

    def stats(self) -> dict:
        with self._mutex:
            return {
                "capacity": self.capacity,
                "headroom": self.headroom,
                "refill_tokens_per_s": self.refill_tokens_per_s,
                "per_tenant": {
                    name: {
                        "weight": state.weight,
                        "pending": state.pending,
                        "admitted": state.admitted,
                        "shed": state.shed,
                        "tokens": state.tokens,
                        **({"deficit": round(state.deficit, 1)}
                           if self.refill_tokens_per_s > 0 else {}),
                    }
                    for name, state in self._tenants.items()
                },
            }


@guard_locksets
class WorkerRegistry:
    """The router's registry of socket workers (``REPLICA_MODE=socket``) —
    JAX's ``WorkerRegistry`` for a fixed set of slots: who is connected, at
    which **incarnation epoch**, and which frames are too old to trust.

    * every (re)registration (a spawned worker's first connect, a
      partitioned worker's reconnect, the router's dial of a
      ``REPLICA_WORKERS`` worker) bumps the slot's epoch, stamped into the
      connection's frame headers;
    * the dispatcher drops a frame whose epoch is older than the slot's
      current one (:meth:`note_stale_frame`), so a worker that heals after
      a partition can neither resurrect a dead ticket nor deliver a stream
      chunk twice;
    * the rebuild awaits re-registration here (:meth:`await_registration`)
      to choose between heal and respawn.

    One listener serves every slot; hellos are authenticated with the
    shared token (constant-time compare) and version-checked before any
    epoch is granted. A hello with ``slot=-1`` is an **elastic join**: the
    registry allocates a slot (:meth:`_alloc_slot`), acknowledges it in the
    ``hello_ack`` and queues the join for :meth:`drain_joins`; a slot
    returned by :meth:`release_slot` is reused, and a redial of a released
    slot's retired incarnation is rejected typed."""

    def __init__(self, auth_token: str, slots: int, bind_host: str = "127.0.0.1",
                 bind_port: int = 0, max_frame_bytes: int = 32 * 1024 * 1024,
                 frame_timeout_s: float = 30.0, hello_timeout_s: float = 10.0) -> None:
        import socket as _socket

        if not auth_token:
            raise ValueError("WorkerRegistry needs a non-empty auth token")
        self.auth_token = auth_token
        self.slots = max(int(slots), 1)
        self.max_frame_bytes = int(max_frame_bytes)
        self.frame_timeout_s = float(frame_timeout_s)
        self.hello_timeout_s = float(hello_timeout_s)
        self._mutex = make_lock("WorkerRegistry._mutex")
        self._epochs = [0] * self.slots  # guarded-by: _mutex
        self._stale = [0] * self.slots  # guarded-by: _mutex
        self._registrations = 0  # guarded-by: _mutex
        self._rejections = 0  # guarded-by: _mutex
        # released slots free for reuse, the join and release counters, and
        # the joins the supervisor drains; _pending only grows, so a
        # lock-free indexed read stays valid
        self._free: list[int] = []  # guarded-by: _mutex
        self._elastic_joins = 0  # guarded-by: _mutex
        self._released = 0  # guarded-by: _mutex
        self._joins: _queue.Queue = _queue.Queue()
        self._pending: list[_queue.Queue] = [_queue.Queue() for _ in range(self.slots)]
        self._stop = threading.Event()
        listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        listener.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        listener.settimeout(0.2)  # close() can stop the accept loop
        listener.bind((bind_host, int(bind_port)))
        listener.listen(max(2 * self.slots, 8))
        self._listener = listener
        self._addr = listener.getsockname()
        self._accepter = threading.Thread(target=self._accept_loop,
                                          name="worker-registry-accept", daemon=True)
        self._accepter.start()

    @property
    def address(self) -> tuple:
        """(host, port) the workers dial to register."""
        return self._addr

    # ------------------------------------------------------------ epoch book

    def current_epoch(self, slot: int) -> int:
        with self._mutex:
            return self._epochs[slot]

    def assign_epoch(self, slot: int) -> int:
        """Bump and return the slot's epoch: from here on every frame of
        the previous incarnation is stale. The dial-out path
        (``REPLICA_WORKERS``) calls it directly."""
        with self._mutex:
            self._epochs[slot] += 1
            epoch = self._epochs[slot]
        get_metrics().record_worker_incarnation(slot, epoch)
        return epoch

    def note_stale_frame(self, slot: int) -> None:
        with self._mutex:
            self._stale[slot] += 1
        get_metrics().record_stale_frames(slot)

    def stale_frames(self, slot: int) -> int:
        with self._mutex:
            return self._stale[slot]

    # ------------------------------------------------------------ elasticity

    def _alloc_slot(self) -> int:
        """A slot for an elastic join: the lowest released one (its epoch
        entry kept, so the fence continues), else a new one."""
        with self._mutex:
            if self._free:
                self._free.sort()
                slot = self._free.pop(0)
            else:
                slot = self.slots
                self.slots += 1  # guarded-by: _mutex
                self._epochs.append(0)
                self._stale.append(0)
                self._pending.append(_queue.Queue())
            self._elastic_joins += 1
        return slot

    def release_slot(self, slot: int) -> None:
        """Return a slot after a graceful retire. Its epoch is kept: the
        next worker on it registers above every frame the retired
        incarnation sent. A second release is a no-op; a registration that
        raced the release onto the queue is dropped."""
        with self._mutex:
            if not 0 <= slot < self.slots or slot in self._free:
                return
            self._free.append(slot)
            self._released += 1
        q = self._pending[slot]
        while True:
            try:
                transport, _h, _e = q.get_nowait()
            except _queue.Empty:
                break
            transport.close()

    def drain_joins(self) -> list[int]:
        """The slots elastically joined since the last call (non-blocking),
        each once per registration."""
        slots: list[int] = []
        while True:
            try:
                slots.append(self._joins.get_nowait())
            except _queue.Empty:
                break
        return slots

    # ---------------------------------------------------------- registration

    def _accept_loop(self) -> None:
        import socket as _socket

        while not self._stop.is_set():
            try:
                conn, _peer = self._listener.accept()
            except _socket.timeout:
                continue
            except OSError:
                return  # the listener closed under us
            # a connector that never says hello must not stall the loop
            threading.Thread(target=self._handshake, args=(conn,),
                             name="worker-registry-handshake", daemon=True).start()

    def _handshake(self, conn) -> None:
        from sentio_tpu_torch.runtime.transport import (
            SocketTransport,
            TransportClosed,
            TransportError,
            expect_hello,
        )

        transport = SocketTransport(conn, max_frame_bytes=self.max_frame_bytes,
                                    frame_timeout_s=self.frame_timeout_s)
        # a bad token or version is counted before its reject frame goes
        # out: a peer that reads the reject reads the count with it
        counted: list[str] = []

        def count_reject(reason: str) -> None:
            counted.append(reason)
            self._note_rejection(reason)

        try:
            hello = expect_hello(transport, self.auth_token, timeout_s=self.hello_timeout_s,
                                 on_reject=count_reject)
        except TransportClosed as exc:
            # a connection that never spoke: not a protocol rejection
            logger.debug("silent connection to the worker registry dropped: %s", exc)
            with self._mutex:
                self._rejections += 1
            transport.close()
            return
        except TransportError as exc:
            if counted:
                transport.close()
            else:
                self._reject(transport, None, str(exc))
            return
        except Exception:  # noqa: BLE001 — a hostile hello must not kill the thread
            logger.exception("worker registration handshake crashed")
            transport.close()
            return
        slot = hello.get("slot", -1)
        elastic = isinstance(slot, int) and slot == -1
        if elastic:
            # the worker asks for a slot: allocate one and name it in the
            # ack, so its reconnect loop redials the same identity
            try:
                faults.hit(ELASTIC_JOIN_POINT)
            except Exception as exc:  # noqa: BLE001 — an injected join failure rejects typed
                self._reject(transport, transport, f"elastic join failed: {exc}")
                return
            slot = self._alloc_slot()
        elif not isinstance(slot, int) or not 0 <= slot < self.slots:
            self._reject(transport, transport, f"unknown slot {slot!r}")
            return
        else:
            with self._mutex:
                retired = slot in self._free
            if retired:
                # a retired incarnation redialing: a typed rejection ends its
                # reconnect loop
                self._reject(transport, transport, f"slot {slot} was retired")
                return
        epoch = self.assign_epoch(slot)
        transport.fault_scope = f"r{slot}"
        transport.epoch = epoch
        try:
            transport.send((0, "hello_ack", {"epoch": epoch, "slot": slot}))
        except TransportError:
            if elastic:
                self.release_slot(slot)
            transport.close()
            return
        with self._mutex:
            self._registrations += 1
        logger.info("worker registered for slot %d at epoch %d (pid %s%s)", slot, epoch,
                    hello.get("pid"), ", elastic join" if elastic else "")
        q = self._pending[slot]
        # supersede by epoch, not by arrival: of everything queued plus this
        # one, only the newest registration stays
        entries = [(transport, hello, epoch)]
        while True:
            try:
                entries.append(q.get_nowait())
            except _queue.Empty:
                break
        entries.sort(key=lambda e: e[2])
        for old_transport, _h, _e in entries[:-1]:
            old_transport.close()
        q.put(entries[-1])
        if elastic:
            # published after the registration is queued: the consumer's
            # await_registration must find it
            self._joins.put(slot)

    def _note_rejection(self, reason: str) -> None:
        """Count, log and export one refused registration."""
        with self._mutex:
            self._rejections += 1
        outcome = "rejected_auth" if "token" in reason else "rejected_proto"
        logger.warning("worker registration rejected: %s", reason)
        get_metrics().record_worker_reconnect(outcome)

    def _reject(self, transport, ackable, reason: str) -> None:
        """Count the refusal, then send the reject frame (when ``ackable``)
        and close."""
        self._note_rejection(reason)
        if ackable is not None:
            from sentio_tpu_torch.runtime.transport import TransportError

            try:
                ackable.send((0, "hello_reject", {"reason": reason}))
            except TransportError:
                pass
        transport.close()

    def await_registration(self, slot: int, timeout_s: float):
        """Block until a worker registers for ``slot`` → ``(transport,
        hello, epoch)`` of the newest registration; a typed
        :class:`ReplicaUnavailable` after ``timeout_s``."""
        deadline = time.perf_counter() + max(timeout_s, 0.0)
        q = self._pending[slot]
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise ReplicaUnavailable(
                    f"no worker registered for slot {slot} within {timeout_s:.0f}s",
                    retry_after_s=2.0, details={"replica": slot, "reason": "no_registration"})
            try:
                transport, hello, epoch = q.get(timeout=min(remaining, 0.5))
            except _queue.Empty:
                continue
            if epoch < self.current_epoch(slot):
                transport.close()  # superseded while queued
                continue
            return transport, hello, epoch

    # ------------------------------------------------------------- lifecycle

    def stats(self) -> dict:
        with self._mutex:
            return {"epochs": list(self._epochs), "stale_frames": list(self._stale),
                    "registrations": self._registrations, "rejections": self._rejections,
                    "slots": self.slots, "elastic_joins": self._elastic_joins,
                    "released_slots": self._released, "free_slots": sorted(self._free)}

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accepter.is_alive():
            self._accepter.join(timeout=5.0)
        for q in self._pending:
            while True:
                try:
                    transport, _h, _e = q.get_nowait()
                except _queue.Empty:
                    break
                transport.close()


def _name_engine_guard(svc, idx: int) -> None:
    """Name a replica's engine guard after its slot, so a sanitizer error
    says WHICH replica's engine a stray thread touched (a worker replica's
    engine lives in its own process and has no guard here)."""
    guard = getattr(getattr(svc, "engine", None), "_san", None)
    if guard is not None:
        guard.name = f"ContinuousBatchingEngine[r{idx}]"


@guard_locksets
class ReplicaSet:
    """WFQ admission → affinity / least-loaded routing → the chosen
    replica's service, with supervision, failover and stream resumes. The
    call surface of one service; one replica is a thin pass-through."""

    def __init__(
        self,
        services: Sequence[PagedGenerationService],
        tenant_weights: Optional[dict[str, float]] = None,
        tenant_default_weight: float = 1.0,
        tenant_refill_tokens_per_s: float = 0.0,
        tenant_burst_tokens: int = 8192,
        tenant_headroom: Optional[int] = None,
        batch_shed_fraction: float = 0.8,
        affinity_stickiness: float = 4.0,
        route_prefix_tokens: int = 512,
        supervise: bool = True,
        probe_interval_s: float = 0.25,
        breaker_window_s: float = 30.0,
        breaker_error_rate: float = 0.5,
        breaker_min_samples: int = 4,
        breaker_tick_failures: int = 3,
        quarantine_backoff_s: float = 0.5,
        rebuild_budget: int = 3,
        rebuild_drain_s: float = 5.0,
        failover_budget: int = 1,
        stream_resume_budget: Optional[int] = None,
        rebuild_workers: int = 1,
        registry: Optional[WorkerRegistry] = None,
    ) -> None:
        services = list(services)
        if not services:
            raise ValueError("ReplicaSet needs at least one replica")
        self._check_isolation(services)
        # element swaps (a rebuild) happen under _mutex; reads are lock-free
        # list indexing: a caller that took the old replica mid-swap gets a
        # typed failure and fails over
        self._services = services
        for i, svc in enumerate(services):
            svc.replica_id = i
            _name_engine_guard(svc, i)
        self.tokenizer = services[0].engine.tokenizer
        # route on at most this many prompt-head tokens
        self.route_prefix_tokens = max(int(route_prefix_tokens), services[0].engine.page_size)
        self.affinity_stickiness = max(float(affinity_stickiness), 0.0)
        self.tenants = TenantFairQueue(
            capacity=sum(svc.max_queue for svc in services), weights=tenant_weights,
            default_weight=tenant_default_weight,
            refill_tokens_per_s=tenant_refill_tokens_per_s, burst_tokens=tenant_burst_tokens,
            batch_shed_fraction=batch_shed_fraction, headroom=tenant_headroom)
        self._mutex = make_lock("ReplicaSet._mutex")
        self._routed_affinity = 0  # guarded-by: _mutex
        self._routed_load = 0  # guarded-by: _mutex
        self._affinity_overflow = 0  # guarded-by: _mutex
        self.probe_interval_s = max(float(probe_interval_s), 0.01)
        self.breaker_window_s = max(float(breaker_window_s), 0.1)
        self.breaker_error_rate = min(max(float(breaker_error_rate), 0.0), 1.0)
        self.breaker_min_samples = max(int(breaker_min_samples), 1)
        self.breaker_tick_failures = max(int(breaker_tick_failures), 1)
        self.quarantine_backoff_s = max(float(quarantine_backoff_s), 0.0)
        # failed rebuilds past this budget retry at the maximum backoff
        self.rebuild_budget = max(int(rebuild_budget), 0)
        self.rebuild_drain_s = max(float(rebuild_drain_s), 0.0)
        self.failover_budget = max(int(failover_budget), 0)
        # None follows the failover budget; 0 keeps the typed mid-stream error
        self.stream_resume_budget = (max(int(stream_resume_budget), 0)
                                     if stream_resume_budget is not None
                                     else self.failover_budget)
        # the tick-failure baseline is the service's count, so failures of a
        # reused engine do not trip the burst breaker at once
        self._health = [_ReplicaHealth(since=time.perf_counter(),
                                       ticks_seen=svc.tick_failure_count)
                        for svc in services]  # guarded-by: _mutex
        self._failovers = 0  # guarded-by: _mutex
        self._closed = False  # guarded-by: _mutex
        # inbox tickets moved at quarantine, stall quarantines, and leaked
        # pumps of incarnations a rebuild replaced
        self._handed_off = 0  # guarded-by: _mutex
        self._stall_quarantines = 0  # guarded-by: _mutex
        self._pump_leaked_carryover = 0  # guarded-by: _mutex
        # stream resumes, the delivered tokens they replayed, and streams
        # whose budget (or opt-out) kept the typed mid-stream error
        self._stream_resumes = 0  # guarded-by: _mutex
        self._resume_replayed_tokens = 0  # guarded-by: _mutex
        self._resume_exhausted = 0  # guarded-by: _mutex
        # the socket workers' registry, closed with the set
        self.registry = registry
        # the elastic fleet: runtime joins and graceful retires, the retires'
        # drain seconds, the membership source (with the registry's slot
        # release) and its poller's warmed joiners, and the autoscaler over the set
        # (stopped before the supervisor, its launched workers reaped after
        # the replicas close)
        self._joined = 0  # guarded-by: _mutex
        self._retired = 0  # guarded-by: _mutex
        self._retire_drain_s: deque = deque(maxlen=256)  # guarded-by: _mutex
        self._membership_source = None
        self._release_slot = None
        # a supervising set polls the source on a thread of its own and
        # hands the supervisor what it returned
        self._join_poller: Optional[threading.Thread] = None
        self._ready_joins: list = []
        self.autoscaler = None
        metrics = get_metrics()
        for i in range(len(services)):
            metrics.record_replica_health(i, HEALTH_HEALTHY)
        metrics.record_fleet_size(len(services))
        self._stop = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        # rebuilds run on a pool, so the supervisor's detection cadence
        # never waits behind one; without a supervisor (tests stepping
        # _supervise_once) a rebuild runs inline
        self.rebuild_workers = max(int(rebuild_workers), 0)
        self._rebuild_q: Optional[_queue.Queue] = None
        self._rebuild_pool: list[threading.Thread] = []
        if supervise:
            # worker replicas (runtime/worker.py) shadow their unanswered
            # tickets router-side; with a supervisor to extract them, a dead
            # worker's tickets are handed to survivors instead of failing
            for svc in services:
                enable = getattr(svc, "enable_shadow_handoff", None)
                if enable is not None:
                    enable()
            if self.rebuild_workers > 0:
                self._rebuild_q = _queue.Queue()
                self._rebuild_pool = [
                    threading.Thread(target=self._rebuild_worker, name=f"replica-rebuild-{k}",
                                     daemon=True)
                    for k in range(self.rebuild_workers)]
                for t in self._rebuild_pool:
                    t.start()
            self._supervisor = threading.Thread(target=self._supervise_loop,
                                                name="replica-supervisor", daemon=True)
            self._supervisor.start()

    @staticmethod
    def _check_isolation(services: Sequence[PagedGenerationService]) -> None:
        """Replicas must not share mutable decode state (the weights and
        the tokenizer are meant to be shared)."""
        seen: dict[int, tuple[int, str]] = {}
        for i, svc in enumerate(services):
            eng = svc.engine
            parts = {"service": svc, "engine": eng,
                     "allocator": getattr(eng, "allocator", None),
                     "pool": getattr(eng, "pool", None),
                     "radix": getattr(eng, "_radix", None)}
            for what, obj in parts.items():
                if obj is None:
                    continue
                prior = seen.get(id(obj))
                if prior is not None:
                    raise ValueError(
                        f"replica {i} shares its {what} with replica {prior[0]}'s "
                        f"{prior[1]} — replicas must own private decode state")
                seen[id(obj)] = (i, what)

    # -------------------------------------------------------------- routing

    @property
    def replicas(self) -> int:
        """Slots, a RETIRED one included (JAX's count)."""
        return len(self._services)

    @property
    def live_replicas(self) -> int:
        """Replicas not RETIRED."""
        with self._mutex:
            return sum(1 for h in self._health if h.state != HEALTH_RETIRED)

    @property
    def services(self) -> list[PagedGenerationService]:
        """The replicas' current services (a rebuild swaps one)."""
        return list(self._services)

    def _route_tokens(self, prompt: str) -> list[int]:
        # chars bound the token count (a byte tokenizer is 1:1), so the
        # encode cost stays flat for long prompts
        head = prompt[: self.route_prefix_tokens * 4]
        try:
            toks = self.tokenizer.encode(head, add_bos=True)
        except Exception:  # noqa: BLE001 — routing must never fail a request
            return []
        return list(toks[: self.route_prefix_tokens])

    def _eligible(self, exclude: frozenset = frozenset()) -> list[int]:
        """Replicas the router may pick: HEALTHY ones, DEGRADED ones too when
        every healthy replica is at its queue bound (or none is healthy),
        never QUARANTINED or REBUILDING. Raises a typed
        :class:`ReplicaUnavailable` when nothing can serve."""
        with self._mutex:
            if self._closed:
                raise ReplicaUnavailable("replica set is closed", retry_after_s=1.0,
                                         retryable=False)
            states = [h.state for h in self._health]
            retry_in = self._rebuild_eta_locked()
        healthy = [i for i, s in enumerate(states) if s == HEALTH_HEALTHY and i not in exclude]
        degraded = [i for i, s in enumerate(states)
                    if s == HEALTH_DEGRADED and i not in exclude]
        if healthy:
            if degraded and all(self._services[i].backlog() >= self._services[i].max_queue
                                for i in healthy):
                return healthy + degraded
            return healthy
        if degraded:
            return degraded
        raise ReplicaUnavailable(
            "no serving replica available (every replica is quarantined, rebuilding, or "
            "already failed this request over)",
            retry_after_s=max(retry_in, 1.0), details={"replica_states": states})

    def _least_loaded(self, eligible: Sequence[int]) -> int:
        """The replica of least projected wait, then backlog, then index."""
        def load_key(i: int):
            svc = self._services[i]
            return (svc.projected_wait() or 0.0, svc.backlog(), i)

        return min(eligible, key=load_key)

    def _rebuild_eta_locked(self) -> float:
        """Seconds until the next quarantined replica's rebuild try."""
        assert_held(self._mutex)
        now = time.perf_counter()
        etas = [h.next_rebuild_at - now for h in self._health if h.state in _OUT_OF_ROTATION]
        return max(min(etas), 0.0) if etas else 1.0

    def _route(self, toks: Sequence[int], count: bool = True,
               exclude: frozenset = frozenset()) -> tuple[int, int]:
        """→ (replica, predicted prefix-hit tokens): the best radix hit among
        the eligible replicas (the first of those tied at it) while its
        backlog is within stickiness x its slots, else the least-loaded
        one. ``count=False`` for probes."""
        eligible = self._eligible(exclude)
        best_i, best_hit = -1, 0
        if len(eligible) > 1 and toks:
            for i in eligible:
                hit = self._services[i].engine.peek_prefix(toks)
                if hit > best_hit:
                    best_i, best_hit = i, hit
        if best_hit > 0:
            svc = self._services[best_i]
            if svc.backlog() <= self.affinity_stickiness * max(svc.engine.max_slots, 1):
                if count:
                    with self._mutex:
                        self._routed_affinity += 1
                return best_i, best_hit
            if count:
                with self._mutex:
                    self._affinity_overflow += 1
        idx = self._least_loaded(eligible)
        if count:
            with self._mutex:
                self._routed_load += 1
        return idx, 0

    # ------------------------------------------------------------------ api

    @staticmethod
    def _is_replica_failure(exc: BaseException) -> bool:
        """Failures of the replica (not of the request): worth failing over."""
        return isinstance(exc, ReplicaUnavailable)

    def generate(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                 timeout_s: Optional[float] = None, request_id: Optional[str] = None,
                 deadline_s: Optional[float] = None, deadline_ts: Optional[float] = None,
                 top_k: int = 0, tenant: Optional[str] = None,
                 priority: str = PRIORITY_INTERACTIVE):
        """Admit, route, delegate; a replica that dies under the request
        (typed :class:`ReplicaUnavailable`, or the ``error`` result a
        crashed pump gives its waiters) is reported to the breaker and the
        request is re-admitted on a survivor within ``failover_budget``.
        The reservation is released before each retry charges again."""
        toks = self._route_tokens(prompt)
        cost = len(toks) + max_new_tokens
        tenant_key = tenant or DEFAULT_TENANT
        attempts = 0
        tried: set[int] = set()
        while True:
            charged = self.tenants.admit(tenant_key, cost, priority=priority)
            idx = svc = None
            try:
                idx, _hit = self._route(toks, exclude=frozenset(tried))
                svc = self._services[idx]
                result = svc.generate(
                    prompt, max_new_tokens=max_new_tokens, temperature=temperature,
                    timeout_s=timeout_s, request_id=request_id, deadline_s=deadline_s,
                    deadline_ts=deadline_ts, top_k=top_k,
                    # rides the ticket for a quarantine handoff's re-charge
                    tenant=charged, priority=priority, cost_tokens=cost)
            except BaseException as exc:
                # refund the estimate: a shed or a dead replica spent nothing
                self.tenants.release(charged, cost, actual_tokens=0)
                if idx is not None and self._is_replica_failure(exc):
                    self._note_failure(idx, exc, svc)
                    tried.add(idx)
                    if attempts < self.failover_budget:
                        attempts += 1
                        with self._mutex:
                            self._failovers += 1
                        continue
                raise
            if result.finish_reason == "error":
                # the crashed pump's waiter: the request did nothing wrong
                self._note_failure(idx, ReplicaUnavailable("error result from replica"), svc)
                tried.add(idx)
                if attempts < self.failover_budget:
                    self.tenants.release(charged, cost, actual_tokens=0)
                    attempts += 1
                    with self._mutex:
                        self._failovers += 1
                    continue
            else:
                self._note_success(idx, svc)
            self.tenants.release(charged, cost,
                                 actual_tokens=result.prompt_tokens + len(result.tokens))
            return result

    def generate_stream(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
                        timeout_s: Optional[float] = None, request_id: Optional[str] = None,
                        deadline_s: Optional[float] = None, deadline_ts: Optional[float] = None,
                        top_k: int = 0, tenant: Optional[str] = None,
                        priority: str = PRIORITY_INTERACTIVE, stats_out: Optional[dict] = None,
                        seed: Optional[int] = None, resumable: bool = True) -> Iterator[str]:
        """Streaming with failover. A stream that dies before delivering
        anything restarts on a survivor (``failover_budget``); one that dies
        after delivering tokens is resumed by replay on a survivor (the
        delivered token ids as ``prior_tokens``; ``stream_resume_budget``),
        yielding only the continuation: greedy resumes are token-exact
        against an uninterrupted run, sampled ones carry the call's
        temperature, top-k and seed. ``resumable=False`` keeps the typed
        mid-stream error. The replica's own call-time checks (``top_k``)
        run here; the admission and the tenant's reservation wait for the
        first ``next()``."""
        toks = self._route_tokens(prompt)
        idx, _hit = self._route(toks)
        progress = StreamProgress()
        kwargs = dict(
            max_new_tokens=max_new_tokens, temperature=temperature, timeout_s=timeout_s,
            request_id=request_id, deadline_s=deadline_s, deadline_ts=deadline_ts, top_k=top_k,
            # stamped with the raw key now and re-stamped with the charged
            # (possibly bucketed) key once the first attempt is admitted
            tenant=tenant or DEFAULT_TENANT, priority=priority,
            cost_tokens=len(toks) + max_new_tokens, stats_out=stats_out, seed=seed,
            progress=progress)
        svc = self._services[idx]
        inner = svc.generate_stream(prompt, **kwargs)
        return self._stream_impl(inner, idx, svc, toks, prompt, kwargs, tenant or DEFAULT_TENANT,
                                 len(toks) + max_new_tokens, priority, progress, max_new_tokens,
                                 resumable)

    def _stream_impl(self, inner: Iterator[str], idx: int, svc, toks: Sequence[int],
                     prompt: str, kwargs: dict, tenant: str, cost: int, priority: str,
                     progress: StreamProgress, max_new_tokens: int,
                     resumable: bool) -> Iterator[str]:
        attempts = 0   # fresh restarts (nothing delivered yet)
        resumes = 0    # replays of a delivered prefix
        tried = {idx}
        base: list[int] = []  # token ids delivered by earlier attempts
        flushed = ""          # text yielded so far
        # a resume is booked only once its attempt clears the admission
        pending_resume_note: Optional[tuple] = None
        while True:
            try:
                charged = self.tenants.admit(tenant, cost, priority=priority)
            except BaseException:
                if pending_resume_note is not None:
                    self._record_resume_outcome("failed")
                raise
            if pending_resume_note is not None:
                self._note_resume(*pending_resume_note)
                pending_resume_note = None
            if kwargs.get("tenant") != charged:
                # the reservation landed on another key (overflow bucket):
                # re-create the not yet started iterator with it, so a
                # handoff re-charges what is actually held
                kwargs["tenant"] = charged
                inner = svc.generate_stream(prompt, **kwargs)
            try:
                if not base:
                    for piece in inner:
                        flushed += piece
                        yield piece
                else:
                    # a resumed attempt decodes the continuation alone; the
                    # whole delivered sequence is decoded again at each piece
                    # and only what extends the flushed text is yielded
                    for _piece in inner:
                        text = self.tokenizer.decode(base + list(progress.tokens))
                        safe = text[:-1] if text.endswith("�") else text
                        if len(safe) > len(flushed):
                            delta = safe[len(flushed):]
                            flushed = safe
                            yield delta
                    text = self.tokenizer.decode(base + list(progress.tokens))
                    if len(text) > len(flushed):
                        delta = text[len(flushed):]
                        flushed = text
                        yield delta
                stats_out = kwargs.get("stats_out")
                if stats_out is not None and resumes:
                    # the service's stats cover the continuation only
                    stats_out["tokens"] = len(base) + len(progress.tokens)
                    stats_out["resumed"] = resumes
                    stats_out["replayed_tokens"] = len(base)
                self.tenants.release(charged, cost)
                self._note_success(idx, svc)
                return
            except BaseException as exc:
                self.tenants.release(charged, cost)
                if not self._is_replica_failure(exc):
                    raise
                self._note_failure(idx, exc, svc)
                delivered = bool(flushed) or bool(base)
                if not delivered and attempts < self.failover_budget:
                    tried.add(idx)
                    attempts += 1
                    with self._mutex:
                        self._failovers += 1
                    progress.reset()
                    idx, _hit = self._route(toks, exclude=frozenset(tried))
                    svc = self._services[idx]
                    inner = svc.generate_stream(prompt, **kwargs)
                    continue
                if delivered and resumable and resumes < self.stream_resume_budget:
                    from_idx = idx
                    tried.add(idx)
                    resumes += 1
                    base = base + list(progress.tokens)
                    progress.reset()
                    remaining = max_new_tokens - len(base)
                    if remaining <= 0:
                        # every token was delivered: only a final flush is owed
                        text = self.tokenizer.decode(base)
                        self._note_resume(from_idx, -1, 0, len(base))
                        stats_out = kwargs.get("stats_out")
                        if stats_out is not None:
                            stats_out["tokens"] = len(base)
                            stats_out["resumed"] = resumes
                            stats_out["replayed_tokens"] = 0
                        if len(text) > len(flushed):
                            yield text[len(flushed):]
                        return
                    try:
                        # the survivor holding the deepest cached prefix of
                        # prompt + delivered wins (valid only while the
                        # routing head covers the whole prompt); only the
                        # replica that just died is excluded
                        resume_toks = (list(toks) + base
                                       if len(toks) < self.route_prefix_tokens else list(toks))
                        idx, _hit = self._route(resume_toks, exclude=frozenset({from_idx}))
                    except BaseException:
                        self._record_resume_outcome("failed")
                        raise
                    svc = self._services[idx]
                    kwargs["prior_tokens"] = list(base)
                    kwargs["max_new_tokens"] = remaining
                    inner = svc.generate_stream(prompt, **kwargs)
                    pending_resume_note = (from_idx, idx, len(base), len(base))
                    continue
                if delivered:
                    self._record_resume_outcome(
                        "exhausted" if resumable and self.stream_resume_budget > 0
                        else "opt_out")
                raise

    def _note_resume(self, replica_from: int, replica_to: int, replayed: int,
                     splice_index: int) -> None:
        """Book one resume: counters, the ``stream_resumed`` event, the
        metric (``replica_to=-1``: absorbed with no re-admission)."""
        with self._mutex:
            self._stream_resumes += 1
            self._resume_replayed_tokens += replayed
        self._record_resume_outcome("resumed")
        get_flight_recorder().record_tick(event="stream_resumed", replica_from=replica_from,
                                          replica_to=replica_to, replayed_tokens=replayed,
                                          splice_index=splice_index)

    def _record_resume_outcome(self, outcome: str) -> None:
        if outcome == "exhausted":
            with self._mutex:
                self._resume_exhausted += 1
        get_metrics().record_stream_resume(outcome)

    def check_admission(self, deadline_ts: Optional[float] = None,
                        tenant: Optional[str] = None, priority: str = PRIORITY_INTERACTIVE,
                        prompt: Optional[str] = None) -> None:
        """Raise what a submit now would raise, reserving nothing: the WFQ
        test, then the routed replica's own admission check (with
        ``prompt``, routed as the submit will be)."""
        self.tenants.admit(tenant or DEFAULT_TENANT, 0, priority=priority, reserve=False)
        toks = self._route_tokens(prompt) if prompt else []
        idx, _hit = self._route(toks, count=False)
        self._services[idx].check_admission(deadline_ts)

    # ------------------------------------------------------- elastic fleet

    def set_membership_source(self, source, release_slot=None) -> None:
        """Install the callable that yields replicas which joined (socket
        mode: the registry's joins, each wrapped in a ``ProcessReplica`` and
        warmed); it returns ``[(slot, service), ...]`` (``slot=None`` lets
        the set choose). ``release_slot`` gets a slot back after a graceful
        retire or a join that failed. A supervising set polls the source on
        its own thread (``replica-join``), so a joiner's spawn and warmup
        never hold up detection, respawns or retires; each supervisor pass
        wires in what the source has returned. Without a supervisor,
        :meth:`_supervise_once` polls it inline. Installed before traffic."""
        self._membership_source = source
        self._release_slot = release_slot
        if self._supervisor is not None and self._join_poller is None:
            self._join_poller = threading.Thread(target=self._join_loop, name="replica-join",
                                                 daemon=True)
            self._join_poller.start()

    def _poll_membership(self) -> list:
        source = self._membership_source
        if source is None:
            return []
        try:
            return list(source() or [])
        except Exception:  # noqa: BLE001 — the poller and the supervisor must survive
            logger.exception("membership source poll failed")
            return []

    def _join_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            fresh = self._poll_membership()
            if not fresh:
                continue
            with self._mutex:
                closed = self._closed or self._stop.is_set()
                if not closed:
                    self._ready_joins.extend(fresh)
            if closed:
                self._discard_joiners(fresh)

    def _rederive_capacity(self) -> None:
        """The WFQ capacity (and default headroom) from the live members,
        and the fleet gauge; the queue is updated outside the set's mutex."""
        with self._mutex:
            caps = [self._services[i].max_queue for i, h in enumerate(self._health)
                    if h.state != HEALTH_RETIRED]
        self.tenants.set_capacity(sum(caps))
        get_metrics().record_fleet_size(len(caps))

    def fleet_load(self) -> dict:
        """The autoscaler's sample, from cached probes: the serving replica
        count, the mean busy fraction (``1 - idle`` of each pump's duty
        cycle, cumulative since its start or its last reset), the summed
        backlog over the summed queue capacity, and each serving replica's
        busy and backlog."""
        with self._mutex:
            serving = [(i, self._services[i]) for i, h in enumerate(self._health)
                       if h.state in _SERVING]
        per: list[dict] = []
        backlog_total = capacity_total = 0
        for i, svc in serving:
            try:
                idle = float((svc.duty_cycle() or {}).get("idle", 1.0))
                backlog = int(svc.backlog())
            except Exception:  # noqa: BLE001 — a replica mid-swap: one sample skipped
                continue
            busy = max(0.0, min(1.0, 1.0 - idle))
            backlog_total += backlog
            capacity_total += int(svc.max_queue or 0)
            per.append({"replica": i, "busy": busy, "backlog": backlog})
        return {"serving": len(serving),
                "busy": sum(p["busy"] for p in per) / len(per) if per else 0.0,
                "backlog_fraction": backlog_total / capacity_total if capacity_total else 0.0,
                "replicas": per}

    def add_replica(self, svc, idx: Optional[int] = None) -> int:
        """Wire a new replica into rotation at runtime (an elastic join):
        ``idx=None`` reuses the lowest RETIRED slot, else appends; socket
        mode passes the registry's slot so the set's index and the wire
        identity agree. It enters HEALTHY, the WFQ capacity follows the
        live members, and a supervising set arms its shadow handoff as at
        start. Returns the slot."""
        faults.hit(JOIN_POINT)
        with self._mutex:
            if self._closed:
                raise ReplicaUnavailable("replica set is closed", retry_after_s=1.0,
                                         retryable=False)
            if idx is None:
                idx = next((i for i, h in enumerate(self._health)
                            if h.state == HEALTH_RETIRED), None)
            elif idx < len(self._health) and self._health[idx].state != HEALTH_RETIRED:
                raise ValueError(f"slot {idx} is occupied by a {self._health[idx].state} "
                                 "replica")
            elif idx > len(self._health):
                raise ValueError(f"slot {idx} would leave a gap (set holds "
                                 f"{len(self._health)} slots)")
            elif idx == len(self._health):
                idx = None  # a plain append
            live = [self._services[i] for i, h in enumerate(self._health)
                    if h.state != HEALTH_RETIRED]
            self._check_isolation(live + [svc])
            fresh = _ReplicaHealth(since=time.perf_counter(), ticks_seen=svc.tick_failure_count)
            if idx is None:
                idx = len(self._services)
                svc.replica_id = idx
                self._services.append(svc)
                self._health.append(fresh)
            else:
                # a RETIRED slot reused: the same index, a fresh incarnation
                svc.replica_id = idx
                self._services[idx] = svc
                self._health[idx] = fresh
            _name_engine_guard(svc, idx)
            self._joined += 1
        if self._supervisor is not None:
            enable = getattr(svc, "enable_shadow_handoff", None)
            if enable is not None:
                enable()
        self._rederive_capacity()
        logger.info("replica %d joined the set at runtime", idx)
        get_metrics().record_replica_health(idx, HEALTH_HEALTHY)
        get_flight_recorder().record_tick(event="replica_joined", replica=idx)
        return idx

    def retire(self, idx: int, deadline_s: Optional[float] = None) -> dict:
        """Take replica ``idx`` out gracefully (a scale-in or a voluntary
        deregister): RETIRING (never routed to again), its never-dispatched
        inbox handed to survivors (the WFQ reservation re-charged), its
        in-flight work drained within ``deadline_s`` (``rebuild_drain_s`` by
        default; a delivered stream the deadline cuts resumes on a
        survivor), then closed, parked RETIRED, its registry slot released
        and the WFQ capacity re-derived. The last serving replica is never
        retired (a typed, non-retryable ``ReplicaUnavailable``). Blocks up
        to the drain deadline."""
        deadline = float(deadline_s) if deadline_s is not None else self.rebuild_drain_s
        with self._mutex:
            if self._closed:
                raise ReplicaUnavailable("replica set is closed", retry_after_s=1.0,
                                         retryable=False)
            if not 0 <= idx < len(self._health):
                raise ValueError(f"no replica {idx} to retire")
            state = self._health[idx].state
            if state in _LEAVING:
                return {"replica": idx, "state": state, "retired": False}
            serving_others = sum(1 for i, h in enumerate(self._health)
                                 if i != idx and h.state in _SERVING)
            if serving_others == 0:
                raise ReplicaUnavailable(
                    f"cannot retire replica {idx}: no other serving replica would remain",
                    retry_after_s=5.0, retryable=False,
                    details={"replica": idx, "reason": "last_serving"})
        faults.hit(RETIRE_POINT)
        t0 = time.perf_counter()
        self._transition(idx, HEALTH_RETIRING, "scale-in")
        svc = self._services[idx]
        # never-dispatched tickets move now: waiting out the drain would add
        # the whole deadline to their latency
        inbox: list = []
        try:
            inbox = svc.extract_inbox()
        except Exception:  # noqa: BLE001 — the retire completes regardless
            logger.exception("replica %d retire inbox extraction failed", idx)
        self._handoff_inbox(idx, inbox)
        drained: dict = {}
        try:
            drained = svc.drain(deadline) or {}
        except Exception:  # noqa: BLE001 — a retire's drain is best-effort
            logger.warning("replica %d retire drain failed", idx, exc_info=True)
        if not svc.closed:
            try:
                svc.close()
            except Exception:  # noqa: BLE001 — every retiree is closed regardless
                logger.warning("replica %d retire close failed", idx, exc_info=True)
        leaked = svc.pump_leaked_count
        release = getattr(getattr(svc, "engine", None), "release", None)
        if release is not None and leaked == 0:
            # a thread replica's pool and graphs go with it, as a rebuild
            # frees them (a worker's went with its process)
            release()
        drain_s = time.perf_counter() - t0
        with self._mutex:
            self._retired += 1
            self._pump_leaked_carryover += leaked
            self._retire_drain_s.append(drain_s)
        self._transition(idx, HEALTH_RETIRED, f"retired after {drain_s:.2f}s drain")
        if self._release_slot is not None:
            try:
                self._release_slot(idx)
            except Exception:  # noqa: BLE001 — the slot's release is best-effort
                logger.warning("registry slot %d release failed", idx, exc_info=True)
        self._rederive_capacity()
        return {"replica": idx, "retired": True, "drain_s": round(drain_s, 3),
                "handed_off": len(inbox), "drained": drained.get("drained", True)}

    def _attach_new_members(self) -> None:
        """Wire each replica the membership source returned into rotation,
        lowest slot first (joins register concurrently, and a higher slot
        first would leave a gap); one bad joiner blocks neither the pass nor
        its siblings, and is closed with its registry slot released."""
        if self._join_poller is None:
            fresh = self._poll_membership()
        else:
            with self._mutex:
                fresh, self._ready_joins = self._ready_joins, []
        fresh.sort(key=lambda joiner: (joiner[0] is None, joiner[0] or 0))
        for slot, svc in fresh:
            try:
                self.add_replica(svc, idx=slot)
            except Exception:  # noqa: BLE001 — one bad joiner, not the pass
                logger.exception("elastic join of slot %s failed", slot)
                self._discard_joiners([(slot, svc)])

    def _discard_joiners(self, joiners: list) -> None:
        """Close joiners that never entered rotation and give their registry
        slots back (not a slot a live replica holds)."""
        for slot, svc in joiners:
            try:
                svc.close()
            except Exception:  # noqa: BLE001 — already on the error path
                logger.debug("failed joiner cleanup failed", exc_info=True)
            if slot is None or self._release_slot is None:
                continue
            with self._mutex:
                held = slot < len(self._health) and self._health[slot].state != HEALTH_RETIRED
            if held:
                continue
            try:
                self._release_slot(slot)
            except Exception:  # noqa: BLE001 — best-effort on the error path
                logger.warning("registry slot %d release failed", slot, exc_info=True)

    def _enqueue_retire(self, idx: int) -> bool:
        """Hand a deregister's retire to the rebuild pool (False: no pool,
        retire inline); the rebuild latch keeps it from being queued
        twice."""
        if self._rebuild_q is None:
            return False
        with self._mutex:
            health = self._health[idx]
            if health.rebuild_inflight:
                return True
            health.rebuild_inflight = True
        self._rebuild_q.put(("retire", idx))
        return True

    # ---------------------------------------------------------- supervision

    def _transition(self, idx: int, state: str, reason: str = "") -> bool:
        """Move replica ``idx`` to ``state`` (no-op if there) with its event,
        gauge and log line; returns whether it moved."""
        with self._mutex:
            health = self._health[idx]
            prev = health.state
            if prev == state:
                return False
            health.state = state
            health.since = time.perf_counter()
            health.last_reason = reason
        logger.warning("replica %d health %s -> %s (%s)", idx, prev, state, reason or "n/a")
        get_metrics().record_replica_health(idx, state)
        get_flight_recorder().record_tick(event="replica_health", replica=idx, state_from=prev,
                                          state_to=state, reason=reason[:200])
        return True

    def _note_success(self, idx: int, svc=None) -> None:
        with self._mutex:
            if svc is not None and self._services[idx] is not svc:
                return  # the slot was rebuilt under the request
            self._health[idx].outcomes.append((time.perf_counter(), True))

    def _note_failure(self, idx: int, exc: BaseException, svc=None) -> None:
        """A caller-observed replica failure: into the breaker window, and a
        service latched broken or closed is quarantined at once (by backlog
        a corpse looks least loaded). A failure seen on an incarnation a
        rebuild has replaced is dropped."""
        now = time.perf_counter()
        with self._mutex:
            if self._closed or idx >= len(self._health):
                return
            current = self._services[idx]
            if svc is not None and current is not svc:
                return
            health = self._health[idx]
            health.outcomes.append((now, False))
            state = health.state
        if state in _OUT_OF_ROTATION or state in _LEAVING:
            return
        if current.broken or current.closed:
            self._quarantine(idx, f"replica latched unavailable: {exc}")

    def _quarantine(self, idx: int, reason: str, stalled: bool = False) -> None:
        now = time.perf_counter()
        with self._mutex:
            health = self._health[idx]
            if health.state in _OUT_OF_ROTATION or health.state in _LEAVING:
                # a retiring replica's drain and close supersede a quarantine
                return
            health.quarantined_at = now
            health.rebuild_attempts = 0
            # the first rebuild try is due at once; backoff follows failures
            health.next_rebuild_at = now
            if stalled:
                self._stall_quarantines += 1
        self._transition(idx, HEALTH_QUARANTINED, reason)
        svc = self._services[idx]
        inbox: list = []
        try:
            # a wedged pump cannot be killed: abandon the service (admitted
            # tickets fail typed and fail over); a working one keeps its
            # admitted work for the rebuild's drain. Either way the inbox
            # moves now instead of sitting out the rebuild
            inbox = svc.abandon(reason) if stalled else svc.extract_inbox()
        except Exception:  # noqa: BLE001 — quarantine must complete
            logger.exception("replica %d inbox extraction failed", idx)
        self._handoff_inbox(idx, inbox)

    def _handoff_inbox(self, idx: int, tickets: list) -> None:
        """Re-admit a quarantined replica's never-dispatched tickets on
        survivors (the reservation re-charged); a ticket no survivor takes
        ends with a typed error. The blocked caller wakes with either, and
        no failover budget is spent."""
        if not tickets:
            return
        moved = 0
        for ticket in tickets:
            exc: Optional[Exception] = None
            if ticket.tenant is not None:
                try:
                    self.tenants.recharge(ticket.tenant, ticket.cost_tokens,
                                          priority=ticket.priority or PRIORITY_INTERACTIVE)
                except ServiceOverloaded as shed:
                    exc = shed
            if exc is None:
                try:
                    target = self._least_loaded(self._eligible(exclude=frozenset({idx})))
                    self._services[target].adopt(ticket)
                    moved += 1
                    continue
                except Exception as adopt_exc:  # noqa: BLE001 — typed below
                    exc = adopt_exc
            if not isinstance(exc, SentioError):
                exc = ReplicaUnavailable(f"inbox handoff failed: {exc}", retry_after_s=2.0,
                                         details={"replica": idx})
            finish_ticket_error(ticket, exc, "failed_over")
        with self._mutex:
            self._handed_off += moved
        logger.warning("replica %d quarantine: %d/%d inbox tickets handed off to survivors",
                       idx, moved, len(tickets))
        get_flight_recorder().record_tick(event="inbox_handoff", replica=idx, handed_off=moved,
                                          failed=len(tickets) - moved)

    def _prune_locked(self, series: deque, now: float) -> None:
        assert_held(self._mutex)
        horizon = now - self.breaker_window_s
        while series and series[0][0] < horizon:
            series.popleft()

    def _supervise_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self._supervise_once()
            except Exception:  # noqa: BLE001 — the supervisor must survive
                logger.exception("replica supervision pass failed")

    def _supervise_once(self) -> None:
        """One breaker + watchdog pass over every replica, then the due
        rebuilds (queued on the pool, or run inline without one). Tests
        call it directly to step supervision."""
        now = time.perf_counter()
        # elastic joins first: a fresh worker is in rotation before this
        # pass's breakers (it may be the survivor a handoff needs)
        self._attach_new_members()
        rebuild_ready: list[int] = []
        retire_ready: list[int] = []
        metrics = get_metrics()
        for idx in range(len(self._services)):
            svc = self._services[idx]
            burst = fails = samples = 0
            with self._mutex:
                health = self._health[idx]
                state = health.state
                if state in _LEAVING:
                    continue
                if state in _SERVING:
                    # each tick-failure increment is one failed decode tick
                    count = svc.tick_failure_count
                    for _ in range(max(count - health.ticks_seen, 0)):
                        health.tick_fails.append((now, False))
                    health.ticks_seen = max(count, health.ticks_seen)
                    self._prune_locked(health.tick_fails, now)
                    self._prune_locked(health.outcomes, now)
                    burst = len(health.tick_fails)
                    fails = sum(1 for _, ok in health.outcomes if not ok)
                    samples = len(health.outcomes)
                rebuild_due = (state == HEALTH_QUARANTINED and now >= health.next_rebuild_at
                               and not health.rebuild_inflight)
            if state in _SERVING and getattr(svc, "deregister_requested", None):
                # a voluntary deregister frame: a graceful retire, on the
                # rebuild pool (its drain must not stall this pass)
                retire_ready.append(idx)
            if state in _OUT_OF_ROTATION:
                # zeroed while out of rotation, or the stall alert would
                # keep firing through the rebuild
                metrics.record_heartbeat_age(idx, 0.0)
                if rebuild_due:
                    rebuild_ready.append(idx)
                continue
            # the stall watchdog: a stale heartbeat with work pending
            budget = svc.tick_stall_budget_s
            age = svc.heartbeat_age() if budget > 0 else None
            metrics.record_heartbeat_age(idx, age if age is not None else 0.0)
            metrics.record_duty_cycle(idx, svc.duty_cycle())
            if age is not None and age > budget:
                get_flight_recorder().record_tick(event="pump_stall", replica=idx,
                                                  heartbeat_age_s=round(age, 3), budget_s=budget)
                self._quarantine(idx, f"pump stalled: heartbeat {age:.1f}s old with pending "
                                      f"work (budget {budget:.0f}s)", stalled=True)
                continue
            if svc.broken:
                self._quarantine(idx, "engine latched broken (reset failed)")
            elif burst >= self.breaker_tick_failures:
                self._quarantine(idx, f"{burst} tick failures inside "
                                      f"{self.breaker_window_s:.0f}s window")
            elif samples >= self.breaker_min_samples and fails / samples >= \
                    self.breaker_error_rate:
                self._quarantine(idx, f"error rate {fails}/{samples} over "
                                      f"{self.breaker_window_s:.0f}s window")
            elif fails > 0 or burst > 0:
                self._transition(idx, HEALTH_DEGRADED,
                                 f"{fails} caller failures / {burst} tick failures in window")
            elif state == HEALTH_DEGRADED:
                self._transition(idx, HEALTH_HEALTHY, "window clean")
        for idx in rebuild_ready:
            if self._stop.is_set():
                break
            if not self._enqueue_rebuild(idx):
                self._rebuild(idx)
        for idx in retire_ready:
            if self._stop.is_set():
                break
            with self._mutex:
                serving_others = sum(1 for i, h in enumerate(self._health)
                                     if i != idx and h.state in _SERVING)
            if serving_others == 0:
                # the last serving replica asked to leave: held until a
                # sibling joins (re-evaluated each pass, so logged at debug)
                logger.debug("replica %d deregister held: last serving replica", idx)
                continue
            if not self._enqueue_retire(idx):
                try:
                    self.retire(idx)
                except Exception:  # noqa: BLE001 — the pass must survive
                    logger.exception("replica %d deregister retire failed", idx)

    def _enqueue_rebuild(self, idx: int) -> bool:
        """Hand a due rebuild to the pool (False: no pool, run inline)."""
        if self._rebuild_q is None:
            return False
        with self._mutex:
            health = self._health[idx]
            if health.rebuild_inflight:
                return True
            health.rebuild_inflight = True
        self._rebuild_q.put(idx)
        return True

    def _rebuild_worker(self) -> None:
        while not self._stop.is_set():
            try:
                idx = self._rebuild_q.get(timeout=0.25)
            except _queue.Empty:
                continue
            if idx is None:
                return  # shutdown
            if isinstance(idx, tuple):
                # ("retire", idx): a deregister's retire rides the same pool
                idx = idx[1]
                try:
                    self.retire(idx)
                except Exception:  # noqa: BLE001 — the pool must survive
                    logger.exception("replica %d retire crashed on worker", idx)
                finally:
                    with self._mutex:
                        if idx < len(self._health):
                            self._health[idx].rebuild_inflight = False
                continue
            try:
                self._rebuild(idx)
            except Exception:  # noqa: BLE001 — the pool must survive
                logger.exception("replica %d rebuild crashed on worker", idx)

    def _rebuild(self, idx: int) -> bool:
        """Rebuild a quarantined replica in place: drain the old service,
        free its engine's device memory if its pump has exited, spawn a
        fresh engine on the same weights behind a fresh service, warm it
        fully, and swap it in. A worker replica (one with ``respawn()``) is
        reborn as a process instead (socket: healed when it re-registers),
        with the same drain, warmup and bookkeeping. Never under
        ``_mutex``. A failure backs off exponentially and leaves the
        replica quarantined."""
        with self._mutex:
            attempt = self._health[idx].rebuild_attempts + 1
            self._health[idx].rebuild_inflight = True
        self._transition(idx, HEALTH_REBUILDING, f"rebuild attempt {attempt}")
        fresh = None
        try:
            faults.hit("replica.rebuild")  # chaos seam: a failed or wedged rebuild
            old = self._services[idx]
            if not old.closed:
                try:
                    # in-flight callers of a working service get a bounded
                    # window; an abandoned one has nothing pending, so its
                    # close's join only counts a wedged pump as leaked
                    old.drain(self.rebuild_drain_s)
                except Exception:  # noqa: BLE001 — drain is best-effort
                    logger.warning("replica %d pre-rebuild drain failed", idx, exc_info=True)
            respawn = getattr(old, "respawn", None)
            if respawn is not None:
                # a worker replica: the drain above closed and reaped the old
                # process (its pool and graphs went with it), a fresh one
                # takes the slot
                fresh = respawn()
            else:
                engine = old.engine
                if old.closed and old.pump_leaked_count == 0:
                    # nothing drives the old engine any more: its pool and
                    # graphs go before the fresh engine allocates, so the
                    # card never holds both (a wedged pump keeps them, and is
                    # counted leaked)
                    engine.release()
                else:
                    engine.trim_cache()
                fresh = PagedGenerationService(
                    engine.spawn_fresh(), default_timeout_s=old.default_timeout_s,
                    max_queue=old.max_queue, default_deadline_s=old.default_deadline_s,
                    retry_budget=old.retry_budget, replica_id=idx,
                    tick_stall_budget_s=old.tick_stall_budget_s,
                    warmup_budget_s=old.warmup_budget_s)
                _name_engine_guard(fresh, idx)
            self._warm_rebuilt(fresh)
            if self._stop.is_set():
                fresh.close()  # never swap a pump into a closing rotation
                return False
            leaked = old.pump_leaked_count
            with self._mutex:
                self._services[idx] = fresh
                self._pump_leaked_carryover += leaked
                health = self._health[idx]
                health.outcomes.clear()
                health.tick_fails.clear()
                health.ticks_seen = 0
                health.rebuild_attempts = 0
                health.rebuilds += 1
            self._transition(idx, HEALTH_HEALTHY, "rebuilt in place")
            return True
        except Exception as exc:  # noqa: BLE001 — rebuild retries on backoff
            logger.exception("replica %d rebuild failed", idx)
            if fresh is not None:
                try:
                    # never entered rotation: its pool must not stack up
                    fresh.close()
                except Exception:  # noqa: BLE001 — already on the error path
                    logger.warning("replica %d failed-rebuild cleanup failed", idx,
                                   exc_info=True)
            now = time.perf_counter()
            with self._mutex:
                health = self._health[idx]
                health.rebuild_attempts += 1
                if health.rebuild_attempts > self.rebuild_budget:
                    backoff = 60.0
                else:
                    backoff = min(self.quarantine_backoff_s
                                  * (2.0 ** (health.rebuild_attempts - 1)), 60.0)
                health.next_rebuild_at = now + backoff
            self._transition(idx, HEALTH_QUARANTINED, f"rebuild failed: {exc}")
            return False
        finally:
            with self._mutex:
                self._health[idx].rebuild_inflight = False

    def _warm_rebuilt(self, fresh: PagedGenerationService) -> None:
        """The full service warmup: on the card every graph variant is
        captured (and the graphs frozen) before the replica re-enters
        rotation — the port has no compile fence, and a capture left to
        live traffic would be an error once frozen. A warmup tick that
        failed (out of memory beside a leaked engine, say) fails the
        rebuild, as JAX's smoke probe does on an error result."""
        fresh.warmup()
        if fresh.tick_failure_count:
            raise RuntimeError(f"rebuilt replica failed {fresh.tick_failure_count} warmup "
                               f"tick(s)")

    def health_summary(self) -> dict:
        """``healthy`` while every replica is HEALTHY, ``degraded`` while at
        least one serves (HEALTHY or DEGRADED), ``unhealthy`` at none."""
        with self._mutex:
            # a RETIRED slot left on purpose: it reads as never there but
            # through the retired count; a RETIRING one is draining, shown
            replicas = [
                {"replica": i, "state": h.state,
                 "since_s": round(time.perf_counter() - h.since, 1), "rebuilds": h.rebuilds,
                 **({"reason": h.last_reason} if h.last_reason else {})}
                for i, h in enumerate(self._health) if h.state != HEALTH_RETIRED]
            joined, retired = self._joined, self._retired
        serving = sum(1 for r in replicas if r["state"] in _SERVING)
        healthy = sum(1 for r in replicas if r["state"] == HEALTH_HEALTHY)
        if healthy == len(replicas):
            status = "healthy"
        elif serving >= 1:
            status = "degraded"
        else:
            status = "unhealthy"
        return {"status": status, "healthy_replicas": healthy, "serving_replicas": serving,
                "total_replicas": len(replicas), "joined_replicas": joined,
                "retired_replicas": retired, "replicas": replicas}

    # ------------------------------------------------------------ lifecycle

    def live_services(self) -> list:
        """(slot, service) of every replica not RETIRED."""
        with self._mutex:
            return [(i, self._services[i]) for i, h in enumerate(self._health)
                    if h.state != HEALTH_RETIRED]

    def _stop_supervisor(self, timeout_s: float = 10.0) -> None:
        if self.autoscaler is not None:
            # first: it must not launch or retire while the set shuts down
            self.autoscaler.close(timeout_s)
        self._stop.set()
        supervisor = self._supervisor
        if supervisor is not None and supervisor.is_alive():
            supervisor.join(timeout=timeout_s)
            if supervisor.is_alive():
                logger.warning("replica supervisor did not exit within %.0fs", timeout_s)
        poller = self._join_poller
        if poller is not None and poller.is_alive():
            # a joiner it is warming is discarded when the poll returns
            poller.join(timeout=timeout_s)
        with self._mutex:
            waiting, self._ready_joins = self._ready_joins, []
        self._discard_joiners(waiting)
        if self._rebuild_q is not None:
            for _ in self._rebuild_pool:
                self._rebuild_q.put(None)
            for t in self._rebuild_pool:
                t.join(timeout=timeout_s)
                if t.is_alive():
                    # a rebuild wedged in a stall; it checks _stop before
                    # swapping, so leaving it is bounded
                    logger.warning("rebuild worker %s did not exit within %.0fs", t.name,
                                   timeout_s)

    def warmup(self, max_new_tokens: int = 4) -> dict:
        """Warm every replica at once, on threads (each captures its own
        graphs over its own pool); a failed replica warmup raises. Returns
        the wall seconds, the prompts, the graph captures and each
        replica's result."""
        t0 = time.perf_counter()
        live = [svc for _i, svc in self.live_services()]
        results: list = [None] * len(live)
        errors: list = []

        def warm(i: int, svc: PagedGenerationService) -> None:
            try:
                results[i] = svc.warmup(max_new_tokens=max_new_tokens)
            except Exception as exc:  # noqa: BLE001 — raised below
                errors.append(exc)

        threads = [threading.Thread(target=warm, args=(i, svc), name=f"replica-warmup-{i}",
                                    daemon=True)
                   for i, svc in enumerate(live)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(svc.default_timeout_s for svc in live) + 120.0)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise RuntimeError("a replica's warmup did not finish")
        return {"seconds": time.perf_counter() - t0,
                "prompts": sum(r["prompts"] for r in results),
                "graph_captures": sum(r["graph_captures"] for r in results),
                "replicas": len(live), "per_replica": results}

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Wait for every replica's pump to stop (see the service's)."""
        deadline = time.perf_counter() + timeout_s
        return all(svc.wait_idle(max(deadline - time.perf_counter(), 0.0))
                   for _i, svc in self.live_services())

    def drain(self, deadline_s: float = 30.0) -> dict:
        """Drain every replica at once, each in the same window, after the
        supervisor stops; the set is closed afterwards."""
        self._stop_supervisor()
        # RETIRED replicas were drained and closed at their retire
        live = self.live_services()
        results: dict[int, Optional[dict]] = {i: None for i, _svc in live}

        def drain_one(i: int, svc: PagedGenerationService) -> None:
            try:
                results[i] = svc.drain(deadline_s)
            except Exception:  # noqa: BLE001 — drain is best-effort
                logger.warning("replica %d drain failed", i, exc_info=True)

        threads = [threading.Thread(target=drain_one, args=(i, svc), name=f"replica-drain-{i}",
                                    daemon=True)
                   for i, svc in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=deadline_s + 15.0)
        per = []
        for i, svc in live:
            res = results[i] or {"drained": False, "abandoned": svc.backlog()}
            per.append({"replica": i, **res})
        with self._mutex:
            self._closed = True
        self._close_registry()
        self._reap_launched()
        return {"drained": all(r["drained"] for r in per),
                "abandoned": sum(r.get("abandoned", 0) for r in per), "replicas": per}

    def close(self) -> None:
        self._stop_supervisor()
        with self._mutex:
            self._closed = True
        for svc in self._services:
            if svc.closed:
                continue  # retired replicas closed at their retire
            try:
                svc.close()
            except Exception:  # noqa: BLE001 — close every replica regardless
                logger.warning("replica %d close failed", svc.replica_id, exc_info=True)
        self._close_registry()
        self._reap_launched()

    def _close_registry(self) -> None:
        if self.registry is not None:
            self.registry.close()

    def _reap_launched(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.reap()

    def workers(self) -> list[dict]:
        """Each live worker replica's process id, incarnation epoch and
        transport (none in thread mode)."""
        return [{"replica": i, "pid": svc.pid, "epoch": svc.epoch,
                 "transport": svc.transport_mode, "alive": not svc.broken}
                for i, svc in self.live_services() if hasattr(svc, "respawn")]

    # ---------------------------------------------------------------- stats

    _SUM_KEYS = (
        "active_slots", "max_slots", "queued", "free_pages", "total_pages", "pool_hbm_bytes",
        "head_skips", "ttft_count", "prefill_tokens", "decode_tokens", "prefix_hits",
        "prefix_misses", "prefix_hit_tokens", "prefix_miss_tokens", "prefix_cache_pages",
        "prefix_cache_nodes", "queued_inbox", "ticks", "completed", "max_queue", "shed",
        "expired", "cancelled", "requeued", "tick_failures", "pump_leaked", "spec_verifies",
        "spec_emitted",
    )
    _MAX_KEYS = ("max_active_slots", "draining")

    def stats(self) -> dict:
        """Counters summed over the replicas' current services, high-water
        marks maxed, TTFT percentiles and occupancy weighted by each
        replica's samples; the per-replica rows under ``replicas``; the
        routing, failover, handoff, stall and resume counters; the tenants
        and the health summary."""
        live = [svc for _i, svc in self.live_services()]
        per = []
        agg: dict = {}
        for svc in live:
            try:
                s = svc.stats()
            except Exception:  # noqa: BLE001 — a replica mid-rebuild
                logger.debug("replica %d stats unavailable", svc.replica_id, exc_info=True)
                continue
            per.append(s)
            for key in self._SUM_KEYS:
                if key in s:
                    agg[key] = agg.get(key, 0) + s[key]
            for key in self._MAX_KEYS:
                if key in s:
                    agg[key] = max(agg.get(key, 0), s[key])
        if not per:
            per = [{}]
        ticks = agg.get("ticks", 0)
        agg["avg_active_slots"] = round(
            sum(s.get("avg_active_slots", 0.0) * s.get("ticks", 0) for s in per) / ticks,
            3) if ticks else 0.0
        hit, miss = agg.get("prefix_hit_tokens", 0), agg.get("prefix_miss_tokens", 0)
        if hit + miss:
            agg["prefix_hit_token_ratio"] = round(hit / (hit + miss), 4)
        ttft_n = sum(s.get("ttft_count", 0) for s in per if "ttft_p50_ms" in s)
        if ttft_n:
            for key in ("ttft_p50_ms", "ttft_p95_ms"):
                agg[key] = round(sum(s[key] * s.get("ttft_count", 0) for s in per if key in s)
                                 / ttft_n, 2)
        if agg.get("spec_verifies"):
            agg["spec_tokens_per_verify"] = round(agg.get("spec_emitted", 0)
                                                  / agg["spec_verifies"], 2)
        phase_totals, duty_elapsed = sum_phase_totals(per)
        if duty_elapsed > 0:
            agg["phase_seconds"] = {k: round(v, 6) for k, v in phase_totals.items()}
            agg["duty_elapsed_s"] = round(duty_elapsed, 6)
            agg["duty_cycle"] = duty_fractions(phase_totals, duty_elapsed)
        agg["page_size"] = per[0].get("page_size")
        agg["kv_quant"] = per[0].get("kv_quant")
        agg["n_replicas"] = len(per)
        agg["replicas"] = per
        with self._mutex:
            agg["routing"] = {"affinity": self._routed_affinity,
                              "least_loaded": self._routed_load,
                              "affinity_overflow": self._affinity_overflow}
            agg["failovers"] = self._failovers
            agg["handed_off"] = self._handed_off
            agg["stall_quarantines"] = self._stall_quarantines
            agg["pump_leaked"] = agg.get("pump_leaked", 0) + self._pump_leaked_carryover
            agg["stream_resumes"] = self._stream_resumes
            agg["resume_replayed_tokens"] = self._resume_replayed_tokens
            agg["resume_exhausted"] = self._resume_exhausted
            # the elastic fleet: joins, retires and the retires' drain p95
            drains = sorted(self._retire_drain_s)
            agg["fleet"] = {"live_replicas": len(live), "joined": self._joined,
                            "retired": self._retired,
                            **({"retire_drain_p95_s": round(
                                drains[min(int(len(drains) * 0.95), len(drains) - 1)], 3)}
                               if drains else {})}
        agg["tenants"] = self.tenants.stats()
        agg["health"] = self.health_summary()
        return agg
