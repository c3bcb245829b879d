"""Shape bucketing and the cross-thread query coalescer, copied from
``sentio_tpu/parallel/batcher.py`` (``bucket_size``, ``floor_bucket``,
``ThreadBatcher`` and its stats and errors; the asyncio ``Batcher`` is
left out: the port's server runs each request on a thread of its own).
The stats add ``max_batch``, the largest batch dispatched."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Generic, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class BatcherClosed(Exception):
    pass


class BatcherTimeout(Exception):
    pass


@dataclass
class BatcherStats:
    batches: int = 0
    items: int = 0
    errors: int = 0
    occupancy_sum: float = 0.0
    wait_ms_sum: float = 0.0
    max_batch: int = 0

    def snapshot(self) -> dict[str, float]:
        return {
            "batches": self.batches,
            "items": self.items,
            "errors": self.errors,
            "avg_occupancy": round(self.occupancy_sum / self.batches, 3) if self.batches else 0.0,
            "avg_wait_ms": round(self.wait_ms_sum / self.items, 3) if self.items else 0.0,
            "max_batch": self.max_batch,
        }


class _SyncPending(Generic[T, R]):
    __slots__ = ("item", "event", "result", "error", "enqueued_at")

    def __init__(self, item: T) -> None:
        self.item = item
        self.event = threading.Event()
        self.result: Optional[R] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.perf_counter()


class ThreadBatcher(Generic[T, R]):
    """Cross-thread deadline coalescer. ``submit`` blocks the calling
    thread until its result is ready; one daemon dispatcher thread collects
    items for up to ``deadline_ms`` (or ``max_size``) and calls
    ``process_fn`` once per batch. One result per item, in order; a failing
    batch fails only its own callers."""

    def __init__(
        self,
        process_fn: Callable[[list[T]], Sequence[R]],
        max_size: int = 8,
        deadline_ms: float = 8.0,
        name: str = "thread-batcher",
        timeout_s: float = 120.0,
    ) -> None:
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.process_fn = process_fn
        self.max_size = max_size
        self.deadline_s = max(deadline_ms, 0.0) / 1000.0
        self.timeout_s = timeout_s
        self.name = name
        self.stats = BatcherStats()
        self._queue: deque[_SyncPending[T, R]] = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    def submit(self, item: T) -> R:
        pending: _SyncPending[T, R] = _SyncPending(item)
        with self._cond:
            if self._closed:
                raise BatcherClosed(f"{self.name} is closed")
            self._queue.append(pending)
            self._ensure_worker()
            self._cond.notify_all()
        # bounded wait: a wedged process_fn surfaces as an error the
        # degradation ladder can act on, not a deadlocked request thread
        if not pending.event.wait(self.timeout_s):
            pending.error = BatcherTimeout(
                f"{self.name}: batch did not complete within {self.timeout_s:.0f}s"
            )
            pending.event.set()
            raise pending.error
        if pending.error is not None:
            raise pending.error
        return pending.result  # type: ignore[return-value]

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None

    def _ensure_worker(self) -> None:  # _cond held
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, name=self.name, daemon=True)
            self._worker.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                deadline = time.perf_counter() + self.deadline_s
                while len(self._queue) < self.max_size and not self._closed:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = []
                while self._queue and len(batch) < self.max_size:
                    pending = self._queue.popleft()
                    if not pending.event.is_set():  # skip timed-out waiters
                        batch.append(pending)
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: list[_SyncPending[T, R]]) -> None:
        now = time.perf_counter()
        self.stats.batches += 1
        self.stats.items += len(batch)
        self.stats.max_batch = max(self.stats.max_batch, len(batch))
        self.stats.occupancy_sum += len(batch) / self.max_size
        self.stats.wait_ms_sum += sum((now - p.enqueued_at) * 1000.0 for p in batch)
        try:
            results = self.process_fn([p.item for p in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"{self.name}: process_fn returned {len(results)} results "
                    f"for {len(batch)} items"
                )
            for pending, result in zip(batch, results):
                pending.result = result
                pending.event.set()
        except BaseException as exc:  # noqa: BLE001 — fail the batch, not the batcher
            self.stats.errors += 1
            for pending in batch:
                if not pending.event.is_set():
                    pending.error = exc
                    pending.event.set()
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                raise


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; past every bucket, n itself (callers pad by
    ``bucket - n``, which must never go negative)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return n


def floor_bucket(n: int, buckets: Sequence[int]) -> int:
    """Largest bucket <= n (min(buckets) if none fit) — for quantities that
    must round DOWN, like decode step counts bounded by cache headroom."""
    best = min(buckets)
    for b in sorted(buckets):
        if b <= n:
            best = b
    return best
