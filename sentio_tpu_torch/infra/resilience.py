"""Resilience — a copy of ``sentio_tpu/infra/resilience.py``: circuit
breakers (closed, open, half-open, with stats and a registry that
``/health/detailed`` reports), jittered exponential retries, the
breaker + retry + timeout combinator, the periodic health checker, and the
degradation ladder's disk and template tiers.

JAX's breakers and retries have a sync and an asyncio face; the port runs
on threads, so it has the sync one: :meth:`ResilientCall.execute` bounds a
call with a worker thread's timeout where JAX bounds a coroutine, and
:class:`HealthChecker` probes from a daemon thread where JAX runs an
asyncio task. A breaker's transitions also set
``sentio_circuit_breaker_state`` on ``/metrics``, and a breaker leaves the
registry when its owner closes it (:func:`unregister_breaker`).

A failing ``/chat`` first replays the cached response for the question
(the query cache), then the last good answer persisted on disk
(:class:`FallbackResponseCache`), then a template answer
(``prompts/fallback_no_llm.md``), then the apology template.
"""

from __future__ import annotations

import concurrent.futures
import functools
import hashlib
import json
import logging
import random
import threading
import time
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Any, Callable, Optional, TypeVar

from sentio_tpu_torch.infra.exceptions import CircuitOpenError, TimeoutError_
from sentio_tpu_torch.ops.prompts import PromptBuilder

logger = logging.getLogger(__name__)

T = TypeVar("T")


class CircuitState(str, Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


_breakers: dict[str, "CircuitBreaker"] = {}
_registry_lock = threading.Lock()


def registered_breakers() -> dict[str, "CircuitBreaker"]:
    """The live breakers by name, for health reporting."""
    with _registry_lock:
        return dict(_breakers)


def unregister_breaker(breaker: "CircuitBreaker") -> None:
    """Take ``breaker`` out of the registry (if its name still maps to it)."""
    with _registry_lock:
        if _breakers.get(breaker.name) is breaker:
            del _breakers[breaker.name]


@dataclass
class BreakerStats:
    calls: int = 0
    failures: int = 0
    successes: int = 0
    rejected: int = 0
    state_changes: int = 0
    consecutive_failures: int = 0


class CircuitBreaker:
    """Thread-safe breaker: OPEN after ``failure_threshold`` consecutive
    failures, a HALF_OPEN probe after ``recovery_timeout_s``, CLOSED again
    after ``success_threshold`` probe successes."""

    def __init__(self, name: str = "breaker", failure_threshold: int = 5,
                 recovery_timeout_s: float = 30.0, success_threshold: int = 2) -> None:
        self.name = name
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self.success_threshold = success_threshold
        self.state = CircuitState.CLOSED
        self.stats = BreakerStats()
        self._opened_at = 0.0
        self._half_open_successes = 0
        self._lock = threading.Lock()
        with _registry_lock:
            _breakers[name] = self

    def _transition(self, new_state: CircuitState) -> None:
        if new_state != self.state:
            logger.info("breaker %s: %s -> %s", self.name, self.state.value, new_state.value)
            self.state = new_state
            self.stats.state_changes += 1
            try:
                from sentio_tpu_torch.infra.metrics import get_metrics

                get_metrics().record_breaker(self.name, new_state.value)
            except Exception:  # noqa: BLE001 — telemetry never fails a breaker
                logger.debug("breaker metric failed", exc_info=True)

    def allow(self) -> bool:
        with self._lock:
            if self.state == CircuitState.CLOSED:
                return True
            if self.state == CircuitState.OPEN:
                if time.monotonic() - self._opened_at >= self.recovery_timeout_s:
                    self._transition(CircuitState.HALF_OPEN)
                    self._half_open_successes = 0
                    return True
                self.stats.rejected += 1
                return False
            return True  # HALF_OPEN probes flow

    def record_success(self) -> None:
        with self._lock:
            self.stats.calls += 1
            self.stats.successes += 1
            self.stats.consecutive_failures = 0
            if self.state == CircuitState.HALF_OPEN:
                self._half_open_successes += 1
                if self._half_open_successes >= self.success_threshold:
                    self._transition(CircuitState.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.stats.calls += 1
            self.stats.failures += 1
            self.stats.consecutive_failures += 1
            if self.state == CircuitState.HALF_OPEN or (
                    self.state == CircuitState.CLOSED
                    and self.stats.consecutive_failures >= self.failure_threshold):
                self._transition(CircuitState.OPEN)
                self._opened_at = time.monotonic()

    def call(self, fn: Callable[..., T], *args, **kwargs) -> T:
        if not self.allow():
            raise CircuitOpenError(f"circuit {self.name} is open")
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def health(self) -> dict[str, Any]:
        return {"name": self.name, "state": self.state.value,
                "failures": self.stats.failures, "successes": self.stats.successes,
                "rejected": self.stats.rejected,
                "consecutive_failures": self.stats.consecutive_failures}


@dataclass
class RetryPolicy:
    """Jittered exponential backoff; ``rng`` (a seeded ``random.Random``)
    makes the jitter deterministic, None uses the module's generator."""

    max_attempts: int = 3
    base_delay_s: float = 0.2
    max_delay_s: float = 10.0
    jitter: float = 0.25
    retry_on: tuple[type[Exception], ...] = (Exception,)
    rng: Optional[random.Random] = None

    def _check_attempts(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"RetryPolicy.max_attempts must be >= 1, got {self.max_attempts}")

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay_s * (2 ** attempt), self.max_delay_s)
        jitter = (self.rng or random).uniform(-self.jitter, self.jitter)
        return d * (1.0 + jitter)

    def run(self, fn: Callable[..., T], *args, **kwargs) -> T:
        self._check_attempts()
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                last = exc
                if attempt < self.max_attempts - 1:
                    time.sleep(self.delay(attempt))
        raise last  # type: ignore[misc]


class ResilientCall:
    """Breaker + retry + timeout around a callable: each attempt runs on a
    worker thread and is abandoned after ``timeout_s`` (a
    :class:`TimeoutError_`, which the breaker counts)."""

    def __init__(self, name: str, breaker: Optional[CircuitBreaker] = None,
                 retry: Optional[RetryPolicy] = None, timeout_s: float = 30.0,
                 max_workers: int = 4) -> None:
        self.name = name
        self.breaker = breaker or CircuitBreaker(name=name)
        self.retry = retry or RetryPolicy()
        self.timeout_s = timeout_s
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=f"resilient-{name}")

    def execute(self, fn: Callable[..., T], *args, **kwargs) -> T:
        def bounded() -> T:
            future = self._pool.submit(fn, *args, **kwargs)
            try:
                return future.result(timeout=self.timeout_s)
            except concurrent.futures.TimeoutError as exc:
                raise TimeoutError_(f"{self.name} timed out after {self.timeout_s}s") from exc

        return self.retry.run(self.breaker.call, bounded)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def with_circuit_breaker(breaker: CircuitBreaker):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return breaker.call(fn, *args, **kwargs)

        return wrapper

    return deco


def with_retry(policy: Optional[RetryPolicy] = None):
    policy = policy or RetryPolicy()

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return policy.run(fn, *args, **kwargs)

        return wrapper

    return deco


class HealthChecker:
    """Runs each registered probe every ``interval_s`` on a daemon thread
    and keeps the latest verdict per probe."""

    def __init__(self, interval_s: float = 30.0) -> None:
        self.interval_s = interval_s
        self._probes: dict[str, Callable[[], bool]] = {}
        self._results: dict[str, dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, name: str, probe: Callable[[], bool]) -> None:
        self._probes[name] = probe

    def run_once(self) -> None:
        """One pass over every probe."""
        for name, probe in list(self._probes.items()):
            try:
                ok = bool(probe())
            except Exception as exc:  # noqa: BLE001 — a failing probe is a verdict
                # wall-clock: the reported probe time
                self._results[name] = {"ok": False, "error": str(exc), "at": time.time()}
                continue
            self._results[name] = {"ok": ok, "at": time.time()}

    def _loop(self) -> None:
        while True:
            self.run_once()
            if self._stop.wait(self.interval_s):
                return

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="health-checker",
                                            daemon=True)
            self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def results(self) -> dict[str, dict[str, Any]]:
        return dict(self._results)


# ---------------------------------------------------------------------------
# the degradation ladder's tiers


class FallbackResponseCache:
    """Disk-persisted query → answer cache, sha256 keys + TTL, at most
    ``max_entries`` answers (least recently used evicted first); every
    mutation, expired-entry deletion included, persists."""

    def __init__(self, cache_dir: Optional[str] = None, ttl_s: float = 24 * 3600.0,
                 max_entries: int = 512) -> None:
        self.dir = Path(cache_dir or Path.home() / ".cache" / "sentio_tpu_torch_fallback")
        self.ttl_s = ttl_s
        self.max_entries = max(int(max_entries), 1)
        self._path = self.dir / "responses.json"
        self._store: dict[str, dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._load()

    @staticmethod
    def _key(query: str) -> str:
        return hashlib.sha256(query.strip().lower().encode()).hexdigest()

    def _load(self) -> None:
        try:
            self._store = json.loads(self._path.read_text())
        except (OSError, json.JSONDecodeError):
            self._store = {}

    def _persist(self) -> None:
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._path.write_text(json.dumps(self._store))
        except OSError:
            logger.warning("fallback cache persist failed", exc_info=True)

    def _evict_locked(self) -> None:
        while len(self._store) > self.max_entries:
            oldest = min(
                self._store,
                key=lambda k: self._store[k].get("last_used", self._store[k].get("at", 0.0)),
            )
            del self._store[oldest]

    def put(self, query: str, response: str) -> None:
        with self._lock:
            # wall-clock: the TTL persists across restarts
            self._store[self._key(query)] = {"response": response, "at": time.time()}
            self._evict_locked()
            self._persist()

    def get(self, query: str) -> Optional[str]:
        with self._lock:
            entry = self._store.get(self._key(query))
            if entry is None:
                return None
            if self.ttl_s > 0 and time.time() - entry["at"] > self.ttl_s:
                del self._store[self._key(query)]
                self._persist()
                return None
            # recency for eviction; not persisted on every read
            entry["last_used"] = time.time()
            return entry["response"]


class LLMFallback:
    """Tier 2: the template answer (``prompts/fallback_*.md``); tier 3 is
    the apology template."""

    def __init__(self, prompts_dir: Optional[str] = None) -> None:
        self._prompts = PromptBuilder(prompts_dir)

    def no_llm(self, context: str) -> str:
        return self._prompts.build("fallback_no_llm", context=context)

    def apology(self) -> str:
        return self._prompts.build("fallback_apology")
