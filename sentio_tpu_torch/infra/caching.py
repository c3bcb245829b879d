"""The cache tiers — a copy of ``sentio_tpu/infra/caching.py``: an LRU with
a per-entry TTL (L1), a pluggable L2 (the Redis tier of
``infra/redis_cache.py`` under ``CACHE_BACKEND=multi_tier``), the
should-cache / TTL strategies and the manager.

``CACHE_BACKEND=memory`` (the default) keeps the LRU alone; ``off`` caches
nothing; ``multi_tier`` puts the LRU in front of Redis at ``REDIS_URL``.
The ``/chat`` handler fills the query cache with every good answer and
replays it as the first tier of its degradation ladder, through the sync
L1 surface (``get`` / ``set``), as JAX's handler does under every backend.
:meth:`CacheManager.tiered_get` and :meth:`CacheManager.tiered_set` are
JAX's ``aget`` / ``aset``: the L2 behind L1, an L2 hit promoted to L1, an
L2 failure a miss. JAX's L2 surface is asyncio; the port's server runs on
threads, so the port's is blocking.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional, Protocol

from sentio_tpu_torch.config import CacheConfig


class MemoryCache:
    """Thread-safe LRU with per-entry TTL."""

    def __init__(self, max_entries: int = 10_000, default_ttl_s: float = 3600.0) -> None:
        self.max_entries = max_entries
        self.default_ttl_s = default_ttl_s
        self._store: OrderedDict[str, tuple[Any, float, float]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            entry = self._store.get(key)
            if entry is None:
                self.misses += 1
                return None
            value, stored_at, ttl = entry
            if ttl > 0 and time.perf_counter() - stored_at > ttl:
                del self._store[key]
                self.misses += 1
                return None
            self._store.move_to_end(key)
            self.hits += 1
            return value

    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        with self._lock:
            ttl = self.default_ttl_s if ttl_s is None else ttl_s
            if key in self._store:
                self._store.move_to_end(key)
            self._store[key] = (value, time.perf_counter(), ttl)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)
                self.evictions += 1

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._store.pop(key, None) is not None

    def clear(self, pattern: str = "*") -> int:
        with self._lock:
            if pattern == "*":
                n = len(self._store)
                self._store.clear()
                return n
            doomed = [k for k in self._store if fnmatch.fnmatch(k, pattern)]
            for k in doomed:
                del self._store[k]
            return len(doomed)

    def cleanup_expired(self) -> int:
        now = time.perf_counter()
        with self._lock:
            doomed = [k for k, (_, at, ttl) in self._store.items() if ttl > 0 and now - at > ttl]
            for k in doomed:
                del self._store[k]
            return len(doomed)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._store), "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                    "hit_rate": round(self.hits / total, 4) if total else 0.0}


class L2Cache(Protocol):
    """The second tier (Redis-shaped). Implementations never raise into the
    caller; the manager reads any exception as a miss all the same."""

    def get(self, key: str) -> Optional[Any]: ...
    def set(self, key: str, value: Any, ttl_s: float) -> None: ...
    def delete(self, key: str) -> None: ...
    def ping(self) -> bool: ...


class NullL2Cache:
    """No second tier: always a miss, never healthy."""

    def get(self, key: str) -> Optional[Any]:
        return None

    def set(self, key: str, value: Any, ttl_s: float) -> None:
        return None

    def delete(self, key: str) -> None:
        return None

    def ping(self) -> bool:
        return False


# --------------------------------------------------------------------- strategies


class CacheStrategy(Protocol):
    def should_cache(self, key: str, value: Any) -> bool: ...
    def ttl_for(self, key: str, value: Any) -> float: ...


@dataclass
class TTLStrategy:
    ttl_s: float = 3600.0

    def should_cache(self, key: str, value: Any) -> bool:
        return value is not None

    def ttl_for(self, key: str, value: Any) -> float:
        return self.ttl_s


@dataclass
class SizeAwareStrategy:
    """Skip oversized values (the size estimated by the repr's length)."""

    max_bytes: int = 256 * 1024
    ttl_s: float = 3600.0

    def should_cache(self, key: str, value: Any) -> bool:
        if value is None:
            return False
        try:
            return len(repr(value)) <= self.max_bytes
        except Exception:  # noqa: BLE001 — a value with no repr fails the size gate
            return False

    def ttl_for(self, key: str, value: Any) -> float:
        return self.ttl_s


class AdaptiveStrategy:
    """Learns each key prefix's hit rate and stretches the TTL of hot
    prefixes, shrinks that of cold ones."""

    def __init__(self, base_ttl_s: float = 3600.0) -> None:
        self.base_ttl_s = base_ttl_s
        self._hits: dict[str, int] = {}
        self._misses: dict[str, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _prefix(key: str) -> str:
        return key.split(":", 1)[0]

    def record(self, key: str, hit: bool) -> None:
        p = self._prefix(key)
        with self._lock:
            table = self._hits if hit else self._misses
            table[p] = table.get(p, 0) + 1

    def hit_rate(self, key: str) -> float:
        p = self._prefix(key)
        with self._lock:
            h, m = self._hits.get(p, 0), self._misses.get(p, 0)
        return h / (h + m) if h + m else 0.5

    def should_cache(self, key: str, value: Any) -> bool:
        return value is not None

    def ttl_for(self, key: str, value: Any) -> float:
        return self.base_ttl_s * (0.25 + 1.5 * self.hit_rate(key))


# ----------------------------------------------------------------------- manager


class CacheManager:
    """``memory`` or ``multi_tier`` (L1 in front of an L2, an L2 hit
    promoted to L1); an L2 failure degrades to L1 alone."""

    def __init__(self, config: Optional[CacheConfig] = None, l2: Optional[L2Cache] = None,
                 strategy: Optional[CacheStrategy] = None) -> None:
        self.config = config or CacheConfig()
        self.l1 = MemoryCache(self.config.max_entries, self.config.default_ttl_s)
        if l2 is None and self.config.backend == "multi_tier":
            from sentio_tpu_torch.infra.redis_cache import RedisL2Cache

            l2 = RedisL2Cache(url=self.config.redis_url,
                              key_prefix=self.config.redis_key_prefix)
        self.l2: L2Cache = l2 or NullL2Cache()
        self.strategy: CacheStrategy = strategy or TTLStrategy(self.config.default_ttl_s)
        self.enabled = self.config.backend != "off"
        self.multi_tier = self.config.backend == "multi_tier"

    # the sync L1 surface
    def get(self, key: str) -> Optional[Any]:
        if not self.enabled:
            return None
        value = self.l1.get(key)
        if isinstance(self.strategy, AdaptiveStrategy):
            self.strategy.record(key, hit=value is not None)
        return value

    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        if not self.enabled or not self.strategy.should_cache(key, value):
            return
        self.l1.set(key, value, ttl_s if ttl_s is not None else self.strategy.ttl_for(key, value))

    # the tiered surface adds the L2
    def tiered_get(self, key: str) -> Optional[Any]:
        value = self.get(key)
        if value is not None or not self.multi_tier:
            return value
        try:
            value = self.l2.get(key)
        except Exception:  # noqa: BLE001 — an L2 outage is a miss
            return None
        if value is not None:  # promote
            self.l1.set(key, value)
        return value

    def tiered_set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        self.set(key, value, ttl_s)
        if self.multi_tier and self.strategy.should_cache(key, value):
            try:
                self.l2.set(key, value,
                            ttl_s if ttl_s is not None else self.strategy.ttl_for(key, value))
            except Exception:  # noqa: BLE001 — the L2 write-through is best effort
                pass

    # typed helpers
    def get_query_response(self, query: str) -> Optional[dict]:
        return self.get(f"query:{query.strip().lower()}")

    def set_query_response(self, query: str, response: dict) -> None:
        self.set(f"query:{query.strip().lower()}", response, self.config.query_cache_ttl_s)

    def get_embedding(self, text_hash: str) -> Optional[Any]:
        return self.get(f"emb:{text_hash}")

    def set_embedding(self, text_hash: str, vec: Any) -> None:
        self.set(f"emb:{text_hash}", vec)

    def stats(self) -> dict[str, Any]:
        return {"backend": self.config.backend, "l1": self.l1.stats(),
                "multi_tier": self.multi_tier}

    def close(self) -> None:
        """Close the L2's connection, if it has one."""
        close = getattr(self.l2, "close", None)
        if close is not None:
            close()
