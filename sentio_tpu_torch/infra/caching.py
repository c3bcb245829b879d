"""The query-response cache — a copy of ``MemoryCache`` and the memory
tier of ``CacheManager`` from ``sentio_tpu/infra/caching.py``.

``CACHE_BACKEND=memory`` (the default) keeps an LRU with a per-entry TTL;
``off`` caches nothing; ``multi_tier`` (the Redis L2) is not ported and
raises ``NotImplementedError``. The ``/chat`` handler fills it with every
good answer and replays it as the first tier of its degradation ladder.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

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



class CacheManager:
    """The memory tier with the TTL strategy: every non-None value is
    cached, for the configured TTL unless the caller gives one."""

    def __init__(self, config: Optional[CacheConfig] = None) -> None:
        self.config = config or CacheConfig()
        if self.config.backend == "multi_tier":
            raise NotImplementedError("CACHE_BACKEND=multi_tier: the Redis L2 cache is "
                                      "not ported")
        self.l1 = MemoryCache(self.config.max_entries, self.config.default_ttl_s)
        self.enabled = self.config.backend != "off"

    def get(self, key: str) -> Optional[Any]:
        if not self.enabled:
            return None
        return self.l1.get(key)

    def set(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        if not self.enabled or value is None:
            return
        self.l1.set(key, value, ttl_s if ttl_s is not None else self.config.default_ttl_s)

    def get_query_response(self, query: str) -> Optional[dict]:
        return self.get(f"query:{query.strip().lower()}")

    def set_query_response(self, query: str, response: dict) -> None:
        self.set(f"query:{query.strip().lower()}", response, self.config.query_cache_ttl_s)
