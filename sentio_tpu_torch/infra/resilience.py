"""The degradation ladder's disk and template tiers — a copy of
``FallbackResponseCache`` and ``LLMFallback`` from
``sentio_tpu/infra/resilience.py``.

A failing ``/chat`` first replays the cached response for the question
(the query cache), then the last good answer persisted on disk
(:class:`FallbackResponseCache`), then a template answer
(``prompts/fallback_no_llm.md``), then the apology template.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any, Optional

from sentio_tpu_torch.ops.prompts import PromptBuilder

logger = logging.getLogger(__name__)


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
