"""Response security headers and the per-IP rate limiter — a copy of
``SECURITY_HEADERS``, ``RateLimitConfig`` and ``IPRateLimiter`` from
``sentio_tpu/infra/security.py``."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from sentio_tpu_torch.infra.exceptions import RateLimitError

SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "X-XSS-Protection": "1; mode=block",
    "Referrer-Policy": "strict-origin-when-cross-origin",
    "Cache-Control": "no-store",
    "Content-Security-Policy": "default-src 'none'",
}


@dataclass
class RateLimitConfig:
    per_minute: int = 100


class IPRateLimiter:
    """Per-IP sliding window of one minute per endpoint bucket."""

    def __init__(self, default: Optional[RateLimitConfig] = None) -> None:
        self.default = default or RateLimitConfig()
        self.per_endpoint: dict[str, RateLimitConfig] = {}
        self._events: dict[tuple[str, str], list[float]] = {}
        self._lock = threading.Lock()
        self._checks_since_sweep = 0

    def _maybe_sweep(self, now: float) -> None:
        """Drop idle (ip, endpoint) keys so rotating IPs cannot grow the
        table without bound. Called under the lock."""
        self._checks_since_sweep += 1
        if self._checks_since_sweep < 1024 and len(self._events) < 16_384:
            return
        self._checks_since_sweep = 0
        doomed = [k for k, w in self._events.items() if not w or now - w[-1] >= 60.0]
        for k in doomed:
            del self._events[k]

    def configure(self, endpoint: str, per_minute: int) -> None:
        self.per_endpoint[endpoint] = RateLimitConfig(per_minute=per_minute)

    def check(self, ip: str, endpoint: str = "*") -> None:
        limit = max(int(self.per_endpoint.get(endpoint, self.default).per_minute), 1)
        now = time.perf_counter()
        key = (ip, endpoint)
        with self._lock:
            self._maybe_sweep(now)
            window = [t for t in self._events.get(key, []) if now - t < 60.0]
            if len(window) >= limit:
                retry = 60.0 - (now - window[0])
                raise RateLimitError(
                    f"rate limit {limit}/min exceeded for {endpoint}",
                    retry_after_s=max(retry, 1.0),
                )
            window.append(now)
            self._events[key] = window
