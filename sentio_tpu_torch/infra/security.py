"""Security utilities — a copy of ``sentio_tpu/infra/security.py``: the
log sanitizer (a root-logger filter that redacts credentials, API keys and
JWTs from every record, installed once a process by
:func:`setup_log_sanitization`), the input validator, the response
security headers, random tokens, the per-IP rate limiter and CSRF tokens.
"""

from __future__ import annotations

import hmac
import html
import logging
import re
import secrets
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from sentio_tpu_torch.infra.exceptions import RateLimitError, ValidationError

_REDACTION_PATTERNS = [
    # key=value / key: value forms for credential-like keys
    re.compile(
        r"(?i)\b(api[_-]?key|authorization|secret|token|password|bearer)"
        r"([\"']?\s*[:=]\s*[\"']?)([^\s\"',;&]+)"
    ),
    re.compile(r"\bstk_[A-Za-z0-9_\-]{16,}\b"),  # the API keys AuthManager issues
    re.compile(r"\beyJ[A-Za-z0-9_\-]+\.[A-Za-z0-9_\-]+\.[A-Za-z0-9_\-]+\b"),  # JWTs
]


def sanitize_text(text: str) -> str:
    out = _REDACTION_PATTERNS[0].sub(lambda m: f"{m.group(1)}{m.group(2)}[REDACTED]", text)
    out = _REDACTION_PATTERNS[1].sub("[REDACTED_KEY]", out)
    return _REDACTION_PATTERNS[2].sub("[REDACTED_JWT]", out)


class LogSanitizer(logging.Filter):
    """Redacts secrets from every record it sees."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            message = record.getMessage()
            sanitized = sanitize_text(message)
            if sanitized != message:
                record.msg = sanitized
                record.args = ()
        except Exception:  # noqa: BLE001 — sanitizing must never break logging itself
            pass
        return True


_sanitizer_lock = threading.Lock()
_sanitizer_installed = False


def setup_log_sanitization() -> None:
    """Install a :class:`LogSanitizer` on the root logger and its handlers,
    once a process."""
    global _sanitizer_installed
    with _sanitizer_lock:
        if _sanitizer_installed:
            return
        root = logging.getLogger()
        root.addFilter(LogSanitizer())
        for handler in root.handlers:
            handler.addFilter(LogSanitizer())
        _sanitizer_installed = True


_CONTROL_CHARS = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
_SUSPICIOUS = re.compile(
    r"(?i)(<script\b|javascript:|on\w+\s*=|\bunion\s+select\b|\bdrop\s+table\b)"
)


class InputValidator:
    """Query, content and metadata validation."""

    def __init__(self, max_query_chars: int = 2000, max_content_chars: int = 50_000) -> None:
        self.max_query_chars = max_query_chars
        self.max_content_chars = max_content_chars

    def validate_query(self, query: Any) -> str:
        if not isinstance(query, str):
            raise ValidationError("question must be a string")
        query = _CONTROL_CHARS.sub("", query).strip()
        if not query:
            raise ValidationError("question must be non-empty")
        if len(query) > self.max_query_chars:
            raise ValidationError(f"question exceeds {self.max_query_chars} characters")
        if _SUSPICIOUS.search(query):
            raise ValidationError("question contains disallowed content")
        return query

    def validate_content(self, content: Any) -> str:
        if not isinstance(content, str):
            raise ValidationError("content must be a string")
        content = _CONTROL_CHARS.sub("", content)
        if not content.strip():
            raise ValidationError("content must be non-empty")
        if len(content) > self.max_content_chars:
            raise ValidationError(f"content exceeds {self.max_content_chars} characters")
        return content

    def validate_metadata(self, metadata: Any) -> dict[str, Any]:
        if metadata is None:
            return {}
        if not isinstance(metadata, dict):
            raise ValidationError("metadata must be an object")
        if len(metadata) > 64:
            raise ValidationError("metadata has too many keys")
        out: dict[str, Any] = {}
        for key, value in metadata.items():
            if not isinstance(key, str) or len(key) > 128:
                raise ValidationError("metadata keys must be short strings")
            if isinstance(value, str):
                if len(value) > 4096:
                    raise ValidationError(f"metadata value for {key!r} too long")
                out[key] = _CONTROL_CHARS.sub("", value)
            elif isinstance(value, (int, float, bool)) or value is None:
                out[key] = value
            else:
                raise ValidationError(f"metadata value for {key!r} must be scalar")
        return out

    @staticmethod
    def sanitize_html(text: str) -> str:
        return html.escape(text, quote=True)


SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "X-XSS-Protection": "1; mode=block",
    "Referrer-Policy": "strict-origin-when-cross-origin",
    "Cache-Control": "no-store",
    "Content-Security-Policy": "default-src 'none'",
}


class TokenGenerator:
    @staticmethod
    def token(n_bytes: int = 32) -> str:
        return secrets.token_urlsafe(n_bytes)

    @staticmethod
    def numeric_code(digits: int = 6) -> str:
        return "".join(secrets.choice("0123456789") for _ in range(digits))


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


class CSRFProtection:
    """HMAC-SHA256 tokens of ``<epoch seconds>.<mac>`` bound to a session
    id."""

    def __init__(self, secret: Optional[str] = None) -> None:
        self._secret = (secret or secrets.token_urlsafe(32)).encode()

    def issue(self, session_id: str) -> str:
        ts = str(int(time.time()))  # wall-clock: the token's stamp crosses processes
        mac = hmac.new(self._secret, f"{session_id}:{ts}".encode(), "sha256").hexdigest()
        return f"{ts}.{mac}"

    def verify(self, session_id: str, token: str, max_age_s: float = 3600.0) -> bool:
        try:
            ts, mac = token.split(".")
            if time.time() - float(ts) > max_age_s:
                return False
        except ValueError:
            return False
        expected = hmac.new(self._secret, f"{session_id}:{ts}".encode(), "sha256").hexdigest()
        return hmac.compare_digest(mac, expected)
