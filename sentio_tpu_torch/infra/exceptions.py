"""The typed errors of the generation service — a copy of the classes of
``sentio_tpu/infra/exceptions.py`` that ``runtime/service.py`` raises.

Each carries a code, an HTTP status and ``details``. The three serving
errors are ``soft_fail_exempt``: the ``/chat`` degradation ladder lets
them raise (a shed or an expired caller gets a typed 429/503/504, not an
empty answer), where any other generation error degrades.
"""

from __future__ import annotations

from typing import Any, Optional

_STATUS = {"OVERLOADED": 503, "DEADLINE_EXCEEDED": 504, "SERVICE_UNAVAILABLE": 503}


class SentioError(Exception):
    """Base error: code + HTTP status + safe-to-serialize details."""

    code = "INTERNAL_ERROR"

    def __init__(self, message: str, status: Optional[int] = None,
                 details: Optional[dict[str, Any]] = None, retryable: bool = False) -> None:
        super().__init__(message)
        self.message = message
        self.status = status or _STATUS.get(self.code, 500)
        self.details = details or {}
        self.retryable = retryable


class ServiceOverloaded(SentioError):
    """Load shed at admission: the queue is full, the service is draining,
    or the request's deadline cannot be met. ``details["retry_after_s"]``
    says when to come back."""

    code = "OVERLOADED"
    soft_fail_exempt = True

    def __init__(self, message: str = "service overloaded", retry_after_s: float = 1.0,
                 **kw) -> None:
        kw.setdefault("retryable", True)
        super().__init__(message, **kw)
        self.details.setdefault("retry_after_s", retry_after_s)


class DeadlineExceededError(SentioError):
    """The caller's deadline passed before (or while) the request was
    served; any in-flight decode work was cancelled."""

    code = "DEADLINE_EXCEEDED"
    soft_fail_exempt = True


class ReplicaUnavailable(SentioError):
    """The service is closed, or its engine latched broken after a failed
    reset."""

    code = "SERVICE_UNAVAILABLE"
    soft_fail_exempt = True

    def __init__(self, message: str = "decode replica unavailable",
                 retry_after_s: float = 5.0, **kw) -> None:
        kw.setdefault("retryable", True)
        super().__init__(message, **kw)
        self.details.setdefault("retry_after_s", retry_after_s)
