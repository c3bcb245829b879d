"""Typed errors and their wire format — a copy of the parts of
``sentio_tpu/infra/exceptions.py`` that the generation service raises and
the HTTP layer maps.

Each error carries an :class:`ErrorCode`, an HTTP status (by code unless
given) and safe-to-serialize ``details``; :meth:`SentioError.to_dict` is
the JSON error body and :meth:`ErrorHandler.handle` maps any exception to
``(status, body)``, an unknown one to an opaque 500. The three serving
errors are ``soft_fail_exempt``: the ``/chat`` degradation ladder lets
them raise (a shed or an expired caller gets a typed 429/503/504 with
``Retry-After``, not an empty answer), where any other generation error
degrades. :class:`VectorStoreError` is the vector-store registry's
refusal of an unknown store name.
"""

from __future__ import annotations

import logging
import time
import uuid
from enum import Enum
from typing import Any, Optional

logger = logging.getLogger(__name__)


class ErrorCode(str, Enum):
    # auth
    UNAUTHORIZED = "UNAUTHORIZED"
    FORBIDDEN = "FORBIDDEN"
    TOKEN_EXPIRED = "TOKEN_EXPIRED"
    ACCOUNT_LOCKED = "ACCOUNT_LOCKED"
    # validation
    VALIDATION_ERROR = "VALIDATION_ERROR"
    INVALID_INPUT = "INVALID_INPUT"
    PAYLOAD_TOO_LARGE = "PAYLOAD_TOO_LARGE"
    # rate limiting / load shedding
    RATE_LIMITED = "RATE_LIMITED"
    OVERLOADED = "OVERLOADED"
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
    # resources
    NOT_FOUND = "NOT_FOUND"
    ALREADY_EXISTS = "ALREADY_EXISTS"
    # services
    SERVICE_UNAVAILABLE = "SERVICE_UNAVAILABLE"
    CIRCUIT_OPEN = "CIRCUIT_OPEN"
    TIMEOUT = "TIMEOUT"
    # processing
    RETRIEVAL_FAILED = "RETRIEVAL_FAILED"
    EMBEDDING_FAILED = "EMBEDDING_FAILED"
    RERANK_FAILED = "RERANK_FAILED"
    GENERATION_FAILED = "GENERATION_FAILED"
    INGEST_FAILED = "INGEST_FAILED"
    # device / runtime
    DEVICE_ERROR = "DEVICE_ERROR"
    DEVICE_OOM = "DEVICE_OOM"
    COMPILATION_FAILED = "COMPILATION_FAILED"
    # system
    INTERNAL_ERROR = "INTERNAL_ERROR"
    NOT_IMPLEMENTED = "NOT_IMPLEMENTED"


_DEFAULT_STATUS = {
    ErrorCode.UNAUTHORIZED: 401,
    ErrorCode.TOKEN_EXPIRED: 401,
    ErrorCode.FORBIDDEN: 403,
    ErrorCode.ACCOUNT_LOCKED: 423,
    ErrorCode.VALIDATION_ERROR: 422,
    ErrorCode.INVALID_INPUT: 400,
    ErrorCode.PAYLOAD_TOO_LARGE: 413,
    ErrorCode.RATE_LIMITED: 429,
    ErrorCode.OVERLOADED: 503,
    ErrorCode.DEADLINE_EXCEEDED: 504,
    ErrorCode.NOT_FOUND: 404,
    ErrorCode.ALREADY_EXISTS: 409,
    ErrorCode.SERVICE_UNAVAILABLE: 503,
    ErrorCode.CIRCUIT_OPEN: 503,
    ErrorCode.TIMEOUT: 504,
    ErrorCode.DEVICE_OOM: 503,
}


class SentioError(Exception):
    """Base error: code + HTTP status + safe-to-serialize details."""

    code: ErrorCode = ErrorCode.INTERNAL_ERROR

    def __init__(self, message: str, code: Optional[ErrorCode] = None,
                 status: Optional[int] = None, details: Optional[dict[str, Any]] = None,
                 retryable: bool = False) -> None:
        super().__init__(message)
        self.message = message
        if code is not None:
            self.code = code
        self.status = status or _DEFAULT_STATUS.get(self.code, 500)
        self.details = details or {}
        self.retryable = retryable
        self.error_id = str(uuid.uuid4())
        self.timestamp = time.time()  # wall-clock: reported error timestamp

    def to_dict(self) -> dict[str, Any]:
        return {
            "error": {
                "code": self.code.value,
                "message": self.message,
                "error_id": self.error_id,
                "retryable": self.retryable,
                "details": self.details,
            }
        }


class ValidationError(SentioError):
    code = ErrorCode.VALIDATION_ERROR


class RateLimitError(SentioError):
    code = ErrorCode.RATE_LIMITED

    def __init__(self, message: str = "rate limit exceeded", retry_after_s: float = 60.0, **kw):
        super().__init__(message, **kw)
        self.details.setdefault("retry_after_s", retry_after_s)


class ServiceOverloaded(SentioError):
    """Load shed at admission: the queue is full, the service is draining,
    or the request's deadline cannot be met. ``details["retry_after_s"]``
    says when to come back."""

    code = ErrorCode.OVERLOADED
    soft_fail_exempt = True

    def __init__(self, message: str = "service overloaded", retry_after_s: float = 1.0,
                 **kw) -> None:
        kw.setdefault("retryable", True)
        super().__init__(message, **kw)
        self.details.setdefault("retry_after_s", retry_after_s)


class DeadlineExceededError(SentioError):
    """The caller's deadline passed before (or while) the request was
    served; any in-flight decode work was cancelled."""

    code = ErrorCode.DEADLINE_EXCEEDED
    soft_fail_exempt = True


class ServiceUnavailableError(SentioError):
    code = ErrorCode.SERVICE_UNAVAILABLE

    def __init__(self, message: str, **kw):
        kw.setdefault("retryable", True)
        super().__init__(message, **kw)


class ReplicaUnavailable(ServiceUnavailableError):
    """The service is closed, or its engine latched broken after a failed
    reset."""

    code = ErrorCode.SERVICE_UNAVAILABLE
    soft_fail_exempt = True

    def __init__(self, message: str = "decode replica unavailable",
                 retry_after_s: float = 5.0, **kw) -> None:
        kw.setdefault("retryable", True)
        super().__init__(message, **kw)
        self.details.setdefault("retry_after_s", retry_after_s)


class VectorStoreError(Exception):
    """An unknown ``INDEX_BACKEND`` / ``VECTOR_STORE`` name —
    ``sentio_tpu/ops/vector_store.py::VectorStoreError``, a plain
    exception as there."""


class ErrorHandler:
    """Central exception → (status, JSON body) mapping; unknown exceptions
    become opaque 500s (internals never leak to clients)."""

    @staticmethod
    def handle(exc: Exception) -> tuple[int, dict[str, Any]]:
        if isinstance(exc, SentioError):
            if exc.status >= 500:
                logger.error("server error %s: %s", exc.code.value, exc.message)
            return exc.status, exc.to_dict()
        logger.exception("unhandled exception")
        wrapped = SentioError("internal server error")
        return 500, wrapped.to_dict()
