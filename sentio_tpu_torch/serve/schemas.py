"""Request schemas of the HTTP surface — a copy of
``sentio_tpu/serve/schemas.py``: ``ChatRequest`` (question 1–2,000
characters, top_k 1–20, temperature 0–2, mode, thread_id, stream,
deadline_ms, resumable) and ``EmbedRequest`` (content up to 50,000
characters, metadata), validated by plain functions over parsed JSON that
raise :class:`SchemaError` with one entry per bad field (a 422 body).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from sentio_tpu_torch.config import ServeConfig

__all__ = [
    "SchemaError", "ChatRequest", "EmbedRequest",
    "parse_chat_request", "parse_embed_request", "MAX_DEADLINE_MS",
]

# upper bound on a caller-supplied deadline (1 hour) — shared by the body
# field validation below and the X-Deadline-Ms header parse in serve/app.py
MAX_DEADLINE_MS = 3_600_000


class SchemaError(ValueError):
    """Carries per-field validation errors for a 422 response body."""

    def __init__(self, errors: list[dict[str, str]]):
        super().__init__("; ".join(f"{e['field']}: {e['error']}" for e in errors))
        self.errors = errors


@dataclass
class ChatRequest:
    question: str
    top_k: Optional[int] = None
    temperature: Optional[float] = None
    mode: str = "balanced"
    thread_id: Optional[str] = None
    stream: bool = False
    # caller's total latency budget in ms (body field; the X-Deadline-Ms
    # header and the serve default fill it when absent) — the decode service
    # sheds/cancels work that cannot finish inside it
    deadline_ms: Optional[float] = None
    # stream resumption opt-out: False keeps a mid-stream replica death a
    # typed error event instead of a resume of the delivered prefix on a
    # survivor. None = the server default (the X-Resumable header, else
    # resume)
    resumable: Optional[bool] = None


@dataclass
class EmbedRequest:
    content: str
    metadata: dict[str, Any] = field(default_factory=dict)


def _require_dict(body: Any) -> dict:
    if not isinstance(body, dict):
        raise SchemaError([{"field": "body", "error": "expected a JSON object"}])
    return body


def parse_chat_request(body: Any, limits: ServeConfig) -> ChatRequest:
    body = _require_dict(body)
    errors: list[dict[str, str]] = []

    question = body.get("question", body.get("query"))
    if not isinstance(question, str) or not question.strip():
        errors.append({"field": "question", "error": "required non-empty string"})
        question = ""
    elif len(question) > limits.max_question_chars:
        errors.append(
            {"field": "question", "error": f"longer than {limits.max_question_chars} chars"}
        )

    top_k = body.get("top_k")
    if top_k is not None:
        if not isinstance(top_k, int) or isinstance(top_k, bool) or not (1 <= top_k <= limits.top_k_max):
            errors.append({"field": "top_k", "error": f"must be an int in [1, {limits.top_k_max}]"})
            top_k = None

    temperature = body.get("temperature")
    if temperature is not None:
        if not isinstance(temperature, (int, float)) or isinstance(temperature, bool) or not (
            0.0 <= float(temperature) <= 2.0
        ):
            errors.append({"field": "temperature", "error": "must be a number in [0, 2]"})
            temperature = None
        else:
            temperature = float(temperature)

    mode = body.get("mode", "balanced")
    if mode not in ("fast", "balanced", "quality", "creative"):
        errors.append({"field": "mode", "error": "one of fast|balanced|quality|creative"})
        mode = "balanced"

    thread_id = body.get("thread_id")
    if thread_id is not None and not isinstance(thread_id, str):
        errors.append({"field": "thread_id", "error": "must be a string"})
        thread_id = None

    resumable = body.get("resumable")
    if resumable is not None and not isinstance(resumable, bool):
        errors.append({"field": "resumable", "error": "must be a boolean"})
        resumable = None

    deadline_ms = body.get("deadline_ms")
    if deadline_ms is not None:
        if not isinstance(deadline_ms, (int, float)) or isinstance(deadline_ms, bool) or not (
            0 < float(deadline_ms) <= MAX_DEADLINE_MS
        ):
            errors.append({
                "field": "deadline_ms",
                "error": f"must be a number in (0, {MAX_DEADLINE_MS}]",
            })
            deadline_ms = None
        else:
            deadline_ms = float(deadline_ms)

    if errors:
        raise SchemaError(errors)
    return ChatRequest(
        question=question.strip(),
        top_k=top_k,
        temperature=temperature,
        mode=mode,
        thread_id=thread_id,
        stream=bool(body.get("stream", False)),
        deadline_ms=deadline_ms,
        resumable=resumable,
    )


def parse_embed_request(body: Any, limits: ServeConfig) -> EmbedRequest:
    body = _require_dict(body)
    errors: list[dict[str, str]] = []

    content = body.get("content", body.get("text"))
    if not isinstance(content, str) or not content.strip():
        errors.append({"field": "content", "error": "required non-empty string"})
        content = ""
    elif len(content) > limits.max_embed_chars:
        errors.append({"field": "content", "error": f"longer than {limits.max_embed_chars} chars"})

    metadata = body.get("metadata") or {}
    if not isinstance(metadata, dict):
        errors.append({"field": "metadata", "error": "must be an object"})
        metadata = {}

    if errors:
        raise SchemaError(errors)
    return EmbedRequest(content=content, metadata=metadata)
