"""Core document model, copied from ``sentio_tpu/models/document.py``.

``text`` + ``metadata`` + auto-uuid ``id``, plus an optional host-side
``embedding`` (numpy array) that flows through ingest with the document.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


def _new_id() -> str:
    return str(uuid.uuid4())


@dataclass
class Document:
    """A unit of retrievable text with metadata and optional embedding."""

    text: str
    metadata: dict[str, Any] = field(default_factory=dict)
    id: str = field(default_factory=_new_id)
    embedding: Optional[Any] = None  # numpy ndarray when present; never a device tensor

    def __post_init__(self) -> None:
        if self.metadata is None:
            self.metadata = {}

    @property
    def content(self) -> str:
        """Text, falling back to ``metadata['content']`` so payloads whose
        text migrated into metadata still round-trip."""
        if self.text:
            return self.text
        return str(self.metadata.get("content", "") or "")

    def score(self, default: float = 0.0) -> float:
        """Best-known relevance score from metadata."""
        for key in ("hybrid_score", "rerank_score", "score"):
            value = self.metadata.get(key)
            if value is not None:
                try:
                    return float(value)
                except (TypeError, ValueError):
                    continue
        return default

    def to_dict(self) -> dict[str, Any]:
        return {"id": self.id, "text": self.content, "metadata": dict(self.metadata)}

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Document":
        return cls(
            text=str(data.get("text", "") or ""),
            metadata=dict(data.get("metadata", {}) or {}),
            id=str(data.get("id") or _new_id()),
        )
