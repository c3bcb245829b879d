"""Text chunking — a copy of ``sentio_tpu/ops/chunking.py``.

A recursive splitter with the separator hierarchy paragraph → line →
sentence → word → character, greedy packing into chunks of at most
``chunk_size`` characters with ``chunk_overlap`` characters carried from
the previous chunk; strategies ``recursive`` (the default), ``fixed`` and
``sentence``. :meth:`TextChunker.split` keeps each document's metadata and
adds ``parent_id``, ``chunk_index``, ``chunk_count`` and
``chunking_strategy``; chunk ids are ``{parent id}:{index}``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable

from sentio_tpu_torch.config import ChunkingConfig
from sentio_tpu_torch.models.document import Document

_SEPARATORS = ["\n\n", "\n", ". ", " ", ""]
_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+")


class ChunkingError(Exception):
    pass


def _split_on(text: str, separator: str) -> list[str]:
    """Split keeping the separator attached to the preceding piece so that
    re-joining chunks loses no characters."""
    if separator == "":
        return list(text)
    parts = text.split(separator)
    out = []
    for i, part in enumerate(parts):
        if i < len(parts) - 1:
            part = part + separator
        if part:
            out.append(part)
    return out


def _recursive_split(text: str, size: int, separators: list[str]) -> list[str]:
    """Break text into pieces each <= size, preferring coarse separators."""
    if len(text) <= size:
        return [text] if text else []
    sep, rest = separators[0], separators[1:]
    pieces = _split_on(text, sep)
    out: list[str] = []
    for piece in pieces:
        if len(piece) <= size:
            out.append(piece)
        elif rest:
            out.extend(_recursive_split(piece, size, rest))
        else:  # single char pieces can't exceed size; defensive
            out.extend(piece[i : i + size] for i in range(0, len(piece), size))
    return out


def _pack(pieces: Iterable[str], size: int, overlap: int) -> list[str]:
    """Greedily merge pieces into chunks of <= size chars with char overlap
    carried from the tail of the previous chunk."""
    chunks: list[str] = []
    current = ""
    for piece in pieces:
        if current and len(current) + len(piece) > size:
            chunks.append(current)
            carry = current[len(current) - overlap :] if overlap > 0 else ""
            # the carried overlap may not crowd out the incoming piece
            keep = max(0, size - len(piece))
            current = carry[len(carry) - keep :] if keep and carry else ""
        current += piece
        step = size - overlap  # > 0, validated by TextChunker
        while len(current) > size:  # a single piece longer than size (no finer separator)
            chunks.append(current[:size])
            current = current[step:]
    if current.strip():
        chunks.append(current)
    return [c.strip() for c in chunks if c.strip()]


@dataclass
class TextChunker:
    config: ChunkingConfig = field(default_factory=ChunkingConfig)
    _stats: dict = field(default_factory=lambda: {"documents": 0, "chunks": 0, "chars": 0})

    def __post_init__(self) -> None:
        if self.config.chunk_size <= 0:
            raise ChunkingError("chunk_size must be positive")
        if self.config.chunk_overlap < 0 or self.config.chunk_overlap >= self.config.chunk_size:
            raise ChunkingError("chunk_overlap must be in [0, chunk_size)")
        if self.config.strategy not in ("recursive", "fixed", "sentence"):
            raise ChunkingError(f"unknown strategy {self.config.strategy!r}")

    def split_text(self, text: str) -> list[str]:
        size, overlap = self.config.chunk_size, self.config.chunk_overlap
        if not text or not text.strip():
            return []
        if self.config.strategy == "fixed":
            step = size - overlap
            return [
                text[i : i + size].strip()
                for i in range(0, max(len(text) - overlap, 1), step)
                if text[i : i + size].strip()
            ]
        if self.config.strategy == "sentence":
            sentences = [s for s in _SENTENCE_RE.split(text) if s]
            pieces: list[str] = []
            for sent in sentences:  # sentences longer than size still need breaking
                pieces.extend(_recursive_split(sent, size, _SEPARATORS[1:]))
            return _pack(pieces, size, overlap)
        pieces = _recursive_split(text, size, _SEPARATORS)
        return _pack(pieces, size, overlap)

    def split(self, documents: list[Document]) -> list[Document]:
        out: list[Document] = []
        for doc in documents:
            texts = self.split_text(doc.content)
            for idx, chunk_text in enumerate(texts):
                meta = dict(doc.metadata)
                meta.update(
                    {
                        "parent_id": doc.id,
                        "chunk_index": idx,
                        "chunk_count": len(texts),
                        "chunking_strategy": self.config.strategy,
                    }
                )
                out.append(Document(text=chunk_text, metadata=meta, id=f"{doc.id}:{idx}"))
            self._stats["documents"] += 1
            self._stats["chunks"] += len(texts)
            self._stats["chars"] += len(doc.content)
        return out

    def get_stats(self) -> dict:
        stats = dict(self._stats)
        stats["avg_chunk_chars"] = (
            round(stats["chars"] / stats["chunks"], 1) if stats["chunks"] else 0.0
        )
        return stats
