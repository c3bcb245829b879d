"""Document ingestion: load → chunk → embed → index — the counterpart of
``sentio_tpu/ops/ingest.py`` over the port's embedder, dense index and
BM25 index.

Readers by suffix, as in JAX: txt/md/rst (raw), json/jsonl (string leaves),
yaml (string leaves; read as plain text when PyYAML is missing or the
file is invalid), html/htm (visible text, script and style skipped),
csv/tsv (non-empty cells), docx (``word/document.xml`` through
``zipfile``) and pdf (needs PyPDF2, imported inside the reader; without
it the reader raises JAX's :class:`IngestError`). :meth:`DocumentIngestor.
ingest_documents` chunks (``TextChunker``), drops empty chunks, embeds
them in device batches (``embed_many``, through the embedding cache), adds
them to the dense index and rebuilds the BM25 index over the dense index's
documents, all under one write lock, so concurrent ingests serialize and a
search sees each index whole.
"""

from __future__ import annotations

import csv
import io
import json
import logging
import re
import threading
import time
import zipfile
from dataclasses import dataclass, field
from html.parser import HTMLParser
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

from sentio_tpu_torch.config import Settings
from sentio_tpu_torch.models.document import Document

logger = logging.getLogger(__name__)

__all__ = [
    "IngestError",
    "IngestStats",
    "DocumentIngestor",
    "SUPPORTED_SUFFIXES",
]


class IngestError(Exception):
    pass


SUPPORTED_SUFFIXES = (
    ".txt", ".md", ".rst", ".json", ".jsonl", ".yaml", ".yml",
    ".html", ".htm", ".csv", ".tsv", ".docx", ".pdf",
)


class _TextExtractor(HTMLParser):
    """Collects visible text, skipping script/style."""

    _SKIP = {"script", "style", "noscript"}

    def __init__(self) -> None:
        super().__init__()
        self.parts: list[str] = []
        self._skip_depth = 0

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP:
            self._skip_depth += 1

    def handle_endtag(self, tag):
        if tag in self._SKIP and self._skip_depth:
            self._skip_depth -= 1

    def handle_data(self, data):
        if not self._skip_depth and data.strip():
            self.parts.append(data.strip())


def _read_html(raw: str) -> str:
    parser = _TextExtractor()
    parser.feed(raw)
    return "\n".join(parser.parts)


def _read_json(raw: str) -> str:
    """Flatten all string leaves."""

    def walk(node) -> Iterable[str]:
        if isinstance(node, str):
            if node.strip():
                yield node.strip()
        elif isinstance(node, dict):
            for v in node.values():
                yield from walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from walk(v)

    return "\n".join(walk(json.loads(raw)))


def _read_jsonl(raw: str) -> str:
    parts = []
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            parts.append(_read_json(line))
        except json.JSONDecodeError:
            parts.append(line)
    return "\n".join(parts)


def _read_yaml(raw: str) -> str:
    try:
        import yaml

        docs = list(yaml.safe_load_all(raw))
    except Exception:  # noqa: BLE001 — yaml missing or invalid: treat as plain text
        return raw

    def walk(node) -> Iterable[str]:
        if isinstance(node, str):
            if node.strip():
                yield node.strip()
        elif isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from walk(v)

    return "\n".join(p for d in docs for p in walk(d))


def _read_csv(raw: str, delimiter: str = ",") -> str:
    rows = csv.reader(io.StringIO(raw), delimiter=delimiter)
    return "\n".join(" ".join(cell for cell in row if cell.strip()) for row in rows)


_DOCX_TAG = re.compile(r"<[^>]+>")


def _read_docx(path: Path) -> str:
    """DOCX is a zip of XML; paragraph text lives in ``word/document.xml``
    under ``<w:t>`` runs."""
    try:
        with zipfile.ZipFile(path) as zf:
            xml = zf.read("word/document.xml").decode("utf-8", errors="replace")
    except (zipfile.BadZipFile, KeyError) as exc:
        raise IngestError(f"not a valid docx file: {path}") from exc
    paragraphs = []
    for para in re.split(r"</w:p>", xml):
        runs = re.findall(r"<w:t[^>]*>(.*?)</w:t>", para, flags=re.S)
        text = _DOCX_TAG.sub("", "".join(runs)).strip()
        if text:
            paragraphs.append(text)
    return "\n".join(paragraphs)


def _read_pdf(path: Path) -> str:
    try:
        import PyPDF2  # noqa: F401 — gated: not in the base image
    except ImportError as exc:
        raise IngestError(
            f"PDF ingestion for {path.name} needs PyPDF2 (not installed in "
            "this image); convert to text/markdown first"
        ) from exc
    reader = PyPDF2.PdfReader(str(path))
    return "\n".join(page.extract_text() or "" for page in reader.pages)


@dataclass
class IngestStats:
    """Per-call (and lifetime) ingest counts."""

    documents_loaded: int = 0
    chunks_created: int = 0
    chunks_embedded: int = 0
    chunks_stored: int = 0
    files_skipped: int = 0
    errors: list[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "documents_loaded": self.documents_loaded,
            "chunks_created": self.chunks_created,
            "chunks_embedded": self.chunks_embedded,
            "chunks_stored": self.chunks_stored,
            "files_skipped": self.files_skipped,
            "errors": self.errors,
            "elapsed_s": round(self.elapsed_s, 3),
        }


class DocumentIngestor:
    """load → chunk → embed (device batches) → index. The serving pipeline
    shares its embedder, dense index and BM25 index with the ingestor; the
    chunker, when not given, is built from ``settings``."""

    def __init__(self, chunker=None, embedder=None, dense_index=None, sparse_index=None,
                 settings: Optional[Settings] = None) -> None:
        self.settings = settings or Settings()
        self._chunker = chunker
        self.embedder = embedder
        self.dense_index = dense_index
        self._sparse_index = sparse_index
        self.stats = IngestStats()  # lifetime totals; per-call stats are returned
        # ingest and clear (embed, dense add, BM25 rebuild) serialize here
        self._write_lock = threading.Lock()

    # ------------------------------------------------------------ components

    @property
    def chunker(self):
        if self._chunker is None:
            from sentio_tpu_torch.ops.chunking import TextChunker

            self._chunker = TextChunker(config=self.settings.chunking)
        return self._chunker

    # ----------------------------------------------------------------- load

    def load_file(self, path: str | Path) -> list[Document]:
        """One file → one Document (pre-chunking), with source metadata."""
        path = Path(path)
        if not path.is_file():
            raise IngestError(f"not a file: {path}")
        suffix = path.suffix.lower()
        if suffix == ".docx":
            text = _read_docx(path)
        elif suffix == ".pdf":
            text = _read_pdf(path)
        else:
            raw = path.read_text(encoding="utf-8", errors="replace")
            if suffix in (".html", ".htm"):
                text = _read_html(raw)
            elif suffix == ".json":
                try:
                    text = _read_json(raw)
                except json.JSONDecodeError:
                    text = raw
            elif suffix == ".jsonl":
                text = _read_jsonl(raw)
            elif suffix in (".yaml", ".yml"):
                text = _read_yaml(raw)
            elif suffix == ".csv":
                text = _read_csv(raw)
            elif suffix == ".tsv":
                text = _read_csv(raw, delimiter="\t")
            else:  # txt/md/rst and any other text-like file
                text = raw
        text = text.strip()
        if not text:
            return []
        return [
            Document(
                text=text,
                metadata={"source": str(path), "filename": path.name, "format": suffix.lstrip(".")},
            )
        ]

    def load_directory(self, path: str | Path, recursive: bool = True) -> list[Document]:
        """Every supported file under ``path``, in sorted order; unsupported
        and unreadable files are counted, not fatal."""
        path = Path(path)
        if not path.is_dir():
            raise IngestError(f"not a directory: {path}")
        pattern = "**/*" if recursive else "*"
        docs: list[Document] = []
        for file in sorted(path.glob(pattern)):
            if not file.is_file():
                continue
            if file.suffix.lower() not in SUPPORTED_SUFFIXES:
                self.stats.files_skipped += 1
                continue
            try:
                docs.extend(self.load_file(file))
            except (IngestError, OSError) as exc:
                logger.warning("skipping %s: %s", file, exc)
                self.stats.errors.append(f"{file.name}: {exc}")
                self.stats.files_skipped += 1
        return docs

    # ---------------------------------------------------------------- ingest

    def ingest_documents(self, documents: Sequence[Document]) -> IngestStats:
        """Chunk, embed and index a document list; empty chunks are dropped
        before embedding. Returns this call's stats; lifetime totals
        accumulate on ``.stats``."""
        t0 = time.perf_counter()
        call = IngestStats(documents_loaded=len(documents))
        with self._write_lock:
            chunks = self.chunker.split(list(documents))
            chunks = [c for c in chunks if c.text.strip()]
            call.chunks_created = len(chunks)
            if chunks:
                vecs = np.asarray(self.embedder.embed_many([c.text for c in chunks]),
                                  np.float32)
                call.chunks_embedded = len(chunks)
                self.dense_index.add(chunks, vecs)
                if self._sparse_index is not None:
                    self._sparse_index.build(self.dense_index.documents())
                call.chunks_stored = len(chunks)
        call.elapsed_s = time.perf_counter() - t0
        self._accumulate(call)
        return call

    def _accumulate(self, call: IngestStats) -> None:
        s = self.stats
        s.documents_loaded += call.documents_loaded
        s.chunks_created += call.chunks_created
        s.chunks_embedded += call.chunks_embedded
        s.chunks_stored += call.chunks_stored
        s.elapsed_s += call.elapsed_s

    def ingest_document(self, text: str, metadata: Optional[dict] = None) -> IngestStats:
        """One in-memory document — the ``POST /embed`` path."""
        return self.ingest_documents([Document(text=text, metadata=dict(metadata or {}))])

    def ingest_path(self, path: str | Path, recursive: bool = True) -> IngestStats:
        path = Path(path)
        # loader failures land on the lifetime stats; snapshot around the
        # load so this call's stats carry its own errors and skips
        err0, skip0 = len(self.stats.errors), self.stats.files_skipped
        docs = (self.load_directory(path, recursive=recursive) if path.is_dir()
                else self.load_file(path))
        call = self.ingest_documents(docs)
        call.errors = self.stats.errors[err0:]
        call.files_skipped = self.stats.files_skipped - skip0
        return call

    def clear(self) -> int:
        """Drop everything from both indexes; returns the prior count."""
        with self._write_lock:
            n = self.dense_index.size
            self.dense_index.clear()
            if self._sparse_index is not None:
                self._sparse_index.build([])
        return n
