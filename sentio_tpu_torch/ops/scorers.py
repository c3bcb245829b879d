"""Post-fusion scorers — the counterpart of ``sentio_tpu/ops/scorers.py``:
keyword overlap, recency decay, semantic similarity and MMR
diversification, each mapping (query, documents) to a score in [0, 1] per
document, mixed into the fused scores by the hybrid retriever with
per-scorer weights (``USE_SCORERS``).

The semantic and MMR scorers share one batched embedding of the query and
the candidates (:func:`_doc_embeddings`, through the embedder's cache and,
on the card, the flash kernel) and vectorized cosine matrices. The memo
that lets the second scorer reuse the first one's embedding is one tuple
swapped whole, so concurrent chats on the server's threads never pair one
request's key with another's vectors (JAX's memo is a dict written in two
steps, which its single event loop makes safe).
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np

from sentio_tpu_torch.models.document import Document

__all__ = ["ScorerPlugin", "KeywordMatchScorer", "RecencyScorer", "SemanticSimilarityScorer",
           "MMRScorer", "default_scorer_stack"]


class ScorerPlugin(Protocol):
    name: str
    weight: float

    def score(self, query: str, documents: Sequence[Document]) -> np.ndarray: ...


# the latest (key, (query vector, document matrix)), read and written whole;
# per thread, so one chat's two scorers share it and chats never cross
_EMBED_MEMO = threading.local()


def _doc_embeddings(embedder, query: str, documents: Sequence[Document]):
    """One batched embedding of the query and every document →
    ``(q_vec, doc_matrix)``, memoized for the scorer that runs next over the
    same candidates."""
    key = (id(embedder), query, tuple(d.id for d in documents))
    memo = getattr(_EMBED_MEMO, "entry", None)
    if memo is not None and memo[0] == key:
        return memo[1]
    vecs = np.asarray(embedder.embed_many([query] + [d.content for d in documents]),
                      np.float32)
    result = (vecs[0], vecs[1:])
    _EMBED_MEMO.entry = (key, result)
    return result


@dataclass
class KeywordMatchScorer:
    """The fraction of the query's words that the document holds."""

    weight: float = 0.8
    name: str = "keyword"

    def score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        q_terms = set(re.findall(r"\w+", query.lower()))
        out = np.zeros(len(documents), np.float32)
        if not q_terms:
            return out
        for i, doc in enumerate(documents):
            d_terms = set(re.findall(r"\w+", doc.content.lower()))
            out[i] = len(q_terms & d_terms) / len(q_terms)
        return out


@dataclass
class RecencyScorer:
    """Exponential decay on ``metadata['timestamp']`` (epoch seconds); a
    document without one scores the neutral 0.5."""

    weight: float = 0.2
    half_life_days: float = 30.0
    name: str = "recency"

    def score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        now = time.time()  # wall-clock: compared with the documents' epoch stamps
        out = np.full(len(documents), 0.5, np.float32)
        half_life_s = self.half_life_days * 86_400.0
        for i, doc in enumerate(documents):
            ts = doc.metadata.get("timestamp")
            if ts is None:
                continue
            try:
                age = max(now - float(ts), 0.0)
            except (TypeError, ValueError):
                continue
            out[i] = float(0.5 ** (age / half_life_s))
        return out


@dataclass
class SemanticSimilarityScorer:
    """cos(query, document) over unit-norm embeddings, mapped from [-1, 1]
    to [0, 1]."""

    embedder: object = None
    weight: float = 0.5
    name: str = "semantic"

    def score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        if self.embedder is None or not documents:
            return np.zeros(len(documents), np.float32)
        q_vec, doc_mat = _doc_embeddings(self.embedder, query, documents)
        return ((doc_mat @ q_vec + 1.0) / 2.0).astype(np.float32)


@dataclass
class MMRScorer:
    """Maximal marginal relevance: greedy λ·relevance − (1−λ)·redundancy,
    returned as a rank score (first selected highest), so it mixes with
    the other scorers by weight."""

    embedder: object = None
    lambda_param: float = 0.7
    weight: float = 0.5
    name: str = "mmr"

    def score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        n = len(documents)
        if self.embedder is None or n == 0:
            return np.zeros(n, np.float32)
        q_vec, doc_mat = _doc_embeddings(self.embedder, query, documents)
        rel = doc_mat @ q_vec  # [n]
        sim = doc_mat @ doc_mat.T  # [n, n]
        lam = self.lambda_param
        selected: list[int] = []
        remaining = set(range(n))
        while remaining:
            if not selected:
                order = sorted(remaining)
                best = order[int(np.argmax([rel[i] for i in order]))]
            else:
                best, best_val = -1, -np.inf
                sel = np.asarray(selected)
                for i in remaining:
                    val = lam * rel[i] - (1.0 - lam) * float(sim[i, sel].max())
                    if val > best_val:
                        best, best_val = i, val
            selected.append(best)
            remaining.discard(best)
        out = np.zeros(n, np.float32)
        for rank, idx in enumerate(selected):
            out[idx] = 1.0 - rank / max(n, 1)
        return out


def default_scorer_stack(embedder, settings) -> list[ScorerPlugin]:
    """Keyword, recency, semantic and MMR with the retrieval settings'
    weights and MMR λ (the semantic scorer takes MMR's weight, as in
    JAX)."""
    r = settings.retrieval
    return [
        KeywordMatchScorer(weight=r.keyword_scorer_weight),
        RecencyScorer(weight=r.recency_scorer_weight),
        SemanticSimilarityScorer(embedder=embedder, weight=r.mmr_scorer_weight),
        MMRScorer(embedder=embedder, lambda_param=r.mmr_lambda, weight=r.mmr_scorer_weight),
    ]
