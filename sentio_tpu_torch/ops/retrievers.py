"""Retrievers: dense (bi-encoder + exact index on the card), sparse (host
BM25) and their hybrid fusion — the counterpart of
``sentio_tpu/ops/retrievers.py``.

:func:`create_retriever` maps ``RETRIEVAL_STRATEGY`` (``dense``, ``bm25`` or
``sparse``, ``hybrid``) to a retriever as the JAX registry does. The hybrid
retriever over-fetches a pool of ``max(2·top_k, 10)`` from each leg, fuses
them with ``retrieval.fusion_method`` (legs weighted by ``dense_weight`` /
``sparse_weight``) and keeps ``top_k``. The legs run in turn; the fused
list is the one the JAX retriever's concurrent legs give.

With ``USE_SCORERS`` the fused list goes through the post-fusion scorers
(``ops/scorers.py``); with ``WEB_CACHE_PATH`` a second dense index is
consulted as the cached-web-results leg.

Differences from the JAX package: a leg that raises fails the retrieval
instead of dropping out of the fusion (the port's legs fail only on a
fault, which must surface) — except a vector store's outage
(:class:`~sentio_tpu_torch.infra.exceptions.VectorStoreError`, raised by
the Qdrant store once its retries are spent or its breaker is open), which
drops that leg as JAX does; the web-cache leg is a local index, so its
faults surface too.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from sentio_tpu_torch.config import RetrievalConfig, Settings
from sentio_tpu_torch.infra.exceptions import VectorStoreError
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.bm25 import BM25Index
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import TorchEmbedder
from sentio_tpu_torch.ops.fusion import fuse
from sentio_tpu_torch.ops.scorers import ScorerPlugin

logger = logging.getLogger(__name__)


class RetrieverError(Exception):
    pass


class BaseRetriever:
    """retrieve(query, top_k) → ranked Documents."""

    name = "base"

    def retrieve(self, query: str, top_k: int = 10) -> list[Document]:
        raise NotImplementedError


@dataclass
class DenseRetriever(BaseRetriever):
    """The query embedding (through the embedder's cache and coalescer)
    stays on the device and feeds the index's top-k (a Qdrant store copies
    it to the host); hits carry ``score`` and ``retriever`` metadata."""

    embedder: TorchEmbedder
    index: object
    name: str = "dense"

    def retrieve(self, query: str, top_k: int = 10) -> list[Document]:
        return self.index.retrieve(self.embedder.embed_device([query])[0], top_k)


@dataclass
class SparseRetriever(BaseRetriever):
    index: BM25Index
    name: str = "bm25"

    def retrieve(self, query: str, top_k: int = 10) -> list[Document]:
        return self.index.retrieve(query, top_k)


@dataclass
class HybridRetriever(BaseRetriever):
    """Fuses any number of legs over pools of ``max(2·top_k, 10)``, then
    mixes in the post-fusion ``scorers``. ``web_cache`` (optional) is the
    cached-web-results leg: its hits go in front of the dense leg's,
    deduplicated by id with the cache's first, so a cached result outranks
    a corpus hit of the same rank; where no dense leg survives they ride
    as a leg of their own (at the dense weight). A leg whose store is out
    (:class:`VectorStoreError`: retries spent or its breaker open) drops
    out of the fusion and is named in ``stats["legs_dropped"]``; any other
    error of a leg, the web cache's included, fails the retrieval."""

    retrievers: Sequence[BaseRetriever] = ()
    config: RetrievalConfig = field(default_factory=RetrievalConfig)
    scorers: Sequence[ScorerPlugin] = ()
    web_cache: Optional[BaseRetriever] = None
    name: str = "hybrid"

    def _weights(self) -> list[float]:
        table = {"dense": self.config.dense_weight, "bm25": self.config.sparse_weight}
        return [table.get(r.name, 1.0) for r in self.retrievers]

    def retrieve(self, query: str, top_k: int = 10,
                 stats: Optional[dict] = None) -> list[Document]:
        pool = max(top_k * 2, 10)
        lists: list[list[Document]] = []
        weights: list[float] = []
        names: list[str] = []
        for retriever, weight in zip(self.retrievers, self._weights()):
            try:
                leg = retriever.retrieve(query, pool)
            except VectorStoreError as exc:
                logger.warning("retrieval leg %s dropped: %s", retriever.name, exc)
                if stats is not None:
                    stats.setdefault("legs_dropped", []).append(retriever.name)
                continue
            lists.append(leg)
            weights.append(weight)
            names.append(retriever.name)
        if self.web_cache is not None:
            cache_hits = self.web_cache.retrieve(query, pool)
            if cache_hits:
                if "dense" in names:
                    j = names.index("dense")
                    seen = {d.id for d in cache_hits}
                    lists[j] = cache_hits + [d for d in lists[j] if d.id not in seen]
                else:
                    lists.append(cache_hits)
                    weights.append(self.config.dense_weight)
        if not lists:
            raise RetrieverError("all retrieval legs failed")
        fused = fuse(lists, method=self.config.fusion_method, weights=weights,
                     rrf_k=self.config.rrf_k)
        return self._apply_scorers(query, fused, stats)[:top_k]

    def _apply_scorers(self, query: str, docs: list[Document],
                       stats: Optional[dict] = None) -> list[Document]:
        """Min-max normalised fused scores plus each scorer's weighted
        scores, over the sum of the weights (the fused scores weigh 1); a
        scorer that raises is skipped. Writes ``hybrid_score`` and
        ``score``."""
        if not self.scorers or not docs:
            return docs
        t0 = time.perf_counter()
        base = np.asarray([d.score() for d in docs], np.float32)
        lo, hi = float(base.min()), float(base.max())
        mixed = (base - lo) / (hi - lo) if hi > lo else np.ones_like(base)
        total_w = 1.0
        for scorer in self.scorers:
            try:
                s = scorer.score(query, docs)
            except Exception:  # noqa: BLE001 — a broken scorer never fails retrieval
                logger.warning("scorer %s failed; skipped", scorer.name, exc_info=True)
                continue
            mixed = mixed + scorer.weight * np.asarray(s, np.float32)
            total_w += scorer.weight
        mixed = mixed / total_w
        out = []
        for i in np.argsort(-mixed, kind="stable"):
            doc = docs[int(i)]
            doc.metadata["hybrid_score"] = float(mixed[int(i)])
            doc.metadata["score"] = float(mixed[int(i)])
            out.append(doc)
        if stats is not None:
            stats["scorers_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        return out


def create_retriever(settings: Settings, embedder: Optional[TorchEmbedder] = None,
                     dense_index=None, bm25_index: Optional[BM25Index] = None,
                     scorers: Optional[Sequence[ScorerPlugin]] = None,
                     web_cache_index: Optional[TorchDenseIndex] = None) -> BaseRetriever:
    """Strategy registry: ``dense``, ``bm25`` (or ``sparse``) or ``hybrid``
    from ``settings.retrieval.strategy``; hybrid takes whichever legs it is
    given, the ``scorers`` and, with an embedder, the web-cache index as
    its cache leg. ``dense_index`` is any vector store (the card's index or
    the Qdrant store)."""
    strategy = settings.retrieval.strategy
    dense = (DenseRetriever(embedder, dense_index)
             if embedder is not None and dense_index is not None else None)
    sparse = SparseRetriever(bm25_index) if bm25_index is not None else None
    if strategy == "dense":
        if dense is None:
            raise RetrieverError("dense strategy needs embedder + dense_index")
        return dense
    if strategy in ("bm25", "sparse"):
        if sparse is None:
            raise RetrieverError("bm25 strategy needs a BM25 index")
        return sparse
    if strategy == "hybrid":
        legs = [r for r in (dense, sparse) if r is not None]
        if not legs:
            raise RetrieverError("hybrid strategy needs at least one leg")
        web_cache = None
        if web_cache_index is not None and embedder is not None:
            web_cache = DenseRetriever(embedder, web_cache_index, name="web_cache")
        return HybridRetriever(retrievers=legs, config=settings.retrieval,
                               scorers=scorers or (), web_cache=web_cache)
    raise RetrieverError(f"unknown retrieval strategy {strategy!r}")
