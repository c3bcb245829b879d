"""Retrievers: dense (bi-encoder + exact index on the card), sparse (host
BM25) and their hybrid fusion — the counterpart of
``sentio_tpu/ops/retrievers.py``.

:func:`create_retriever` maps ``RETRIEVAL_STRATEGY`` (``dense``, ``bm25`` or
``sparse``, ``hybrid``) to a retriever as the JAX registry does. The hybrid
retriever over-fetches a pool of ``max(2·top_k, 10)`` from each leg, fuses
them with ``retrieval.fusion_method`` (legs weighted by ``dense_weight`` /
``sparse_weight``) and keeps ``top_k``. The legs run in turn; the fused
list is the one the JAX retriever's concurrent legs give.

Differences from the JAX package: a leg that raises fails the retrieval
instead of dropping out of the fusion (the port's legs fail only on a
fault, which must surface), and the post-fusion scorers and the web-cache
leg are not ported — ``build_pipeline`` refuses settings that ask for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from sentio_tpu_torch.config import RetrievalConfig, Settings
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.bm25 import BM25Index
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import TorchEmbedder
from sentio_tpu_torch.ops.fusion import fuse


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
    stays on the device and feeds the index's top-k; hits carry ``score``
    and ``retriever="dense"`` metadata."""

    embedder: TorchEmbedder
    index: TorchDenseIndex
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
    """Fuses any number of legs over pools of ``max(2·top_k, 10)``."""

    retrievers: Sequence[BaseRetriever] = ()
    config: RetrievalConfig = field(default_factory=RetrievalConfig)
    name: str = "hybrid"

    def _weights(self) -> list[float]:
        table = {"dense": self.config.dense_weight, "bm25": self.config.sparse_weight}
        return [table.get(r.name, 1.0) for r in self.retrievers]

    def retrieve(self, query: str, top_k: int = 10) -> list[Document]:
        pool = max(top_k * 2, 10)
        legs = [r.retrieve(query, pool) for r in self.retrievers]
        fused = fuse(legs, method=self.config.fusion_method, weights=self._weights(),
                     rrf_k=self.config.rrf_k)
        return fused[:top_k]


def create_retriever(settings: Settings, embedder: Optional[TorchEmbedder] = None,
                     dense_index: Optional[TorchDenseIndex] = None,
                     bm25_index: Optional[BM25Index] = None) -> BaseRetriever:
    """Strategy registry: ``dense``, ``bm25`` (or ``sparse``) or ``hybrid``
    from ``settings.retrieval.strategy``; hybrid takes whichever legs it is
    given."""
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
        return HybridRetriever(retrievers=legs, config=settings.retrieval)
    raise RetrieverError(f"unknown retrieval strategy {strategy!r}")
