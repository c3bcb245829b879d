"""The ``/chat`` pipeline on the card — the sync graph of
``sentio_tpu/graph/factory.py::build_basic_graph``:
retrieve → rerank → select → generate → verify.

Retrieval follows ``RETRIEVAL_STRATEGY``: ``dense`` (the bi-encoder embeds
the query and an exact top-k runs over the index on the card), ``bm25``
(host BM25) or ``hybrid``, the default (both legs fused by
``FUSION_METHOD``, rrf by default). ``KV_QUANT=int8`` gives the engine an
int8 page pool; ``PREFIX_CACHE``, ``DECODE_PIPELINE_DEPTH`` and
``PREFILL_CHUNK`` reach the engine as in the JAX service (the radix prefix
cache and depth 2 by default).

* :meth:`ChatPipeline.ingest` embeds documents, adds them to the index and
  rebuilds the BM25 index over the index's documents;
* :meth:`ChatPipeline.chat` answers one question and returns ``answer``,
  ``sources`` and ``verification`` as ``/chat`` does, plus per-stage times.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import Settings
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops.bm25 import BM25Index, BM25Params, make_bm25_index
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import TorchEmbedder
from sentio_tpu_torch.ops.generator import EngineProvider, LLMGenerator
from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
from sentio_tpu_torch.ops.retrievers import BaseRetriever, create_retriever
from sentio_tpu_torch.ops.verifier import AnswerVerifier
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine

CHARS_PER_TOKEN = 4  # the selector's ≈4-chars/token budget heuristic


def select_documents(docs: list, budget_tokens: int) -> tuple[list[Document], int]:
    """Sort by best score, dedup by id, enforce the ≈4-chars/token context
    budget — a copy of ``sentio_tpu/graph/nodes.py::select_documents``."""
    docs = sorted(docs, key=lambda d: d.score(), reverse=True)
    seen: set[str] = set()
    budget_chars = budget_tokens * CHARS_PER_TOKEN
    used = 0
    selected: list[Document] = []
    for doc in docs:
        if doc.id in seen:
            continue
        seen.add(doc.id)
        text = doc.content
        if not text.strip():
            continue
        cost = len(text)
        if used + cost > budget_chars and selected:
            continue  # keep scanning: a shorter doc may still fit
        selected.append(doc)
        used += cost
        if used >= budget_chars:
            break
    return selected, used


def _user_top_k(raw: Optional[int], default: int, cap: int = 50) -> int:
    if raw is None:
        return default
    return max(1, min(int(raw), cap))


def serialize_sources(docs: Sequence[Document]) -> list[dict[str, Any]]:
    """Cited sources in the ``/chat`` response shape."""
    keep = ("source", "filename", "score", "hybrid_score", "rerank_score")
    return [{"id": d.id, "text": d.text[:500], "score": d.score(),
             "metadata": {k: v for k, v in d.metadata.items() if k in keep}}
            for d in docs]


@dataclass
class ChatPipeline:
    embedder: TorchEmbedder
    index: TorchDenseIndex
    retriever: BaseRetriever
    generator: LLMGenerator
    bm25_index: Optional[BM25Index] = None
    reranker: Optional[CrossEncoderReranker] = None
    verifier: Optional[AnswerVerifier] = None
    settings: Settings = field(default_factory=Settings)

    def ingest(self, documents: Sequence[Document]) -> int:
        """Embed ``documents``, add them to the index and rebuild the BM25
        index over every document the index holds; returns the count."""
        documents = list(documents)
        self.index.add(documents, self.embedder.embed_many([d.content for d in documents]))
        if self.bm25_index is not None:
            self.bm25_index.build(self.index.documents())
        return len(documents)

    def chat(self, question: str, top_k: Optional[int] = None,
             temperature: Optional[float] = None, mode: str = "balanced") -> dict[str, Any]:
        s = self.settings
        stage_ms: dict[str, float] = {}
        t = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t
            now = time.perf_counter()
            stage_ms[name] = (now - t) * 1e3
            t = now

        retrieved = self.retriever.retrieve(question, _user_top_k(top_k, s.retrieval.top_k))
        lap("retrieve")
        docs = retrieved
        if self.reranker is not None and retrieved:
            docs = self.reranker.rerank(
                question, retrieved, top_k=_user_top_k(top_k, s.rerank.top_k)).documents
            lap("rerank")
        selected, _used = select_documents(docs, s.generator.context_token_budget)
        best = selected or docs
        lap("select")
        gen_stats: dict = {}
        answer = self.generator.generate(question, best, mode=mode,
                                         temperature=temperature, stats=gen_stats)
        lap("generate")
        verification: dict = {}
        if self.verifier is not None:
            if answer:
                result = self.verifier.verify(question, answer, best)
                verification = result.to_dict()
                if result.verdict == "fail" and result.revised_answer:
                    answer = result.revised_answer
            else:
                verification = {"verdict": "warn", "notes": ["empty answer"]}
            lap("verify")
        return {
            "answer": answer,
            "sources": serialize_sources(best),
            "verification": verification,
            "metadata": {
                "retrieved_ids": [d.id for d in retrieved],
                "reranked_ids": [d.id for d in docs],
                "stage_ms": stage_ms,
                "generated_tokens": gen_stats.get("tokens", 0),
            },
        }


def build_pipeline(settings: Optional[Settings] = None, device=None, seed: int = 0,
                   llama_config: Optional[LlamaConfig] = None,
                   embedder_config: Optional[EncoderConfig] = None,
                   reranker_config: Optional[EncoderConfig] = None,
                   llama_params: Optional[dict] = None,
                   embedder_params: Optional[dict] = None,
                   reranker_params: Optional[dict] = None) -> ChatPipeline:
    """Assemble the pipeline from ``settings`` on ``device`` (the card by
    default). Missing weights are random, made on the device from
    ``seed``; the retriever follows the retrieval settings (strategy,
    fusion, BM25 backend) and the engine the generator settings (slots,
    page size, pages per sequence, ``kv_quant``, the prefix cache, the
    decode pipeline depth and chunked prefill, as the JAX service hands
    them to its engine). Settings this package cannot honour raise
    ``NotImplementedError``."""
    settings = settings or Settings()
    rcfg, gcfg = settings.retrieval, settings.generator
    if rcfg.use_scorers:
        raise NotImplementedError("USE_SCORERS: post-fusion scorers are not ported")
    if rcfg.web_cache_path:
        raise NotImplementedError("WEB_CACHE_PATH: the web-cache retrieval leg is not ported")
    if gcfg.draft_checkpoint_path:
        raise NotImplementedError("LLM_DRAFT_CHECKPOINT: speculative decoding is not ported")
    if not gcfg.use_paged_decode:
        raise NotImplementedError("USE_PAGED_KV=0: the contiguous engine is not ported")
    if gcfg.verify_mode != "sync":
        raise NotImplementedError(f"VERIFY_MODE={gcfg.verify_mode}: only sync verification "
                                  "is ported")
    dev = resolve_device(device)

    def gen(offset: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + offset)
        return g

    embedder = TorchEmbedder(settings.embedder, params=embedder_params,
                             model_config=embedder_config, device=dev, generator=gen(1))
    # the corpus is held in the generator dtype, as the JAX container holds it
    index = TorchDenseIndex(embedder.dimension, device=dev, dtype=gcfg.dtype)
    bm25 = None
    if rcfg.strategy in ("bm25", "sparse", "hybrid"):
        bm25 = make_bm25_index(BM25Params(k1=rcfg.bm25_k1, b=rcfg.bm25_b),
                               backend=rcfg.bm25_backend)
    retriever = create_retriever(settings, embedder, index, bm25)
    reranker = None
    if settings.rerank.enabled:
        reranker = CrossEncoderReranker(settings.rerank, params=reranker_params,
                                        model_config=reranker_config, device=dev,
                                        generator=gen(2))
    llama_config = llama_config or (
        LlamaConfig.tiny() if gcfg.model_preset == "tiny" else LlamaConfig.llama3_8b())
    if llama_params is None:
        llama_params = init_llama(llama_config, gen(3), dev)
    engine = ContinuousBatchingEngine(
        model_config=llama_config, params=llama_params,
        max_slots=gcfg.max_batch_size, page_size=gcfg.kv_page_size,
        max_pages_per_seq=gcfg.kv_max_pages_per_seq, rng_seed=seed,
        steps_per_tick=gcfg.decode_steps_per_tick,
        max_tick_steps=gcfg.decode_max_tick_steps, kv_quant=gcfg.kv_quant,
        prefix_cache=gcfg.prefix_cache, pipeline_depth=gcfg.decode_pipeline_depth,
        prefill_chunk=gcfg.prefill_chunk or None, device=dev,
    )
    generator = LLMGenerator(provider=EngineProvider(engine), config=gcfg)
    verifier = AnswerVerifier(generator=generator, config=gcfg) if gcfg.use_verifier else None
    return ChatPipeline(embedder=embedder, index=index, retriever=retriever,
                        generator=generator, bm25_index=bm25, reranker=reranker,
                        verifier=verifier, settings=settings)
