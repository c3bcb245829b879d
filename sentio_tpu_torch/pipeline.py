"""The ``/chat`` pipeline on the card — the graph of
``sentio_tpu/graph/factory.py::build_basic_graph``:
retrieve → rerank → select → generate → verify, with verify synchronous,
detached (``VERIFY_MODE=async``) or behind a confidence gate (``gated``).

Retrieval follows ``RETRIEVAL_STRATEGY``: ``dense`` (the bi-encoder embeds
the query and an exact top-k runs over the index on the card), ``bm25``
(host BM25) or ``hybrid``, the default (both legs fused by
``FUSION_METHOD``, rrf by default). ``KV_QUANT=int8`` gives the engine an
int8 page pool; ``PREFIX_CACHE``, ``DECODE_PIPELINE_DEPTH`` and
``PREFILL_CHUNK`` reach the engine as in the JAX service (the radix prefix
cache and depth 2 by default). Generation runs on ``REPLICAS`` paged
engines (one by default), each behind its own generation service
(``runtime/service.py``), fronted by the replica tier
(``runtime/replica.py``: tenant WFQ, radix-affinity routing, supervision
with in-place rebuild, failover, resumable streams), as the JAX container
builds it; concurrent ``chat`` calls share each replica's decode batch. The
replicas share the weights and own their pools, radix trees, CUDA streams
and graphs. With ``PREFIX_CACHE`` on, the ``/chat`` template head is warmed
into every replica's radix tree at build time.
``USE_PAGED_KV=0`` generates on the contiguous engine instead
(``runtime/engine.py``: causal flash prefill, one call at a time).
``LLM_CHECKPOINT`` and ``RERANKER_CHECKPOINT`` load ``save_pytree``
checkpoints. ``LLM_DRAFT_CHECKPOINT`` (k from ``SPECULATIVE_K``) makes
generation speculative as in the JAX container: the paged engine runs
every decode tick as a spec tick (``runtime/paged_spec.py``) unless
``PREFILL_CHUNK`` is set, which excludes it (a warning, and
``speculative_info`` says why); the contiguous engine is wrapped in a
``SpeculativeDecoder`` (``runtime/speculative.py``).

* :meth:`ChatPipeline.ingest` embeds pre-chunked documents, adds them to
  the index and rebuilds the BM25 index over the index's documents, under
  the ingestor's write lock (``pipeline.ingestor``, a ``DocumentIngestor``
  over the same embedder and indexes, chunks and ingests files and texts);
* :meth:`ChatPipeline.run` runs one question through the stages and
  returns the JAX graph's final state (documents of each stage, response,
  evaluation, and the metadata each JAX node and the executor write);
  :meth:`ChatPipeline.context` is its retrieve → rerank → select part,
  which the SSE handler runs too;
* :meth:`ChatPipeline.chat` answers one question and returns ``answer``,
  ``sources`` and ``verification`` as ``/chat`` does, plus per-stage times.
  As the JAX graph's nodes do, a failed retrieval gives no documents and
  ``metadata.retrieval_error``, a failed generation an empty answer and
  ``metadata.generation_error`` (errors marked ``soft_fail_exempt`` —
  shed, expired, service down — raise), a failed rerank keeps the
  retrieval order (``metadata.rerank_fallback``), and a caller's deadline
  that has passed before verify skips it.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import Settings
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.infra.exceptions import VectorStoreError
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.infra.tracing import get_tracing
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops.bm25 import BM25Index, BM25Params, make_bm25_index
from sentio_tpu_torch.ops.confidence import confidence_score
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import TorchEmbedder
from sentio_tpu_torch.ops.generator import EngineProvider, LLMGenerator
from sentio_tpu_torch.ops.ingest import DocumentIngestor
from sentio_tpu_torch.ops.prompts import PromptBuilder
from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
from sentio_tpu_torch.ops.retrievers import BaseRetriever, create_retriever
from sentio_tpu_torch.ops.verifier import AnswerVerifier
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.replica import ReplicaSet
from sentio_tpu_torch.runtime.service import PagedGenerationService
from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder
from sentio_tpu_torch.runtime.weights import load_draft, load_llama, refuse_tokenizer

logger = logging.getLogger(__name__)

CHARS_PER_TOKEN = 4  # the selector's ≈4-chars/token budget heuristic
VERIFY_MODES = ("sync", "async", "gated")

# live detached verify threads (VERIFY_MODE=async|gated), joined by
# wait_detached() before a service is closed under them
_detached_lock = threading.Lock()
_detached_threads: list[threading.Thread] = []


def wait_detached(timeout_s: float = 30.0) -> bool:
    """Join every live detached verify thread, all within ``timeout_s``;
    returns whether all finished. Whatever closes a generation service right
    after a chat (eval, tests, ``ChatPipeline.close``) calls it first, or
    the trailing verify decode races the shutdown."""
    deadline = time.perf_counter() + max(timeout_s, 0.0)
    while True:
        with _detached_lock:
            _detached_threads[:] = [t for t in _detached_threads if t.is_alive()]
            live = list(_detached_threads)
        if not live:
            return True
        if time.perf_counter() >= deadline:
            return False
        live[0].join(timeout=min(max(deadline - time.perf_counter(), 0.0), 0.5))


def check_verify_mode(mode: str) -> str:
    if mode not in VERIFY_MODES:
        raise ValueError(f"verify_mode must be one of {VERIFY_MODES}, got {mode!r}")
    return mode


def record_verify(request_id: Optional[str], mode: str, outcome: str,
                  confidence: Optional[float] = None, verdict_ms: Optional[float] = None,
                  skipped: Optional[str] = None) -> None:
    """One verify outcome, published to ``/metrics`` (by mode and outcome,
    and the confidence score) and to the request's flight record (its
    ``verify`` section) — the JAX graph's ``_record_verify``. Best effort:
    telemetry never fails a verdict."""
    try:
        get_metrics().record_verify(mode, outcome, confidence=confidence)
        if request_id:
            fields: dict[str, Any] = {"mode": mode, "outcome": outcome}
            if confidence is not None:
                fields["confidence"] = round(float(confidence), 4)
            if verdict_ms is not None:
                fields["verdict_ms"] = round(float(verdict_ms), 2)
            if skipped is not None:
                fields["skipped"] = skipped
            get_flight_recorder().note_verify(str(request_id), **fields)
    except Exception:  # noqa: BLE001 — telemetry must never fail a verdict
        logger.debug("verify telemetry failed", exc_info=True)


def confidence_skip_evaluation(confidence: float) -> dict[str, Any]:
    """The typed ``skipped_confident`` verdict, shared by ``run`` and the
    SSE handler."""
    return {"verdict": "skipped_confident", "citations_ok": True,
            "confidence": round(float(confidence), 4), "notes": []}


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


def check_replica_settings(serve) -> None:
    """Refuse the replica settings the port cannot honour, naming each;
    an unknown ``REPLICA_MODE`` warns and means thread mode, as in JAX."""
    if serve.replica_mode in ("process", "socket"):
        raise NotImplementedError(f"REPLICA_MODE={serve.replica_mode}: process and socket "
                                  "replicas are not ported (thread mode is)")
    if serve.parsed_replica_workers():
        raise NotImplementedError("REPLICA_WORKERS: remote socket workers are not ported")
    if serve.autoscale:
        raise NotImplementedError("AUTOSCALE=1: the replica autoscaler is not ported")
    if serve.replica_mode != "thread":
        logger.warning("REPLICA_MODE=%r unknown (expected thread|process|socket); using "
                       "thread mode", serve.replica_mode)


def check_index_backend(name: str) -> None:
    """``INDEX_BACKEND`` / ``VECTOR_STORE``: ``tpu`` is the in-memory exact
    index on the card; ``qdrant`` (JAX's external store) is not ported; any
    other name is refused as JAX's vector-store registry refuses it."""
    if name == "tpu":
        return
    if name == "qdrant":
        raise NotImplementedError("INDEX_BACKEND=qdrant: the Qdrant vector store is not "
                                  "ported")
    raise VectorStoreError(f"unknown vector store {name!r} (expected: tpu, qdrant)")


def _user_top_k(raw: Optional[int], default: int, cap: int = 50) -> int:
    if raw is None:
        return default
    return max(1, min(int(raw), cap))


def _node(meta: dict, name: str, t0: float) -> None:
    """Record a finished stage as the JAX executor does."""
    meta.setdefault("graph_path", []).append(name)
    meta.setdefault("node_timings_ms", {})[name] = round((time.perf_counter() - t0) * 1e3, 3)


def best_documents(state: dict) -> list[Document]:
    """The most-processed document list: selected → reranked → retrieved."""
    for key in ("selected_documents", "reranked_documents", "retrieved_documents"):
        if state.get(key):
            return state[key]
    return []


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
    # the /chat template head warmed into the paged engine's radix tree
    warm_head: str = ""
    # /info's generator.speculative: whether a draft was configured, whether
    # generation speculates, and if not, why
    speculative_info: dict = field(
        default_factory=lambda: {"draft_configured": False, "active": False})

    ingestor: Optional[DocumentIngestor] = None
    # set once warmup() has run: the server's readiness
    ready: bool = False

    def ingest(self, documents: Sequence[Document]) -> int:
        """Embed ``documents`` (already chunks), add them to the index and
        rebuild the BM25 index over every document the index holds, under
        the ingestor's write lock; returns the count."""
        documents = list(documents)
        lock = self.ingestor._write_lock if self.ingestor is not None else contextlib.nullcontext()
        with lock:
            self.index.add(documents, self.embedder.embed_many([d.content for d in documents]))
            if self.bm25_index is not None:
                self.bm25_index.build(self.index.documents())
        return len(documents)

    def run(self, question: str, top_k: Optional[int] = None,
            temperature: Optional[float] = None, mode: str = "balanced",
            metadata: Optional[dict] = None, deadline_ts: Optional[float] = None,
            tenant: Optional[str] = None, priority: Optional[str] = None) -> dict:
        """retrieve → rerank → select → generate → verify, as the JAX
        graph runs them. ``metadata`` seeds the state's metadata (the
        ``/chat`` handler's query id and request fields); ``deadline_ts``
        (absolute ``time.perf_counter()``) reaches the service's tickets,
        and verify is skipped once it has passed. Verification follows
        ``VERIFY_MODE`` (read at each call): ``sync`` audits before
        returning; ``async`` runs the audit on a thread of its own and
        returns at once with ``metadata.verify_pending``; ``gated`` scores
        the answer's confidence first (``metadata.verify_confidence``) and,
        at or above ``VERIFY_CONFIDENCE_THRESHOLD``, returns the typed
        ``skipped_confident`` verdict with no audit at all, else detaches
        the audit as ``async`` does. A detached verdict lands on the flight
        record of ``metadata.query_id`` (made when the caller gave none).
        ``tenant`` and ``priority`` (``X-Tenant``, ``X-Priority``) charge
        the generate and the verify admissions to that tenant's fair share.
        Returns the final state: ``query``, ``retrieved_documents``,
        ``reranked_documents``, ``selected_documents``, ``response``,
        ``evaluation``, ``metadata`` and ``generated_tokens``."""
        s = self.settings
        meta: dict[str, Any] = dict(metadata or {})
        state: dict[str, Any] = {"query": question, "response": "", "evaluation": {},
                                 "metadata": meta}
        state.update(self.context(question, _user_top_k(top_k, s.retrieval.top_k),
                                  _user_top_k(top_k, s.rerank.top_k), meta))
        best = best_documents(state)
        t0 = time.perf_counter()
        gen_stats: dict = {}
        request_id = str(meta["query_id"]) if meta.get("query_id") else None
        try:
            with self._span("generate"):
                answer = self.generator.generate(
                    question, best, mode=mode or s.generator.mode, temperature=temperature,
                    deadline_ts=deadline_ts, stats=gen_stats, tenant=tenant,
                    priority=priority, request_id=request_id)
        except Exception as exc:  # noqa: BLE001 — the JAX generate node's degradation
            if getattr(exc, "soft_fail_exempt", False):
                raise  # shed / expired / service down surface typed
            logger.exception("generation failed")
            meta["generation_error"] = str(exc)
        else:
            state["response"] = answer
            meta.update(generation_ms=round((time.perf_counter() - t0) * 1000, 2),
                        generation_mode=mode or s.generator.mode,
                        generator=self.generator.provider.name)
            if gen_stats.get("logprob_count"):
                meta.update(logprob_mean=round(gen_stats["logprob_mean"], 4),
                            logprob_min=round(gen_stats["logprob_min"], 4),
                            logprob_count=gen_stats["logprob_count"])
            if gen_stats.get("replica_id") is not None:
                meta["replica_id"] = gen_stats["replica_id"]  # which replica decoded it
        state["generated_tokens"] = gen_stats.get("tokens", 0)
        _node(meta, "generate", t0)
        if self.verifier is not None:
            mode = check_verify_mode(s.generator.verify_mode)
            if mode != "sync" and not meta.get("query_id"):
                # the flight record a detached verdict lands on
                meta["query_id"] = uuid.uuid4().hex[:12]
            skipped = False
            if mode == "gated":
                t0 = time.perf_counter()
                skipped = self._gate(state, best, s.generator.verify_confidence_threshold)
                _node(meta, "verify_gate", t0)
            charge = {"tenant": tenant, "priority": priority}
            if mode == "sync":
                t0 = time.perf_counter()
                with self._span("verify"):
                    self._verify(state, best, deadline_ts, mode, **charge)
                _node(meta, "verify", t0)
            elif not skipped:
                self._detach_verify(state, best, deadline_ts, mode, **charge)
        if meta.get("query_id"):
            get_flight_recorder().add_node_timings(str(meta["query_id"]),
                                                   meta["node_timings_ms"],
                                                   graph_path=meta["graph_path"])
        return state

    def _gate(self, state: dict, docs: list[Document], threshold: float) -> bool:
        """The confidence gate (``VERIFY_MODE=gated``): score the answer's
        logprobs and the retrieval margin; at or above ``threshold`` the
        typed ``skipped_confident`` verdict replaces verification (no verify
        admission) and this returns True. No answer, or no logprob signal,
        never skips."""
        meta = state["metadata"]
        if not state["response"]:
            meta["verify_confidence"] = None
            return False
        conf = confidence_score(meta.get("logprob_mean"), meta.get("logprob_min"), docs)
        meta["verify_confidence"] = None if conf is None else round(conf, 4)
        if conf is None or conf < threshold:
            return False
        record_verify(meta.get("query_id"), "gated", "skipped_confident", confidence=conf,
                      skipped="confident")
        state["evaluation"] = confidence_skip_evaluation(conf)
        meta["verify_skipped"] = "confident"
        return True

    def _verify(self, state: dict, docs: list[Document], deadline_ts: Optional[float],
                mode: str, tenant: Optional[str] = None,
                priority: Optional[str] = None) -> None:
        """The verify stage, writing its verdict into ``state`` and the
        flight record: an empty answer is a ``warn``, a caller's deadline
        that has passed skips the audit, a ``fail`` with a revision
        replaces the answer."""
        meta = state["metadata"]
        request_id = meta.get("query_id")
        answer = state["response"]
        if not answer:
            record_verify(request_id, mode, "skipped_empty", skipped="empty")
            state["evaluation"] = {"verdict": "warn", "notes": ["empty answer"]}
            return
        if deadline_ts is not None and time.perf_counter() >= deadline_ts:
            record_verify(request_id, mode, "skipped_deadline", skipped="deadline")
            state["evaluation"] = {"verdict": "skip",
                                   "notes": ["deadline expired; verification skipped"]}
            meta["verify_skipped"] = "deadline"
            return
        t0 = time.perf_counter()
        result = self.verifier.verify(state["query"], answer, docs, deadline_ts=deadline_ts,
                                      tenant=tenant, priority=priority,
                                      request_id=str(request_id) if request_id else None)
        verdict_ms = round((time.perf_counter() - t0) * 1000, 2)
        record_verify(request_id, mode, result.verdict,
                      confidence=meta.get("verify_confidence"), verdict_ms=verdict_ms)
        state["evaluation"] = result.to_dict()
        meta.update(verify_ms=verdict_ms, verdict=result.verdict)
        if result.verdict == "fail" and result.revised_answer:
            state["response"] = result.revised_answer
            meta["answer_revised"] = True

    def _detach_verify(self, state: dict, docs: list[Document],
                       deadline_ts: Optional[float], mode: str, tenant: Optional[str] = None,
                       priority: Optional[str] = None) -> None:
        """Run the verify stage on a thread of its own over a snapshot of
        ``state`` and return at once with ``metadata.verify_pending``: the
        verdict lands on the flight record only (a late revision has no
        answer left to replace)."""
        snapshot = dict(state)
        snapshot["metadata"] = dict(state["metadata"])

        def run() -> None:
            try:
                self._verify(snapshot, docs, deadline_ts, mode, tenant, priority)
            except Exception:  # noqa: BLE001 — the answer has shipped; log, never crash
                logger.exception("detached verify failed")

        thread = threading.Thread(target=run, name="graph-detached-verify", daemon=True)
        with _detached_lock:
            _detached_threads[:] = [t for t in _detached_threads if t.is_alive()]
            _detached_threads.append(thread)
        thread.start()
        meta = state["metadata"]
        meta["verify_pending"] = True
        meta.setdefault("graph_path", []).append("verify")

    def context(self, question: str, retrieve_k: int, rerank_k: int,
                meta: dict) -> dict[str, list[Document]]:
        """retrieve → rerank → select, degrading as the JAX graph's nodes
        do: a failed retrieval leaves no documents and sets
        ``meta["retrieval_error"]``, a failed rerank keeps the retrieval
        order and sets ``meta["rerank_fallback"]``. Each stage's time goes
        to ``meta["node_timings_ms"]`` and its name to ``meta["graph_path"]``.
        Returns ``retrieved_documents``, ``reranked_documents`` and
        ``selected_documents``."""
        docs: dict[str, list[Document]] = {"retrieved_documents": [], "reranked_documents": [],
                                           "selected_documents": []}
        t0 = time.perf_counter()
        try:
            with self._span("retrieve"):
                retrieved = self.retriever.retrieve(question, retrieve_k)
        except Exception as exc:  # noqa: BLE001 — the JAX retrieve node's degradation
            logger.exception("retrieval failed")
            meta["retrieval_error"] = str(exc)
        else:
            docs["retrieved_documents"] = retrieved
            meta.update(num_retrieved=len(retrieved),
                        retrieval_ms=round((time.perf_counter() - t0) * 1000, 2),
                        retriever=self.retriever.name)
        _node(meta, "retrieve", t0)
        if self.reranker is not None:
            t0 = time.perf_counter()
            if not docs["retrieved_documents"]:
                meta["num_reranked"] = 0
            else:
                with self._span("rerank"):
                    result = self.reranker.rerank(question, docs["retrieved_documents"],
                                                  top_k=rerank_k)
                docs["reranked_documents"] = result.documents
                meta.update(num_reranked=len(result.documents),
                            rerank_ms=round((time.perf_counter() - t0) * 1000, 2),
                            reranker=result.model, rerank_fallback=result.fallback_used)
            _node(meta, "rerank", t0)
        t0 = time.perf_counter()
        selected, used = select_documents(
            docs["reranked_documents"] or docs["retrieved_documents"],
            self.settings.generator.context_token_budget)
        docs["selected_documents"] = selected
        meta.update(num_selected=len(selected), context_chars=used,
                    context_budget_chars=(self.settings.generator.context_token_budget
                                          * CHARS_PER_TOKEN))
        _node(meta, "select", t0)
        return docs

    @contextlib.contextmanager
    def _span(self, node: str):
        """A ``graph.node.{node}`` span around one stage when tracing is on
        (``TRACING_ENABLED`` and OpenTelemetry importable), as the JAX
        executor wraps its nodes; nothing otherwise."""
        tracing = get_tracing()
        if not tracing.enabled:
            yield
            return
        with tracing.span(f"graph.node.{node}", node=node):
            yield

    def chat(self, question: str, top_k: Optional[int] = None,
             temperature: Optional[float] = None, mode: str = "balanced",
             deadline_ts: Optional[float] = None, tenant: Optional[str] = None,
             priority: Optional[str] = None) -> dict[str, Any]:
        state = self.run(question, top_k=top_k, temperature=temperature, mode=mode,
                         deadline_ts=deadline_ts, tenant=tenant, priority=priority)
        meta = state["metadata"]
        return {
            "answer": state["response"],
            "sources": serialize_sources(best_documents(state)),
            "verification": state["evaluation"],
            "metadata": {
                "retrieved_ids": [d.id for d in state["retrieved_documents"]],
                "reranked_ids": [d.id for d in (state["reranked_documents"]
                                                or state["retrieved_documents"])],
                "stage_ms": meta["node_timings_ms"],
                "generated_tokens": state["generated_tokens"],
                **{k: meta[k] for k in ("retrieval_error", "rerank_fallback",
                                        "generation_error", "query_id", "verify_pending")
                   if k in meta},
            },
        }

    @property
    def replica_set(self) -> Optional[ReplicaSet]:
        """The replica tier generation goes through (None on the contiguous
        engine)."""
        service = self.generator.provider.service
        return service if isinstance(service, ReplicaSet) else None

    @property
    def service(self) -> Optional[PagedGenerationService]:
        """The first replica's current generation service (a rebuild swaps
        it; the only one at ``REPLICAS=1``), for callers that drive its
        engine directly; None on the contiguous engine."""
        replicas = self.replica_set
        return replicas.services[0] if replicas is not None else None

    def load_index(self, path) -> int:
        """Add a dense index saved by ``TorchDenseIndex.save`` (or the JAX
        index's ``save``) to this pipeline's index and rebuild BM25 over it;
        returns the documents loaded. The saved vectors must have the
        embedder's width."""
        loaded = TorchDenseIndex.load(path, device=self.index.device, dtype=self.index.dtype)
        if loaded.dim != self.embedder.dimension:
            raise ValueError(f"persisted dense index at {path} has dim={loaded.dim} but the "
                             f"configured embedder produces dim={self.embedder.dimension}")
        documents, embeddings = loaded.documents(), loaded.embeddings()
        lock = self.ingestor._write_lock if self.ingestor is not None else contextlib.nullcontext()
        with lock:
            if documents:
                self.index.add(documents, embeddings)
            if self.bm25_index is not None:
                self.bm25_index.build(self.index.documents())
        return len(documents)

    def warmup(self) -> Optional[dict]:
        """Warm every replica at once (each captures every graph variant on
        the card) before traffic, then warm the template head into every
        replica's tree again: warmup's own prompts fill the trees and can
        evict it. None on the contiguous engine. Sets ``ready``."""
        stats = None
        replicas = self.replica_set
        if replicas is not None:
            stats = replicas.warmup()
            if self.warm_head:
                stats["head_tokens"] = []
                for svc in replicas.services:
                    svc.wait_idle()
                    stats["head_tokens"].append(svc.engine.warm_prefix(self.warm_head))
        self.ready = True
        return stats

    def close(self, detached_timeout_s: float = 30.0) -> None:
        """Join the detached verify threads (up to ``detached_timeout_s``;
        one still running then ends with the closed service's error as a
        ``warn`` verdict), stop the generation service's pump, if any, and
        the embedder's coalescer."""
        if not wait_detached(detached_timeout_s):
            logger.warning("closing with detached verifies still running")
        service = self.generator.provider.service
        if service is not None:
            service.close()
        self.embedder.close()


def make_embedder(settings: Settings, device, seed: int = 0, params: Optional[dict] = None,
                  model_config: Optional[EncoderConfig] = None) -> TorchEmbedder:
    """The embedder ``build_pipeline`` makes for ``seed``: the checkpoint's
    weights, or random ones drawn from ``seed + 1`` on ``device`` — so an
    index that ``ingest`` saves is searched with the same weights by a
    server built from the same settings and seed."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    return TorchEmbedder(settings.embedder, params=params, model_config=model_config,
                         device=dev, generator=g)


def build_pipeline(settings: Optional[Settings] = None, device=None, seed: int = 0,
                   llama_config: Optional[LlamaConfig] = None,
                   embedder_config: Optional[EncoderConfig] = None,
                   reranker_config: Optional[EncoderConfig] = None,
                   llama_params: Optional[dict] = None,
                   embedder_params: Optional[dict] = None,
                   reranker_params: Optional[dict] = None,
                   draft_params: Optional[dict] = None,
                   draft_config: Optional[LlamaConfig] = None) -> ChatPipeline:
    """Assemble the pipeline from ``settings`` on ``device`` (the card by
    default). Weights not passed in come from the configured checkpoints or
    are random, made on the device from ``seed``; the retriever follows
    the retrieval settings (strategy, fusion, BM25 backend) and the engine
    the generator settings: with ``USE_PAGED_KV`` (the default)
    ``REPLICAS`` paged engines (slots, page size, pages per sequence,
    ``kv_quant``, the prefix cache, the decode pipeline depth and chunked
    prefill, as the JAX service hands them to its engine) on the shared
    weights, each behind a generation service with the serve section's
    admission bound, default deadline, retry budget and stall budgets, all
    behind a ``ReplicaSet`` with every serve knob of the tier; without it
    the contiguous engine. A draft model (``draft_params`` and
    ``draft_config``, for callers that hold the weights, or the
    ``LLM_DRAFT_CHECKPOINT`` checkpoint) makes generation speculative with
    ``SPECULATIVE_K`` drafted tokens a round: the paged engine speculates in
    every decode tick unless ``PREFILL_CHUNK`` is set (then the draft is
    ignored with a warning), the contiguous engine through a
    ``SpeculativeDecoder``. Settings this package cannot honour raise
    ``NotImplementedError``."""
    settings = settings or Settings()
    rcfg, gcfg = settings.retrieval, settings.generator
    if rcfg.use_scorers:
        raise NotImplementedError("USE_SCORERS: post-fusion scorers are not ported")
    if rcfg.web_cache_path:
        raise NotImplementedError("WEB_CACHE_PATH: the web-cache retrieval leg is not ported")
    check_index_backend(rcfg.index_backend)
    mesh = settings.mesh
    if max(mesh.dp_size, mesh.tp_size, mesh.sp_size) > 1:
        raise NotImplementedError(f"MESH_DP={mesh.dp_size} MESH_TP={mesh.tp_size} "
                                  f"MESH_SP={mesh.sp_size}: device meshes are not ported "
                                  "(one card)")
    check_verify_mode(gcfg.verify_mode)
    check_replica_settings(settings.serve)
    dev = resolve_device(device)
    if draft_params is not None and draft_config is None:
        raise ValueError("draft_params requires draft_config")
    spec_info = {"draft_configured": bool(gcfg.draft_checkpoint_path
                                          or draft_params is not None)}
    if spec_info["draft_configured"] and gcfg.use_paged_decode and gcfg.prefill_chunk:
        logger.warning("LLM_DRAFT_CHECKPOINT ignored: PREFILL_CHUNK is set and paged "
                       "speculation requires whole-prompt admission (the draft prefills "
                       "full prompts)")
        spec_info["ignored_reason"] = ("PREFILL_CHUNK set (chunked prefill excludes paged "
                                       "speculation)")
    spec_info["active"] = spec_info["draft_configured"] and "ignored_reason" not in spec_info
    if spec_info["active"]:
        if draft_params is None:
            draft_params, draft_config = load_draft(gcfg.draft_checkpoint_path, device=dev)
        logger.info("speculative decoding: draft dim=%d L=%d, k=%d", draft_config.dim,
                    draft_config.n_layers, gcfg.speculative_k)
    else:
        draft_params = draft_config = None

    def gen(offset: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + offset)
        return g

    embedder = make_embedder(settings, dev, seed, params=embedder_params,
                             model_config=embedder_config)
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
    refuse_tokenizer("LLM_TOKENIZER", gcfg.tokenizer_path)
    if llama_params is None and gcfg.checkpoint_path:
        llama_params, llama_config = load_llama(gcfg.checkpoint_path, device=dev)
    llama_config = llama_config or (
        LlamaConfig.tiny() if gcfg.model_preset == "tiny" else LlamaConfig.llama3_8b())
    if llama_params is None:
        llama_params = init_llama(llama_config, gen(3), dev)
    prompts = PromptBuilder()
    warm_head = ""
    if gcfg.use_paged_decode:
        serve = settings.serve
        if gcfg.prefix_cache:
            # spares the first /chat its cold prefill of the template head,
            # as the JAX container warms each replica's tree
            warm_head = prompts.static_head("retrieve", instruction=prompts.load("profile"))
        services = []
        for i in range(max(serve.replicas, 1)):
            engine = ContinuousBatchingEngine(
                model_config=llama_config, params=llama_params,
                max_slots=gcfg.max_batch_size, page_size=gcfg.kv_page_size,
                max_pages_per_seq=gcfg.kv_max_pages_per_seq, rng_seed=seed,
                steps_per_tick=gcfg.decode_steps_per_tick,
                max_tick_steps=gcfg.decode_max_tick_steps, kv_quant=gcfg.kv_quant,
                prefix_cache=gcfg.prefix_cache, pipeline_depth=gcfg.decode_pipeline_depth,
                prefill_chunk=gcfg.prefill_chunk or None, draft_params=draft_params,
                draft_config=draft_config, spec_k=gcfg.speculative_k, device=dev,
            )
            if warm_head:
                engine.warm_prefix(warm_head)
            services.append(PagedGenerationService(
                engine, max_queue=serve.admission_max_queue or None,
                default_deadline_s=(serve.default_deadline_ms / 1e3
                                    if serve.default_deadline_ms > 0 else None),
                retry_budget=serve.crash_retry_budget, replica_id=i,
                tick_stall_budget_s=serve.tick_stall_budget_s,
                warmup_budget_s=serve.warmup_budget_s))
        replicas = ReplicaSet(
            services, tenant_weights=serve.parsed_tenant_weights(),
            tenant_default_weight=serve.tenant_default_weight,
            tenant_refill_tokens_per_s=serve.tenant_refill_tokens_per_s,
            tenant_burst_tokens=serve.tenant_burst_tokens,
            tenant_headroom=serve.tenant_headroom if serve.tenant_headroom >= 0 else None,
            batch_shed_fraction=serve.batch_shed_fraction,
            affinity_stickiness=serve.affinity_stickiness,
            route_prefix_tokens=serve.route_prefix_tokens,
            supervise=serve.replica_supervise,
            probe_interval_s=serve.replica_probe_interval_s,
            breaker_window_s=serve.replica_breaker_window_s,
            breaker_error_rate=serve.replica_breaker_error_rate,
            breaker_min_samples=serve.replica_breaker_min_samples,
            breaker_tick_failures=serve.replica_breaker_tick_failures,
            quarantine_backoff_s=serve.replica_quarantine_backoff_s,
            rebuild_budget=serve.replica_rebuild_budget,
            rebuild_drain_s=serve.replica_rebuild_drain_s,
            failover_budget=serve.replica_failover_budget,
            stream_resume_budget=(serve.stream_resume_budget
                                  if serve.stream_resume_budget >= 0 else None),
            rebuild_workers=serve.replica_rebuild_workers)
        # the escape hatch, as JAX's container builds it beside the tier: a
        # contiguous engine on the same weights, whose cache is allocated
        # per call (no memory until a chat falls back to it)
        contiguous = GeneratorEngine(config=gcfg, model_config=llama_config,
                                     params=llama_params, rng_seed=seed, device=dev)
        provider = EngineProvider(contiguous=contiguous, service=replicas)
    else:
        engine = GeneratorEngine(config=gcfg, model_config=llama_config, params=llama_params,
                                 rng_seed=seed, device=dev)
        speculative = None
        if draft_params is not None:
            speculative = SpeculativeDecoder(engine, draft_params, draft_config,
                                             k=gcfg.speculative_k)
        provider = EngineProvider(engine, speculative=speculative)
    generator = LLMGenerator(provider=provider, config=gcfg, prompts=prompts)
    verifier = AnswerVerifier(generator=generator, config=gcfg) if gcfg.use_verifier else None
    ingestor = DocumentIngestor(embedder=embedder, dense_index=index, sparse_index=bm25,
                                settings=settings)
    return ChatPipeline(embedder=embedder, index=index, retriever=retriever,
                        generator=generator, bm25_index=bm25, reranker=reranker,
                        verifier=verifier, settings=settings, warm_head=warm_head,
                        speculative_info=spec_info, ingestor=ingestor)
