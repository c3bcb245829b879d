"""The ``/chat`` pipeline on the card — the graph of
``sentio_tpu/graph/factory.py::build_basic_graph``:
retrieve → rerank → select → generate → verify, with verify synchronous,
detached (``VERIFY_MODE=async``) or behind a confidence gate (``gated``).

Retrieval follows ``RETRIEVAL_STRATEGY``: ``dense`` (the bi-encoder embeds
the query and an exact top-k runs over the index on the card), ``bm25``
(host BM25) or ``hybrid``, the default (both legs fused by
``FUSION_METHOD``, rrf by default). ``INDEX_BACKEND`` picks the dense
store through the registry (``ops/vector_store.py``: ``tpu``, the index
on the card, or ``qdrant``, whose corpus BM25 is rebuilt from at build
time); ``USE_SCORERS`` mixes the post-fusion scorers into the hybrid
list, and ``WEB_CACHE_PATH`` (a saved index) adds the cached-web-results
leg. ``KV_QUANT=int8`` gives the engine an
int8 page pool; ``PREFIX_CACHE``, ``DECODE_PIPELINE_DEPTH`` and
``PREFILL_CHUNK`` reach the engine as in the JAX service (the radix prefix
cache and depth 2 by default). Generation runs on ``REPLICAS`` paged
engines (one by default), each behind its own generation service
(``runtime/service.py``), fronted by the replica tier
(``runtime/replica.py``: tenant WFQ, radix-affinity routing, supervision
with in-place rebuild, failover, resumable streams), as the JAX container
builds it; concurrent ``chat`` calls share each replica's decode batch. The
replicas share the weights and own their pools, radix trees, CUDA streams
and graphs. ``REPLICA_MODE=process`` puts each replica in a worker process
of its own (``runtime/worker.py``) and ``socket`` does so over TCP, the
workers registering with the router's ``WorkerRegistry``, or, with
``REPLICA_WORKERS``, dialed where they already serve; the router's weight
tensors reach each spawned worker through the spawn arguments, so the card
holds them once. A socket set also takes workers that join at runtime
(``slot=-1``: warmed on the set's join thread, then wired in by the
supervisor) and retires one that deregisters; ``AUTOSCALE=1`` puts the
autoscaler (``runtime/autoscaler.py``) over the set in every mode, whose scale-out
spawns such a worker in socket mode (thread and process sets have no
launcher, as in JAX: a scale-out is booked skipped, a scale-in retires).
With ``PREFIX_CACHE`` on, the ``/chat`` template head is warmed into every
replica's radix tree at build time.
``USE_PAGED_KV=0`` generates on the contiguous engine instead
(``runtime/engine.py``: causal flash prefill, one call at a time).
``LLM_CHECKPOINT`` and ``RERANKER_CHECKPOINT`` load ``save_pytree``
checkpoints. ``LLM_DRAFT_CHECKPOINT`` (k from ``SPECULATIVE_K``) makes
generation speculative as in the JAX container: the paged engine runs
every decode tick as a spec tick (``runtime/paged_spec.py``) unless
``PREFILL_CHUNK`` is set, which excludes it (a warning, and
``speculative_info`` says why); the contiguous engine is wrapped in a
``SpeculativeDecoder`` (``runtime/speculative.py``). The ``MESH_*``
settings (or a caller's ``mesh``) put the models on a device mesh
(``parallel/``), as JAX's container does; :func:`build_pipeline` gives
its rules.

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
from pathlib import Path
from typing import Any, Optional, Sequence

import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import Settings
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.infra.tracing import get_tracing
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.moe import decoder_rules, family, init_decoder
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops.bm25 import BM25Index, BM25Params, make_bm25_index
from sentio_tpu_torch.ops.confidence import confidence_score
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import BaseEmbedder, TorchEmbedder, get_embedder
from sentio_tpu_torch.ops.generator import EngineProvider, LLMGenerator, provider_for
from sentio_tpu_torch.ops.ingest import DocumentIngestor
from sentio_tpu_torch.ops.prompts import PromptBuilder
from sentio_tpu_torch.ops.reranker import Reranker, get_reranker
from sentio_tpu_torch.ops.retrievers import BaseRetriever, HybridRetriever, create_retriever
from sentio_tpu_torch.ops.scorers import default_scorer_stack
from sentio_tpu_torch.ops.vector_store import get_vector_store
from sentio_tpu_torch.ops.verifier import AnswerVerifier
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.parallel.mesh import (
    Mesh,
    MeshError,
    build_mesh,
    visible_devices,
)
from sentio_tpu_torch.parallel.sharding import shard_params
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, check_mesh_model
from sentio_tpu_torch.runtime.replica import ReplicaSet
from sentio_tpu_torch.runtime.service import PagedGenerationService
from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder
from sentio_tpu_torch.runtime.weights import load_draft, load_generator

logger = logging.getLogger(__name__)

CHARS_PER_TOKEN = 4  # the selector's ≈4-chars/token budget heuristic
VERIFY_MODES = ("sync", "async", "gated")
REPLICA_MODES = ("thread", "process", "socket")

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
    """Refuse, as JAX's container does, ``REPLICA_WORKERS`` under
    ``REPLICA_MODE=socket`` without ``SOCKET_AUTH_TOKEN`` (a
    ``ValueError``); an unknown ``REPLICA_MODE`` warns and means thread
    mode, as in JAX."""
    if serve.replica_mode == "socket" and serve.parsed_replica_workers() \
            and not serve.socket_auth_token:
        raise ValueError("REPLICA_WORKERS needs SOCKET_AUTH_TOKEN set identically on router "
                         "and workers")
    if serve.replica_mode not in REPLICA_MODES:
        logger.warning("REPLICA_MODE=%r unknown (expected thread|process|socket); using "
                       "thread mode", serve.replica_mode)


def serving_mesh(cfg, device) -> Optional[Mesh]:
    """The mesh the ``MESH_*`` settings ask for, by JAX's container rule:
    none at the defaults on a host of one device, else
    :func:`~.parallel.mesh.build_mesh` over the host's devices (every card,
    or the host itself for a CPU pipeline or ``MESH_BACKEND=cpu``), whose
    ``MeshError`` a size the host cannot hold raises."""
    devices = visible_devices(cfg.backend or ("cpu" if device.type == "cpu" else ""))
    if cfg.dp_size == 0 and cfg.tp_size <= 1 and cfg.sp_size <= 1 and len(devices) <= 1:
        return None  # one device: no mesh machinery
    return build_mesh(cfg, devices)


def replica_mode(serve) -> str:
    """The mode ``build_pipeline`` runs: the setting, or thread mode for an
    unknown value."""
    return serve.replica_mode if serve.replica_mode in REPLICA_MODES else "thread"


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
    embedder: BaseEmbedder
    index: TorchDenseIndex
    retriever: BaseRetriever
    generator: LLMGenerator
    bm25_index: Optional[BM25Index] = None
    reranker: Optional[Reranker] = None
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
    # REPLICA_MODE as built: thread, process or socket
    replica_mode: str = "thread"
    # the cached-web-results index (WEB_CACHE_PATH), if one was loaded
    web_cache_index: Optional[TorchDenseIndex] = None
    # the device mesh the models are sharded over (MESH_*), or None
    mesh: Optional[Mesh] = None

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
        leg_stats: dict[str, Any] = {}
        extra = {"stats": leg_stats} if isinstance(self.retriever, HybridRetriever) else {}
        try:
            with self._span("retrieve"):
                retrieved = self.retriever.retrieve(question, retrieve_k, **extra)
        except Exception as exc:  # noqa: BLE001 — the JAX retrieve node's degradation
            logger.exception("retrieval failed")
            meta["retrieval_error"] = str(exc)
        else:
            docs["retrieved_documents"] = retrieved
            meta.update(num_retrieved=len(retrieved),
                        retrieval_ms=round((time.perf_counter() - t0) * 1000, 2),
                        retriever=self.retriever.name)
        _node(meta, "retrieve", t0)
        if "scorers_ms" in leg_stats:  # the post-fusion scorers, inside retrieve
            meta["node_timings_ms"]["scorers"] = leg_stats["scorers_ms"]
        if leg_stats.get("legs_dropped") and meta.get("query_id"):
            # a store's outage dropped a leg: the request's record counts it
            get_flight_recorder().annotate(str(meta["query_id"]),
                                           retrieval_legs_dropped=leg_stats["legs_dropped"])
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
        service = self.generation_service
        return service if isinstance(service, ReplicaSet) else None

    @property
    def generation_service(self):
        """The provider's generation tier (None for a provider with none:
        the contiguous engine, a remote or the echo provider)."""
        return getattr(self.generator.provider, "service", None)

    @property
    def engine(self):
        """The provider's engine (None for a remote or the echo
        provider)."""
        return getattr(self.generator.provider, "engine", None)

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
        loaded = TorchDenseIndex.load(path, device=self.embedder.device,
                                      dtype=self.settings.generator.dtype)
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
        """Warm every live replica at once (each captures every graph
        variant on the card, a worker in its own process) before traffic,
        then warm the template head into every replica's tree again:
        warmup's own prompts fill the trees and can evict it. None on the
        contiguous engine. Sets ``ready``."""
        stats = None
        replicas = self.replica_set
        if replicas is not None:
            stats = replicas.warmup()
            if self.warm_head:
                stats["head_tokens"] = []
                for (_slot, svc), result in zip(replicas.live_services(), stats["per_replica"]):
                    if "head_tokens" in result:
                        # a worker warmed it again itself, after its warmup
                        stats["head_tokens"].append(result["head_tokens"])
                        continue
                    stats["head_tokens"].append(svc.warm_prefix(self.warm_head))
        self.ready = True
        return stats

    def close(self, detached_timeout_s: float = 30.0) -> None:
        """Join the detached verify threads (up to ``detached_timeout_s``;
        one still running then ends with the closed service's error as a
        ``warn`` verdict), stop the generation service's pump, if any, and
        the embedder's coalescer."""
        if not wait_detached(detached_timeout_s):
            logger.warning("closing with detached verifies still running")
        service = self.generation_service
        if service is not None:
            service.close()
        self.embedder.close()
        close_store = getattr(self.index, "close", None)
        if close_store is not None:  # the Qdrant store's clients and health loop
            close_store()


def make_embedder(settings: Settings, device, seed: int = 0, params: Optional[dict] = None,
                  model_config: Optional[EncoderConfig] = None, mesh: Optional[Mesh] = None):
    """The embedder ``build_pipeline`` makes for ``seed``: under
    ``EMBEDDER_PROVIDER=tpu`` the checkpoint's weights, or random ones
    drawn from ``seed + 1`` on ``device`` — so an index that ``ingest``
    saves is searched with the same weights by a server built from the same
    settings and seed —, under any other name the hash embedder."""
    dev = resolve_device(device)
    if settings.embedder.provider != "tpu":
        return get_embedder(settings.embedder, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    return TorchEmbedder(settings.embedder, params=params, model_config=model_config,
                         device=dev, generator=g, mesh=mesh)


def build_pipeline(settings: Optional[Settings] = None, device=None, seed: int = 0,
                   llama_config: Optional[LlamaConfig] = None,
                   embedder_config: Optional[EncoderConfig] = None,
                   reranker_config: Optional[EncoderConfig] = None,
                   llama_params: Optional[dict] = None,
                   embedder_params: Optional[dict] = None,
                   reranker_params: Optional[dict] = None,
                   draft_params: Optional[dict] = None,
                   draft_config: Optional[LlamaConfig] = None,
                   mesh: Optional[Mesh] = None) -> ChatPipeline:
    """Assemble the pipeline from ``settings`` on ``device`` (the card by
    default). Weights not passed in come from the configured checkpoints or
    are random, made on the device from ``seed``; the generator is of
    either decoder family (``llama_config`` a ``MoeConfig``, or a ``moe``
    checkpoint, serves the routed decoder on every engine); the retriever
    follows
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
    ignored with a warning; its draft is a llama model), the contiguous
    engine through a ``SpeculativeDecoder`` (a draft of either family).
    The dense store comes from ``INDEX_BACKEND`` through the registry
    (BM25 is rebuilt from a store that already holds a corpus), the
    scorers from ``USE_SCORERS`` and the web-cache index from
    ``WEB_CACHE_PATH`` when ``<path>.json`` exists (else none, as in
    JAX). ``AUTOSCALE=1`` starts the autoscaler over the set
    (``pipeline.replica_set.autoscaler``). ``LLM_PROVIDER``,
    ``EMBEDDER_PROVIDER`` and ``RERANKER_KIND`` pick the components as
    JAX's container does: a provider other than ``tpu`` is served with no
    engine, draft or tier. ``LLM_TOKENIZER`` beside ``LLM_CHECKPOINT`` is
    the engines' and the router's tokenizer (and each worker's).

    The device mesh comes from the ``MESH_*`` settings (:func:`serving_mesh`,
    JAX's container rule), or from the caller's ``mesh`` (JAX's
    ``container.override("mesh", ...)``; a mesh may repeat a device). On a
    mesh, as JAX's container builds it: the embedder and the cross-encoder
    shard by ``ENCODER_TP_RULES`` (plain attention at sp > 1), the dense
    index (and the web-cache index) by rows over every axis, the generator
    by its family's rules (``LLAMA_TP_RULES``, or ``MOE_EP_RULES`` for the
    ``moe`` family: experts over ep); the contiguous engine's prefill rides
    the ring at sp > 1; axes the rules do not name replicate.
    ``REPLICAS`` map onto :func:`split_mesh_dp`'s dp slices, or share the
    whole mesh with a warning when they do not divide;
    ``REPLICA_MODE=process|socket`` falls to thread mode and a draft is
    ignored, each with JAX's warning (``speculative_info`` gives the
    reason)."""
    settings = settings or Settings()
    rcfg, gcfg = settings.retrieval, settings.generator
    check_verify_mode(gcfg.verify_mode)
    check_replica_settings(settings.serve)
    if mesh is None:
        mesh = serving_mesh(settings.mesh, resolve_device(device))
    # LLM_PROVIDER other than tpu (JAX's create_generator): a remote or
    # fake provider, and no engine, draft, service or replica set — nothing
    # of the generator touches the card
    remote = provider_for(gcfg) if gcfg.provider != "tpu" else None
    dev = mesh.device if mesh is not None else resolve_device(device)
    if draft_params is not None and draft_config is None:
        raise ValueError("draft_params requires draft_config")
    spec_info = {"draft_configured": bool(gcfg.draft_checkpoint_path
                                          or draft_params is not None)}
    if remote is None and spec_info["draft_configured"] and mesh is not None:
        # JAX's container: neither engine speculates on a mesh
        logger.warning("LLM_DRAFT_CHECKPOINT ignored: %s speculation does not support a "
                       "device mesh yet (MESH_* > 1 configured); /info reports this under "
                       "generator.speculative",
                       "paged" if gcfg.use_paged_decode else "contiguous")
        spec_info["ignored_reason"] = (
            f"device mesh configured ({'paged' if gcfg.use_paged_decode else 'contiguous'} "
            "speculation is single-chip)")
    elif remote is None and spec_info["draft_configured"] and gcfg.use_paged_decode \
            and gcfg.prefill_chunk:
        logger.warning("LLM_DRAFT_CHECKPOINT ignored: PREFILL_CHUNK is set and paged "
                       "speculation requires whole-prompt admission (the draft prefills "
                       "full prompts)")
        spec_info["ignored_reason"] = ("PREFILL_CHUNK set (chunked prefill excludes paged "
                                       "speculation)")
    spec_info["active"] = (remote is None and spec_info["draft_configured"]
                           and "ignored_reason" not in spec_info)
    if spec_info["active"]:
        if draft_params is None and gcfg.use_paged_decode:
            draft_params, draft_config = load_draft(gcfg.draft_checkpoint_path, device=dev)
        elif draft_params is None:
            # the contiguous decoder drafts with either family, as JAX's
            draft_params, draft_config, _ = load_generator(gcfg.draft_checkpoint_path,
                                                           device=dev)
        logger.info("speculative decoding: draft dim=%d L=%d, k=%d", draft_config.dim,
                    draft_config.n_layers, gcfg.speculative_k)
    else:
        draft_params = draft_config = None

    def gen(offset: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + offset)
        return g

    # RERANKER_KIND first: an unknown kind raises before any model is made
    reranker = None
    if settings.rerank.enabled:
        reranker = get_reranker(settings.rerank.kind, config=settings.rerank,
                                params=reranker_params, model_config=reranker_config,
                                device=dev, generator=gen(2), mesh=mesh)
    embedder = make_embedder(settings, dev, seed, params=embedder_params,
                             model_config=embedder_config, mesh=mesh)
    # the registry, as JAX's container builds its store; the card's corpus
    # is held in the generator dtype
    index = get_vector_store(rcfg.index_backend, embedder.dimension, device=dev,
                             settings=settings, dtype=gcfg.dtype, mesh=mesh)
    bm25 = None
    if rcfg.strategy in ("bm25", "sparse", "hybrid"):
        bm25 = make_bm25_index(BM25Params(k1=rcfg.bm25_k1, b=rcfg.bm25_b),
                               backend=rcfg.bm25_backend)
        docs = index.documents()
        if docs:  # rehydrate from a store that already holds a corpus
            bm25.build(docs)
    web_cache = None
    if rcfg.web_cache_path and Path(rcfg.web_cache_path).with_suffix(".json").exists():
        logger.info("loading web-cache index from %s", rcfg.web_cache_path)
        web_cache = TorchDenseIndex.load(rcfg.web_cache_path, device=dev, dtype=gcfg.dtype,
                                         mesh=mesh)
    scorers = default_scorer_stack(embedder, settings) if rcfg.use_scorers else None
    retriever = create_retriever(settings, embedder, index, bm25, scorers=scorers,
                                 web_cache_index=web_cache)
    prompts = PromptBuilder()
    warm_head = ""
    tokenizer = None  # LLM_TOKENIZER takes effect beside LLM_CHECKPOINT, as in JAX
    if remote is None:
        if llama_params is None and gcfg.checkpoint_path:
            llama_params, llama_config, tokenizer = load_generator(
                gcfg.checkpoint_path, gcfg.tokenizer_path, device=dev)
        llama_config = llama_config or (
            LlamaConfig.tiny() if gcfg.model_preset == "tiny" else LlamaConfig.llama3_8b())
        if llama_params is None:
            llama_params = init_decoder(llama_config, gen(3), dev)
        if mesh is not None:
            check_mesh_model(llama_config, mesh)
            # the weights on every coordinate once; each engine takes its
            # slice's shards
            llama_params = shard_params(llama_params, mesh, decoder_rules(llama_config))
    if remote is not None:
        provider = remote
    elif gcfg.use_paged_decode:
        serve = settings.serve
        if gcfg.prefix_cache:
            # spares the first /chat its cold prefill of the template head,
            # as the JAX container warms each replica's tree
            warm_head = prompts.static_head("retrieve", instruction=prompts.load("profile"))
        tier = dict(
            tenant_weights=serve.parsed_tenant_weights(),
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
        mode = replica_mode(serve)
        if mode != "thread" and mesh is not None:
            logger.warning("REPLICA_MODE=%s ignored: a device mesh is configured (MESH_* > 1) "
                           "and mesh-sliced worker replicas are not wired yet; using thread "
                           "mode", mode)
            mode = "thread"
        if mode == "thread":
            services = []
            n_replicas = max(serve.replicas, 1)
            slices = replica_slices(mesh, llama_params, n_replicas)
            for i in range(n_replicas):
                engine = ContinuousBatchingEngine(
                    model_config=llama_config, params=slices[i][1], rng_seed=seed, device=dev,
                    draft_params=draft_params, draft_config=draft_config,
                    tokenizer=tokenizer, mesh=slices[i][0], **engine_settings(gcfg))
                if warm_head:
                    engine.warm_prefix(warm_head)
                services.append(PagedGenerationService(engine, replica_id=i,
                                                       **service_settings(serve)))
            replicas = ReplicaSet(services, **tier)
            if serve.autoscale:
                start_autoscaler(replicas, serve, launcher=None)
        else:
            replicas = _worker_tier(settings, mode, llama_config, llama_params, draft_params,
                                    draft_config, seed, dev, warm_head, tier, tokenizer)
        # the escape hatch, as JAX's container builds it beside the tier: a
        # contiguous engine on the same weights, whose cache is allocated
        # per call (no memory until a chat falls back to it)
        contiguous = GeneratorEngine(config=gcfg, model_config=llama_config,
                                     params=llama_params, rng_seed=seed, device=dev,
                                     tokenizer=tokenizer, mesh=mesh)
        provider = EngineProvider(contiguous=contiguous, service=replicas)
    else:
        engine = GeneratorEngine(config=gcfg, model_config=llama_config, params=llama_params,
                                 rng_seed=seed, device=dev, tokenizer=tokenizer, mesh=mesh)
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
                        speculative_info=spec_info, ingestor=ingestor,
                        replica_mode="thread" if mesh is not None else replica_mode(settings.serve),
                        web_cache_index=web_cache, mesh=mesh)


def replica_slices(mesh: Optional[Mesh], params, n: int) -> list:
    """``(mesh, params)`` of each of ``n`` replicas: off a mesh the shared
    weights; on one, :func:`split_mesh_dp`'s dp slices with their shards
    when they divide, else the whole mesh for every replica (their work
    serializes on the devices), with JAX's warning."""
    if mesh is None:
        return [(None, params)] * n
    if n > 1:
        try:
            parts = params.split(n)
            logger.info("replicas mapped onto %d dp-axis mesh slices", n)
            return [(part.mesh, part) for part in parts]
        except MeshError as exc:
            logger.warning("REPLICAS=%d cannot slice the dp axis (%s); replicas will share "
                           "the whole mesh", n, exc)
    return [(mesh, params)] * n


def engine_settings(gcfg) -> dict:
    """The paged engine's arguments from the generator settings, as the JAX
    container hands them to its engines."""
    return dict(max_slots=gcfg.max_batch_size, page_size=gcfg.kv_page_size,
                max_pages_per_seq=gcfg.kv_max_pages_per_seq,
                steps_per_tick=gcfg.decode_steps_per_tick,
                max_tick_steps=gcfg.decode_max_tick_steps, kv_quant=gcfg.kv_quant,
                prefix_cache=gcfg.prefix_cache, pipeline_depth=gcfg.decode_pipeline_depth,
                prefill_chunk=gcfg.prefill_chunk or None, spec_k=gcfg.speculative_k)


def service_settings(serve) -> dict:
    """A replica service's arguments from the serve settings."""
    return dict(max_queue=serve.admission_max_queue or None,
                default_deadline_s=(serve.default_deadline_ms / 1e3
                                    if serve.default_deadline_ms > 0 else None),
                retry_budget=serve.crash_retry_budget,
                tick_stall_budget_s=serve.tick_stall_budget_s,
                warmup_budget_s=serve.warmup_budget_s)


def worker_spec(settings: Settings, model_config: LlamaConfig, replica_id: int, seed: int = 0,
                device="cuda", warm_head: str = "", params: Optional[dict] = None,
                draft_params: Optional[dict] = None,
                draft_config: Optional[LlamaConfig] = None, auth_token: str = "",
                socket: bool = False, tokenizer_path: str = ""):
    """One worker's :class:`~sentio_tpu_torch.runtime.worker.WorkerSpec`
    under ``settings`` — JAX's ``make_spec``: the engine and service
    arguments the thread tier gives its replicas, the template head, and
    the weights: ``params`` (tensors, shared through the spawn arguments),
    else the worker makes them from ``seed`` as ``build_pipeline`` does,
    and the checkpoint's tokenizer directory, if any. A socket worker gets
    the token, the frame bounds and reconnection."""
    import dataclasses

    from sentio_tpu_torch.runtime.worker import WorkerSpec

    serve, gcfg = settings.serve, settings.generator
    kwargs = dict(
        model_family=family(model_config), model_config=dataclasses.asdict(model_config),
        rng_seed=seed, device=str(device),
        engine_kwargs=engine_settings(gcfg),
        service_kwargs={**service_settings(serve), "replica_id": replica_id},
        warm_prefix_text=warm_head, params=params, tokenizer_path=tokenizer_path)
    if draft_params is not None:
        kwargs.update(draft_params=draft_params,
                      draft_config=dataclasses.asdict(draft_config))
    transport = {} if not socket else dict(
        auth_token=auth_token, reconnect=True, max_frame_bytes=serve.socket_frame_max_bytes,
        frame_timeout_s=serve.socket_frame_timeout_s)
    return WorkerSpec(factory_kwargs=kwargs, telemetry_interval_s=serve.telemetry_interval_s,
                      **transport)


def start_autoscaler(replicas: ReplicaSet, serve, launcher=None):
    """The ``AUTOSCALE_*`` policy and loop over ``replicas``, started and
    attached to the set (which stops it first when it drains or closes)."""
    from sentio_tpu_torch.runtime.autoscaler import AutoscalePolicy, Autoscaler

    autoscaler = Autoscaler(
        replicas,
        AutoscalePolicy(min_replicas=serve.autoscale_min_replicas,
                        max_replicas=serve.autoscale_max_replicas,
                        window_s=serve.autoscale_window_s, out_busy=serve.autoscale_out_busy,
                        in_busy=serve.autoscale_in_busy,
                        out_backlog=serve.autoscale_out_backlog,
                        out_cooldown_s=serve.autoscale_out_cooldown_s,
                        in_cooldown_s=serve.autoscale_in_cooldown_s),
        launcher=launcher, poll_interval_s=serve.autoscale_poll_interval_s)
    replicas.autoscaler = autoscaler
    autoscaler.start()
    return autoscaler


def _worker_tier(settings: Settings, mode: str, llama_config: LlamaConfig, llama_params: dict,
                 draft_params: Optional[dict], draft_config: Optional[LlamaConfig], seed: int,
                 dev: torch.device, warm_head: str, tier: dict,
                 tokenizer=None) -> ReplicaSet:
    """The process or socket replica tier: a ``ProcessReplica`` per worker
    behind a ``ReplicaSet`` (JAX's ``dependencies.py`` branch). Spawned
    workers get the router's weight tensors; ``REPLICA_WORKERS`` (socket
    mode) dials workers serving elsewhere instead. The kernels are built
    before the first spawn, so the workers only load them. A failed spawn
    reaps the workers already running and closes the registry. One spec
    recipe serves the start, the elastic joins and the autoscaler's
    launcher; a socket set always takes joins (the membership source),
    whatever ``AUTOSCALE`` says. A checkpoint's ``tokenizer`` is the
    router's (it encodes the routing head) and each worker loads the same
    directory."""
    import secrets

    from sentio_tpu_torch.models.tokenizer import ByteTokenizer
    from sentio_tpu_torch.runtime.replica import WorkerRegistry
    from sentio_tpu_torch.runtime.worker import ProcessReplica

    serve = settings.serve
    n_replicas = max(serve.replicas, 1)
    registry = None
    addrs: list = []
    token = ""
    if mode == "socket":
        addrs = serve.parsed_replica_workers()
        if addrs:  # check_replica_settings made sure of the token
            n_replicas = len(addrs)
        token = serve.socket_auth_token or secrets.token_hex(16)
        registry = WorkerRegistry(token, slots=n_replicas, bind_host=serve.socket_bind_host,
                                  bind_port=serve.socket_bind_port,
                                  max_frame_bytes=serve.socket_frame_max_bytes,
                                  frame_timeout_s=serve.socket_frame_timeout_s)
    services: list = []
    try:
        if dev.type == "cuda":
            from sentio_tpu_torch.kernels import KERNELS
            from sentio_tpu_torch.kernels._build import build_all

            build_all(KERNELS)
        tokenizer_path = settings.generator.tokenizer_path if tokenizer is not None else ""
        tokenizer = tokenizer or ByteTokenizer(llama_config.vocab_size)

        def make_spec(i: int):
            return worker_spec(settings, llama_config, i, seed=seed, device=dev,
                               warm_head=warm_head, params=llama_params,
                               draft_params=draft_params, draft_config=draft_config,
                               auth_token=token, socket=mode == "socket",
                               tokenizer_path=tokenizer_path)

        socket_kwargs = dict(transport_mode="socket", registry=registry,
                             partition_timeout_s=serve.socket_partition_timeout_s,
                             heal_grace_s=serve.socket_heal_grace_s)
        for i in range(n_replicas):
            transport = {} if mode != "socket" else dict(
                socket_kwargs, connect_addr=addrs[i] if addrs else None)
            services.append(ProcessReplica(make_spec(i), tokenizer, replica_id=i, **transport))
        logger.info("%s-mode replica tier: %d workers (pids %s%s)", mode, n_replicas,
                    [svc.pid for svc in services],
                    f", registry {registry.address}" if registry is not None else "")
        replicas = ReplicaSet(services, registry=registry, **tier)
    except BaseException:
        for svc in services:
            try:
                svc.close(join_timeout_s=5.0)
            except Exception:  # noqa: BLE001 — reaping is best-effort
                logger.warning("replica %d cleanup failed", svc.replica_id, exc_info=True)
        if registry is not None:
            registry.close()
        raise
    launcher = None
    if registry is not None:

        def join_elastic() -> list:
            """The registry's joins, each wrapped, then warmed (every graph
            captured and the head warm before it takes traffic), on the
            set's ``replica-join`` thread, never the supervisor's; one that
            fails to come up is closed and its slot released."""
            joined = []
            for slot in sorted(registry.drain_joins()):
                svc = None
                try:
                    svc = ProcessReplica(make_spec(slot), tokenizer, replica_id=slot,
                                         adopt_registration=True, **socket_kwargs)
                    svc.warmup()
                except Exception:  # noqa: BLE001 — one joiner that failed, not the poll
                    logger.exception("elastic worker for slot %d did not come up", slot)
                    if svc is not None:
                        svc.close()
                    registry.release_slot(slot)
                    continue
                joined.append((slot, svc))
            return joined

        replicas.set_membership_source(join_elastic, release_slot=registry.release_slot)
        from sentio_tpu_torch.runtime.autoscaler import socket_worker_launcher

        launcher = socket_worker_launcher(registry.address, make_spec(-1))
    if serve.autoscale:
        start_autoscaler(replicas, serve, launcher=launcher)
    return replicas
