"""Request handlers: chat (with the degradation ladder) and health — the
counterpart of ``sentio_tpu/serve/handlers.py`` over the port's
``ChatPipeline``.

:meth:`ChatHandler.process_chat_request_sync` runs the pipeline's stages
(:meth:`~sentio_tpu_torch.pipeline.ChatPipeline.run`) and returns JAX's
wire shape — ``answer``, cited ``sources`` and ``metadata`` with the graph
nodes' keys, ``query_id``, ``latency_ms``, ``degraded`` and the verdict
under ``evaluation`` — fills the query cache and the disk cache, and on a
failure walks the ladder: query cache → disk cache → template → apology,
so ``/chat`` never answers 500 for a pipeline fault. Errors marked
``soft_fail_exempt`` (shed, expired, service down) raise and become typed
429/503/504 responses. :meth:`ChatHandler.stream_chat_sync` is the SSE
path over the same retrieve → rerank → select stages
(:meth:`~sentio_tpu_torch.pipeline.ChatPipeline.context`): ``sources``,
``token`` increments and the verdict — ``verdict``, or under
``VERIFY_MODE=async|gated`` a ``done`` as soon as the answer is complete
and a trailing ``verify`` — or a typed ``error`` event for shed or
expired work. Both open and close the request's flight record, which
``GET /debug/flight/{id}`` serves.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Iterator, Optional

from sentio_tpu_torch.infra.caching import CacheManager
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.ops.confidence import confidence_score
from sentio_tpu_torch.pipeline import (
    ChatPipeline,
    best_documents,
    confidence_skip_evaluation,
    record_verify,
    serialize_sources,
)

logger = logging.getLogger(__name__)

__all__ = ["ChatHandler", "HealthHandler"]


class ChatHandler:
    """Pipeline-invoking chat processor with soft-fail semantics.
    ``fallback`` is the ladder's ``(FallbackResponseCache, LLMFallback)``
    pair, built on first use when not given."""

    def __init__(self, pipeline: ChatPipeline, cache_manager: Optional[CacheManager] = None,
                 fallback: Optional[tuple] = None) -> None:
        self.pipeline = pipeline
        self.settings = pipeline.settings
        self.cache_manager = cache_manager or CacheManager(self.settings.cache)
        self._fallback = fallback

    @property
    def fallback(self):
        if self._fallback is None:
            from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback

            self._fallback = (FallbackResponseCache(), LLMFallback())
        return self._fallback

    def process_chat_request_sync(self, question: str, top_k: Optional[int] = None,
                                  temperature: Optional[float] = None, mode: str = "balanced",
                                  thread_id: Optional[str] = None,
                                  deadline_ts: Optional[float] = None) -> dict[str, Any]:
        t0 = time.perf_counter()
        query_id = thread_id or uuid.uuid4().hex[:12]
        metadata: dict[str, Any] = {"query_id": query_id, "mode": mode,
                                    "graph_config": {"thread_id": query_id}}
        if top_k is not None:
            metadata["user_top_k"] = top_k
        if temperature is not None:
            metadata["temperature"] = temperature
        # the flight record opens here; the pipeline and a detached verify
        # add to it under the same id
        recorder = get_flight_recorder()
        recorder.start_request(
            query_id, endpoint="/chat", mode=mode, question_chars=len(question),
            **({"deadline_ms": round((deadline_ts - t0) * 1e3, 1)}
               if deadline_ts is not None else {}))
        try:
            state = self.pipeline.run(question, top_k=top_k, temperature=temperature,
                                      mode=mode, metadata=metadata, deadline_ts=deadline_ts)
            get_metrics().record_retrieval(self.settings.retrieval.strategy,
                                           state["metadata"]["node_timings_ms"]["retrieve"]
                                           / 1e3)
            answer = state.get("response", "")
            if not answer:
                raise RuntimeError("pipeline produced an empty response")
            result = {
                "answer": answer,
                "sources": serialize_sources(best_documents(state)),
                "metadata": {
                    **state["metadata"],
                    "query_id": query_id,
                    "latency_ms": round((time.perf_counter() - t0) * 1000.0, 1),
                    "degraded": False,
                },
            }
            if state.get("evaluation"):
                result["metadata"]["evaluation"] = state["evaluation"]
            # under VERIFY_MODE=async|gated the live answer carries
            # verify_pending (the verdict comes at /debug/flight/{query_id});
            # a cached replay has no verify behind it, so its copy drops it
            self.cache_manager.set_query_response(question, {
                **result, "metadata": {k: v for k, v in result["metadata"].items()
                                       if k != "verify_pending"}})
            disk_cache, _ = self.fallback
            disk_cache.put(question, answer)
            recorder.finish_request(query_id, status="done",
                                    latency_ms=result["metadata"]["latency_ms"])
            return result
        except Exception as exc:  # noqa: BLE001 — ladder, never a 500
            latency_ms = round((time.perf_counter() - t0) * 1000.0, 1)
            if getattr(exc, "soft_fail_exempt", False):
                recorder.finish_request(query_id, status="shed", error=str(exc),
                                        latency_ms=latency_ms)
                raise  # typed shed / deadline errors: 429/503/504 + Retry-After
            logger.warning("chat pipeline failed (%s); degrading", exc)
            recorder.finish_request(query_id, status="degraded", error=str(exc),
                                    latency_ms=latency_ms)
            return self._degraded_response(question, query_id, str(exc), t0)

    def _degraded_response(self, question: str, query_id: str, error: str,
                           t0: float) -> dict[str, Any]:
        """cached → disk → template → apology."""
        meta = {
            "query_id": query_id,
            "degraded": True,
            "error": error,
            "latency_ms": round((time.perf_counter() - t0) * 1000.0, 1),
        }
        cached = self.cache_manager.get_query_response(question)
        if cached and cached.get("answer"):
            return {**cached, "metadata": {**cached.get("metadata", {}), **meta,
                                           "tier": "query_cache"}}
        disk_cache, llm_fallback = self.fallback
        disk_hit = disk_cache.get(question)
        if disk_hit:
            return {"answer": disk_hit, "sources": [], "metadata": {**meta, "tier": "disk_cache"}}
        template = llm_fallback.no_llm(question)
        if template:
            return {"answer": template, "sources": [], "metadata": {**meta, "tier": "template"}}
        return {"answer": llm_fallback.apology(), "sources": [],
                "metadata": {**meta, "tier": "apology"}}

    def stream_chat_sync(self, question: str, top_k: Optional[int] = None,
                         temperature: Optional[float] = None, mode: str = "balanced",
                         deadline_ts: Optional[float] = None,
                         request_id: Optional[str] = None) -> Iterator[tuple[str, Any]]:
        """Typed events for SSE over the same stages as ``/chat``:
        ``("sources", [...])`` once, ``("token", str)`` per increment, then
        by ``VERIFY_MODE``: ``sync`` — ``("verdict", {...})``; ``gated``
        with a confident answer — ``("verdict", skipped_confident)`` and no
        audit; ``async`` or ``gated`` below the threshold — ``("done",
        "")`` as soon as the answer is complete (its flight record closes
        then), the audit, and a trailing ``("verify", {...})``, which a
        failure around the audit degrades to a ``warn`` verdict and never
        to the ladder. A reranker that failed (the retrieval order kept)
        adds ``("rerank_fallback", True)`` after ``sources``. A shed or
        expired request ends with ``("error", {...})``; a failed retrieval
        and any other failure before the answer degrade to the ladder's
        text as one ``token``. ``request_id`` names the stream's flight
        record. Closing the generator (a client that went away) cancels
        the decode."""
        pipeline, settings = self.pipeline, self.settings
        recorder = get_flight_recorder()
        t0 = time.perf_counter()
        if request_id:
            recorder.start_request(
                request_id, endpoint="/chat?stream", mode=mode, question_chars=len(question),
                **({"deadline_ms": round((deadline_ts - t0) * 1e3, 1)}
                   if deadline_ts is not None else {}))
        timings: dict[str, float] = {}
        # set once the answer's record is finished (async / gated close it
        # at [DONE]); later failures must not re-finish it
        record_closed = False

        def finish(status: str, **fields) -> None:
            if request_id:
                recorder.add_node_timings(request_id, timings)
                recorder.finish_request(
                    request_id, status=status,
                    latency_ms=round((time.perf_counter() - t0) * 1e3, 1), **fields)

        try:
            meta: dict[str, Any] = {}
            selected = pipeline.context(question, top_k or settings.retrieval.top_k,
                                        settings.rerank.top_k, meta)["selected_documents"]
            timings.update({k: v for k, v in meta["node_timings_ms"].items()
                            if k in ("retrieve", "rerank")})
            if "retrieval_error" in meta:
                raise RuntimeError(meta["retrieval_error"])
            yield ("sources", [{"id": d.id, "source": d.metadata.get("source", d.id),
                                "score": d.score()} for d in selected])
            if meta.get("rerank_fallback"):
                yield ("rerank_fallback", True)
            chunks: list[str] = []
            gen_stats: dict = {}
            t = time.perf_counter()
            for piece in pipeline.generator.stream(question, selected, mode=mode,
                                                   temperature=temperature,
                                                   deadline_ts=deadline_ts, stats=gen_stats):
                chunks.append(piece)
                yield ("token", piece)
            timings["generate"] = round((time.perf_counter() - t) * 1e3, 3)
            answer = "".join(chunks)
            # skip the optional audit once the caller's budget is spent
            deadline_ok = deadline_ts is None or time.perf_counter() < deadline_ts
            verifier = pipeline.verifier
            verify_mode = settings.generator.verify_mode
            if verifier is not None and answer and deadline_ok:
                conf = None
                if verify_mode == "gated":
                    conf = confidence_score(gen_stats.get("logprob_mean"),
                                            gen_stats.get("logprob_min"), selected)
                if conf is not None and conf >= settings.generator.verify_confidence_threshold:
                    record_verify(request_id, "gated", "skipped_confident", confidence=conf,
                                  skipped="confident")
                    yield ("verdict", confidence_skip_evaluation(conf))
                elif verify_mode in ("async", "gated"):
                    yield ("done", "")
                    finish("done")
                    record_closed = True
                    try:
                        t = time.perf_counter()
                        result = verifier.verify(question, answer, selected,
                                                 deadline_ts=deadline_ts)
                        verdict_ms = round((time.perf_counter() - t) * 1e3, 3)
                        if request_id:
                            recorder.add_node_timings(request_id, {"verify": verdict_ms})
                        record_verify(request_id, verify_mode, result.verdict,
                                      confidence=conf, verdict_ms=verdict_ms)
                        trailing = result.to_dict()
                    except Exception as exc:  # noqa: BLE001 — the answer is delivered
                        logger.warning("trailing verify failed (%s)", exc)
                        trailing = {"verdict": "warn", "citations_ok": True,
                                    "notes": [f"verify failed: {exc}"]}
                    if conf is not None:
                        trailing["confidence"] = round(conf, 4)
                    yield ("verify", trailing)
                    return
                else:
                    t = time.perf_counter()
                    result = verifier.verify(question, answer, selected,
                                             deadline_ts=deadline_ts)
                    timings["verify"] = round((time.perf_counter() - t) * 1e3, 3)
                    record_verify(request_id, "sync", result.verdict,
                                  verdict_ms=timings["verify"])
                    yield ("verdict", result.to_dict())
            finish("done")
        except GeneratorExit:
            # a client that left after the answer was delivered keeps the
            # answer's 'done' record
            if not record_closed:
                finish("disconnected")
            raise
        except Exception as exc:  # noqa: BLE001 — ladder, never a raw error
            if record_closed:
                # the answer is delivered and its record closed: nothing
                # may follow [DONE]
                logger.warning("post-answer stream stage failed (%s)", exc)
                return
            if getattr(exc, "soft_fail_exempt", False):
                # the SSE status is already on the wire: a typed error
                # event, never an apology appended to real tokens
                finish("shed", error=str(exc))
                code = getattr(exc, "code", None)
                yield ("error", {
                    "code": getattr(code, "value", "OVERLOADED"),
                    "message": str(exc),
                    "retryable": bool(getattr(exc, "retryable", True)),
                })
                return
            logger.warning("stream pipeline failed (%s); degrading", exc)
            finish("degraded", error=str(exc))
            result = self._degraded_response(question, "stream", str(exc), time.perf_counter())
            yield ("token", result["answer"])


class HealthHandler:
    """basic / live / ready. Ready means the pipeline's warmup has run."""

    def __init__(self, pipeline: ChatPipeline) -> None:
        self.pipeline = pipeline
        self.started_at = time.perf_counter()

    def basic(self) -> dict[str, Any]:
        return {
            "status": "healthy",
            "service": "sentio-tpu",
            "uptime_s": round(time.perf_counter() - self.started_at, 1),
        }

    def live(self) -> dict[str, Any]:
        return {"status": "alive"}

    def ready(self) -> dict[str, Any]:
        ready = bool(self.pipeline.ready)
        return {"status": "ready" if ready else "initializing", "ready": ready}
