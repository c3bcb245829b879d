"""The eval matrix — ``sentio_tpu/eval/runner.py`` over the port: the five
BASELINE.md configurations over the seeded bundle and the measured
reference-architecture baseline, as one payload (the keys of JAX's
``EVAL.json``).

1. ``sparse_api``    — BM25 retrieval + the LLM over a real loopback HTTP
                       hop (:class:`~sentio_tpu_torch.ops.generator.
                       OpenAIProvider` against :class:`~.baseline.
                       MockModelServer`);
2. ``dense``         — the bi-encoder embeds on the card (the flash kernel
                       in each layer) → exact top-k over the index;
3. ``hybrid_rerank`` — dense + BM25 fused by rrf, then the cross-encoder;
4. ``full_paged``    — the whole pipeline (retrieve → rerank → select →
                       generate → verify) on the paged engine behind the
                       generation service and a one-replica replica tier,
                       as JAX routes it, one caller at a time;
5. ``batched``       — the same, ``concurrency`` callers sharing the decode
                       batch.

Run with ``python -m sentio_tpu_torch eval``.
"""

from __future__ import annotations

import sys
import time
import uuid
from typing import Callable, Optional

from sentio_tpu_torch.eval.dataset import EvalBundle, build_bundle
from sentio_tpu_torch.eval.harness import run_queries

CONFIGS = ("sparse_api", "dense", "hybrid_rerank", "full_paged", "batched")


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _build_models(scale: str):
    from sentio_tpu_torch.models.llama import LlamaConfig
    from sentio_tpu_torch.models.transformer import EncoderConfig

    if scale == "tiny":
        return EncoderConfig.tiny(), LlamaConfig.tiny()
    # "bench": the mini models bench.py serves (dims multiples of 128, bf16)
    enc = EncoderConfig(vocab_size=512, dim=512, n_layers=8, n_heads=8, mlp_dim=2048,
                        max_len=512)
    llm = LlamaConfig(vocab_size=512, dim=512, n_layers=12, n_heads=8, n_kv_heads=4,
                      mlp_dim=1536, max_len=2048, rope_theta=500_000.0)
    return enc, llm


def platform_info(dev) -> dict:
    """The payload's ``platform``: the CUDA device's name and count with
    backend ``gpu``, or the CPU."""
    import torch

    if dev.type == "cuda":
        return {"devices": torch.cuda.device_count(), "kind": torch.cuda.get_device_name(dev),
                "backend": "gpu"}
    return {"devices": 1, "kind": "cpu", "backend": dev.type}


def await_verdict(query_id: str, timeout_s: float = 60.0) -> Optional[str]:
    """Poll the flight record for a detached verify's verdict
    (``VERIFY_MODE=async|gated`` return before the audit lands)."""
    from sentio_tpu_torch.infra.flight import get_flight_recorder

    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        outcome = (get_flight_recorder().get(query_id) or {}).get("verify", {}).get("outcome")
        if outcome is not None:
            return outcome
        time.sleep(0.05)
    return None


def run_eval(scale: str = "bench", n_docs: int = 1024, n_queries: int = 64,
             concurrency: int = 8, new_tokens: int = 48, verifier_tokens: int = 64,
             rtt_ms: float = 0.0, seed: int = 0, skip_baseline: bool = False,
             configs: Optional[set] = None, encoder_checkpoint: str = "",
             kv_quant: str = "none", verify_mode: str = "sync",
             verify_threshold: Optional[float] = None, device=None,
             on_config: Optional[Callable[[str, bool], None]] = None) -> dict:
    """Run the eval matrix on ``device`` (the card by default); returns the
    payload. ``on_config(name, starting)`` is called just before and just
    after each configuration's queries (its warmup query included), for
    instrumentation such as per-configuration kernel launch counts."""
    import torch

    from sentio_tpu_torch import resolve_device
    from sentio_tpu_torch.config import EmbedderConfig, RerankConfig, Settings
    from sentio_tpu_torch.models.llama import init_llama
    from sentio_tpu_torch.ops.bm25 import BM25Index
    from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
    from sentio_tpu_torch.ops.embedder import TorchEmbedder
    from sentio_tpu_torch.ops.generator import EngineProvider, LLMGenerator, OpenAIProvider
    from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
    from sentio_tpu_torch.ops.retrievers import DenseRetriever, HybridRetriever, SparseRetriever
    from sentio_tpu_torch.ops.verifier import AnswerVerifier
    from sentio_tpu_torch.pipeline import ChatPipeline, check_verify_mode, wait_detached
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
    from sentio_tpu_torch.runtime.replica import ReplicaSet
    from sentio_tpu_torch.runtime.service import PagedGenerationService

    t_start = time.perf_counter()
    want = set(configs) if configs else set(CONFIGS)
    unknown = want - set(CONFIGS)
    if unknown:
        raise ValueError(f"unknown eval configs {sorted(unknown)}; known: {sorted(CONFIGS)}")
    check_verify_mode(verify_mode)
    dev = resolve_device(device)
    enc_cfg, llm_cfg = _build_models(scale)
    platform = platform_info(dev)
    _log(f"eval: {platform['devices']} x {platform['backend']} ({platform['kind']}); "
         f"scale={scale} docs={n_docs} queries={n_queries} concurrency={concurrency}")

    def gen(offset: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(seed + offset)
        return g

    def timed(name: str, label: str, fn, **kwargs) -> dict:
        if on_config is not None:
            on_config(name, True)
        try:
            return run_queries(label, fn, queries, **kwargs)
        finally:
            if on_config is not None:
                on_config(name, False)

    bundle: EvalBundle = build_bundle(n_docs=n_docs, n_queries=n_queries, seed=seed)
    queries = bundle.queries

    settings = Settings()
    g = settings.generator
    g.max_new_tokens = new_tokens
    # the verify gate runs gated against sync over the same bundle and
    # weights and compares per-query verdicts
    g.verify_mode = verify_mode
    if verify_threshold is not None:
        g.verify_confidence_threshold = verify_threshold
    # random weights never emit EOS: cap the verdict's budget
    g.verifier_max_tokens = verifier_tokens
    # the byte tokenizer makes ~1 token a character while the selector
    # budgets 4 characters a token: size the documents so the assembled
    # prompt fits the model's window with room to generate
    g.context_token_budget = max((llm_cfg.max_len - new_tokens - 256) // 4, 32)
    settings.retrieval.top_k = 10
    # recall@10 over 10 documents end to end (rerank keeps 5 by default)
    settings.rerank.top_k = 10

    needs_dense = bool(want & {"dense", "hybrid_rerank", "full_paged", "batched"})
    needs_sparse = bool(want & {"sparse_api", "hybrid_rerank", "full_paged", "batched"})
    rows: list[dict] = []
    extras: dict = {}

    embedder = dense_index = None
    if needs_dense:
        # a trained checkpoint's config applies to the embedder only; the
        # cross-encoder and the mock API keep the scale's
        emb_params, emb_cfg = None, enc_cfg
        if encoder_checkpoint:
            from sentio_tpu_torch.runtime.weights import load_model

            emb_params, emb_cfg = load_model(encoder_checkpoint, expect_family="encoder",
                                             setting="--encoder-checkpoint", device=dev)
            extras["encoder_checkpoint"] = encoder_checkpoint
        _log("eval: embedding corpus on device ...")
        embedder = TorchEmbedder(EmbedderConfig(batch_size=128), params=emb_params,
                                 model_config=emb_cfg, device=dev, generator=gen(1))
        t0 = time.perf_counter()
        vecs = embedder.embed_many([d.text for d in bundle.documents])
        ingest_s = time.perf_counter() - t0
        _log(f"eval: embedded {n_docs} docs in {ingest_s:.1f}s "
             f"({n_docs / max(ingest_s, 1e-9):.0f} docs/s)")
        dense_index = TorchDenseIndex(emb_cfg.dim, device=dev)
        dense_index.add(bundle.documents, vecs)
        extras["ingest_docs_per_s"] = round(n_docs / max(ingest_s, 1e-9), 1)
    bm25 = BM25Index().build(bundle.documents) if needs_sparse else None

    service = None
    try:
        if "sparse_api" in want:
            from sentio_tpu_torch.eval.baseline import MockModelServer

            server = MockModelServer(dim=enc_cfg.dim, rtt_ms=rtt_ms).start()
            provider = OpenAIProvider(base_url=server.base_url + "/v1")
            try:
                sparse = SparseRetriever(bm25)
                api_gen = LLMGenerator(provider=provider, config=settings.generator)

                def cfg1(question: str):
                    docs = sparse.retrieve(question, top_k=10)
                    return docs, api_gen.generate(question, docs, mode="fast")

                _log("eval: [1/5] sparse_api ...")
                rows.append(timed("sparse_api", "1-bm25+api-llm", cfg1).row())
            finally:
                provider.close()
                server.stop()

        if "dense" in want:
            dense_ret = DenseRetriever(embedder, dense_index)

            def cfg2(question: str):
                return dense_ret.retrieve(question, top_k=10), ""

            _log("eval: [2/5] dense ...")
            rows.append(timed("dense", "2-dense-tpu", cfg2).row())

        hybrid = reranker = None
        if want & {"hybrid_rerank", "full_paged", "batched"}:
            hybrid = HybridRetriever(retrievers=[DenseRetriever(embedder, dense_index),
                                                 SparseRetriever(bm25)],
                                     config=settings.retrieval)
            reranker = CrossEncoderReranker(RerankConfig(batch_size=32), model_config=enc_cfg,
                                            device=dev, generator=gen(2))
        if "hybrid_rerank" in want:
            def cfg3(question: str):
                docs = hybrid.retrieve(question, top_k=10)
                return reranker.rerank(question, docs, top_k=10).documents, ""

            _log("eval: [3/5] hybrid_rerank ...")
            rows.append(timed("hybrid_rerank", "3-hybrid+rerank", cfg3).row())

        if want & {"full_paged", "batched"}:
            llm_params = init_llama(llm_cfg, gen(3), dev)
            paged = ContinuousBatchingEngine(
                model_config=llm_cfg, params=llm_params,
                max_slots=max(concurrency, 4), page_size=16,
                # a sequence's window is the model's context: prompts sized
                # by context_token_budget always fit
                max_pages_per_seq=llm_cfg.max_len // 16, steps_per_tick=16,
                max_tick_steps=64, pipeline_depth=2, kv_quant=kv_quant,
                # random weights emit EOS almost at once: fixed-length
                # answers pay the full decode and verify cost
                ignore_eos=True, rng_seed=seed, device=dev)
            # the serving tier's front end at one replica, as JAX measures
            # the routed path; no supervisor, as in JAX's eval
            service = ReplicaSet([PagedGenerationService(paged)], supervise=False)
            # the contiguous engine on the same weights behind the tier, as
            # JAX's eval builds it: the provider's escape hatch
            contiguous = GeneratorEngine(config=settings.generator, model_config=llm_cfg,
                                         params=llm_params, rng_seed=seed, device=dev)
            generator = LLMGenerator(provider=EngineProvider(contiguous=contiguous,
                                                             service=service),
                                     config=settings.generator)
            pipeline = ChatPipeline(embedder=embedder, index=dense_index, retriever=hybrid,
                                    generator=generator, bm25_index=bm25, reranker=reranker,
                                    verifier=AnswerVerifier(generator=generator,
                                                            config=settings.generator),
                                    settings=settings)
            # the quality gates' answer metric: a collapsed decode moves the
            # mean answer length even where recall cannot see it
            answer_chars: list[int] = []
            # each question's final verdict (a detached one read off the
            # flight record); the harness's warmup repeat overwrites
            verdicts: dict[str, str] = {}

            def full(question: str):
                query_id = f"eval-{uuid.uuid4().hex[:10]}"
                state = pipeline.run(question, mode="fast",
                                     metadata={"mode": "fast", "query_id": query_id})
                docs = state.get("reranked_documents") or state.get("retrieved_documents") or []
                answer = state.get("response", "") or ""
                answer_chars.append(len(answer))
                verdict = (state.get("evaluation") or {}).get("verdict")
                if verdict is None and state["metadata"].get("verify_pending"):
                    verdict = await_verdict(query_id)
                if verdict is not None:
                    verdicts[question] = str(verdict)
                return docs, answer

            if "full_paged" in want:
                _log("eval: [4/5] full_paged ...")
                res4 = timed("full_paged", "4-full-graph-paged", full)
                if answer_chars:
                    res4.extras["answer_chars_mean"] = round(
                        sum(answer_chars) / len(answer_chars), 1)
                if verdicts:
                    res4.extras["verdicts"] = dict(verdicts)
                    skipped = sum(1 for v in verdicts.values() if v == "skipped_confident")
                    res4.extras["verify_skip_rate"] = round(skipped / len(verdicts), 4)
                rows.append(res4.row())
            if "batched" in want:
                _log(f"eval: [5/5] batched x{concurrency} ...")
                before = service.stats()  # the replicas' lifetime stats
                answer_chars.clear()
                result = timed("batched", "5-batched-dp", full, concurrent=concurrency)
                if answer_chars:
                    result.extras["answer_chars_mean"] = round(
                        sum(answer_chars) / len(answer_chars), 1)
                stats = service.stats()
                ticks = stats["ticks"] - before["ticks"]
                active = (stats["avg_active_slots"] * stats["ticks"]
                          - before["avg_active_slots"] * before["ticks"])
                result.extras["avg_active_slots"] = round(active / max(ticks, 1), 3)
                result.extras["max_active_slots"] = stats["max_active_slots"]
                result.extras["decode_ticks"] = ticks
                rows.append(result.row())

        baseline_row = None
        if not skip_baseline:
            from sentio_tpu_torch.eval.baseline import measure_baseline

            _log("eval: measuring reference-architecture loopback baseline ...")
            baseline_row = measure_baseline(bundle.documents, queries,
                                            dim=min(enc_cfg.dim, 1024), rtt_ms=rtt_ms).row()
    finally:
        if service is not None:
            # detached verify threads hold tickets on this service
            if not wait_detached():
                _log("eval: detached verifies still running at close")
            service.close()
        if embedder is not None:
            embedder.close()

    payload: dict = {
        "metric": "synthetic NQ-style retrieval-QA: recall@10, p50 ms, QPS",
        "bundle": {"n_docs": n_docs, "n_queries": n_queries, "seed": seed,
                   "n_facts": bundle.n_facts},
        "platform": platform,
        "models": {
            "encoder": {"dim": enc_cfg.dim, "layers": enc_cfg.n_layers},
            "llm": {"dim": llm_cfg.dim, "layers": llm_cfg.n_layers,
                    "vocab": llm_cfg.vocab_size},
            "new_tokens": new_tokens,
        },
        "rows": rows,
        "baseline": baseline_row,
        "rtt_ms": rtt_ms,
        "wall_s": round(time.perf_counter() - t_start, 1),
        **({"kv_quant": kv_quant} if kv_quant != "none" else {}),
        **({"verify_mode": verify_mode} if verify_mode != "sync" else {}),
        **extras,
    }
    # the north star: the full pipeline's p50 against the measured baseline's
    full_row = next((r for r in rows if r["config"].startswith("4-")), None)
    if full_row and baseline_row:
        payload["north_star"] = {
            "target_speedup": 10.0,
            "measured_p50_speedup": round(
                baseline_row["p50_ms"] / max(full_row["p50_ms"], 1e-9), 2),
            "recall_delta": round(full_row["recall@10"] - baseline_row["recall@10"], 3),
        }
    return payload
