"""Configuration for the PyTorch port: the slice of ``sentio_tpu.config``
that the ``/chat`` main path, ingestion and the HTTP server read.

Same dataclasses, fields, defaults and environment variable names as the
JAX package's tree (chunking, retrieval, rerank, embedder, generator, the
serve section's HTTP surface, the generation service's overload controls
and the thread-mode replica tier, the cache section, and of auth the
switch, observability, and of the mesh section its dp / tp / sp sizes);
the socket tier's and the autoscaler's tuning fields and the rest of auth
and of the mesh are left out because nothing in this package reads them.
Settings the port cannot honour (``AUTH_ENABLED=1``,
``CACHE_BACKEND=multi_tier``, ``REPLICA_MODE=process|socket``, a non-empty
``REPLICA_WORKERS``, ``AUTOSCALE=1``, an ``INDEX_BACKEND`` other than
``tpu``, a mesh of more than one device) raise where they would be used.
Plain dataclasses, no import-time work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

__all__ = [
    "ChunkingConfig",
    "RetrievalConfig",
    "RerankConfig",
    "EmbedderConfig",
    "GeneratorConfig",
    "ServeConfig",
    "CacheConfig",
    "AuthConfig",
    "MeshConfig",
    "ObservabilityConfig",
    "Settings",
]


def _env_str(names: Sequence[str], default: str) -> str:
    for name in names:
        value = os.environ.get(name)
        if value is not None and value != "":
            return value
    return default


def _env_int(names: Sequence[str], default: int) -> int:
    raw = _env_str(names, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(names: Sequence[str], default: float) -> float:
    raw = _env_str(names, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_bool(names: Sequence[str], default: bool) -> bool:
    raw = _env_str(names, "").strip().lower()
    if not raw:
        return default
    return raw in ("1", "true", "yes", "on")


@dataclass
class ChunkingConfig:
    """Splitter settings."""

    strategy: str = "recursive"  # recursive | fixed | sentence
    chunk_size: int = 512
    chunk_overlap: int = 64

    @classmethod
    def from_env(cls) -> "ChunkingConfig":
        return cls(
            strategy=_env_str(["CHUNKING_STRATEGY"], "recursive"),
            chunk_size=_env_int(["CHUNK_SIZE"], 512),
            chunk_overlap=_env_int(["CHUNK_OVERLAP"], 64),
        )


@dataclass
class RetrievalConfig:
    """Retriever strategy + fusion knobs. This package implements the
    ``dense``, ``bm25`` and ``hybrid`` strategies with every fusion method
    and BM25 backend; ``use_scorers`` and ``web_cache_path`` are not ported
    (``build_pipeline`` raises when they are set), and the index backend is
    the in-process index. The other fields are kept so a settings tree reads
    the same in both packages."""

    strategy: str = "hybrid"  # dense | bm25 | hybrid
    top_k: int = 10
    rrf_k: int = 60
    fusion_method: str = "rrf"  # rrf | weighted_rrf | comb_sum
    dense_weight: float = 0.7
    sparse_weight: float = 0.3
    use_scorers: bool = False
    keyword_scorer_weight: float = 0.8
    recency_scorer_weight: float = 0.2
    mmr_scorer_weight: float = 0.5
    mmr_lambda: float = 0.7
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    bm25_backend: str = "auto"  # auto | numpy | native
    index_backend: str = "tpu"  # tpu | qdrant
    collection_name: str = "sentio"
    qdrant_url: str = "http://localhost:6333"
    qdrant_api_key: str = ""
    index_path: str = ""
    web_cache_path: str = ""

    @classmethod
    def from_env(cls) -> "RetrievalConfig":
        return cls(
            strategy=_env_str(["RETRIEVAL_STRATEGY", "RETRIEVER_TYPE"], "hybrid"),
            top_k=_env_int(["RETRIEVAL_TOP_K", "TOP_K"], 10),
            rrf_k=_env_int(["RRF_K"], 60),
            fusion_method=_env_str(["FUSION_METHOD", "HYBRID_FUSION"], "rrf"),
            dense_weight=_env_float(["DENSE_WEIGHT"], 0.7),
            sparse_weight=_env_float(["SPARSE_WEIGHT"], 0.3),
            use_scorers=_env_bool(["USE_SCORERS"], False),
            keyword_scorer_weight=_env_float(["KEYWORD_SCORER_WEIGHT"], 0.8),
            recency_scorer_weight=_env_float(["RECENCY_SCORER_WEIGHT"], 0.2),
            mmr_scorer_weight=_env_float(["MMR_SCORER_WEIGHT"], 0.5),
            mmr_lambda=_env_float(["MMR_LAMBDA"], 0.7),
            bm25_k1=_env_float(["BM25_K1"], 1.5),
            bm25_b=_env_float(["BM25_B"], 0.75),
            bm25_backend=_env_str(["BM25_BACKEND"], "auto"),
            index_backend=_env_str(["INDEX_BACKEND", "VECTOR_STORE"], "tpu"),
            collection_name=_env_str(["COLLECTION_NAME", "QDRANT_COLLECTION"], "sentio"),
            qdrant_url=_env_str(["QDRANT_URL"], "http://localhost:6333"),
            qdrant_api_key=_env_str(["QDRANT_API_KEY"], ""),
            index_path=_env_str(["INDEX_PATH"], ""),
            web_cache_path=_env_str(["WEB_CACHE_PATH", "CACHE_COLLECTION_PATH"], ""),
        )


@dataclass
class RerankConfig:
    """Reranker selection."""

    enabled: bool = True
    kind: str = "cross_encoder"  # cross_encoder | passthrough
    top_k: int = 5
    max_pair_tokens: int = 512
    batch_size: int = 32
    checkpoint_path: str = ""
    tokenizer_path: str = ""

    @classmethod
    def from_env(cls) -> "RerankConfig":
        return cls(
            enabled=_env_bool(["USE_RERANKER"], True),
            kind=_env_str(["RERANKER_KIND", "RERANKER_TYPE"], "cross_encoder"),
            top_k=_env_int(["RERANK_TOP_K"], 5),
            max_pair_tokens=_env_int(["RERANK_MAX_PAIR_TOKENS"], 512),
            batch_size=_env_int(["RERANK_BATCH_SIZE"], 32),
            checkpoint_path=_env_str(["RERANKER_CHECKPOINT"], ""),
            tokenizer_path=_env_str(["RERANKER_TOKENIZER"], ""),
        )


@dataclass
class EmbedderConfig:
    """Bi-encoder settings (``provider='tpu'`` names the in-process model,
    which in this package runs on the GPU)."""

    provider: str = "tpu"  # tpu | hash
    dim: int = 1024
    max_tokens: int = 512
    batch_size: int = 128
    cache_size: int = 10_000
    cache_ttl_s: float = 3600.0
    model_preset: str = "base"  # tiny | base
    checkpoint_path: str = ""
    tokenizer_path: str = ""
    coalesce: bool = True
    coalesce_deadline_ms: float = 5.0
    coalesce_max: int = 16

    @classmethod
    def from_env(cls) -> "EmbedderConfig":
        return cls(
            provider=_env_str(["EMBEDDER_PROVIDER", "EMBEDDING_PROVIDER"], "tpu"),
            dim=_env_int(["EMBEDDING_DIM"], 1024),
            max_tokens=_env_int(["EMBED_MAX_TOKENS"], 512),
            batch_size=_env_int(["EMBED_BATCH_SIZE"], 128),
            cache_size=_env_int(["EMBEDDING_CACHE_SIZE"], 10_000),
            cache_ttl_s=_env_float(["EMBEDDING_CACHE_TTL"], 3600.0),
            model_preset=_env_str(["EMBEDDER_PRESET"], "base"),
            checkpoint_path=_env_str(["EMBEDDER_CHECKPOINT"], ""),
            tokenizer_path=_env_str(["EMBEDDER_TOKENIZER"], ""),
            coalesce=_env_bool(["EMBED_COALESCE"], True),
            coalesce_deadline_ms=_env_float(["EMBED_COALESCE_DEADLINE_MS"], 5.0),
            coalesce_max=_env_int(["EMBED_COALESCE_MAX"], 16),
        )


@dataclass
class GeneratorConfig:
    """Generator/verifier settings."""

    provider: str = "tpu"
    model_preset: str = "llama3-8b"  # llama3-8b | tiny
    checkpoint_path: str = ""
    tokenizer_path: str = ""
    draft_checkpoint_path: str = ""
    speculative_k: int = 4
    api_base: str = ""
    api_key: str = ""
    api_model: str = "default"
    api_timeout_s: float = 60.0
    mode: str = "balanced"  # fast | balanced | quality | creative
    max_new_tokens: int = 1024
    context_token_budget: int = 2000
    max_prompt_tokens: int = 4096
    use_verifier: bool = True
    verifier_max_tokens: int = 512
    verify_mode: str = "sync"  # sync | async | gated
    verify_confidence_threshold: float = 0.75
    dtype: str = "bfloat16"
    kv_page_size: int = 128
    kv_max_pages_per_seq: int = 64
    kv_quant: str = "none"
    prefix_cache: bool = True
    max_batch_size: int = 8
    use_paged_decode: bool = True
    decode_steps_per_tick: int = 16
    decode_max_tick_steps: int = 64
    decode_pipeline_depth: int = 2
    prefill_chunk: int = 0
    prefill_buckets: tuple[int, ...] = (256, 512, 1024, 2048, 4096)
    temperature_by_mode: tuple[tuple[str, float], ...] = (
        ("fast", 0.0),
        ("balanced", 0.3),
        ("quality", 0.2),
        ("creative", 0.7),
    )

    def temperature(self, mode: Optional[str] = None) -> float:
        table = dict(self.temperature_by_mode)
        return table.get(mode or self.mode, 0.3)

    @classmethod
    def from_env(cls) -> "GeneratorConfig":
        return cls(
            provider=_env_str(["LLM_PROVIDER", "CHAT_LLM_PROVIDER"], "tpu"),
            model_preset=_env_str(["LLM_MODEL", "CHAT_LLM_MODEL"], "llama3-8b"),
            checkpoint_path=_env_str(["LLM_CHECKPOINT", "MODEL_PATH"], ""),
            tokenizer_path=_env_str(["LLM_TOKENIZER", "TOKENIZER_PATH"], ""),
            draft_checkpoint_path=_env_str(["LLM_DRAFT_CHECKPOINT"], ""),
            speculative_k=_env_int(["SPECULATIVE_K"], 4),
            api_base=_env_str(["OPENAI_BASE_URL", "CHAT_LLM_BASE_URL"], ""),
            api_key=_env_str(["OPENAI_API_KEY", "CHAT_LLM_API_KEY"], ""),
            api_model=_env_str(["OPENAI_MODEL", "CHAT_LLM_API_MODEL"], "default"),
            api_timeout_s=_env_float(["OPENAI_TIMEOUT_S"], 60.0),
            mode=_env_str(["LLM_MODE"], "balanced"),
            max_new_tokens=_env_int(["LLM_MAX_TOKENS", "MAX_NEW_TOKENS"], 1024),
            context_token_budget=_env_int(["CONTEXT_TOKEN_BUDGET"], 2000),
            max_prompt_tokens=_env_int(["MAX_PROMPT_TOKENS"], 4096),
            use_verifier=_env_bool(["USE_VERIFIER"], True),
            verifier_max_tokens=_env_int(["VERIFIER_MAX_TOKENS"], 512),
            verify_mode=_env_str(["VERIFY_MODE"], "sync"),
            verify_confidence_threshold=_env_float(
                ["VERIFY_CONFIDENCE_THRESHOLD"], 0.75
            ),
            dtype=_env_str(["LLM_DTYPE"], "bfloat16"),
            kv_page_size=_env_int(["KV_PAGE_SIZE"], 128),
            kv_max_pages_per_seq=_env_int(["KV_MAX_PAGES_PER_SEQ"], 64),
            kv_quant=_env_str(["KV_QUANT"], "none"),
            prefix_cache=_env_bool(["PREFIX_CACHE"], True),
            max_batch_size=_env_int(["LLM_MAX_BATCH"], 8),
            use_paged_decode=_env_bool(["USE_PAGED_KV", "USE_PAGED_DECODE"], True),
            decode_steps_per_tick=_env_int(["DECODE_STEPS_PER_TICK"], 16),
            decode_max_tick_steps=_env_int(["DECODE_MAX_TICK_STEPS"], 64),
            decode_pipeline_depth=_env_int(["DECODE_PIPELINE_DEPTH"], 2),
            prefill_chunk=_env_int(["PREFILL_CHUNK"], 0),
        )


@dataclass
class ServeConfig:
    """The HTTP surface and the generation service's overload and deadline
    controls, named and defaulted as in the JAX ``ServeConfig``."""

    host: str = "0.0.0.0"
    port: int = 8000
    # per-IP sliding-window limits: /embed and /upload share the tight one
    rate_limit_embed_per_min: int = 10
    rate_limit_default_per_min: int = 100
    max_question_chars: int = 2000
    max_embed_chars: int = 50_000
    top_k_max: int = 20
    # only honor X-Forwarded-For when deployed behind a trusted proxy
    trust_proxy_headers: bool = False
    # /upload multipart body cap (every part's bytes count)
    max_upload_mb: int = 32
    # default per-request deadline (ms) for callers that send none; 0 = none
    default_deadline_ms: float = 0.0
    # bound on waiting decode work (inbox + admitted); 0 = derive from the
    # engine (max(8 * max_slots, 64))
    admission_max_queue: int = 0
    # requeues granted per request after a failed tick whose reset worked
    crash_retry_budget: int = 1
    # graceful-shutdown drain window for in-flight requests
    drain_deadline_s: float = 10.0
    # SSE liveness: a comment keepalive after this long without an event;
    # 0 disables
    sse_keepalive_s: float = 15.0
    # ---- the replica tier (runtime/replica.py, thread mode) ----
    # independent engine + service replicas behind the router, all on one
    # card; 1 = one engine behind a one-replica set
    replicas: int = 1
    # "thread" (the port's tier); "process" and "socket" are not ported and
    # raise; an unknown value warns and uses thread mode
    replica_mode: str = "thread"
    # a prefix-hit replica keeps a request while its backlog <= stickiness
    # x its slot count; 0 = least-loaded routing only
    affinity_stickiness: float = 4.0
    # prompt-head tokens the router matches against each replica's tree
    route_prefix_tokens: int = 512
    # per-tenant WFQ: "tenantA:4,tenantB:1"; unlisted tenants get the default
    tenant_weights: str = ""
    tenant_default_weight: float = 1.0
    # token-weighted deficit refill per unit weight (0 = quota-only) and cap
    tenant_refill_tokens_per_s: float = 0.0
    tenant_burst_tokens: int = 8192
    # queue slots no one tenant may take; < 0 = max(1, capacity // 8)
    tenant_headroom: int = -1
    # batch-tier requests shed once pending crosses this share of capacity
    batch_shed_fraction: float = 0.8
    # the supervisor thread (breaker, stall watchdog, in-place rebuild)
    replica_supervise: bool = True
    replica_probe_interval_s: float = 0.25
    # breaker window, error rate over at least min samples, tick failures
    replica_breaker_window_s: float = 30.0
    replica_breaker_error_rate: float = 0.5
    replica_breaker_min_samples: int = 4
    replica_breaker_tick_failures: int = 3
    # backoff after a failed rebuild (doubles, 60 s cap); attempts past the
    # budget wait the cap; drain grace before a rebuild swaps a service out
    replica_quarantine_backoff_s: float = 0.5
    replica_rebuild_budget: int = 3
    replica_rebuild_drain_s: float = 5.0
    # cross-replica retries of a request whose replica died under it
    replica_failover_budget: int = 1
    # resume-by-replay of delivered-token streams: -1 follows the failover
    # budget, 0 keeps the typed mid-stream error
    stream_resume_budget: int = -1
    # a pump iteration longer than this with pending work is a stall
    # (0 disables); the warmup stand-down ends after warmup_budget_s
    tick_stall_budget_s: float = 120.0
    warmup_budget_s: float = 600.0
    # rebuild worker threads (0 = rebuild on the supervisor thread)
    replica_rebuild_workers: int = 1
    # the socket tier's remote workers and the autoscaler: not ported, a
    # non-empty value (or AUTOSCALE=1) raises
    replica_workers: str = ""
    autoscale: bool = False

    @classmethod
    def from_env(cls) -> "ServeConfig":
        return cls(
            host=_env_str(["SENTIO_HOST", "API_HOST", "HOST"], "0.0.0.0"),
            port=_env_int(["SENTIO_PORT", "API_PORT", "PORT"], 8000),
            rate_limit_embed_per_min=_env_int(
                ["RATE_LIMIT_EMBED_PER_MIN", "RATE_LIMIT_EMBED"], 10
            ),
            rate_limit_default_per_min=_env_int(
                ["RATE_LIMIT_DEFAULT_PER_MIN", "RATE_LIMIT_DEFAULT"], 100
            ),
            max_question_chars=_env_int(["MAX_QUESTION_CHARS"], 2000),
            max_embed_chars=_env_int(["MAX_EMBED_CHARS"], 50_000),
            top_k_max=_env_int(["TOP_K_MAX"], 20),
            trust_proxy_headers=_env_bool(["TRUST_PROXY_HEADERS"], False),
            max_upload_mb=_env_int(["MAX_UPLOAD_MB"], 32),
            default_deadline_ms=_env_float(["DEADLINE_MS", "DEFAULT_DEADLINE_MS"], 0.0),
            admission_max_queue=_env_int(["ADMISSION_MAX_QUEUE"], 0),
            crash_retry_budget=_env_int(["CRASH_RETRY_BUDGET"], 1),
            drain_deadline_s=_env_float(["DRAIN_DEADLINE_S"], 10.0),
            sse_keepalive_s=_env_float(["SSE_KEEPALIVE_S"], 15.0),
            replicas=_env_int(["REPLICAS", "SENTIO_REPLICAS"], 1),
            replica_mode=_env_str(["REPLICA_MODE"], "thread").strip().lower(),
            affinity_stickiness=_env_float(["AFFINITY_STICKINESS"], 4.0),
            route_prefix_tokens=_env_int(["ROUTE_PREFIX_TOKENS"], 512),
            tenant_weights=_env_str(["TENANT_WEIGHTS"], ""),
            tenant_default_weight=_env_float(["TENANT_DEFAULT_WEIGHT"], 1.0),
            tenant_refill_tokens_per_s=_env_float(["TENANT_REFILL_TOKENS_PER_S"], 0.0),
            tenant_burst_tokens=_env_int(["TENANT_BURST_TOKENS"], 8192),
            tenant_headroom=_env_int(["TENANT_HEADROOM"], -1),
            batch_shed_fraction=_env_float(["BATCH_SHED_FRACTION"], 0.8),
            replica_supervise=_env_bool(["REPLICA_SUPERVISE"], True),
            replica_probe_interval_s=_env_float(["REPLICA_PROBE_INTERVAL_S"], 0.25),
            replica_breaker_window_s=_env_float(["REPLICA_BREAKER_WINDOW_S"], 30.0),
            replica_breaker_error_rate=_env_float(["REPLICA_BREAKER_ERROR_RATE"], 0.5),
            replica_breaker_min_samples=_env_int(["REPLICA_BREAKER_MIN_SAMPLES"], 4),
            replica_breaker_tick_failures=_env_int(["REPLICA_BREAKER_TICK_FAILURES"], 3),
            replica_quarantine_backoff_s=_env_float(["REPLICA_QUARANTINE_BACKOFF_S"], 0.5),
            replica_rebuild_budget=_env_int(["REPLICA_REBUILD_BUDGET"], 3),
            replica_rebuild_drain_s=_env_float(["REPLICA_REBUILD_DRAIN_S"], 5.0),
            replica_failover_budget=_env_int(["REPLICA_FAILOVER_BUDGET"], 1),
            stream_resume_budget=_env_int(["STREAM_RESUME_BUDGET"], -1),
            tick_stall_budget_s=_env_float(["TICK_STALL_BUDGET_S"], 120.0),
            warmup_budget_s=_env_float(["WARMUP_BUDGET_S"], 600.0),
            replica_rebuild_workers=_env_int(["REPLICA_REBUILD_WORKERS"], 1),
            replica_workers=_env_str(["REPLICA_WORKERS"], ""),
            autoscale=_env_bool(["AUTOSCALE"], False),
        )

    def parsed_replica_workers(self) -> list[tuple[str, int]]:
        """``"hostA:9101,hostB:9101"`` → [("hostA", 9101), ...]; a malformed
        entry raises. The port reads it only to refuse a non-empty value."""
        out: list[tuple[str, int]] = []
        for part in self.replica_workers.split(","):
            part = part.strip()
            if not part:
                continue
            host, sep, port = part.rpartition(":")
            if not sep or not host:
                raise ValueError(f"REPLICA_WORKERS entry {part!r} is not host:port")
            out.append((host, int(port)))
        return out

    def parsed_tenant_weights(self) -> dict[str, float]:
        """``"a:4,b:1"`` → {"a": 4.0, "b": 1.0}; malformed entries skipped."""
        out: dict[str, float] = {}
        for part in self.tenant_weights.split(","):
            part = part.strip()
            if not part or ":" not in part:
                continue
            name, _, raw = part.partition(":")
            try:
                out[name.strip()] = float(raw)
            except ValueError:
                continue
        return out


@dataclass
class CacheConfig:
    """The query-response cache: ``memory`` (an LRU with a TTL, the
    default) or ``off``; ``multi_tier`` (the Redis L2) is not ported."""

    backend: str = "memory"  # memory | multi_tier | off
    max_entries: int = 10_000
    default_ttl_s: float = 3600.0
    query_cache_ttl_s: float = 600.0

    @classmethod
    def from_env(cls) -> "CacheConfig":
        return cls(
            backend=_env_str(["CACHE_BACKEND"], "memory"),
            max_entries=_env_int(["CACHE_MAX_ENTRIES"], 10_000),
            default_ttl_s=_env_float(["CACHE_TTL"], 3600.0),
            query_cache_ttl_s=_env_float(["QUERY_CACHE_TTL"], 600.0),
        )


@dataclass
class AuthConfig:
    """Only the switch: auth is not ported, so ``AUTH_ENABLED=1`` raises."""

    enabled: bool = False

    @classmethod
    def from_env(cls) -> "AuthConfig":
        return cls(enabled=_env_bool(["AUTH_ENABLED"], False))


@dataclass
class MeshConfig:
    """The mesh sizes ``info`` reports (``MESH_DP``, ``MESH_TP``,
    ``MESH_SP``); the port runs on one card, so ``build_pipeline`` refuses
    any size above 1 (0 for dp means "infer": one card)."""

    dp_size: int = 0
    tp_size: int = 1
    sp_size: int = 1

    @classmethod
    def from_env(cls) -> "MeshConfig":
        return cls(
            dp_size=_env_int(["MESH_DP"], 0),
            tp_size=_env_int(["MESH_TP"], 1),
            sp_size=_env_int(["MESH_SP"], 1),
        )


@dataclass
class ObservabilityConfig:
    """Tracing and metrics: ``TRACING_ENABLED`` (or ``OTEL_ENABLED``) turns
    on OpenTelemetry spans around the pipeline's stages and a
    ``torch.profiler.record_function`` range around each pump tick;
    ``PROFILER_DIR`` (or JAX's ``JAX_PROFILER_DIR``) is where
    ``/debug/profile`` writes its trace when the request names none.
    ``METRICS_ENABLED=0`` is refused by the server (every family is always
    recorded); JAX's ``MONITOR_INTERVAL_S`` is read by nothing in either
    package and is left out."""

    tracing_enabled: bool = False
    otlp_endpoint: str = ""
    console_exporter: bool = False
    service_name: str = "sentio-tpu"
    metrics_enabled: bool = True
    profiler_dir: str = ""

    @classmethod
    def from_env(cls) -> "ObservabilityConfig":
        return cls(
            tracing_enabled=_env_bool(["TRACING_ENABLED", "OTEL_ENABLED"], False),
            otlp_endpoint=_env_str(["OTEL_EXPORTER_OTLP_ENDPOINT"], ""),
            console_exporter=_env_bool(["OTEL_CONSOLE"], False),
            service_name=_env_str(["OTEL_SERVICE_NAME"], "sentio-tpu"),
            metrics_enabled=_env_bool(["METRICS_ENABLED"], True),
            profiler_dir=_env_str(["PROFILER_DIR", "JAX_PROFILER_DIR"], ""),
        )


@dataclass
class Settings:
    """The sections the port reads."""

    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    rerank: RerankConfig = field(default_factory=RerankConfig)
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    observability: ObservabilityConfig = field(default_factory=ObservabilityConfig)

    @classmethod
    def from_env(cls) -> "Settings":
        return cls(
            chunking=ChunkingConfig.from_env(),
            retrieval=RetrievalConfig.from_env(),
            rerank=RerankConfig.from_env(),
            embedder=EmbedderConfig.from_env(),
            generator=GeneratorConfig.from_env(),
            serve=ServeConfig.from_env(),
            cache=CacheConfig.from_env(),
            auth=AuthConfig.from_env(),
            mesh=MeshConfig.from_env(),
            observability=ObservabilityConfig.from_env(),
        )
