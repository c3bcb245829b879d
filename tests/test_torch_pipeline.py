"""``ChatPipeline.chat`` against the JAX graph on carried tiny weights.

The JAX side is ``build_basic_graph`` over TpuEmbedder, TpuDenseIndex, the
retriever JAX's ``create_retriever`` makes for the strategy (dense, or
hybrid: the dense leg and a BM25 leg fused by rrf), CrossEncoderReranker
and TpuProvider over the JAX paged engine with its Pallas kernel in
interpret mode; the port gets the same float32 weights through
sentio_tpu_torch.runtime.weights and builds its own retriever from the same
settings. Both decode greedily (mode "fast") under a small token budget,
and must return the same retrieved and reranked ids, the same sources, the
same answer text and the same verdict — with bf16 pools (float32 here) and
with int8 pools on both sides, each engine under the default serving
settings (radix prefix cache, pipeline depth 2; the port's behind its
generation service). Also: the settings this package cannot honour raise,
the engine settings reach the engine, the CLI honours
``RETRIEVAL_STRATEGY`` and ``KV_QUANT``, the ``/chat`` template head is
warmed as the JAX container warms it (chat 1 hits as many tokens as a JAX
engine warmed with the same head), and a failing retrieval, rerank or
generation degrades with the JAX graph's metadata while a
``soft_fail_exempt`` error raises."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import RerankConfig as JRerankConfig
from sentio_tpu.config import RetrievalConfig as JRetrievalConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.eval.dataset import build_bundle
from sentio_tpu.graph.factory import GraphConfig, build_basic_graph
from sentio_tpu.graph.state import create_initial_state
from sentio_tpu.models.cross_encoder import init_cross_encoder
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder
from sentio_tpu.ops.bm25 import BM25Index as JBM25Index
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu.ops.embedder import TpuEmbedder
from sentio_tpu.ops.generator import LLMGenerator as JLLMGenerator
from sentio_tpu.ops.generator import TpuProvider
from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
from sentio_tpu.ops.retrievers import create_retriever
from sentio_tpu.ops.verifier import AnswerVerifier as JVerifier
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.serve.handlers import ChatHandler
from sentio_tpu_torch import __main__ as cli
from sentio_tpu_torch import pipeline as pipeline_module
from sentio_tpu_torch.config import (
    EmbedderConfig,
    GeneratorConfig,
    RerankConfig,
    RetrievalConfig,
    Settings,
)
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime import weights

ENGINE = dict(max_batch_size=4, kv_page_size=16, kv_max_pages_per_seq=32)
GEN = dict(max_new_tokens=16, verifier_max_tokens=12, context_token_budget=120,
           decode_steps_per_tick=8, decode_max_tick_steps=8)
QUESTIONS = ["Who maintains the ingest pipeline?", "what changed in the scheduler"]


class _PagedAsEngine:
    """TpuProvider's contiguous-engine seam over the JAX paged engine."""

    def __init__(self, engine):
        self.engine = engine

    def generate(self, prompts, max_new_tokens, temperature):
        return self.engine.run_all(prompts, max_new_tokens=max_new_tokens,
                                   temperature=temperature)


@pytest.fixture(scope="module")
def shared():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    lcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        enc=enc, lcfg=lcfg,
        enc_tree=np_tree(init_encoder(jax.random.PRNGKey(21), enc)),
        ce_tree=np_tree(init_cross_encoder(jax.random.PRNGKey(22), enc)),
        llama_tree=np_tree(init_llama(jax.random.PRNGKey(23), lcfg)),
        docs=build_bundle(n_docs=16, n_queries=1, seed=3).documents,
    )


def _build(shared, strategy, kv_quant):
    enc, lcfg, docs = shared["enc"], shared["lcfg"], shared["docs"]
    # float32 corpus on both sides (the index follows the generator dtype):
    # a bf16 corpus rounds scores to 8 bits and reorders near-ties
    gen = dict(GEN, **ENGINE, dtype="float32", kv_quant=kv_quant)

    # ---- JAX reference graph
    js = JSettings(
        retrieval=JRetrievalConfig(strategy=strategy, top_k=6),
        rerank=JRerankConfig(top_k=3),
        embedder=JEmbedderConfig(model_preset="tiny", coalesce=False, cache_size=0),
        generator=JGeneratorConfig(model_preset="tiny", **gen),
    )
    embedder = TpuEmbedder(js.embedder, params=shared["enc_tree"], model_config=enc)
    index = TpuDenseIndex(dim=enc.dim, dtype="float32")
    index.add(docs, embedder.embed_many([d.text for d in docs]))
    # the JAX service hands its engine these generator settings (the radix
    # prefix cache and pipeline depth 2 by default), as build_pipeline does
    jg = js.generator
    engine = JEngine(model_config=lcfg, params=shared["llama_tree"], max_slots=4, page_size=16,
                     max_pages_per_seq=32, use_pallas=True, prefix_cache=jg.prefix_cache,
                     pipeline_depth=jg.decode_pipeline_depth,
                     prefill_chunk=jg.prefill_chunk or None, steps_per_tick=8,
                     kv_quant=kv_quant)
    generator = JLLMGenerator(provider=TpuProvider(engine=_PagedAsEngine(engine)),
                              config=js.generator)
    retriever = create_retriever(settings=js, embedder=embedder, dense_index=index,
                                 bm25_index=JBM25Index().build(index.documents()))
    reranker = JReranker(js.rerank, params=shared["ce_tree"], model_config=enc)
    graph = build_basic_graph(
        retriever, generator, reranker=reranker,
        verifier=JVerifier(generator=generator, config=js.generator),
        config=GraphConfig(settings=js),
    )
    graph.parts = {"retriever": retriever, "reranker": reranker, "generator": generator}

    # ---- the port, same weights and settings
    ts = Settings(
        retrieval=RetrievalConfig(strategy=strategy, top_k=6),
        rerank=RerankConfig(top_k=3),
        embedder=EmbedderConfig(model_preset="tiny"),
        generator=GeneratorConfig(model_preset="tiny", **gen),
    )
    pipeline = build_pipeline(
        ts, device="cpu",
        llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]),
    )
    pipeline.ingest([Document(text=d.text, metadata=dict(d.metadata), id=d.id) for d in docs])
    return graph, pipeline


@pytest.fixture(scope="module")
def both(shared):
    return _build(shared, "dense", "none")


@pytest.fixture(scope="module")
def hybrid(shared):
    return _build(shared, "hybrid", "none")


@pytest.fixture(scope="module")
def hybrid_int8(shared):
    return _build(shared, "hybrid", "int8")


def _assert_same_chat(graph, pipeline, question):
    state = graph.invoke(create_initial_state(question, metadata={"mode": "fast"}))
    got = pipeline.chat(question, mode="fast")
    meta = got["metadata"]
    assert meta["retrieved_ids"] == [d.id for d in state["retrieved_documents"]]
    assert meta["reranked_ids"] == [d.id for d in state["reranked_documents"]]
    ref_sources = ChatHandler._serialize_sources(state)
    assert [s["id"] for s in got["sources"]] == [s["id"] for s in ref_sources]
    np.testing.assert_allclose([s["score"] for s in got["sources"]],
                               [s["score"] for s in ref_sources], atol=1e-4, rtol=0)
    assert got["answer"] == state["response"]
    assert got["answer"]
    assert got["verification"]["verdict"] == state["evaluation"]["verdict"]
    assert got["verification"]["notes"] == state["evaluation"]["notes"]
    assert meta["generated_tokens"] > 0
    return state, got


@pytest.mark.parametrize("question", QUESTIONS)
def test_chat_matches_jax_graph(both, question):
    _assert_same_chat(*both, question)


@pytest.mark.parametrize("question", QUESTIONS)
def test_hybrid_chat_matches_jax_graph(hybrid, question):
    """RETRIEVAL_STRATEGY=hybrid (rrf over the dense and BM25 legs): the
    BM25 leg has hits that reach the fused list, and the chat is
    token-exact."""
    _state, got = _assert_same_chat(*hybrid, question)
    dense_leg, sparse_leg = hybrid[1].retriever.retrievers
    assert (dense_leg.name, sparse_leg.name) == ("dense", "bm25")
    sparse_ids = {d.id for d in sparse_leg.retrieve(question, 12)}
    assert sparse_ids & set(got["metadata"]["retrieved_ids"])


@pytest.mark.parametrize("question", QUESTIONS)
def test_int8_chat_matches_jax_graph(hybrid_int8, question):
    """Hybrid retrieval with KV_QUANT=int8 on both sides: the same ids, and
    the answer held to the int8 greedy drain's criterion
    (tests/test_torch_kv_quant.py), token-exact; an int8 pool is in use."""
    _graph, pipeline = hybrid_int8
    assert pipeline.generator.provider.engine.pool.quantized
    _assert_same_chat(*hybrid_int8, question)


@pytest.mark.parametrize("section,field,value", [
    ("retrieval", "use_scorers", True),
    ("retrieval", "web_cache_path", "/nonexistent/cache"),
    ("generator", "draft_checkpoint_path", "/nonexistent/draft"),  # LLM_DRAFT_CHECKPOINT
    ("generator", "tokenizer_path", "/nonexistent/tokenizer"),  # LLM_TOKENIZER
    ("generator", "verify_mode", "gated"),
])
def test_build_pipeline_refuses_what_it_cannot_honour(section, field, value):
    """Settings of parts that are not ported raise NotImplementedError; a
    draft checkpoint (speculation is ported) that cannot be loaded raises
    the loader's WeightsError, naming LLM_DRAFT_CHECKPOINT; VERIFY_MODE
    (ported) builds, and an unknown mode raises JAX's ValueError before
    anything is built."""
    config = {"retrieval": RetrievalConfig, "generator": GeneratorConfig}[section]
    settings = Settings(**{section: config(**{field: value})})
    if field == "verify_mode":
        with pytest.raises(ValueError, match="verify_mode must be one of"):
            build_pipeline(Settings(generator=GeneratorConfig(verify_mode="eventually")),
                           device="cpu")
        tiny = Settings(embedder=EmbedderConfig(model_preset="tiny"),
                        generator=GeneratorConfig(verify_mode=value, model_preset="tiny",
                                                  kv_page_size=16, kv_max_pages_per_seq=64))
        pipeline = build_pipeline(tiny, device="cpu")
        try:
            assert pipeline.settings.generator.verify_mode == value
        finally:
            pipeline.close()
        return
    if field == "draft_checkpoint_path":
        with pytest.raises(weights.WeightsError, match="LLM_DRAFT_CHECKPOINT: cannot load"):
            build_pipeline(settings, device="cpu")
        return
    with pytest.raises(NotImplementedError):
        build_pipeline(settings, device="cpu")


@pytest.mark.parametrize("prefix_cache,depth,chunk", [(True, 2, 0), (False, 1, 0), (True, 1, 64)])
def test_engine_settings_reach_the_engine(monkeypatch, prefix_cache, depth, chunk):
    """PREFIX_CACHE, DECODE_PIPELINE_DEPTH and PREFILL_CHUNK (0 = off) from
    the environment reach the engine that build_pipeline makes, as the JAX
    service hands them to its engine."""
    monkeypatch.setenv("PREFIX_CACHE", "1" if prefix_cache else "0")
    monkeypatch.setenv("DECODE_PIPELINE_DEPTH", str(depth))
    monkeypatch.setenv("PREFILL_CHUNK", str(chunk))
    settings = Settings.from_env()
    settings.embedder = dataclasses.replace(settings.embedder, model_preset="tiny")
    settings.generator = dataclasses.replace(settings.generator, model_preset="tiny",
                                             kv_page_size=16, kv_max_pages_per_seq=8)
    engine = build_pipeline(settings, device="cpu").generator.provider.engine
    assert (engine._radix is not None) == prefix_cache
    assert engine.pipeline_depth == depth
    assert engine.prefill_chunk == (chunk or None)


@pytest.mark.parametrize("strategy,kv_quant", [("hybrid", "none"), ("bm25", "int8"),
                                               ("dense", "int8")])
def test_cli_honours_strategy_and_kv_quant(monkeypatch, capsys, strategy, kv_quant):
    """``python -m sentio_tpu_torch chat`` reads RETRIEVAL_STRATEGY and
    KV_QUANT from the environment and hands them to the retriever and the
    engine."""
    built = []
    real = pipeline_module.build_pipeline

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(pipeline_module, "build_pipeline", spy)
    monkeypatch.setenv("RETRIEVAL_STRATEGY", strategy)
    monkeypatch.setenv("KV_QUANT", kv_quant)
    monkeypatch.setenv("USE_VERIFIER", "0")
    assert cli.main(["chat", "what does a page table map?", "--tiny", "--device", "cpu",
                     "--max-tokens", "4"]) == 0
    response = json.loads(capsys.readouterr().out)
    (pipeline,) = built
    assert pipeline.settings.retrieval.strategy == strategy
    assert pipeline.retriever.name == strategy
    assert pipeline.generator.provider.engine.kv_quant == kv_quant
    assert pipeline.generator.provider.engine.pool.quantized == (kv_quant == "int8")
    assert response["metadata"]["retrieved_ids"]


# ---- the /chat template head (C2) and the degradation ladder (C3)


def _port_pipeline(shared, **gen):
    """A fresh port pipeline on the shared weights (dense retrieval)."""
    enc, lcfg = shared["enc"], shared["lcfg"]
    ts = Settings(retrieval=RetrievalConfig(strategy="dense", top_k=6),
                  rerank=RerankConfig(top_k=3), embedder=EmbedderConfig(model_preset="tiny"),
                  generator=GeneratorConfig(model_preset="tiny",
                                            **{**GEN, **ENGINE, "dtype": "float32", **gen}))
    pipeline = build_pipeline(
        ts, device="cpu", llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]))
    pipeline.ingest([Document(text=d.text, metadata=dict(d.metadata), id=d.id)
                     for d in shared["docs"]])
    return pipeline


def test_template_head_is_warmed_as_jax_warms_it(shared):
    """build_pipeline warms JAX's static_head of the retrieve template into
    the radix tree, so chat 1's generate hits as many prompt tokens as on a
    JAX engine warmed with the same head."""
    from sentio_tpu.ops.prompts import PromptBuilder as JPromptBuilder

    jp = JPromptBuilder()
    head = jp.static_head("retrieve", instruction=jp.load("profile"))
    pipeline = _port_pipeline(shared)
    try:
        prompts = pipeline.generator.prompts
        assert prompts.static_head("retrieve", instruction=prompts.load("profile")) == head
        engine = pipeline.generator.provider.engine
        head_ids = engine.tokenizer.encode(head, add_bos=True)
        full = len(head_ids) // engine.page_size * engine.page_size
        assert full > 0 and engine._radix.peek_prefix(head_ids) == full
        results = []
        generate = pipeline.service.generate
        pipeline.service.generate = lambda *a, **kw: results.append(generate(*a, **kw)) \
            or results[-1]
        question = QUESTIONS[0]
        docs = pipeline.retriever.retrieve(question, 6)
        docs = pipeline.reranker.rerank(question, docs, top_k=3).documents
        prompt = pipeline.generator.build_prompt(question, docs)
        pipeline.chat(question, mode="fast")
    finally:
        pipeline.close()
    jengine = JEngine(model_config=shared["lcfg"], params=shared["llama_tree"], max_slots=4,
                      page_size=16, max_pages_per_seq=32, steps_per_tick=8)
    assert jengine.warm_prefix(head) == full
    (ref,) = jengine.run_all([prompt], max_new_tokens=GEN["max_new_tokens"], temperature=0.0)
    assert results[0].prefix_hit_tokens == ref.prefix_hit_tokens == full
    assert results[0].tokens == ref.tokens


@pytest.mark.parametrize("leg", ["retrieval", "rerank", "generation"])
def test_failing_leg_degrades_as_jax(both, monkeypatch, leg):
    """A retrieval or generation error gives an empty list or answer and
    the JAX metadata key with the error's text; a rerank error keeps the
    retrieval order and sets rerank_fallback — on both sides."""
    graph, pipeline = both
    question = QUESTIONS[0]
    exc = RuntimeError(f"{leg} leg down")

    def boom(*_a, **_kw):
        raise exc

    async def aboom(*_a, **_kw):
        raise exc

    parts = graph.parts
    if leg == "retrieval":
        monkeypatch.setattr(pipeline.retriever, "retrieve", boom)
        monkeypatch.setattr(parts["retriever"], "aretrieve", aboom)
    elif leg == "rerank":
        monkeypatch.setattr(pipeline.reranker, "_score", boom)
        monkeypatch.setattr(parts["reranker"], "_score", boom)
    else:
        monkeypatch.setattr(pipeline.generator.provider, "chat", boom)
        monkeypatch.setattr(parts["generator"].provider, "chat", boom)
    state = graph.invoke(create_initial_state(question, metadata={"mode": "fast"}))
    got = pipeline.chat(question, mode="fast")
    meta, ref_meta = got["metadata"], state["metadata"]
    if leg == "retrieval":
        assert meta["retrieval_error"] == ref_meta["retrieval_error"] == str(exc)
        assert meta["retrieved_ids"] == [] == state["retrieved_documents"]
    elif leg == "rerank":
        assert meta["rerank_fallback"] is True and ref_meta["rerank_fallback"] is True
        assert meta["reranked_ids"] == [d.id for d in state["reranked_documents"]]
        assert meta["reranked_ids"] == meta["retrieved_ids"][:3]
        assert [s["score"] for s in got["sources"]] == pytest.approx(
            [s["score"] for s in ChatHandler._serialize_sources(state)])
    else:
        assert meta["generation_error"] == ref_meta["generation_error"] == str(exc)
        assert got["answer"] == state["response"] == ""
    assert got["answer"] == state["response"]


def test_soft_fail_exempt_errors_raise(both, monkeypatch):
    """A shed (soft_fail_exempt) is not degraded into an empty answer."""
    from sentio_tpu.infra.exceptions import ServiceOverloaded as JOverloaded
    from sentio_tpu_torch.infra.exceptions import ServiceOverloaded

    graph, pipeline = both

    def shed(*_a, **_kw):
        raise ServiceOverloaded("decode queue full")

    def jshed(*_a, **_kw):
        raise JOverloaded("decode queue full")

    monkeypatch.setattr(pipeline.generator.provider, "chat", shed)
    monkeypatch.setattr(graph.parts["generator"].provider, "chat", jshed)
    with pytest.raises(ServiceOverloaded):
        pipeline.chat(QUESTIONS[0], mode="fast")
    with pytest.raises(JOverloaded):
        graph.invoke(create_initial_state(QUESTIONS[0], metadata={"mode": "fast"}))
