"""``ChatPipeline.chat`` against the JAX graph on carried tiny weights.

The JAX side is ``build_basic_graph`` over TpuEmbedder, TpuDenseIndex (the
dense retriever), CrossEncoderReranker and TpuProvider over the JAX paged
engine with its Pallas kernel in interpret mode; the port gets the same
float32 weights through sentio_tpu_torch.runtime.weights. Both retrieve
densely, decode greedily (mode "fast") under a small token budget, and
must return the same retrieved and reranked ids, the same sources, the
same answer text and the same verdict."""

import dataclasses

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
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu.ops.embedder import TpuEmbedder
from sentio_tpu.ops.generator import LLMGenerator as JLLMGenerator
from sentio_tpu.ops.generator import TpuProvider
from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
from sentio_tpu.ops.retrievers import DenseRetriever
from sentio_tpu.ops.verifier import AnswerVerifier as JVerifier
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.serve.handlers import ChatHandler
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
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
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
def both():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    lcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    enc_tree = np_tree(init_encoder(jax.random.PRNGKey(21), enc))
    ce_tree = np_tree(init_cross_encoder(jax.random.PRNGKey(22), enc))
    llama_tree = np_tree(init_llama(jax.random.PRNGKey(23), lcfg))
    docs = build_bundle(n_docs=16, n_queries=1, seed=3).documents

    # ---- JAX reference graph
    js = JSettings(
        retrieval=JRetrievalConfig(strategy="dense", top_k=6),
        rerank=JRerankConfig(top_k=3),
        embedder=JEmbedderConfig(model_preset="tiny", coalesce=False, cache_size=0),
        generator=JGeneratorConfig(model_preset="tiny", **GEN, **ENGINE),
    )
    embedder = TpuEmbedder(js.embedder, params=enc_tree, model_config=enc)
    index = TpuDenseIndex(dim=enc.dim, dtype="float32")
    index.add(docs, embedder.embed_many([d.text for d in docs]))
    engine = JEngine(model_config=lcfg, params=llama_tree, max_slots=4, page_size=16,
                     max_pages_per_seq=32, use_pallas=True, prefix_cache=False,
                     steps_per_tick=8)
    generator = JLLMGenerator(provider=TpuProvider(engine=_PagedAsEngine(engine)),
                              config=js.generator)
    graph = build_basic_graph(
        DenseRetriever(embedder, index), generator,
        reranker=JReranker(js.rerank, params=ce_tree, model_config=enc),
        verifier=JVerifier(generator=generator, config=js.generator),
        config=GraphConfig(settings=js),
    )

    # ---- the port, same weights
    ts = Settings(
        retrieval=RetrievalConfig(strategy="dense", top_k=6),
        rerank=RerankConfig(top_k=3),
        embedder=EmbedderConfig(model_preset="tiny"),
        generator=GeneratorConfig(model_preset="tiny", **GEN, **ENGINE),
    )
    pipeline = build_pipeline(
        ts, device="cpu",
        llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(llama_tree),
        embedder_params=weights.encoder_from_jax(enc_tree),
        reranker_params=weights.cross_encoder_from_jax(ce_tree),
    )
    # float32 corpus on both sides (the JAX index above): a bf16 corpus rounds
    # scores to 8 bits and reorders near-ties
    pipeline.index = TorchDenseIndex(enc.dim, device="cpu", dtype="float32")
    pipeline.ingest([Document(text=d.text, metadata=dict(d.metadata), id=d.id) for d in docs])
    return graph, pipeline


@pytest.mark.parametrize("question", QUESTIONS)
def test_chat_matches_jax_graph(both, question):
    graph, pipeline = both
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
