"""The three provider settings in the port against the JAX factories:
``EMBEDDER_PROVIDER`` (``get_embedder``: ``tpu`` the bi-encoder, any other
name the hash embedder), ``RERANKER_KIND`` (``get_reranker``:
``cross_encoder`` or ``passthrough``, else JAX's ``ValueError``) and
``LLM_PROVIDER`` (``create_generator``: ``tpu`` the engines, ``openai`` the
remote endpoint, ``echo``, else JAX's ``ValueError``). A pipeline with a
provider other than ``tpu`` builds no engine, and ``/info`` and
``/health/detailed`` answer for it as JAX's do. Hash vectors to 1e-6,
passthrough order and scores exactly."""

from __future__ import annotations

import http.client
import json
import threading

import numpy as np
import pytest

from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.ops.embedder import get_embedder as jget_embedder
from sentio_tpu.ops.generator import EchoProvider as JEchoProvider
from sentio_tpu.ops.generator import create_generator as jcreate_generator
from sentio_tpu.ops.reranker import get_reranker as jget_reranker
from sentio_tpu_torch.config import (
    EmbedderConfig,
    GeneratorConfig,
    RerankConfig,
    RetrievalConfig,
    Settings,
)
from sentio_tpu_torch.eval.baseline import MockModelServer
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.embedder import HashEmbedder, TorchEmbedder, get_embedder
from sentio_tpu_torch.ops.generator import EchoProvider, OpenAIProvider, provider_for
from sentio_tpu_torch.ops.reranker import (
    CrossEncoderReranker,
    PassthroughReranker,
    get_reranker,
)
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime import engine as engine_mod
from sentio_tpu_torch.runtime import paged as paged_mod
from sentio_tpu_torch.serve.app import create_server

TEXTS = ["What is a systolic array?", "", "The quick brown fox", "the QUICK brown fox",
         "Tokens: 1 2 3 ü é 日本"]
CORPUS = ("Systolic arrays multiply matrices in a wave. Paged attention reads a page "
          "table. Retrieval cites numbered sources. The verifier audits answers. ") * 6


@pytest.mark.parametrize("provider", ["hash", "jina", "openai"])
def test_hash_embedder_matches_jax(provider):
    """Any name but ``tpu`` gives the hash embedder, as JAX falls back."""
    ours = get_embedder(EmbedderConfig(provider=provider, dim=96), device="cpu")
    theirs = jget_embedder(JEmbedderConfig(provider=provider, dim=96))
    assert isinstance(ours, HashEmbedder) and type(theirs).__name__ == "HashEmbedder"
    assert ours.dimension == theirs.dimension == 96
    np.testing.assert_allclose(ours.embed_many(TEXTS), theirs.embed_many(TEXTS),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.embed_device(TEXTS[:1])[0], theirs.embed(TEXTS[0]),
                               atol=1e-6, rtol=0)
    assert ours.get_stats()["cache"]["hits"] == 1


def test_tpu_embedder_provider():
    emb = get_embedder(EmbedderConfig(model_preset="tiny"), device="cpu")
    try:
        assert isinstance(emb, TorchEmbedder)
    finally:
        emb.close()


def _docs(cls):
    return [cls(text=f"document {i} about topic {i % 3}",
                metadata={"score": s, "source": f"s{i}"}, id=f"d{i}")
            for i, s in enumerate([0.2, 0.9, None, 0.5, 0.7])]


@pytest.mark.parametrize("top_k", [None, 3])
def test_passthrough_keeps_order_and_scores_as_jax(top_k):
    ours = get_reranker("passthrough").rerank("q", _docs(Document), top_k=top_k)
    theirs = jget_reranker("passthrough").rerank("q", _docs(JDocument), top_k=top_k)
    assert isinstance(get_reranker("passthrough"), PassthroughReranker)
    assert ours.model == theirs.model == "passthrough"
    assert [d.id for d in ours.documents] == [d.id for d in theirs.documents]
    assert ours.scores == theirs.scores
    assert [d.metadata for d in ours.documents] == [d.metadata for d in theirs.documents]


def test_cross_encoder_kind_builds_the_model():
    rr = get_reranker("cross_encoder", config=RerankConfig(), device="cpu")
    assert isinstance(rr, CrossEncoderReranker)


@pytest.mark.parametrize("kind", ["cohere", "Passthrough", "cross-encoder"])
def test_unknown_reranker_raises_jax_error(kind):
    with pytest.raises(ValueError) as theirs:
        jget_reranker(kind)
    with pytest.raises(ValueError) as ours:
        get_reranker(kind)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match=str(theirs.value).split(";")[0]):
        build_pipeline(Settings(rerank=RerankConfig(kind=kind)), device="cpu")


@pytest.mark.parametrize("name", ["anthropic", "TPU", "local"])
def test_unknown_llm_provider_raises_jax_error(name):
    with pytest.raises(ValueError) as theirs:
        jcreate_generator(JSettings(generator=JGeneratorConfig(provider=name)))
    with pytest.raises(ValueError) as ours:
        provider_for(GeneratorConfig(provider=name))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown LLM provider"):
        build_pipeline(Settings(generator=GeneratorConfig(provider=name)), device="cpu")


def test_openai_provider_from_settings():
    cfg = GeneratorConfig(provider="openai", api_base="http://127.0.0.1:9/v1", api_key="k",
                          api_model="m", api_timeout_s=3.0)
    ours = provider_for(cfg)
    theirs = jcreate_generator(JSettings(generator=JGeneratorConfig(
        provider="openai", api_base="http://127.0.0.1:9/v1", api_key="k", api_model="m",
        api_timeout_s=3.0))).provider
    assert isinstance(ours, OpenAIProvider)
    assert (ours.base_url, ours.api_key, ours.model, ours.timeout_s) == (
        theirs.base_url, theirs.api_key, theirs.model, theirs.timeout_s)


@pytest.mark.parametrize("prompt", ["no sources here", "Context:\n  [1] Source: a (score 0.9)\n"
                                    "text\n[2] Source: b", ""])
def test_echo_provider_matches_jax(prompt):
    ours, theirs = EchoProvider(), JEchoProvider()
    assert ours.chat(prompt, 16, 0.0) == theirs.chat(prompt, 16, 0.0)
    assert list(ours.stream(prompt, 16, 0.0)) == list(theirs.stream(prompt, 16, 0.0))


@pytest.fixture
def no_engines(monkeypatch):
    """Any engine construction fails the test."""

    def refuse(*_a, **_k):
        raise AssertionError("an engine was built for a provider other than tpu")

    monkeypatch.setattr(engine_mod.GeneratorEngine, "__init__", refuse)
    monkeypatch.setattr(paged_mod.ContinuousBatchingEngine, "__init__", refuse)


class _Client:
    def __init__(self, port: int) -> None:
        self.port = port

    def json(self, method: str, path: str, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            data = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"} if data else {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"null")
        finally:
            conn.close()


def _serve(pipeline):
    server = create_server(None, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name="provider-server",
                              daemon=True)
    thread.start()
    return server, thread, _Client(server.server_address[1])


@pytest.mark.parametrize("llm", ["openai", "echo"])
def test_pipeline_without_engine_serves_chat_info_and_health(no_engines, llm):
    """``LLM_PROVIDER`` openai (the port's mock server on loopback) or echo,
    with the hash embedder and passthrough reranker: ``/chat`` answers,
    no engine is built, ``/info``'s device is null and
    ``/health/detailed`` names the provider, as JAX's do."""
    mock = MockModelServer(dim=64).start()
    settings = Settings(
        retrieval=RetrievalConfig(strategy="hybrid", top_k=4),
        embedder=EmbedderConfig(provider="hash", dim=64),
        rerank=RerankConfig(kind="passthrough", top_k=2),
        generator=GeneratorConfig(provider=llm, api_base=mock.base_url + "/v1",
                                  use_verifier=llm == "openai", max_new_tokens=32,
                                  draft_checkpoint_path="/nonexistent/draft"))
    pipeline = build_pipeline(settings, device="cpu")
    server, thread, client = _serve(pipeline)
    try:
        assert pipeline.engine is None and pipeline.replica_set is None
        assert isinstance(pipeline.embedder, HashEmbedder)
        assert isinstance(pipeline.reranker, PassthroughReranker)
        assert pipeline.speculative_info == {"draft_configured": True, "active": False}
        assert client.json("POST", "/embed", {"content": CORPUS})[0] == 200
        status, answer = client.json("POST", "/chat", {"question": "What is paged attention?"})
        assert status == 200, answer
        if llm == "openai":
            assert answer["answer"].startswith("Based on the provided sources:")
            assert mock.calls["chat"] >= 1
        else:
            assert answer["answer"].startswith(
                "Based on the provided sources, the most relevant finding is: [1]")
        status, info = client.json("GET", "/info")
        assert status == 200 and info["device"] is None
        assert info["generator"]["provider"] == llm
        assert info["reranker"] == {"enabled": True, "kind": "passthrough"}
        status, health = client.json("GET", "/health/detailed")
        assert status == 200
        assert health["components"]["engine"] == {"healthy": True, "provider": llm}
        assert "generation_service" not in health["components"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        pipeline.close()
        mock.stop()
