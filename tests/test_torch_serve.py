"""The port's HTTP server (``serve/app.py`` over ``http.server``) against
the JAX server (``sentio_tpu.serve.app.create_app`` on aiohttp), both read
with ``http.client`` on the same tiny float32 weights.

The JAX side is a ``DependencyContainer`` whose parts are the tiny JAX
graph that ``tests/test_torch_pipeline.py`` builds (hybrid retrieval, the
cross-encoder, the verifier), with its paged engine behind JAX's
``PagedGenerationService`` and a one-replica ``ReplicaSet`` (what JAX's
container builds under the default settings), in an aiohttp ``TestServer``
on a background loop; the port side is ``create_server`` over
``build_pipeline`` on the same weights. Both ingest the same corpus over ``/upload`` (document ids
made deterministic by one uuid sequence) and must answer alike:

* the request schemas and ``ErrorHandler``'s statuses, bodies and
  ``Retry-After`` on tables of payloads and errors;
* ``/embed`` stats, the greedy (``mode: fast``) ``/chat`` JSON — answer,
  sources, status, ``degraded``, ``evaluation`` and the metadata keys but
  those of features left out of the port (``LEFT_OUT_META``, now none) — the SSE
  event sequence and its joined tokens, ``/upload`` per-file results, 413
  over the cap, the non-multipart refusal, ``/embed``'s 429 and
  ``Retry-After`` past its limit, ``/clear``, the keys of ``/health`` and
  ``/info``, the degradation ladder's tier with a failing generator, and
  a deadline of 1 ms;
* an SSE client that goes away mid-stream cancels the service's ticket;
* ``python -m sentio_tpu_torch ingest`` prints JAX's stats, and ``serve``
  in a subprocess answers ``/health`` and ``/chat`` over the saved index
  and exits on SIGTERM.

Every join, socket read and server shutdown has a timeout."""

import asyncio
import contextlib
import dataclasses
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from sentio_tpu.config import CacheConfig as JCacheConfig
from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import RerankConfig as JRerankConfig
from sentio_tpu.config import RetrievalConfig as JRetrievalConfig
from sentio_tpu.config import ServeConfig as JServeConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.eval.dataset import build_bundle
from sentio_tpu.graph.factory import GraphConfig, build_basic_graph
from sentio_tpu.infra import exceptions as jexc
from sentio_tpu.infra.caching import CacheManager as JCacheManager
from sentio_tpu.infra.resilience import FallbackResponseCache as JFallbackResponseCache
from sentio_tpu.infra.resilience import LLMFallback as JLLMFallback
from sentio_tpu.infra.security import IPRateLimiter as JIPRateLimiter
from sentio_tpu.infra.security import RateLimitConfig as JRateLimitConfig
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
from sentio_tpu.ops.ingest import DocumentIngestor as JDocumentIngestor
from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
from sentio_tpu.ops.retrievers import create_retriever
from sentio_tpu.ops.verifier import AnswerVerifier as JVerifier
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.replica import ReplicaSet as JReplicaSet
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu.serve import schemas as jschemas
from sentio_tpu.serve.app import create_app
from sentio_tpu.serve.dependencies import DependencyContainer
from sentio_tpu.serve.handlers import ChatHandler as JChatHandler
from sentio_tpu_torch import __main__ as cli
from sentio_tpu_torch.config import (
    EmbedderConfig,
    GeneratorConfig,
    RerankConfig,
    RetrievalConfig,
    ServeConfig,
    Settings,
)
from sentio_tpu_torch.infra import exceptions as texc
from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
from sentio_tpu_torch.infra.security import IPRateLimiter, RateLimitConfig
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime import weights
from sentio_tpu_torch.serve import schemas as tschemas
from sentio_tpu_torch.serve.app import create_server

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0
SCORE_ATOL = 1e-4
ENGINE = dict(max_batch_size=4, kv_page_size=16, kv_max_pages_per_seq=32)
GEN = dict(max_new_tokens=16, verifier_max_tokens=12, context_token_budget=120,
           decode_steps_per_tick=8, decode_max_tick_steps=8, dtype="float32")
SERVE = dict(max_upload_mb=1)
# metadata the JAX server writes for features the port leaves out (the
# tenant tier's WFQ key and priority and the replica id are ported)
LEFT_OUT_META = frozenset()
QUESTIONS = ["Who maintains the ingest pipeline?", "what changed in the scheduler"]


# ------------------------------------------------------------------- tables

CHAT_PAYLOADS = [
    {}, {"question": ""}, {"question": "x" * 3000}, {"question": "ok", "top_k": 0},
    {"question": "ok", "top_k": 99}, {"question": "ok", "top_k": True},
    {"question": "ok", "temperature": 3.0}, {"question": "ok", "temperature": "hot"},
    {"question": "ok", "mode": "bogus"}, {"question": "ok", "thread_id": 7},
    {"question": "ok", "resumable": "nope"}, {"question": "ok", "deadline_ms": 0},
    {"question": "ok", "deadline_ms": -5}, {"question": "ok", "deadline_ms": "fast"},
    {"question": "ok", "deadline_ms": True}, {"question": "ok", "deadline_ms": 3_600_001},
    {"question": "  spaced  ", "top_k": 3, "temperature": 0, "mode": "fast",
     "thread_id": "t-1", "stream": True, "deadline_ms": 2500, "resumable": False},
    {"query": "alias field"}, [], "text",
    {"question": "", "top_k": 0, "mode": "x", "temperature": -1},
]
EMBED_PAYLOADS = [{}, {"content": " "}, {"content": "x" * 50_001}, {"text": "alias"},
                  {"content": "ok", "metadata": [1]}, {"content": "ok", "metadata": {"a": 1}},
                  {"content": "ok", "metadata": None}, []]


def _parse(module, fn, payload):
    limits = JServeConfig() if module is jschemas else ServeConfig()
    try:
        return ("ok", dataclasses.asdict(getattr(module, fn)(payload, limits)))
    except module.SchemaError as exc:
        return ("error", exc.errors, str(exc))


@pytest.mark.parametrize("payload", CHAT_PAYLOADS, ids=lambda p: json.dumps(p)[:40])
def test_parse_chat_request_matches_jax(payload):
    assert _parse(tschemas, "parse_chat_request", payload) == \
        _parse(jschemas, "parse_chat_request", payload)


@pytest.mark.parametrize("payload", EMBED_PAYLOADS, ids=lambda p: json.dumps(p)[:40])
def test_parse_embed_request_matches_jax(payload):
    assert _parse(tschemas, "parse_embed_request", payload) == \
        _parse(jschemas, "parse_embed_request", payload)


ERRORS = [
    ("ServiceOverloaded", dict(message="decode queue full", status=429, retry_after_s=7.0)),
    ("ServiceOverloaded", dict(message="draining", retry_after_s=0.2)),
    ("DeadlineExceededError", dict(message="deadline expired")),
    ("ReplicaUnavailable", dict()),
    ("RateLimitError", dict(message="rate limit 2/min exceeded for /embed",
                            retry_after_s=42.5)),
    ("ValidationError", dict(message="bad", details={"field": "x"})),
    ("SentioError", dict(message="plain")),
]


def _handled(module, name, kwargs):
    if name is None:
        exc = RuntimeError("secret internals")
    else:
        exc = getattr(module, name)(**kwargs)
    status, body = module.ErrorHandler.handle(exc)
    body["error"].pop("error_id")
    retry = getattr(exc, "details", {}).get("retry_after_s")
    return status, body, str(max(int(retry), 1)) if retry else None


@pytest.mark.parametrize("name,kwargs", ERRORS + [(None, {})],
                         ids=[e[0] for e in ERRORS] + ["untyped"])
def test_error_handler_matches_jax(name, kwargs):
    """Status, JSON body (but its random ``error_id``) and the
    ``Retry-After`` the server derives, for each typed error."""
    assert _handled(texc, name, kwargs) == _handled(jexc, name, kwargs)


# ------------------------------------------------------------ the two servers


@contextlib.contextmanager
def fixed_uuids():
    """``uuid.uuid4`` as a counter, so both servers mint the same document
    ids in the same order."""
    counter = iter(range(1, 1 << 30))
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    try:
        yield
    finally:
        uuid.uuid4 = real


class Client:
    """``http.client`` against one server; every read has a timeout."""

    def __init__(self, port: int) -> None:
        self.port = port

    def request(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT_S)
        headers = dict(headers or {})
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
            headers.setdefault("Content-Type", "application/json")
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
        finally:
            conn.close()

    def json(self, method, path, body=None, headers=None):
        status, hdrs, data = self.request(method, path, body, headers)
        return status, hdrs, json.loads(data) if data else None

    def sse(self, payload):
        """The stream's events in order (``[DONE]`` as the string)."""
        status, hdrs, data = self.request("POST", "/chat", {**payload, "stream": True})
        events = []
        for block in data.decode().split("\n\n"):
            for line in block.splitlines():
                if line.startswith("data: "):
                    raw = line[len("data: "):]
                    events.append(raw if raw == "[DONE]" else json.loads(raw))
        return status, hdrs, events


def multipart(files, boundary="sentio-test-boundary"):
    body = b""
    for name, data in files:
        disposition = (f'form-data; name="file"; filename="{name}"' if name is not None
                       else 'form-data; name="note"')
        body += (f"--{boundary}\r\nContent-Disposition: {disposition}\r\n"
                 "Content-Type: application/octet-stream\r\n\r\n").encode() + data + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def docx_bytes(paragraphs) -> bytes:
    body = "".join(f"<w:p><w:r><w:t>{p}</w:t></w:r></w:p>" for p in paragraphs)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("word/document.xml", f"<w:document><w:body>{body}</w:body></w:document>")
    return buf.getvalue()


@pytest.fixture(scope="module")
def shared():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    lcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    docs = build_bundle(n_docs=16, n_queries=1, seed=3).documents
    return dict(enc=enc, lcfg=lcfg,
                enc_tree=np_tree(init_encoder(jax.random.PRNGKey(21), enc)),
                ce_tree=np_tree(init_cross_encoder(jax.random.PRNGKey(22), enc)),
                llama_tree=np_tree(init_llama(jax.random.PRNGKey(23), lcfg)),
                corpus="\n\n".join(d.text for d in docs))


def _jax_container(shared, tmp):
    enc, lcfg = shared["enc"], shared["lcfg"]
    js = JSettings(retrieval=JRetrievalConfig(top_k=6), rerank=JRerankConfig(top_k=3),
                   embedder=JEmbedderConfig(model_preset="tiny"),
                   generator=JGeneratorConfig(model_preset="tiny", **GEN, **ENGINE),
                   serve=JServeConfig(**SERVE), cache=JCacheConfig())
    jg = js.generator
    embedder = TpuEmbedder(js.embedder, params=shared["enc_tree"], model_config=enc)
    index = TpuDenseIndex(dim=enc.dim, dtype="float32")
    bm25 = JBM25Index()
    engine = JEngine(model_config=lcfg, params=shared["llama_tree"], max_slots=4,
                     page_size=16, max_pages_per_seq=32, prefix_cache=jg.prefix_cache,
                     pipeline_depth=jg.decode_pipeline_depth, steps_per_tick=8,
                     max_tick_steps=8)
    service = JReplicaSet([JService(engine, default_timeout_s=TIMEOUT_S)], supervise=False)
    generator = JLLMGenerator(provider=TpuProvider(service=service), config=jg)
    retriever = create_retriever(settings=js, embedder=embedder, dense_index=index,
                                 bm25_index=bm25)
    reranker = JReranker(js.rerank, params=shared["ce_tree"], model_config=enc)
    verifier = JVerifier(generator=generator, config=jg)
    graph = build_basic_graph(retriever, generator, reranker=reranker, verifier=verifier,
                              config=GraphConfig(settings=js))
    container = DependencyContainer(
        settings=js, mesh=None, embedder=embedder, dense_index=index, sparse_index=bm25,
        retriever=retriever, reranker=reranker, engine=None, generation_service=service,
        generator=generator, verifier=verifier, graph=graph,
        ingestor=JDocumentIngestor(embedder=embedder, dense_index=index, sparse_index=bm25,
                                   settings=js),
        cache_manager=JCacheManager(config=js.cache))
    handler = JChatHandler(container)
    handler._fallback = (JFallbackResponseCache(str(tmp / "jax-fallback")), JLLMFallback())
    container.override("chat_handler", handler)
    container._initialized = True
    return container


class JaxServer:
    """The JAX app in an aiohttp TestServer on a loop of its own."""

    def __init__(self, container) -> None:
        self.container = container
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="jax-server-loop",
                                       daemon=True)
        self.thread.start()
        self.server = TestServer(create_app(container=container, initialize=False),
                                 host="127.0.0.1")
        self._run(self.server.start_server())
        self.port = self.server.port

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(TIMEOUT_S)

    def close(self) -> None:
        try:
            self._run(self.server.close())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=TIMEOUT_S)


def _port_pipeline(shared):
    enc, lcfg = shared["enc"], shared["lcfg"]
    ts = Settings(retrieval=RetrievalConfig(top_k=6), rerank=RerankConfig(top_k=3),
                  embedder=EmbedderConfig(model_preset="tiny"),
                  generator=GeneratorConfig(model_preset="tiny", **GEN, **ENGINE),
                  # unsupervised, as the JAX container's set: a state a test
                  # seeds holds until it restores it
                  serve=ServeConfig(replica_supervise=False, **SERVE))
    return build_pipeline(
        ts, device="cpu", llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]))


@pytest.fixture(scope="module")
def servers(shared, tmp_path_factory):
    """Both servers, each with the corpus uploaded as one text file and one
    docx; yields ``(jax_client, port_client, jax_container, port_server)``
    and the two upload responses."""
    tmp = tmp_path_factory.mktemp("serve")
    container = _jax_container(shared, tmp)
    jserver = JaxServer(container)
    pipeline = _port_pipeline(shared)
    pipeline.warmup()
    pserver = create_server(None, pipeline, host="127.0.0.1", port=0,
                            fallback=(FallbackResponseCache(str(tmp / "port-fallback")),
                                      LLMFallback()))
    thread = threading.Thread(target=pserver.serve_forever, name="port-server", daemon=True)
    thread.start()
    jc, pc = Client(jserver.port), Client(pserver.server_address[1])
    body, headers = multipart([("corpus.txt", shared["corpus"].encode()),
                               ("notes.docx", docx_bytes(["The scheduler owns every tick.",
                                                          "Pages map to slots."])),
                               ("image.png", b"\x89PNG"), (None, b"a form field")])
    uploads = []
    for client in (jc, pc):
        with fixed_uuids():
            uploads.append(client.json("POST", "/upload", body, headers))
    try:
        yield dict(jax=jc, port=pc, container=container, server=pserver, uploads=uploads)
    finally:
        pserver.shutdown()
        pserver.server_close()
        thread.join(timeout=TIMEOUT_S)
        pipeline.close()
        jserver.close()


def _no_elapsed(entry):
    return {k: v for k, v in entry.items() if k != "elapsed_s"}


def test_upload_matches_jax(servers):
    (js, _, jbody), (ps, _, pbody) = servers["uploads"]
    assert (ps, pbody["status"]) == (js, jbody["status"]) == (200, "ok")
    assert [_no_elapsed(f) for f in pbody["files"]] == [_no_elapsed(f) for f in jbody["files"]]
    assert pbody["files"][0]["chunks_stored"] > 4
    assert pbody["files"][2] == {"filename": "image.png", "error": "unsupported type '.png'"}


def test_info_and_health_keys_match_jax(servers):
    jc, pc = servers["jax"], servers["port"]
    for path in ("/health", "/health/live", "/health/ready", "/info"):
        js, jh, jbody = jc.json("GET", path)
        ps, ph, pbody = pc.json("GET", path)
        assert ps == js == 200, path
        assert pbody.keys() == jbody.keys(), path
        assert ph["x-content-type-options"] == "nosniff"
    _, _, info = pc.json("GET", "/info")
    _, _, jinfo = jc.json("GET", "/info")
    assert info["retrieval"] == jinfo["retrieval"]
    assert info["retrieval"]["corpus_size"] > 4
    assert pc.json("GET", "/health/ready")[2] == jc.json("GET", "/health/ready")[2]


@pytest.mark.parametrize("question", QUESTIONS)
def test_chat_json_matches_jax(servers, question):
    jc, pc = servers["jax"], servers["port"]
    payload = {"question": question, "mode": "fast", "top_k": 5}
    js, _, jbody = jc.json("POST", "/chat", payload)
    ps, ph, pbody = pc.json("POST", "/chat", payload)
    assert ps == js == 200
    assert ph["content-type"].startswith("application/json")
    assert pbody["answer"] == jbody["answer"] and pbody["answer"]
    assert [s["id"] for s in pbody["sources"]] == [s["id"] for s in jbody["sources"]]
    assert [s["text"] for s in pbody["sources"]] == [s["text"] for s in jbody["sources"]]
    np.testing.assert_allclose([s["score"] for s in pbody["sources"]],
                               [s["score"] for s in jbody["sources"]], atol=SCORE_ATOL, rtol=0)
    pmeta, jmeta = pbody["metadata"], jbody["metadata"]
    assert pmeta["degraded"] is jmeta["degraded"] is False
    assert pmeta["evaluation"] == jmeta["evaluation"]
    assert set(pmeta) == set(jmeta) - LEFT_OUT_META
    for key in ("mode", "user_top_k", "num_retrieved", "num_reranked", "num_selected",
                "context_chars", "graph_path", "verdict", "retriever", "logprob_count"):
        assert pmeta[key] == jmeta[key], key


def test_sse_matches_jax(servers):
    jc, pc = servers["jax"], servers["port"]
    payload = {"question": QUESTIONS[1], "mode": "fast"}
    js, jh, jevents = jc.sse(payload)
    ps, ph, pevents = pc.sse(payload)
    assert ps == js == 200
    assert ph["content-type"].startswith("text/event-stream")
    assert ph["transfer-encoding"] == "chunked" and ph["x-request-id"]

    def shape(events):
        kinds = [e if e == "[DONE]" else next(iter(e)) for e in events]
        return [k for i, k in enumerate(kinds) if i == 0 or k != kinds[i - 1]]

    assert shape(pevents) == shape(jevents) == ["sources", "token", "verdict", "[DONE]"]
    tokens = lambda evs: "".join(e["token"] for e in evs if e != "[DONE]" and "token" in e)  # noqa: E731
    assert tokens(pevents) == tokens(jevents) and tokens(pevents)
    assert pevents[0]["sources"] == jevents[0]["sources"] or \
        [s["id"] for s in pevents[0]["sources"]] == [s["id"] for s in jevents[0]["sources"]]
    assert pevents[-2] == jevents[-2]


def test_embed_matches_jax(servers):
    jc, pc = servers["jax"], servers["port"]
    payload = {"content": "The radix tree shares prompt heads across requests. " * 20,
               "metadata": {"source": "api"}}
    with fixed_uuids():
        js, _, jbody = jc.json("POST", "/embed", payload)
    with fixed_uuids():
        ps, _, pbody = pc.json("POST", "/embed", payload)
    assert ps == js == 200
    assert pbody["status"] == jbody["status"] == "ok"
    assert _no_elapsed(pbody["stats"]) == _no_elapsed(jbody["stats"])


@pytest.mark.parametrize("case", ["empty", "not_json", "over_cap", "not_multipart",
                                  "no_file_parts", "unknown_route", "deadline_1ms",
                                  "deadline_header"])
def test_refusals_match_jax(servers, case):
    """422 bodies, 413 over the upload cap (with the files so far), the
    non-multipart refusal, 404, and a 1 ms deadline's typed error (from the
    body field and from ``X-Deadline-Ms``)."""
    jc, pc = servers["jax"], servers["port"]
    json_headers = {"Content-Type": "application/json"}
    request = {
        "empty": ("POST", "/chat", {}, None),
        "not_json": ("POST", "/chat", b"{nope", json_headers),
        "over_cap": ("POST", "/upload", *multipart([("small.txt", b"a small file"),
                                                    ("big.txt", b"x" * (1536 * 1024))])),
        "not_multipart": ("POST", "/upload", {"file": "x"}, None),
        "no_file_parts": ("POST", "/upload", *multipart([(None, b"just a field")])),
        "unknown_route": ("GET", "/nowhere", None, None),
        "deadline_1ms": ("POST", "/chat", {"question": QUESTIONS[0], "deadline_ms": 1}, None),
        "deadline_header": ("POST", "/chat", {"question": QUESTIONS[1]}, {"X-Deadline-Ms": "1"}),
    }[case]
    with fixed_uuids():
        js, jh, jdata = jc.request(*request)
    with fixed_uuids():
        ps, ph, pdata = pc.request(*request)
    assert ps == js, (case, pdata, jdata)
    if case == "unknown_route":
        assert pdata == jdata
        return
    pbody, jbody = json.loads(pdata), json.loads(jdata)
    if case == "over_cap":
        assert ps == 413
        pbody["files"] = [_no_elapsed(f) for f in pbody["files"]]
        jbody["files"] = [_no_elapsed(f) for f in jbody["files"]]
    if case.startswith("deadline"):
        assert ps == 504
        pbody["error"].pop("error_id"), jbody["error"].pop("error_id")
        assert pbody["error"]["code"] == jbody["error"]["code"] == "DEADLINE_EXCEEDED"
        return
    assert pbody == jbody
    assert ph["content-security-policy"] == "default-src 'none'"


def test_embed_rate_limit_matches_jax(servers):
    """Past ``/embed``'s per-minute limit both answer 429 with the same
    body and a ``Retry-After`` of about a minute."""
    jc, pc = servers["jax"], servers["port"]
    container, pserver = servers["container"], servers["server"]
    jlimiter = JIPRateLimiter(default=JRateLimitConfig(per_minute=100))
    jlimiter.configure("/embed", 2)
    plimiter = IPRateLimiter(default=RateLimitConfig(per_minute=100))
    plimiter.configure("/embed", 2)
    jprev, pprev = container.rate_limiter, pserver.rate_limiter
    container.override("rate_limiter", jlimiter)
    pserver.rate_limiter = plimiter
    try:
        got = []
        for client in (jc, pc):
            statuses = []
            for i in range(3):
                status, headers, body = client.json("POST", "/embed", {"content": f"doc {i}"})
                statuses.append(status)
            body["error"].pop("error_id")
            retry_s = body["error"]["details"].pop("retry_after_s")  # a clock reading
            assert 58.0 <= retry_s <= 60.0
            got.append((statuses, body, int(headers["retry-after"])))
    finally:
        container.override("rate_limiter", jprev)
        pserver.rate_limiter = pprev
    (jstat, jbody, jretry), (pstat, pbody, pretry) = got
    assert pstat == jstat == [200, 200, 429]
    assert pbody == jbody
    assert 58 <= pretry <= 60 and 58 <= jretry <= 60


def test_ladder_tier_matches_jax(servers, monkeypatch):
    """With the generator failing, both answer 200, degraded, from the
    same tier with the same text."""
    jc, pc = servers["jax"], servers["port"]
    boom = RuntimeError("decode device on fire")

    def fail(*args, **kwargs):
        raise boom

    monkeypatch.setattr(servers["container"].generator.provider, "chat", fail)
    monkeypatch.setattr(servers["server"].pipeline.generator.provider, "chat", fail)
    payload = {"question": "a question nobody asked before", "mode": "fast"}
    js, _, jbody = jc.json("POST", "/chat", payload)
    ps, _, pbody = pc.json("POST", "/chat", payload)
    assert ps == js == 200
    assert pbody["metadata"]["degraded"] is jbody["metadata"]["degraded"] is True
    assert pbody["metadata"]["tier"] == jbody["metadata"]["tier"] == "template"
    assert pbody["answer"] == jbody["answer"]
    assert pbody["metadata"]["error"] == jbody["metadata"]["error"]


@pytest.mark.parametrize("leg", ["retrieval", "rerank"])
def test_sse_degrades_as_jax(servers, monkeypatch, leg):
    """A failed retrieval turns both streams into the ladder's text as one
    token. A failed rerank keeps the retrieval order on both, and the
    port's stream says so with a ``rerank_fallback`` event after
    ``sources``, as its JSON answer does in ``metadata.rerank_fallback``."""
    jc, pc = servers["jax"], servers["port"]
    container, pipeline = servers["container"], servers["server"].pipeline

    def boom(*args, **kwargs):
        raise RuntimeError(f"{leg} leg down")

    if leg == "retrieval":
        monkeypatch.setattr(container.retriever, "retrieve", boom)
        monkeypatch.setattr(pipeline.retriever, "retrieve", boom)
    else:
        monkeypatch.setattr(container.reranker, "_score", boom)
        monkeypatch.setattr(pipeline.reranker, "_score", boom)
    payload = {"question": f"What happens when the {leg} leg is down?", "mode": "fast"}
    js, _, jevents = jc.sse(payload)
    ps, _, pevents = pc.sse(payload)
    assert ps == js == 200
    if leg == "retrieval":
        assert pevents == jevents and len(pevents) == 2 and pevents[1] == "[DONE]"
        assert pevents[0]["token"]
        return
    assert pevents[1] == {"rerank_fallback": True}
    assert all(e == "[DONE]" or "rerank_fallback" not in e for e in jevents)
    assert [s["id"] for s in pevents[0]["sources"]] == [s["id"] for s in jevents[0]["sources"]]
    tokens = lambda evs: "".join(e["token"] for e in evs if e != "[DONE]" and "token" in e)  # noqa: E731
    assert tokens(pevents) == tokens(jevents) and tokens(pevents)
    assert pevents[-2] == jevents[-2] and "verdict" in pevents[-2]
    _, _, jbody = jc.json("POST", "/chat", payload)
    _, _, pbody = pc.json("POST", "/chat", payload)
    assert pbody["metadata"]["rerank_fallback"] is jbody["metadata"]["rerank_fallback"] is True


def test_metrics_parse_and_count(servers):
    from prometheus_client.parser import text_string_to_metric_families

    pc = servers["port"]
    status, headers, data = pc.request("GET", "/metrics")
    assert status == 200 and headers["content-type"].startswith("text/plain")
    families = {f.name: f for f in text_string_to_metric_families(data.decode())}
    chats = {tuple(sorted(s.labels.items())): s.value
             for s in families["sentio_requests"].samples
             if s.name == "sentio_requests_total" and s.labels["endpoint"] == "/chat"}
    assert chats[(("endpoint", "/chat"), ("status", "200"))] >= 3
    stats = {s.labels["stat"] for s in families["sentio_tpu_serving_stat"].samples}
    assert {"active_slots", "free_pages", "max_queue"} <= stats
    assert families["sentio_tpu_tick_phase_seconds"].samples
    assert families["sentio_embeddings"].samples


def test_sse_disconnect_cancels_the_ticket(servers, monkeypatch):
    """A client that closes after its first token: the service cancels the
    ticket (no live rows left) and the next ``/chat`` answers."""
    pserver = servers["server"]
    pipeline = pserver.pipeline
    service = pipeline.service
    step = service.engine.step

    def slow_step():
        time.sleep(0.05)
        return step()

    monkeypatch.setattr(service.engine, "step", slow_step)
    monkeypatch.setattr(pipeline.generator, "config",
                        dataclasses.replace(pipeline.generator.config, max_new_tokens=256))
    cancelled0 = service.stats()["cancelled"]
    conn = http.client.HTTPConnection("127.0.0.1", pserver.server_address[1], timeout=TIMEOUT_S)
    conn.request("POST", "/chat", body=json.dumps({"question": QUESTIONS[0], "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    seen = b""
    while b'"token"' not in seen:
        line = resp.fp.readline()
        assert line, seen
        seen += line
    conn.sock.shutdown(2)
    conn.close()
    end = time.monotonic() + 30
    while time.monotonic() < end:
        stats = service.stats()
        if stats["cancelled"] > cancelled0 and stats["active_slots"] == 0:
            break
        time.sleep(0.05)
    stats = service.stats()
    assert stats["cancelled"] == cancelled0 + 1, stats
    assert stats["active_slots"] == 0
    monkeypatch.undo()
    status, _, body = servers["port"].json("POST", "/chat", {"question": QUESTIONS[1],
                                                             "mode": "fast"})
    assert status == 200 and body["answer"]


def test_sse_keepalive_during_silence(servers, monkeypatch):
    """While the decode is silent longer than ``sse_keepalive_s``, the
    stream carries ``: keepalive`` comments between its events."""
    pserver = servers["server"]
    engine = pserver.pipeline.service.engine
    step = engine.step

    def slow_step():
        time.sleep(0.5)
        return step()

    monkeypatch.setattr(engine, "step", slow_step)
    monkeypatch.setattr(pserver, "settings", dataclasses.replace(
        pserver.settings, serve=dataclasses.replace(pserver.settings.serve,
                                                    sse_keepalive_s=0.2)))
    status, headers, data = servers["port"].request(
        "POST", "/chat", {"question": QUESTIONS[0], "stream": True, "mode": "fast"})
    text = data.decode()
    assert status == 200 and ": keepalive\n\n" in text
    assert text.index('data: {"sources"') < text.index(": keepalive")
    assert text.rstrip().endswith("data: [DONE]")


def test_clear_matches_jax(servers):
    """Last of the server tests: ``/clear`` empties both indexes and
    reports the same count; ``/info`` then shows 0."""
    jc, pc = servers["jax"], servers["port"]
    js, _, jbody = jc.json("POST", "/clear")
    ps, _, pbody = pc.json("POST", "/clear")
    assert ps == js == 200
    assert pbody == jbody and pbody["documents_removed"] > 4
    assert pc.json("GET", "/info")[2]["retrieval"]["corpus_size"] == 0


# ------------------------------------------------------------------- the CLI


def test_cli_ingest_and_serve(tmp_path, monkeypatch, capsys):
    """``ingest DIR --save IDX`` prints JAX's stats (JAX's CLI with its hash
    embedder: the counts do not depend on the vectors); ``serve --index
    IDX`` in a subprocess answers ``/health`` and ``/chat`` over the loaded
    corpus and exits 0 on SIGTERM."""
    from sentio_tpu.cli import main as jax_main
    from sentio_tpu.config import set_settings

    docs = tmp_path / "docs"
    (docs / "sub").mkdir(parents=True)
    (docs / "a.md").write_text("Pages hold keys and values. " * 40)
    (docs / "sub" / "b.txt").write_text("The scheduler admits requests at ticks. " * 25)
    (docs / "c.docx").write_bytes(docx_bytes(["Slots decode together."]))
    (docs / "skip.bin").write_bytes(b"\x00")
    index = tmp_path / "idx" / "corpus"
    assert cli.main(["ingest", str(docs), "--save", str(index), "--tiny",
                     "--device", "cpu"]) == 0
    port_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("EMBEDDER_PROVIDER", "hash")
    set_settings(None)
    try:
        assert jax_main(["ingest", str(docs)]) == 0
    finally:
        # the port honours EMBEDDER_PROVIDER too: the server below must
        # embed with the bi-encoder the index was saved with
        monkeypatch.delenv("EMBEDDER_PROVIDER")
        set_settings(None)
    jax_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _no_elapsed(port_stats) == _no_elapsed(jax_stats)
    assert port_stats["chunks_stored"] > 3 and port_stats["files_skipped"] == 1

    env = {k: v for k, v in os.environ.items() if not k.startswith("PALLAS")}
    # the server's disk fallback cache lives under HOME
    env.update(LLM_MAX_TOKENS="8", PYTHONUNBUFFERED="1", HOME=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sentio_tpu_torch", "serve", "--index", str(index), "--host",
         "127.0.0.1", "--port", "0", "--tiny", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        end = time.monotonic() + TIMEOUT_S
        while "serving on" not in line and time.monotonic() < end:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()[-2000:]
        port = int(line.strip().rsplit(":", 1)[1])
        client = Client(port)
        assert client.json("GET", "/health")[0] == 200
        assert client.json("GET", "/health/ready")[2]["ready"] is True
        info = client.json("GET", "/info")[2]
        assert info["retrieval"]["corpus_size"] == port_stats["chunks_stored"]
        status, _, body = client.json("POST", "/chat", {"question": "what do pages hold?"})
        assert status == 200 and body["sources"] and body["metadata"]["degraded"] is False
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT_S)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("env,value", [("AUTH_ENABLED", "1"), ("CACHE_BACKEND", "multi_tier"),
                                       ("VERIFY_MODE", "async"), ("VERIFY_MODE", "gated")])
def test_server_refuses_unported_settings(monkeypatch, env, value):
    """Auth, the Redis cache and VERIFY_MODE=async|gated are ported and
    pass, read from JAX's env names into JAX's values; an unknown verify
    mode is JAX's ValueError."""
    from sentio_tpu.config import Settings as JSettingsEnv
    from sentio_tpu_torch.serve.app import check_serve_settings

    monkeypatch.setenv(env, value)
    check_serve_settings(Settings.from_env())
    if env == "VERIFY_MODE":
        monkeypatch.setenv(env, "eventually")
        with pytest.raises(ValueError, match="verify_mode must be one of"):
            check_serve_settings(Settings.from_env())
        return
    section = "auth" if env == "AUTH_ENABLED" else "cache"
    assert vars(getattr(Settings.from_env(), section)) == \
        vars(getattr(JSettingsEnv.from_env(), section))


# ------------------------------------------------------------- the replica tier


class _AiohttpRequest(dict):
    """What JAX's header helpers read off an aiohttp request: ``headers``
    and ``get("auth")``."""

    def __init__(self, headers) -> None:
        super().__init__()
        self.headers = headers


@pytest.mark.parametrize("headers,resumable", [
    ({}, None),
    ({"X-Tenant": "team-a"}, None),
    ({"X-Tenant": "bad tenant!"}, None),
    ({"X-Tenant": "t" * 65}, None),
    ({"X-Tenant": "a.b:c-d_e", "X-Priority": "batch"}, None),
    ({"X-Priority": " BATCH "}, None),
    ({"X-Priority": "urgent"}, None),
    ({"X-Resumable": "0"}, None),
    ({"X-Resumable": "off"}, None),
    ({"X-Resumable": "maybe"}, None),
    ({"X-Resumable": "0"}, True),
    ({}, False),
], ids=lambda v: json.dumps(v)[:30])
def test_tenant_priority_and_resumable_resolve_as_jax(headers, resumable):
    from sentio_tpu.serve import app as japp
    from sentio_tpu_torch.serve import app as tapp

    req = dataclasses.replace(tschemas.ChatRequest(question="q"), resumable=resumable)
    jreq = dataclasses.replace(jschemas.ChatRequest(question="q"), resumable=resumable)
    assert tapp._request_tenant(headers) == japp._request_tenant(_AiohttpRequest(headers))
    assert tapp._resolve_resumable(headers, req) == \
        japp._resolve_resumable(_AiohttpRequest(headers), jreq)


def _sets(servers):
    return servers["container"].generation_service, servers["server"].pipeline.replica_set


def test_chat_charges_the_header_tenant_as_jax(servers):
    """``X-Tenant`` / ``X-Priority`` reach the answer's metadata and the
    tenant's WFQ ledger alike: the generate and the verify admissions are
    both charged to it and nothing stays pending."""
    jc, pc = servers["jax"], servers["port"]
    headers = {"X-Tenant": "team-h", "X-Priority": "batch"}
    payload = {"question": QUESTIONS[0], "mode": "fast"}
    (js, _, jbody), (ps, _, pbody) = (jc.json("POST", "/chat", payload, headers),
                                      pc.json("POST", "/chat", payload, headers))
    assert ps == js == 200
    for key in ("tenant", "priority", "replica_id"):
        assert pbody["metadata"][key] == jbody["metadata"][key], key
    assert pbody["metadata"]["tenant"] == "team-h"
    jset, tset = _sets(servers)
    jt = jset.tenants.stats()["per_tenant"]["team-h"]
    tt = tset.tenants.stats()["per_tenant"]["team-h"]
    assert (tt["admitted"], tt["pending"], tt["shed"]) == \
        (jt["admitted"], jt["pending"], jt["shed"]) == (2, 0, 0)


def test_sse_precheck_sheds_the_tenant_before_200_as_jax(servers, monkeypatch):
    """A tenant at its quota is refused before the SSE status line: 429
    with the same body and ``Retry-After`` as JAX's."""
    got = []
    for client, rs in zip((servers["jax"], servers["port"]), _sets(servers)):
        monkeypatch.setattr(rs.tenants, "capacity", 1)
        monkeypatch.setattr(rs.tenants, "headroom", 0)
        rs.tenants.admit("hog", 1)
        try:
            status, headers, data = client.request(
                "POST", "/chat", {"question": QUESTIONS[0], "stream": True},
                {"X-Tenant": "hog"})
        finally:
            rs.tenants.release("hog", 1)
        body = json.loads(data)
        body["error"].pop("error_id")
        got.append((status, headers["retry-after"], headers["content-type"], body))
    assert got[1] == got[0]
    assert got[1][0] == 429 and got[1][3]["error"]["details"]["shed_reason"] == "tenant_quota"


def test_health_and_detailed_follow_replica_health_as_jax(servers):
    """A quarantined sole replica makes ``/health`` 503 ``unhealthy`` on
    both servers (back to 200 once healthy); ``/health/detailed`` has
    JAX's keys, components and a breaker per replica."""
    jc, pc = servers["jax"], servers["port"]
    sets = _sets(servers)
    for rs in sets:
        rs._transition(0, "QUARANTINED", "seeded")
    try:
        (js, _, jbody), (ps, _, pbody) = jc.json("GET", "/health"), pc.json("GET", "/health")
        assert ps == js == 503
        assert pbody["status"] == jbody["status"] == "unhealthy"
        assert pbody["replicas"].keys() == jbody["replicas"].keys()
        assert [r["state"] for r in pbody["replicas"]["replicas"]] == ["QUARANTINED"]
    finally:
        for rs in sets:
            rs._transition(0, "HEALTHY", "restored")
    assert pc.json("GET", "/health")[0] == jc.json("GET", "/health")[0] == 200
    (js, _, jbody), (ps, _, pbody) = (jc.json("GET", "/health/detailed"),
                                      pc.json("GET", "/health/detailed"))
    assert ps == js == 200
    assert pbody.keys() == jbody.keys()
    assert pbody["components"].keys() == jbody["components"].keys()
    assert pbody["status"] == jbody["status"] == "healthy"
    assert pbody["components"]["breakers"]["replica_0"]["state"] == "HEALTHY"
    assert pc.json("GET", "/health/detailed")[2]["cached"] is True


def test_metrics_have_replica_rows_as_jax(servers):
    from prometheus_client.parser import text_string_to_metric_families

    rows = []
    for client in (servers["jax"], servers["port"]):
        client.json("POST", "/chat", {"question": QUESTIONS[1], "mode": "fast"})
        status, _, data = client.request("GET", "/metrics")
        assert status == 200
        families = {f.name: f for f in text_string_to_metric_families(data.decode())}
        rows.append({(s.labels["replica"], s.labels["stat"])
                     for s in families["sentio_tpu_replica_stat"].samples})
    assert rows[1] == rows[0]
    assert ("0", "active_slots") in rows[1] and ("0", "pool_hbm_bytes") in rows[1]


def test_info_names_the_replica_tier(servers):
    info = servers["port"].json("GET", "/info")[2]
    assert info["generator"]["replicas"] == {"count": 1, "mode": "thread",
                                             "fleet": {"joined": 0, "retired": 0},
                                             "autoscale": None}


def test_two_replicas_degrade_and_recover_over_http(shared):
    """``REPLICAS=2``: one quarantined replica is ``degraded`` with 200, both
    ``unhealthy`` with 503; chats go on while one serves; ``/metrics`` has
    a row set per replica and ``/info`` names two."""
    enc, lcfg = shared["enc"], shared["lcfg"]
    ts = Settings(retrieval=RetrievalConfig(top_k=6), rerank=RerankConfig(top_k=3),
                  embedder=EmbedderConfig(model_preset="tiny"),
                  generator=GeneratorConfig(model_preset="tiny", **GEN, **ENGINE),
                  serve=ServeConfig(replicas=2, replica_supervise=False, **SERVE))
    pipeline = build_pipeline(
        ts, device="cpu", llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]))
    server = create_server(None, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name="two-replica-server",
                              daemon=True)
    thread.start()
    client, rs = Client(server.server_address[1]), pipeline.replica_set
    try:
        client.json("POST", "/embed", {"content": shared["corpus"][:4000]})
        rs._transition(1, "QUARANTINED", "seeded")
        status, _, body = client.json("GET", "/health")
        assert (status, body["status"], body["replicas"]["serving_replicas"]) == \
            (200, "degraded", 1)
        status, _, answer = client.json("POST", "/chat", {"question": QUESTIONS[0],
                                                          "mode": "fast"})
        assert status == 200 and answer["metadata"]["replica_id"] == 0
        assert not answer["metadata"]["degraded"]
        rs._transition(0, "QUARANTINED", "seeded")
        status, _, body = client.json("GET", "/health")
        assert (status, body["status"]) == (503, "unhealthy")
        status, headers, body = client.json("POST", "/chat", {"question": QUESTIONS[1]})
        assert status == 503 and headers["retry-after"]
        assert body["error"]["code"] == "SERVICE_UNAVAILABLE"
        for i in (0, 1):
            rs._transition(i, "HEALTHY", "restored")
        assert client.json("GET", "/health")[2]["status"] == "healthy"
        text = client.request("GET", "/metrics")[2].decode()
        for i in (0, 1):
            assert f'sentio_tpu_replica_stat{{replica="{i}",stat="active_slots"}}' in text
        assert client.json("GET", "/info")[2]["generator"]["replicas"]["count"] == 2
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT_S)
        pipeline.close()


# ------------------------------------------------------- auth, the page, metrics off

AUTH_SECRET = "shared-test-secret"
USERS = (("ada", "Str0ngPassword!", "user"), ("root", "Adm1nPassword!!", "admin"))


@contextlib.contextmanager
def auth_on(servers):
    """Both servers with auth on for the block: one ``AuthManager`` each,
    the same secret and users, restored to off afterwards."""
    from sentio_tpu.config import AuthConfig as JAuthConfig
    from sentio_tpu.infra.auth import AuthManager as JAuthManager
    from sentio_tpu_torch.config import AuthConfig
    from sentio_tpu_torch.infra.auth import AuthManager

    jauth = JAuthManager(JAuthConfig(enabled=True, jwt_secret=AUTH_SECRET))
    tauth = AuthManager(AuthConfig(enabled=True, jwt_secret=AUTH_SECRET))
    for name, password, role in USERS:
        jauth.create_user(name, password, role)
        tauth.create_user(name, password, role)
    servers["container"].override("auth_manager", jauth)
    servers["server"].auth_manager = tauth
    try:
        yield jauth, tauth
    finally:
        servers["container"].override("auth_manager", None)
        servers["server"].auth_manager = None


def _bearer(token):
    return {"Authorization": f"Bearer {token}"}


@pytest.mark.parametrize("method,path,headers", [
    ("POST", "/chat", {}),
    ("POST", "/chat", {"Authorization": "Bearer not.a.token"}),
    ("POST", "/chat", {"Authorization": "Basic abc"}),
    ("POST", "/chat", {"X-API-Key": "stk_nope"}),
    ("POST", "/embed", {}),
    ("POST", "/upload", {}),
    ("GET", "/info", {}),
    ("GET", "/debug/flight/some-id", {}),
    ("GET", "/nowhere", {}),
], ids=lambda v: json.dumps(v)[:30])
def test_auth_refuses_as_jax(servers, method, path, headers):
    """Without a good credential every gated path answers JAX's 401 body,
    with the security headers, and no chat runs."""
    jc, pc = servers["jax"], servers["port"]
    with auth_on(servers):
        launches = servers["server"].pipeline.embedder.forwards
        body = {"question": QUESTIONS[0]} if path == "/chat" else None
        js, jh, jbody = jc.json(method, path, body, headers)
        ps, ph, pbody = pc.json(method, path, body, headers)
        assert (ps, pbody) == (js, jbody)
        assert ps == 401 and pbody["error"] in ("missing credentials", "invalid credentials")
        assert ph["content-type"] == jh["content-type"]
        assert ph["x-content-type-options"] == "nosniff"
        assert servers["server"].pipeline.embedder.forwards == launches


@pytest.mark.parametrize("path", ["/health", "/health/live", "/health/ready", "/metrics", "/"])
def test_open_paths_answer_without_a_token_as_jax(servers, path):
    jc, pc = servers["jax"], servers["port"]
    with auth_on(servers):
        (js, _, jbody), (ps, _, pbody) = jc.request("GET", path), pc.request("GET", path)
        assert ps == js == 200
        if path == "/":
            assert pbody == jbody


def test_auth_token_and_the_tenant_key_as_jax(servers, monkeypatch):
    """``/auth/token`` gives a token pair whose claims equal JAX's (and
    whose tokens verify on the other server: one secret); a bad password is
    JAX's 401; an authenticated chat is answered and charged to
    ``user:<sub>`` whatever ``X-Tenant`` says, in the answer's metadata and
    the tenant ledger; an API key works as a token does."""
    from sentio_tpu.infra.auth import JWT as JJWT

    jc, pc = servers["jax"], servers["port"]
    with auth_on(servers) as (jauth, tauth):
        tokens = {}
        for name, client in (("jax", jc), ("port", pc)):
            status, _, body = client.json("POST", "/auth/token",
                                          {"username": "ada", "password": USERS[0][1]})
            assert status == 200 and body["token_type"] == "bearer"
            tokens[name] = body
        claims = {k: {c: v for c, v in JJWT(AUTH_SECRET).decode(t["access_token"]).items()
                      if c not in ("iat", "exp")} for k, t in tokens.items()}
        assert claims["port"] == claims["jax"] == {"sub": "ada", "role": "user",
                                                   "scopes": ["read", "chat", "embed"],
                                                   "type": "access"}
        for client in (jc, pc):
            status, _, body = client.json("POST", "/auth/token",
                                          {"username": "ada", "password": "Wrong-Password-1"})
            assert status == 401 and body["error"]["code"] == "UNAUTHORIZED"
            assert body["error"]["message"] == "invalid credentials"
        spoof = {"X-Tenant": "someone-else"}
        payload = {"question": QUESTIONS[1], "mode": "fast"}
        # each server takes the other's token: the secret is shared
        (js, _, jbody), (ps, _, pbody) = (
            jc.json("POST", "/chat", payload, {**_bearer(tokens["port"]["access_token"]),
                                               **spoof}),
            pc.json("POST", "/chat", payload, {**_bearer(tokens["jax"]["access_token"]),
                                               **spoof}))
        assert ps == js == 200
        assert pbody["metadata"]["tenant"] == jbody["metadata"]["tenant"] == "user:ada"
        assert pbody["answer"] == jbody["answer"]
        jset, tset = _sets(servers)
        assert tset.tenants.stats()["per_tenant"]["user:ada"]["admitted"] == \
            jset.tenants.stats()["per_tenant"]["user:ada"]["admitted"] >= 1
        assert "someone-else" not in tset.tenants.stats()["per_tenant"]
        key = tauth.create_api_key("root")
        status, _, body = pc.json("POST", "/chat", payload, {"X-API-Key": key})
        assert status == 200 and body["metadata"]["tenant"] == "user:root"


def test_request_tenant_takes_the_principal_as_jax():
    from sentio_tpu.serve import app as japp
    from sentio_tpu_torch.serve import app as tapp

    for auth in (None, {}, {"sub": ""}, {"sub": "ada"}, {"sub": "x y", "role": "admin"}):
        for headers in ({}, {"X-Tenant": "team-a", "X-Priority": "batch"}):
            request = _AiohttpRequest(headers)
            if auth is not None:
                request["auth"] = auth
            assert tapp._request_tenant(headers, auth) == japp._request_tenant(request)


def test_auth_token_is_404_while_auth_is_off_as_jax(servers):
    jc, pc = servers["jax"], servers["port"]
    payload = {"username": "ada", "password": "x"}
    (js, _, jbody), (ps, _, pbody) = (jc.json("POST", "/auth/token", payload),
                                      pc.json("POST", "/auth/token", payload))
    assert (ps, pbody) == (js, jbody) == (404, {"error": "auth disabled"})


def test_ui_page_matches_jax(servers):
    """``GET /``: JAX's page byte for byte, as HTML, under its own
    Content-Security-Policy; the rest of the security headers as on every
    response."""
    (js, jh, jbody), (ps, ph, pbody) = (servers["jax"].request("GET", "/"),
                                        servers["port"].request("GET", "/"))
    assert (ps, pbody) == (js, jbody) and ps == 200 and b"<title>sentio-tpu</title>" in pbody
    for header in ("content-type", "content-security-policy", "x-frame-options"):
        assert ph[header] == jh[header], header


def test_server_serves_with_metrics_disabled_as_jax(servers):
    """``METRICS_ENABLED=0``: JAX's server serves with its families
    recorded, and so does the port's (a second server over the same
    pipeline)."""
    pipeline = servers["server"].pipeline
    settings = dataclasses.replace(
        pipeline.settings,
        observability=dataclasses.replace(pipeline.settings.observability,
                                          metrics_enabled=False))
    server = create_server(settings, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name="metrics-off-server",
                              daemon=True)
    thread.start()
    try:
        client = Client(server.server_address[1])
        status, _, body = client.json("POST", "/chat", {"question": QUESTIONS[0],
                                                        "mode": "fast"})
        assert status == 200 and body["answer"]
        port_text = client.request("GET", "/metrics")[2].decode()
        jax_text = servers["jax"].request("GET", "/metrics")[2].decode()
        for family in ("sentio_requests_total", "sentio_request_latency_seconds"):
            assert family in port_text and family in jax_text
        assert 'endpoint="/chat"' in port_text
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT_S)


def test_chat_under_multi_tier_uses_l1_only_as_jax(servers):
    """``CACHE_BACKEND=multi_tier``: the ``/chat`` handler fills and reads
    the query cache through the L1 surface alone, as JAX's does — no
    command reaches Redis during a chat."""
    from test_torch_redis_cache import LoopThread
    from test_redis_cache import FakeRedis

    from sentio_tpu_torch.config import CacheConfig
    from sentio_tpu_torch.infra.caching import CacheManager
    from sentio_tpu_torch.serve.handlers import ChatHandler

    lt = LoopThread()
    redis = FakeRedis()
    lt.run(redis.start())
    try:
        manager = CacheManager(CacheConfig(backend="multi_tier",
                                           redis_url=f"redis://127.0.0.1:{redis.port}/0"))
        handler = ChatHandler(servers["server"].pipeline, cache_manager=manager,
                              fallback=servers["server"].chat_handler.fallback)
        out = handler.process_chat_request_sync(question=QUESTIONS[0], mode="fast")
        assert out["answer"] and manager.get_query_response(QUESTIONS[0])["answer"] == \
            out["answer"]
        assert redis.commands == [] and manager.multi_tier
        manager.close()
    finally:
        lt.run(redis.stop())
        lt.close()


def test_health_detailed_lists_registered_breakers_as_jax(servers):
    """``/health/detailed``'s ``breakers`` carry each registered
    ``CircuitBreaker`` (a store's) as JAX's do, beside the replica tier's
    (``replica_0``); the report is recomputed after its cache time."""
    from sentio_tpu.infra.resilience import CircuitBreaker as JCircuitBreaker
    from sentio_tpu_torch.infra.resilience import CircuitBreaker, unregister_breaker

    jc, pc = servers["jax"], servers["port"]
    name = "qdrant:serve-test"
    breakers = [CircuitBreaker(name=name, failure_threshold=2),
                JCircuitBreaker(name=name, failure_threshold=2)]
    for b in breakers:
        b.record_success()
        b.record_failure()
        b.record_failure()
    for handler in (servers["server"].health_handler,
                    servers["container"].health_handler):
        handler._cached = None
    try:
        (js, _, jbody), (ps, _, pbody) = (jc.json("GET", "/health/detailed"),
                                          pc.json("GET", "/health/detailed"))
        assert ps == js == 200
        got, want = pbody["components"]["breakers"], jbody["components"]["breakers"]
        assert got[name] == want[name] and got[name]["state"] == "open"
        assert got["replica_0"]["state"] == "HEALTHY" and "replica_0" not in want
    finally:
        unregister_breaker(breakers[0])
