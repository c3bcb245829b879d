"""``VERIFY_MODE=sync|async|gated`` in the port against the JAX graph and
server, on the same tiny float32 weights (greedy ``mode: fast``).

* ``confidence_score`` and ``retrieval_support`` equal JAX's on a
  hypothesis grid (``None`` logprobs stay ``None``);
* the flight recorder's request table behaves as JAX's under one sequence
  of calls (merging, summed node timings, a verify on a finished record,
  LRU eviction);
* ``ChatPipeline.run`` under sync, async and gated (threshold 0 and 1.01)
  against ``build_basic_graph`` in the same mode: the same answer, graph
  path, ``verify_pending`` / ``verify_skipped`` / ``verify_confidence``,
  verdict (a detached one read off each side's flight record) and verify
  admissions on the generation service (none when the gate skips);
* the HTTP servers side by side (the port's ``create_server`` and JAX's
  aiohttp app): JSON ``/chat`` answers before its audit with
  ``verify_pending``, ``/debug/flight/{id}`` then serves the verdict (404
  for an unknown id), SSE sends ``[DONE]`` and then a ``verify`` event,
  and the gate at threshold 0 sends ``skipped_confident`` with no audit.

Every join has a timeout."""

import asyncio
import dataclasses
import http.client
import json
import math
import threading
import time

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import RerankConfig as JRerankConfig
from sentio_tpu.config import RetrievalConfig as JRetrievalConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.eval.dataset import build_bundle
from sentio_tpu.graph.executor import wait_detached as jax_wait_detached
from sentio_tpu.graph.factory import GraphConfig, build_basic_graph
from sentio_tpu.graph.state import create_initial_state
from sentio_tpu.infra import flight as jflight
from sentio_tpu.models.cross_encoder import init_cross_encoder
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder
from sentio_tpu.ops import confidence as jconf
from sentio_tpu.ops.bm25 import BM25Index as JBM25Index
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu.ops.embedder import TpuEmbedder
from sentio_tpu.ops.generator import LLMGenerator as JLLMGenerator
from sentio_tpu.ops.generator import TpuProvider
from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
from sentio_tpu.ops.retrievers import create_retriever
from sentio_tpu.ops.verifier import AnswerVerifier as JVerifier
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu_torch.config import (
    EmbedderConfig,
    GeneratorConfig,
    RerankConfig,
    RetrievalConfig,
    Settings,
)
from sentio_tpu_torch.infra import flight as tflight
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops import confidence as tconf
from sentio_tpu_torch.pipeline import build_pipeline, wait_detached
from sentio_tpu_torch.runtime import weights

TIMEOUT_S = 120.0
GEN = dict(max_new_tokens=16, verifier_max_tokens=12, context_token_budget=120,
           decode_steps_per_tick=8, decode_max_tick_steps=8, dtype="float32",
           max_batch_size=4, kv_page_size=16, kv_max_pages_per_seq=32)
QUESTION = "Who maintains the ingest pipeline?"
# (mode, threshold): always-verify, detached, the gate skipping every
# answer (threshold 0) and none (above any score)
MODES = [("sync", 0.75), ("async", 0.75), ("gated", 0.0), ("gated", 1.01)]


# ------------------------------------------------------------ confidence


class _Doc:
    def __init__(self, score):
        self._score = score

    def score(self):
        return self._score


_logprob = st.one_of(st.none(), st.floats(min_value=-30.0, max_value=2.0, allow_nan=False))
_scores = st.lists(st.floats(min_value=-5.0, max_value=5.0, allow_nan=False), max_size=6)


@settings(max_examples=200, deadline=None)
@given(mean=_logprob, worst=_logprob, scores=_scores)
def test_confidence_score_matches_jax(mean, worst, scores):
    docs = [_Doc(s) for s in scores]
    got = tconf.confidence_score(mean, worst, docs)
    ref = jconf.confidence_score(mean, worst, docs)
    assert (got is None) == (ref is None) == (mean is None)
    if ref is not None:
        assert got == ref and 0.0 <= got <= 1.0
    assert tconf.retrieval_support(docs) == jconf.retrieval_support(docs)
    assert (tconf.WEIGHT_MEAN, tconf.WEIGHT_MIN, tconf.WEIGHT_RETRIEVAL) == \
        (jconf.WEIGHT_MEAN, jconf.WEIGHT_MIN, jconf.WEIGHT_RETRIEVAL)


# ------------------------------------------------------------- the recorder


def _drive(recorder):
    """One sequence of request-table calls; returns what a reader sees."""
    recorder.start_request("a", endpoint="/chat", mode="fast")
    recorder.annotate("a", question_chars=7)
    recorder.add_node_timings("a", {"retrieve": 1.5, "generate": 2.0}, ["retrieve", "generate"])
    recorder.add_node_timings("a", {"generate": 0.25})
    recorder.finish_request("a", status="done", latency_ms=12.5)
    recorder.note_verify("a", mode="async", outcome="warn", verdict_ms=3.0)
    recorder.note_verify("ghost", mode="gated", outcome="skipped_confident")
    recorder.start_request("a", endpoint="/chat")  # a finished id starts afresh
    recorder.finish_request("missing", status="done")
    for i in range(5):
        recorder.start_request(f"r{i}")
    strip = lambda r: {k: v for k, v in (r or {}).items() if k != "t_start_s"}  # noqa: E731
    return ({k: strip(recorder.get(k)) for k in ("a", "ghost", "r0", "r4", "missing")},
            [strip(r) for r in recorder.records()], recorder.dropped_requests)


def test_flight_request_table_matches_jax():
    got = _drive(tflight.FlightRecorder(max_requests=4))
    ref = _drive(jflight.FlightRecorder(max_requests=4))
    assert got == ref
    recorder = tflight.FlightRecorder()
    recorder.start_request("x")
    recorder.clear()
    assert recorder.get("x") is None and recorder.records() == []


# ------------------------------------------------------- the pipeline, modes


@pytest.fixture(scope="module")
def shared():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    lcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(enc=enc, lcfg=lcfg,
                enc_tree=np_tree(init_encoder(jax.random.PRNGKey(21), enc)),
                ce_tree=np_tree(init_cross_encoder(jax.random.PRNGKey(22), enc)),
                llama_tree=np_tree(init_llama(jax.random.PRNGKey(23), lcfg)),
                docs=build_bundle(n_docs=16, n_queries=1, seed=3).documents)


class Counted:
    """Counts a service's blocking admissions (each generate and each
    verify goes through ``generate``)."""

    def __init__(self, service):
        self.calls = 0
        self._generate = service.generate
        service.generate = self

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self._generate(*args, **kwargs)


@pytest.fixture(scope="module")
def sides(shared):
    """The JAX parts (a graph per mode is built on demand) and the port's
    pipeline over the same weights, corpus and settings; the port's
    settings are switched per mode (the pipeline reads them at each run)."""
    enc, lcfg, docs = shared["enc"], shared["lcfg"], shared["docs"]
    js = JSettings(retrieval=JRetrievalConfig(top_k=6), rerank=JRerankConfig(top_k=3),
                   embedder=JEmbedderConfig(model_preset="tiny", coalesce=False, cache_size=0),
                   generator=JGeneratorConfig(model_preset="tiny", **GEN))
    embedder = TpuEmbedder(js.embedder, params=shared["enc_tree"], model_config=enc)
    index = TpuDenseIndex(dim=enc.dim, dtype="float32")
    index.add(docs, embedder.embed_many([d.text for d in docs]))
    jg = js.generator
    engine = JEngine(model_config=lcfg, params=shared["llama_tree"], max_slots=4, page_size=16,
                     max_pages_per_seq=32, prefix_cache=jg.prefix_cache,
                     pipeline_depth=jg.decode_pipeline_depth, steps_per_tick=8,
                     max_tick_steps=8)
    jservice = JService(engine, default_timeout_s=TIMEOUT_S)
    generator = JLLMGenerator(provider=TpuProvider(service=jservice), config=jg)
    jax_parts = dict(
        settings=js, service=jservice, generator=generator, embedder=embedder, index=index,
        bm25=JBM25Index().build(index.documents()),
        reranker=JReranker(js.rerank, params=shared["ce_tree"], model_config=enc),
        verifier=JVerifier(generator=generator, config=jg), counted=Counted(jservice))
    jax_parts["retriever"] = create_retriever(settings=js, embedder=embedder, dense_index=index,
                                              bm25_index=jax_parts["bm25"])

    ts = Settings(retrieval=RetrievalConfig(top_k=6), rerank=RerankConfig(top_k=3),
                  embedder=EmbedderConfig(model_preset="tiny"),
                  generator=GeneratorConfig(model_preset="tiny", **GEN))
    pipeline = build_pipeline(
        ts, device="cpu", llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]))
    pipeline.ingest([Document(text=d.text, metadata=dict(d.metadata), id=d.id) for d in docs])
    port_counted = Counted(pipeline.service)
    try:
        yield dict(jax=jax_parts, port=pipeline, port_counted=port_counted)
    finally:
        assert wait_detached(TIMEOUT_S) and jax_wait_detached(TIMEOUT_S)
        pipeline.close()
        jservice.close()


def jax_graph(parts, mode, threshold):
    js = dataclasses.replace(parts["settings"], generator=dataclasses.replace(
        parts["settings"].generator, verify_mode=mode, verify_confidence_threshold=threshold))
    return build_basic_graph(parts["retriever"], parts["generator"], reranker=parts["reranker"],
                             verifier=parts["verifier"],
                             config=GraphConfig(settings=js, verify_mode=mode))


def set_port_mode(pipeline, mode, threshold):
    pipeline.settings.generator.verify_mode = mode
    pipeline.settings.generator.verify_confidence_threshold = threshold


def _final_verdict(recorder, state, query_id):
    """The state's verdict, or a detached one off the flight record."""
    verdict = (state.get("evaluation") or {}).get("verdict")
    if verdict is None and state["metadata"].get("verify_pending"):
        return (recorder.get(query_id) or {}).get("verify", {}).get("outcome")
    return verdict


@pytest.mark.parametrize("mode,threshold", MODES, ids=[f"{m}-{t}" for m, t in MODES])
def test_pipeline_verify_modes_match_jax(sides, mode, threshold):
    parts, pipeline = sides["jax"], sides["port"]
    graph = jax_graph(parts, mode, threshold)
    set_port_mode(pipeline, mode, threshold)
    try:
        jcount, tcount = parts["counted"].calls, sides["port_counted"].calls
        qid = f"modes-{mode}-{threshold}"
        ref = graph.invoke(create_initial_state(QUESTION, metadata={"mode": "fast",
                                                                    "query_id": qid}))
        got = pipeline.run(QUESTION, mode="fast", metadata={"mode": "fast", "query_id": qid})
        assert jax_wait_detached(TIMEOUT_S) and wait_detached(TIMEOUT_S)
        jmeta, tmeta = ref["metadata"], got["metadata"]
        assert got["response"] == ref["response"] and got["response"]
        assert tmeta["graph_path"] == jmeta["graph_path"]
        for key in ("verify_pending", "verify_skipped", "verdict"):
            assert tmeta.get(key) == jmeta.get(key), key
        assert (tmeta.get("verify_confidence") is None) == (jmeta.get("verify_confidence")
                                                            is None)
        if jmeta.get("verify_confidence") is not None:
            assert math.isclose(tmeta["verify_confidence"], jmeta["verify_confidence"],
                                abs_tol=2e-4)
        assert set(got["evaluation"]) == set(ref["evaluation"])
        assert got["evaluation"].get("verdict") == ref["evaluation"].get("verdict")
        jrec = jflight.get_flight_recorder().get(qid)["verify"]
        trec = tflight.get_flight_recorder().get(qid)["verify"]
        assert set(trec) == set(jrec)
        assert {k: trec[k] for k in ("mode", "outcome")} == {k: jrec[k] for k in ("mode",
                                                                                "outcome")}
        assert trec.get("skipped") == jrec.get("skipped")
        assert _final_verdict(tflight.get_flight_recorder(), got, qid) == \
            _final_verdict(jflight.get_flight_recorder(), ref, qid)
        admissions = (parts["counted"].calls - jcount, sides["port_counted"].calls - tcount)
        assert admissions[0] == admissions[1] == (1 if (mode, threshold) == ("gated", 0.0)
                                                  else 2)
        if mode == "gated" and threshold == 0.0:
            assert got["evaluation"]["verdict"] == "skipped_confident"
            assert trec["outcome"] == "skipped_confident"
        if mode in ("async", "gated") and (mode, threshold) != ("gated", 0.0):
            assert tmeta["verify_pending"] is True and not got["evaluation"]
    finally:
        set_port_mode(pipeline, "sync", 0.75)


def test_chat_under_async_returns_the_query_id(sides):
    """``chat`` gives a caller without a query id one, under which the
    detached verdict lands; an unknown mode raises JAX's ValueError."""
    pipeline = sides["port"]
    set_port_mode(pipeline, "async", 0.75)
    try:
        out = pipeline.chat(QUESTION, mode="fast")
        assert wait_detached(TIMEOUT_S)
        meta = out["metadata"]
        assert meta["verify_pending"] is True and out["verification"] == {}
        record = tflight.get_flight_recorder().get(meta["query_id"])
        assert record["verify"]["mode"] == "async" and record["verify"]["outcome"]
        pipeline.settings.generator.verify_mode = "later"
        with pytest.raises(ValueError, match="verify_mode must be one of"):
            pipeline.run(QUESTION, mode="fast")
    finally:
        set_port_mode(pipeline, "sync", 0.75)


def test_close_joins_a_running_detached_verify(shared):
    """A detached verify still decoding when the pipeline closes is joined
    (bounded) before the service stops; one that outlives the join ends as
    a ``warn`` verdict carrying the closed service's typed error, and
    nothing raises."""
    enc, lcfg = shared["enc"], shared["lcfg"]
    ts = Settings(embedder=EmbedderConfig(model_preset="tiny"),
                  generator=GeneratorConfig(model_preset="tiny", **{**GEN,
                                                                    "verify_mode": "async"}))
    pipeline = build_pipeline(
        ts, device="cpu", llama_config=LlamaConfig(**dataclasses.asdict(lcfg)),
        embedder_config=EncoderConfig(**dataclasses.asdict(enc)),
        reranker_config=EncoderConfig(**dataclasses.asdict(enc)),
        llama_params=weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]))
    pipeline.ingest([Document(text=d.text, metadata=dict(d.metadata), id=d.id)
                     for d in shared["docs"]])
    service = pipeline.service
    gate = threading.Event()
    generate = service.generate

    def slow(prompt, **kwargs):  # the verify admission waits for the close
        if "verdict" in prompt:
            gate.wait(TIMEOUT_S)
        return generate(prompt, **kwargs)

    service.generate = slow
    out = pipeline.chat(QUESTION, mode="fast")
    qid = out["metadata"]["query_id"]
    closer = threading.Thread(target=pipeline.close, kwargs={"detached_timeout_s": 0.2},
                              name="test-close")
    closer.start()
    closer.join(timeout=TIMEOUT_S)
    gate.set()
    assert not closer.is_alive()
    assert wait_detached(TIMEOUT_S)
    verify = tflight.get_flight_recorder().get(qid)["verify"]
    assert verify["outcome"] == "warn"
    assert service.closed


# ---------------------------------------------------------- the two servers


def _no_volatile(meta):
    """Metadata keys both servers write, less timings, ids and the keys of
    features the port leaves out (the tenant tier's, the replica tier's)."""
    drop = {"tenant", "priority", "replica_id"}
    return {k: v for k, v in meta.items() if k not in drop}


class Client:
    """``http.client`` against one server; every read has a timeout."""

    def __init__(self, port: int) -> None:
        self.port = port

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT_S)
        headers = {}
        if body is not None:
            body = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def json(self, method, path, body=None):
        status, data = self.request(method, path, body)
        return status, json.loads(data) if data else None

    def sse(self, payload):
        """The stream's events in order (``[DONE]`` as the string)."""
        status, data = self.request("POST", "/chat", {**payload, "stream": True})
        events = []
        for line in data.decode().splitlines():
            if line.startswith("data: "):
                raw = line[len("data: "):]
                events.append(raw if raw == "[DONE]" else json.loads(raw))
        return status, events

    def verdict(self, request_id):
        """Poll ``/debug/flight/{id}`` until its verify section has an
        outcome."""
        end = time.monotonic() + TIMEOUT_S
        while time.monotonic() < end:
            status, record = self.json("GET", f"/debug/flight/{request_id}")
            if status == 200 and record.get("verify", {}).get("outcome"):
                return record
            time.sleep(0.02)
        raise AssertionError(f"no verdict for {request_id}")


class JaxServer:
    """The JAX app in an aiohttp TestServer on a loop of its own."""

    def __init__(self, container) -> None:
        from aiohttp.test_utils import TestServer

        from sentio_tpu.serve.app import create_app

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


@pytest.fixture(scope="module")
def servers(sides, tmp_path_factory):
    """The JAX app over a container of the JAX parts (its graph replaced
    per mode, its settings switched for the SSE path) and the port's
    server over the port pipeline (its settings switched)."""
    from sentio_tpu.infra.caching import CacheManager as JCacheManager
    from sentio_tpu.infra.resilience import FallbackResponseCache as JFallbackResponseCache
    from sentio_tpu.infra.resilience import LLMFallback as JLLMFallback
    from sentio_tpu.ops.ingest import DocumentIngestor as JDocumentIngestor
    from sentio_tpu.serve.dependencies import DependencyContainer
    from sentio_tpu.serve.handlers import ChatHandler as JChatHandler
    from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
    from sentio_tpu_torch.serve.app import create_server

    tmp = tmp_path_factory.mktemp("verify-modes")
    parts, pipeline = sides["jax"], sides["port"]
    js = parts["settings"]
    container = DependencyContainer(
        settings=js, mesh=None, embedder=parts["embedder"], dense_index=parts["index"],
        sparse_index=parts["bm25"], retriever=parts["retriever"], reranker=parts["reranker"],
        engine=None, generation_service=parts["service"], generator=parts["generator"],
        verifier=parts["verifier"], graph=jax_graph(parts, "sync", 0.75),
        ingestor=JDocumentIngestor(embedder=parts["embedder"], dense_index=parts["index"],
                                   sparse_index=parts["bm25"], settings=js),
        cache_manager=JCacheManager(config=js.cache))
    handler = JChatHandler(container)
    handler._fallback = (JFallbackResponseCache(str(tmp / "jax-fallback")), JLLMFallback())
    container.override("chat_handler", handler)
    container._initialized = True
    jserver = JaxServer(container)
    pserver = create_server(None, pipeline, host="127.0.0.1", port=0,
                            fallback=(FallbackResponseCache(str(tmp / "port-fallback")),
                                      LLMFallback()))
    thread = threading.Thread(target=pserver.serve_forever, name="port-server", daemon=True)
    thread.start()

    def switch(mode, threshold):
        container.override("graph", jax_graph(parts, mode, threshold))
        js.generator.verify_mode = mode
        js.generator.verify_confidence_threshold = threshold
        set_port_mode(pipeline, mode, threshold)

    try:
        yield dict(jax=Client(jserver.port), port=Client(pserver.server_address[1]),
                   switch=switch)
    finally:
        switch("sync", 0.75)
        assert wait_detached(TIMEOUT_S) and jax_wait_detached(TIMEOUT_S)
        pserver.shutdown()
        pserver.server_close()
        thread.join(timeout=TIMEOUT_S)
        jserver.close()


def test_http_async_json_and_flight_match_jax(servers):
    """The answer comes back before its audit with ``verify_pending`` and no
    evaluation; ``/debug/flight/{id}`` then serves the verdict; an unknown
    id is a 404 with JAX's body."""
    servers["switch"]("async", 0.75)
    out = {}
    for side in ("jax", "port"):
        client = servers[side]
        status, body = client.json("POST", "/chat", {"question": QUESTION, "mode": "fast",
                                                     "thread_id": f"http-async-{side}"})
        assert status == 200, body
        record = client.verdict(f"http-async-{side}")
        out[side] = (body, record)
    (jbody, jrec), (tbody, trec) = out["jax"], out["port"]
    assert tbody["answer"] == jbody["answer"] and tbody["answer"]
    assert tbody["metadata"]["verify_pending"] is jbody["metadata"]["verify_pending"] is True
    assert "evaluation" not in tbody["metadata"] and "evaluation" not in jbody["metadata"]
    assert _no_volatile(tbody["metadata"]).keys() == _no_volatile(jbody["metadata"]).keys()
    assert trec["status"] == jrec["status"] == "done"
    assert trec["endpoint"] == jrec["endpoint"] == "/chat"
    assert set(trec["verify"]) == set(jrec["verify"])
    assert (trec["verify"]["mode"], trec["verify"]["outcome"]) == \
        (jrec["verify"]["mode"], jrec["verify"]["outcome"])
    assert trec["graph_path"] == jrec["graph_path"]
    assert servers["port"].json("GET", "/debug/flight/nope") == \
        servers["jax"].json("GET", "/debug/flight/nope")
    assert servers["port"].json("GET", "/debug/flight/nope")[0] == 404


@pytest.mark.parametrize("mode,threshold", [("async", 0.75), ("gated", 1.01)])
def test_http_detached_sse_matches_jax(servers, mode, threshold):
    """SSE sends ``[DONE]`` as soon as the answer is complete, then the
    trailing ``verify`` event, as JAX's server does."""
    servers["switch"](mode, threshold)
    events = {side: servers[side].sse({"question": QUESTION, "mode": "fast"})
              for side in ("jax", "port")}
    (js_, jev), (ps, pev) = events["jax"], events["port"]
    kinds = lambda ev: [e if e == "[DONE]" else next(iter(e)) for e in ev]  # noqa: E731
    assert ps == js_ == 200
    assert kinds(pev) == kinds(jev)
    assert kinds(pev)[-2:] == ["[DONE]", "verify"]
    tokens = lambda ev: "".join(e["token"] for e in ev if isinstance(e, dict)  # noqa: E731
                                and "token" in e)
    assert tokens(pev) == tokens(jev) and tokens(pev)
    assert set(pev[-1]["verify"]) == set(jev[-1]["verify"])
    assert pev[-1]["verify"]["verdict"] == jev[-1]["verify"]["verdict"]


def test_http_gate_at_zero_skips_every_audit_as_jax(servers, sides):
    """Threshold 0: JSON and SSE carry the typed ``skipped_confident``
    verdict and the services make no verify admission."""
    servers["switch"]("gated", 0.0)
    counts = (sides["jax"]["counted"].calls, sides["port_counted"].calls)
    out = {side: servers[side].json("POST", "/chat", {"question": QUESTION, "mode": "fast"})
           for side in ("jax", "port")}
    streams = {side: servers[side].sse({"question": QUESTION, "mode": "fast"})
               for side in ("jax", "port")}
    assert wait_detached(TIMEOUT_S) and jax_wait_detached(TIMEOUT_S)
    (js_, jbody), (ps, pbody) = out["jax"], out["port"]
    assert ps == js_ == 200
    jev, tev = jbody["metadata"]["evaluation"], pbody["metadata"]["evaluation"]
    assert tev.keys() == jev.keys() and tev["verdict"] == jev["verdict"] == "skipped_confident"
    assert math.isclose(tev["confidence"], jev["confidence"], abs_tol=2e-4)
    assert "verify_pending" not in pbody["metadata"]
    assert pbody["metadata"]["verify_skipped"] == jbody["metadata"]["verify_skipped"]
    verdicts = {side: [e["verdict"] for e in ev if isinstance(e, dict) and "verdict" in e]
                for side, (_status, ev) in streams.items()}
    assert verdicts["port"] == [dict(verdicts["jax"][0])] == [verdicts["port"][0]]
    assert verdicts["port"][0]["verdict"] == "skipped_confident"
    assert streams["port"][1][-1] == streams["jax"][1][-1] == "[DONE]"
    # one generate admission for the JSON chat on each side, no verify
    assert (sides["jax"]["counted"].calls - counts[0],
            sides["port_counted"].calls - counts[1]) == (1, 1)
