"""The port's vector-store registry and Qdrant store
(``ops/vector_store.py``, REST over the port's ``HttpClient``) against
JAX's, both talking to JAX's test ``FakeQdrant``: the port's over loopback
HTTP (a ``http.server`` that hands each request to ``FakeQdrant.handler``
as an ``httpx.Request``), JAX's through ``httpx.MockTransport``.

JAX's cases (``tests/test_vector_store.py``) run on the port's store:
bootstrap, upsert, count, delete, scroll pagination, the retrieve
contract, clear, batch search, shape errors, an unreachable store, the
payload text fallback, the client pool, retries on 5xx and not on 4xx, the
breaker opening (and a 4xx storm not opening it), the health loop and
concurrent searches. Rankings equal JAX's store's and the port's
``TorchDenseIndex``'s on the same vectors; the ingestor writes through the
store; the registry refuses an unknown name with JAX's message; the
store's breaker reaches the registry and ``/metrics``' breaker family."""

import concurrent.futures
import http.server
import threading
import time

import httpx
import numpy as np
import pytest
import torch
from test_vector_store import FakeQdrant

from sentio_tpu.infra.resilience import RetryPolicy as JRetryPolicy
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.ops import vector_store as jvs
from sentio_tpu_torch.config import ChunkingConfig, EmbedderConfig, RetrievalConfig, Settings
from sentio_tpu_torch.infra import resilience
from sentio_tpu_torch.infra.exceptions import VectorStoreError
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.vector_store import (
    QdrantVectorStore,
    TransientStoreError,
    get_vector_store,
)

FAST_RETRY = resilience.RetryPolicy(max_attempts=3, base_delay_s=0.001, max_delay_s=0.01,
                                    retry_on=(TransientStoreError,))


class LoopbackQdrant:
    """``FakeQdrant.handler`` (or any httpx-style handler) served over
    loopback HTTP on a thread; ``handler`` may be swapped at any time."""

    def __init__(self, handler) -> None:
        self.handler = handler
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _serve(self) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                request = httpx.Request(self.command, f"http://qdrant{self.path}",
                                        content=self.rfile.read(n) if n else b"",
                                        headers=dict(self.headers))
                try:
                    response = outer.handler(request)
                except httpx.ConnectError:
                    self.close_connection = True  # a refused connection, as near as HTTP gets
                    self.connection.shutdown(2)
                    return
                body = response.content
                self.send_response(response.status_code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_POST = do_PUT = do_DELETE = _serve

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, name="fake-qdrant",
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


@pytest.fixture
def fake():
    return FakeQdrant()


@pytest.fixture
def served(fake):
    srv = LoopbackQdrant(fake.handler)
    yield srv
    srv.close()


@pytest.fixture
def store(served):
    s = QdrantVectorStore(dim=8, url=served.url, collection="test", retry=FAST_RETRY)
    yield s
    s.close()


def _jax_store(handler, **kw):
    return jvs.QdrantVectorStore(dim=8, collection=kw.pop("collection", "test"),
                                 transport=httpx.MockTransport(handler), **kw)


def mk_docs_vecs(n=6, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    docs = [Document(text=f"doc {i}", id=f"d{i}", metadata={"i": i}) for i in range(n)]
    return docs, vecs


def _jdocs(docs):
    return [JDocument(text=d.text, id=d.id, metadata=dict(d.metadata)) for d in docs]


def _ids(hits):
    return [(d.id, round(s, 5)) for d, s in hits]


# ------------------------------------------------------------- JAX's cases


def test_add_count_search_as_jax(store, fake):
    docs, vecs = mk_docs_vecs()
    store.add(docs, vecs)
    jstore = _jax_store(FakeQdrant().handler)
    jstore.add(_jdocs(docs), vecs)
    assert store.size == jstore.size == 6
    hits = store.search(vecs[2], top_k=3)
    assert hits[0][0].id == "d2" and hits[0][1] == pytest.approx(1.0, abs=1e-5)
    assert _ids(hits) == _ids(jstore.search(vecs[2], top_k=3))
    # the points on the wire are JAX's: the same ids, vectors and payloads
    jfake = FakeQdrant()
    _jax_store(jfake.handler).add(_jdocs(docs), vecs)
    assert fake.collections["test"]["points"] == jfake.collections["test"]["points"]
    jstore.close()


def test_upsert_same_id_overwrites(store):
    docs, vecs = mk_docs_vecs()
    store.add(docs, vecs)
    store.add([Document(text="updated", id="d0", metadata={})], vecs[:1])
    assert store.size == 6
    assert store.search(vecs[0], top_k=1)[0][0].text == "updated"


def test_delete(store):
    docs, vecs = mk_docs_vecs()
    store.add(docs, vecs)
    assert store.delete(["d1", "d3", "missing"]) == 2
    assert store.size == 4
    assert store.delete([]) == 0


def test_documents_scroll_pagination(store):
    docs, vecs = mk_docs_vecs(n=600)  # more than two 256-point scroll pages
    store.add(docs, vecs)
    got = store.documents()
    assert len(got) == 600 and {d.id for d in got} == {d.id for d in docs}
    assert {d.id: d.metadata for d in got} == {d.id: d.metadata for d in docs}


def test_retrieve_contract(store):
    docs, vecs = mk_docs_vecs()
    store.add(docs, vecs)
    out = store.retrieve(torch.as_tensor(vecs[4]), top_k=2)  # a tensor query too
    assert out[0].id == "d4" and out[0].metadata["retriever"] == "qdrant"
    assert out[0].metadata["i"] == 4 and "score" in out[0].metadata


def test_clear_drops_collection(store, fake):
    docs, vecs = mk_docs_vecs()
    store.add(docs, vecs)
    store.clear()
    assert "test" not in fake.collections
    assert store.size == 0  # bootstraps again, empty


def test_batch_search(store):
    docs, vecs = mk_docs_vecs()
    store.add(docs, vecs)
    batches = store.search_batch(torch.as_tensor(vecs[:3]), top_k=2)
    assert [b[0][0].id for b in batches] == ["d0", "d1", "d2"]
    jstore = _jax_store(FakeQdrant().handler)
    jstore.add(_jdocs(docs), vecs)
    assert [_ids(b) for b in batches] == [_ids(b) for b in jstore.search_batch(vecs[:3], 2)]
    jstore.close()


def test_shape_mismatch_raises(store):
    docs, vecs = mk_docs_vecs()
    with pytest.raises(VectorStoreError, match=r"expected embeddings \[N, 8\]"):
        store.add(docs, vecs[:, :4])
    with pytest.raises(VectorStoreError, match="length mismatch"):
        store.add(docs[:2], vecs)


def test_unreachable_raises_store_error():
    s = QdrantVectorStore(dim=8, url="http://127.0.0.1:1", collection="down", retry=FAST_RETRY)
    try:
        with pytest.raises(VectorStoreError):
            s.search(np.zeros(8, np.float32))
    finally:
        s.close()


def test_payload_text_fallback(fake, store):
    store.add([Document(text="x", id="seed", metadata={})], np.ones((1, 8), np.float32))
    pid = next(iter(fake.collections["test"]["points"]))
    fake.collections["test"]["points"][pid]["payload"] = {"content": "alt content",
                                                          "doc_id": "seed", "extra": 1}
    hit = store.search(np.ones(8, np.float32), top_k=1)[0][0]
    assert (hit.text, hit.id, hit.metadata) == ("alt content", "seed", {"extra": 1})


@pytest.mark.parametrize("seed", [3, 4])
def test_same_ranking_as_jax_store_and_dense_index(store, seed):
    docs, vecs = mk_docs_vecs(n=40, seed=seed)
    store.add(docs, vecs)
    jstore = _jax_store(FakeQdrant().handler)
    jstore.add(_jdocs(docs), vecs)
    index = TorchDenseIndex(dim=8, device="cpu", dtype="float32")
    index.add(docs, vecs)
    rng = np.random.default_rng(9)
    for _ in range(5):
        q = rng.standard_normal(8).astype(np.float32)
        got = [d.id for d, _ in store.search(q, top_k=5)]
        assert got == [d.id for d, _ in jstore.search(q, top_k=5)]
        assert got == [d.id for d, _ in index.search(torch.as_tensor(q), top_k=5)]
    jstore.close()


# ---------------------------------------------------------------- registry


def test_registry_tpu_is_the_card_index():
    idx = get_vector_store("tpu", dim=16, device="cpu", dtype="float32")
    assert isinstance(idx, TorchDenseIndex) and idx.dtype == "float32"


def test_registry_qdrant_entry_reads_settings():
    settings = Settings(retrieval=RetrievalConfig(qdrant_url="http://127.0.0.1:1",
                                                  collection_name="col",
                                                  qdrant_api_key="k"))
    s = get_vector_store("qdrant", dim=16, settings=settings, dtype="bfloat16")
    try:
        assert isinstance(s, QdrantVectorStore) and s.collection == "col"
        assert s._clients[0].base_url == "http://127.0.0.1:1"
        assert s._clients[0].headers["api-key"] == "k"
    finally:
        s.close()


@pytest.mark.parametrize("name", ["hnswlib", "", "Qdrant"])
def test_registry_unknown_raises_as_jax(name):
    with pytest.raises(VectorStoreError) as got:
        get_vector_store(name, dim=16)
    with pytest.raises(jvs.VectorStoreError) as want:
        jvs.get_vector_store(name, dim=16)
    assert str(got.value) == str(want.value)


def test_ingestor_writes_through_the_store(store, fake):
    from sentio_tpu_torch.ops.bm25 import BM25Index
    from sentio_tpu_torch.ops.ingest import DocumentIngestor

    class Embedder:
        dimension = 8

        def embed_many(self, texts):
            return np.ones((len(texts), 8), np.float32)

    bm25 = BM25Index()
    settings = Settings(chunking=ChunkingConfig(chunk_size=64, chunk_overlap=0),
                        embedder=EmbedderConfig(model_preset="tiny"))
    ingestor = DocumentIngestor(embedder=Embedder(), dense_index=store, sparse_index=bm25,
                                settings=settings)
    stats = ingestor.ingest_document("Pages map to slots. " * 20, metadata={"src": "t"})
    assert stats.chunks_stored >= 2
    assert len(fake.collections["test"]["points"]) == stats.chunks_stored == bm25.size
    assert ingestor.clear() == stats.chunks_stored and store.size == 0


# ---------------------------------------------------------- pool and breaker


def test_pool_round_robins_clients(served):
    s = QdrantVectorStore(dim=8, url=served.url, collection="t", pool_size=3)
    try:
        seen = [s._next_client() for _ in range(6)]
        assert len({id(c) for c in seen}) == 3
        assert [id(c) for c in seen[:3]] == [id(c) for c in seen[3:]]
    finally:
        s.close()


def _counting(handler, status=None, times=None):
    calls = {"n": 0}

    def wrapped(request):
        calls["n"] += 1
        if status is not None and (times is None or calls["n"] <= times):
            return httpx.Response(status, text="no")
        return handler(request)

    return wrapped, calls


@pytest.mark.parametrize("status,times,ok,calls", [(503, 2, True, 3), (500, 5, False, 3),
                                                   (422, None, False, 1), (404, None, False, 1)])
def test_retries_5xx_not_4xx_as_jax(fake, status, times, ok, calls):
    results = []
    for make in ("port", "jax"):
        handler, count = _counting(fake.handler, status, times)
        if make == "port":
            srv = LoopbackQdrant(handler)
            s = QdrantVectorStore(dim=8, url=srv.url, collection="t", retry=FAST_RETRY)
        else:
            srv, s = None, _jax_store(handler, collection="t", retry=JRetryPolicy(
                max_attempts=3, base_delay_s=0.001, max_delay_s=0.01,
                retry_on=(jvs.TransientStoreError,)))
        try:
            out = s._request("GET", "/collections")
            results.append(("ok", out["status"], count["n"]))
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            results.append((type(exc).__name__, str(exc), count["n"]))
        finally:
            s.close()
            if srv is not None:
                srv.close()
    assert results[0] == results[1]
    assert (results[0][0] == "ok") is ok and results[0][2] == calls


def test_breaker_opens_fails_fast_and_reaches_health_and_metrics():
    s = QdrantVectorStore(dim=8, url="http://127.0.0.1:1", collection="breaker-t",
                          retry=resilience.RetryPolicy(max_attempts=1,
                                                       retry_on=(TransientStoreError,)))
    try:
        assert resilience.registered_breakers()["qdrant:breaker-t"] is s.breaker
        for _ in range(5):  # failure_threshold consecutive failures
            with pytest.raises(TransientStoreError):
                s._request("GET", "/collections")
        with pytest.raises(VectorStoreError, match="unavailable: circuit qdrant:breaker-t open"):
            s._request("GET", "/collections")
        assert s.breaker.health()["state"] == "open" and s.breaker.stats.rejected == 1
        text = get_metrics().export_prometheus().decode()
        assert 'sentio_circuit_breaker_state{name="qdrant:breaker-t"} 2.0' in text
    finally:
        s.close()
    assert "qdrant:breaker-t" not in resilience.registered_breakers()


def test_4xx_storm_does_not_open_breaker(fake):
    def mixed(request):
        if request.url.path == "/collections":
            return fake.handler(request)
        return httpx.Response(422, text="bad filter")

    srv = LoopbackQdrant(mixed)
    s = QdrantVectorStore(dim=8, url=srv.url, collection="breaker-4xx", retry=FAST_RETRY)
    try:
        for _ in range(8):  # past failure_threshold: must not open
            with pytest.raises(VectorStoreError):
                s._request("POST", "/collections/breaker-4xx/points/search", {})
        assert s._request("GET", "/collections")["status"] == "ok"
    finally:
        s.close()
        srv.close()


def test_health_loop_caches_and_recovers(fake):
    state = {"up": False}

    def flapping(request):
        if not state["up"]:
            return httpx.Response(503, text="down")
        return fake.handler(request)

    srv = LoopbackQdrant(flapping)
    s = QdrantVectorStore(dim=8, url=srv.url, collection="t", health_interval_s=0.05,
                          retry=FAST_RETRY)
    try:
        s.health()  # the public surface starts the loop
        deadline = time.perf_counter() + 10
        while s._healthy is not False and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert s.health() is False
        state["up"] = True
        while s._healthy is not True and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert s.health() is True
    finally:
        s.close()
        srv.close()
    assert s._health_thread is None and s.health() is False


def test_concurrent_searches_all_succeed(served):
    s = QdrantVectorStore(dim=8, url=served.url, collection="t", pool_size=4)
    try:
        docs, vecs = mk_docs_vecs(n=12)
        s.add(docs, vecs)
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            results = list(ex.map(lambda i: s.search(vecs[i % 12], 3), range(32)))
        assert all(len(r) == 3 for r in results)
        assert [r[0][0].id for r in results] == [f"d{i % 12}" for i in range(32)]
    finally:
        s.close()
