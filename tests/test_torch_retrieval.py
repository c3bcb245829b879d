"""The port's host retrieval (BM25, its C++ core, fusion, the retriever
registry) against the JAX package on the same documents and queries.

BM25: the same ids in the same order and scores within 1e-6 (float32
accumulation over the same postings in the same order; the C++ core is
built without FMA contraction), empty queries, unknown and repeated terms,
and save/load across both packages. Fusion: ids, scores and merged metadata
identical (the same float64 arithmetic in the same order). The native core
is built with g++ where the host has it and skipped otherwise, with the
reason."""

import asyncio

import numpy as np
import pytest

from sentio_tpu.config import RetrievalConfig as JRetrievalConfig
from sentio_tpu.eval.dataset import build_bundle
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.ops.bm25 import BM25Index as JBM25Index
from sentio_tpu.ops.bm25 import BM25Params as JBM25Params
from sentio_tpu.ops.fusion import fuse as jax_fuse
from sentio_tpu.ops.retrievers import BaseRetriever as JBaseRetriever
from sentio_tpu.ops.retrievers import HybridRetriever as JHybridRetriever
from sentio_tpu.ops.retrievers import SparseRetriever as JSparseRetriever
from sentio_tpu_torch import native
from sentio_tpu_torch.config import RetrievalConfig, Settings
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.bm25 import BM25Index, BM25Params, NativeBM25Index, make_bm25_index
from sentio_tpu_torch.ops.fusion import fuse
from sentio_tpu_torch.ops.retrievers import (
    BaseRetriever,
    DenseRetriever,
    HybridRetriever,
    RetrieverError,
    SparseRetriever,
    create_retriever,
)

QUERIES = [
    "", "zzzz qqqq unknownterm", "ingest pipeline", "who maintains the scheduler",
    "scheduler scheduler scheduler changed", "The", "what changed in 2003",
]


@pytest.fixture(scope="module")
def corpus():
    bundle = build_bundle(n_docs=60, n_queries=8, seed=5)
    docs = list(bundle.documents) + [
        JDocument(text="", id="empty-doc"),
        JDocument(text="", metadata={"content": "text kept in metadata scheduler"}, id="meta"),
        JDocument(text="Ünïcode façade naïve 東京 scheduler", id="unicode"),
    ]
    queries = QUERIES + [question for question, _gold in bundle.queries]
    return docs, queries


def _port_docs(docs):
    return [Document.from_dict(d.to_dict()) for d in docs]


def _hits(index, query, k=10):
    return [(d.id, d.metadata["score"], d.metadata["retriever"])
            for d in index.retrieve(query, k)]


def _assert_same_hits(got, want):
    assert [h[0] for h in got] == [h[0] for h in want]
    assert [h[2] for h in got] == [h[2] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], atol=1e-6, rtol=0)


PARAMS = {"okapi": {}, "k1_b": {"k1": 0.9, "b": 0.4}, "plus": {"variant": "plus"}}


@pytest.mark.parametrize("params", sorted(PARAMS))
def test_bm25_matches_jax(corpus, params):
    docs, queries = corpus
    ref = JBM25Index(JBM25Params(**PARAMS[params])).build(docs)
    got = BM25Index(BM25Params(**PARAMS[params])).build(_port_docs(docs))
    assert got.vocab == ref.vocab and got.doc_ids == ref.doc_ids
    for query in queries:
        np.testing.assert_allclose(got.scores(query), ref.scores(query), atol=1e-6, rtol=0)
        for k in (1, 5, 100):
            _assert_same_hits(_hits(got, query, k), _hits(ref, query, k))
    assert got.retrieve("", 5) == [] and got.retrieve("unknownterm", 5) == []


def test_bm25_save_load_across_packages(corpus, tmp_path):
    """An index saved by either package loads in the other and answers the
    same."""
    docs, queries = corpus
    port = BM25Index().build(_port_docs(docs))
    port.save(tmp_path / "port")
    JBM25Index().build(docs).save(tmp_path / "jax")
    for loaded_port, loaded_jax in ((BM25Index.load(tmp_path / "port"),
                                     JBM25Index.load(tmp_path / "port")),
                                    (BM25Index.load(tmp_path / "jax"),
                                     JBM25Index.load(tmp_path / "jax"))):
        for query in queries:
            _assert_same_hits(_hits(loaded_port, query), _hits(port, query))
            _assert_same_hits(_hits(loaded_port, query), _hits(loaded_jax, query))


def test_empty_bm25_index():
    index = BM25Index().build([])
    assert index.size == 0 and index.retrieve("anything", 3) == []
    assert BM25Index().retrieve("anything", 3) == []


@pytest.fixture(scope="module")
def native_lib():
    lib = native.load_bm25()
    if lib is None:
        pytest.skip("the native BM25 core did not build here (no working g++)")
    return lib


def test_native_bm25_matches_jax_numpy(corpus, native_lib):
    docs, queries = corpus
    ref = JBM25Index().build(docs)
    got = NativeBM25Index().build(_port_docs(docs))
    assert got._get_box() is not None  # scored natively, not by the numpy fallback
    for query in queries:
        np.testing.assert_allclose(got.scores(query), ref.scores(query), atol=1e-6, rtol=0)
        _assert_same_hits(_hits(got, query), _hits(ref, query))
    # a rebuild retires the old handle; the new corpus answers
    got.build(_port_docs(docs[:10]))
    ref.build(docs[:10])
    for query in queries:
        _assert_same_hits(_hits(got, query), _hits(ref, query))


@pytest.mark.parametrize("backend", ["auto", "numpy", "native"])
def test_make_bm25_index_backends(backend, native_lib):
    index = make_bm25_index(BM25Params(k1=1.2), backend=backend)
    assert index.params.k1 == 1.2
    assert isinstance(index, NativeBM25Index) == (backend != "numpy")


def test_make_bm25_index_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "load_bm25", lambda: None)
    assert type(make_bm25_index(backend="auto")) is BM25Index
    with pytest.raises(RuntimeError, match="native"):
        make_bm25_index(backend="native")
    with pytest.raises(ValueError, match="backend"):
        make_bm25_index(backend="lucene")


def _legs(seed):
    """Two ranked legs with overlapping ids, differing metadata on the
    shared ids, a duplicate id inside one leg and a constant-score leg."""
    rng = np.random.default_rng(seed)
    ids = [f"d{i}" for i in range(12)]
    legs = []
    for name, n in (("dense", 8), ("bm25", 7), ("extra", 4)):
        picked = list(rng.choice(ids, size=n, replace=False))
        if name == "bm25":
            picked.append(picked[0])
        scores = np.sort(rng.uniform(0, 5, len(picked)))[::-1]
        if name == "extra":
            scores[:] = 2.0
        legs.append([{"id": i, "text": f"text {i}",
                      "metadata": {"score": float(s), "retriever": name, name: True}}
                     for i, s in zip(picked, scores)])
    return legs


def _as(cls, legs):
    return [[cls.from_dict(d) for d in leg] for leg in legs]


@pytest.mark.parametrize("weights", [None, [0.7, 0.3, 1.0], [1.0, 2.5, 0.0]])
@pytest.mark.parametrize("method", ["rrf", "weighted_rrf", "comb_sum"])
@pytest.mark.parametrize("top_k", [None, 5])
def test_fuse_matches_jax(method, weights, top_k):
    legs = _legs(len(method) + (0 if weights is None else int(10 * weights[1])))
    want = jax_fuse(_as(JDocument, legs), method=method, weights=weights, rrf_k=60, top_k=top_k)
    got = fuse(_as(Document, legs), method=method, weights=weights, rrf_k=60, top_k=top_k)
    assert [d.id for d in got] == [d.id for d in want]
    assert [d.metadata for d in got] == [d.metadata for d in want]
    assert [d.text for d in got] == [d.text for d in want]


def test_fuse_rejects_bad_arguments():
    with pytest.raises(ValueError, match="unknown fusion method"):
        fuse([], method="borda")
    with pytest.raises(ValueError, match="weights"):
        fuse([[Document(text="a")]], weights=[1.0, 2.0])


class _FixedLeg(BaseRetriever):
    def __init__(self, name, docs):
        self.name, self.docs, self.asked = name, docs, []

    def retrieve(self, query, top_k=10):
        self.asked.append(top_k)
        return [Document.from_dict(d.to_dict()) for d in self.docs[:top_k]]


class _JFixedLeg(JBaseRetriever):
    def __init__(self, name, docs):
        self.name, self.docs = name, docs

    def retrieve(self, query, top_k=10):
        return [JDocument.from_dict(d.to_dict()) for d in self.docs[:top_k]]


@pytest.mark.parametrize("method", ["rrf", "weighted_rrf", "comb_sum"])
@pytest.mark.parametrize("top_k", [3, 10])
def test_hybrid_retriever_matches_jax(corpus, method, top_k):
    """A fixed dense leg and the real BM25 leg, fused: the same list as the
    JAX hybrid retriever, whose legs run concurrently; each leg is asked
    for a pool of max(2·top_k, 10)."""
    docs, queries = corpus
    dense_docs = [d for d in docs[::3] if d.content]
    config = dict(fusion_method=method, dense_weight=0.7, sparse_weight=0.3, rrf_k=60)
    port_dense = _FixedLeg("dense", _port_docs(dense_docs))
    port = HybridRetriever([port_dense, SparseRetriever(BM25Index().build(_port_docs(docs)))],
                           RetrievalConfig(**config))
    ref = JHybridRetriever([_JFixedLeg("dense", dense_docs),
                            JSparseRetriever(JBM25Index().build(docs))],
                           config=JRetrievalConfig(**config))
    for query in queries[2:]:
        want = asyncio.run(ref.aretrieve(query, top_k))
        got = port.retrieve(query, top_k)
        assert [d.id for d in got] == [d.id for d in want]
        assert [d.metadata for d in got] == [d.metadata for d in want]
    assert set(port_dense.asked) == {max(2 * top_k, 10)}


def test_hybrid_leg_failure_raises():
    class Broken(BaseRetriever):
        name = "dense"

        def retrieve(self, query, top_k=10):
            raise RuntimeError("device fault")

    hybrid = HybridRetriever([Broken(), _FixedLeg("bm25", [Document(text="x", id="x")])])
    with pytest.raises(RuntimeError, match="device fault"):
        hybrid.retrieve("q")


def test_create_retriever_strategies():
    bm25 = BM25Index().build([Document(text="alpha beta", id="a")])
    embedder, index = object(), object()

    def make(strategy, **kw):
        return create_retriever(Settings(retrieval=RetrievalConfig(strategy=strategy)), **kw)

    assert isinstance(make("dense", embedder=embedder, dense_index=index), DenseRetriever)
    for name in ("bm25", "sparse"):
        assert isinstance(make(name, bm25_index=bm25), SparseRetriever)
    hybrid = make("hybrid", embedder=embedder, dense_index=index, bm25_index=bm25)
    assert [r.name for r in hybrid.retrievers] == ["dense", "bm25"]
    assert [r.name for r in make("hybrid", bm25_index=bm25).retrievers] == ["bm25"]
    for strategy, kw in (("dense", {"bm25_index": bm25}), ("bm25", {}), ("hybrid", {}),
                         ("colbert", {"bm25_index": bm25})):
        with pytest.raises(RetrieverError):
            make(strategy, **kw)
