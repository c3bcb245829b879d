"""The port's post-fusion scorers (``ops/scorers.py``) and the hybrid
retriever's scorer and web-cache legs (``ops/retrievers.py``) against
JAX's, on shared tiny float32 encoder weights and one seeded corpus.

* Each scorer's scores equal JAX's within 1e-5 (keyword and recency
  exactly, under one clock); ``default_scorer_stack`` takes the settings'
  weights and λ as JAX's does;
* the semantic and MMR scorers share one ``embed_many`` of the query and
  the candidates (one encoder forward), and the shared memo holds under 8
  threads with different queries;
* ``create_retriever`` with scorers and a web-cache index returns JAX's ids
  in JAX's order with its mixed scores, with the cache's hits first; a
  scorer that raises is skipped; with no dense leg the cache rides as a
  leg of its own; a store outage (``VectorStoreError``) drops its leg as
  JAX drops it, and is named in ``stats["legs_dropped"]``."""

import dataclasses
import threading

import jax
import numpy as np
import pytest

from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import RetrievalConfig as JRetrievalConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.eval.dataset import build_bundle
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder
from sentio_tpu.ops import scorers as jscorers
from sentio_tpu.ops.bm25 import BM25Index as JBM25Index
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu.ops.embedder import TpuEmbedder
from sentio_tpu.ops.retrievers import create_retriever as jcreate_retriever
from sentio_tpu_torch.config import EmbedderConfig, RetrievalConfig, Settings
from sentio_tpu_torch.infra.exceptions import VectorStoreError
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops import scorers as tscorers
from sentio_tpu_torch.ops.bm25 import BM25Index
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.retrievers import HybridRetriever, create_retriever
from sentio_tpu_torch.runtime.weights import encoder_from_jax

ATOL = 1e-5
NOW = 1_800_000_000.0
QUESTIONS = ["Who maintains the ingest pipeline?", "what changed in the scheduler",
             "pages and slots", "zzzz unknownterm"]


@pytest.fixture(scope="module")
def world():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_encoder(jax.random.PRNGKey(41), enc))
    jemb = TpuEmbedder(JEmbedderConfig(model_preset="tiny"), params=tree, model_config=enc)
    temb = _port_embedder(enc, tree)
    bundle = build_bundle(n_docs=40, n_queries=2, seed=7)
    jdocs = list(bundle.documents)
    for i, doc in enumerate(jdocs):  # some with a timestamp, one malformed
        if i % 3 == 0:
            doc.metadata["timestamp"] = NOW - 86_400.0 * i
    jdocs[1].metadata["timestamp"] = "not a number"
    cache_docs = [JDocument(text=f"cached web result {i}: the scheduler changed on day {i}",
                            id=f"web-{i}", metadata={"source": "web"}) for i in range(6)]
    yield dict(jemb=jemb, temb=temb, jdocs=jdocs, cache_docs=cache_docs)
    temb.close()


def _port_embedder(enc, tree):
    from sentio_tpu_torch.ops.embedder import TorchEmbedder

    return TorchEmbedder(EmbedderConfig(model_preset="tiny"), params=encoder_from_jax(tree),
                         model_config=EncoderConfig(**dataclasses.asdict(enc)), device="cpu")


def _tdocs(docs):
    return [Document.from_dict(d.to_dict()) for d in docs]


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr("time.time", lambda: NOW)


SCORERS = {
    "keyword": lambda m, e: m.KeywordMatchScorer(),
    "recency": lambda m, e: m.RecencyScorer(half_life_days=2.0),
    "semantic": lambda m, e: m.SemanticSimilarityScorer(embedder=e),
    "mmr": lambda m, e: m.MMRScorer(embedder=e, lambda_param=0.6),
    "semantic_no_embedder": lambda m, e: m.SemanticSimilarityScorer(),
}


@pytest.mark.parametrize("name", sorted(SCORERS))
@pytest.mark.parametrize("question", QUESTIONS[:3])
def test_each_scorer_matches_jax(world, clock, name, question):
    jdocs = world["jdocs"][:12]
    got = SCORERS[name](tscorers, world["temb"]).score(question, _tdocs(jdocs))
    want = SCORERS[name](jscorers, world["jemb"]).score(question, jdocs)
    assert got.dtype == np.float32 and got.shape == (12,)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    if name in ("keyword", "recency"):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_scorers_on_no_documents_match_jax(world):
    for name in sorted(SCORERS):
        got = SCORERS[name](tscorers, world["temb"]).score("q", [])
        assert got.shape == np.asarray(
            SCORERS[name](jscorers, world["jemb"]).score("q", [])).shape == (0,)


def test_default_stack_matches_jax(world):
    kw = dict(keyword_scorer_weight=0.3, recency_scorer_weight=0.1, mmr_scorer_weight=0.7,
              mmr_lambda=0.55)
    got = tscorers.default_scorer_stack("E", Settings(retrieval=RetrievalConfig(**kw)))
    want = jscorers.default_scorer_stack("E", JSettings(retrieval=JRetrievalConfig(**kw)))
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]


class CountingEmbedder:
    """Query-dependent unit vectors from a hash of each text, slow enough
    for threads to interleave; counts its calls."""

    dimension = 16

    def __init__(self) -> None:
        self.calls: list[int] = []
        self._lock = threading.Lock()

    def embed_many(self, texts):
        with self._lock:
            self.calls.append(len(texts))
        threading.Event().wait(0.001)
        rows = []
        for text in texts:
            v = np.random.default_rng(abs(hash(text)) % (1 << 32)).standard_normal(16)
            rows.append(v / np.linalg.norm(v))
        return np.asarray(rows, np.float32)


def test_semantic_and_mmr_share_one_embed(world):
    docs = _tdocs(world["jdocs"][:9])
    emb = CountingEmbedder()
    tscorers.SemanticSimilarityScorer(embedder=emb).score("one query", docs)
    tscorers.MMRScorer(embedder=emb).score("one query", docs)
    assert emb.calls == [10]  # the query and every candidate, once
    temb = world["temb"]
    before = temb.forwards
    cold = _tdocs([JDocument(text=f"never embedded before {i}", id=f"cold-{i}")
                   for i in range(5)])
    tscorers.SemanticSimilarityScorer(embedder=temb).score("a fresh question", cold)
    tscorers.MMRScorer(embedder=temb).score("a fresh question", cold)
    assert temb.forwards - before == 1  # one encoder forward for the pair


def test_memo_holds_under_eight_threads(world):
    """8 threads, each its own question over the same candidates, run the
    semantic and MMR scorers in a loop; every result equals the question's
    result computed alone."""
    docs = _tdocs(world["jdocs"][:10])
    emb = CountingEmbedder()
    questions = [f"question number {i} about pages" for i in range(8)]
    alone = {q: (tscorers.SemanticSimilarityScorer(embedder=emb).score(q, docs),
                 tscorers.MMRScorer(embedder=emb).score(q, docs)) for q in questions}
    barrier = threading.Barrier(8)
    wrong: list = []

    def run(q: str) -> None:
        barrier.wait()
        for _ in range(25):
            sem = tscorers.SemanticSimilarityScorer(embedder=emb).score(q, docs)
            mmr = tscorers.MMRScorer(embedder=emb).score(q, docs)
            if not (np.array_equal(sem, alone[q][0]) and np.array_equal(mmr, alone[q][1])):
                wrong.append(q)

    threads = [threading.Thread(target=run, args=(q,), name=f"memo-{i}")
               for i, q in enumerate(questions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []


# ------------------------------------------------------------ hybrid retriever


def _retrievers(world, with_dense=True, scorers=True, web_cache=True, port_scorers=None,
                jax_scorers=None):
    jdocs, cache_docs = world["jdocs"], world["cache_docs"]
    jemb, temb = world["jemb"], world["temb"]
    js = JSettings(retrieval=JRetrievalConfig(mmr_lambda=0.6))
    ts = Settings(retrieval=RetrievalConfig(mmr_lambda=0.6))
    jidx, tidx = TpuDenseIndex(dim=jemb.dimension, dtype="float32"), \
        TorchDenseIndex(temb.dimension, device="cpu", dtype="float32")
    vecs = jemb.embed_many([d.content for d in jdocs])
    jidx.add(jdocs, vecs)
    tidx.add(_tdocs(jdocs), vecs)
    jcache = tcache = None
    if web_cache:
        cvecs = jemb.embed_many([d.content for d in cache_docs])
        jcache = TpuDenseIndex(dim=jemb.dimension, dtype="float32")
        jcache.add(cache_docs, cvecs)
        tcache = TorchDenseIndex(temb.dimension, device="cpu", dtype="float32")
        tcache.add(_tdocs(cache_docs), cvecs)
    jbm, tbm = JBM25Index().build(jdocs), BM25Index().build(_tdocs(jdocs))
    if scorers:
        jax_scorers = jax_scorers or jscorers.default_scorer_stack(jemb, js)
        port_scorers = port_scorers or tscorers.default_scorer_stack(temb, ts)
    jr = jcreate_retriever(settings=js, embedder=jemb, dense_index=jidx if with_dense else None,
                           bm25_index=jbm, scorers=jax_scorers, web_cache_index=jcache)
    tr = create_retriever(ts, temb, tidx if with_dense else None, tbm, scorers=port_scorers,
                          web_cache_index=tcache)
    return jr, tr


def _assert_same(got, want):
    assert [d.id for d in got] == [d.id for d in want]
    np.testing.assert_allclose([d.score() for d in got], [d.score() for d in want],
                               atol=ATOL, rtol=0)
    assert [d.metadata.get("retriever") for d in got] == \
        [d.metadata.get("retriever") for d in want]


@pytest.mark.parametrize("question", QUESTIONS)
@pytest.mark.parametrize("case", ["scorers_and_cache", "scorers", "cache", "cache_no_dense"])
def test_hybrid_with_scorers_and_web_cache_matches_jax(world, clock, case, question):
    jr, tr = _retrievers(world, with_dense=case != "cache_no_dense",
                         scorers=case.startswith("scorers"),
                         web_cache=case != "scorers")
    stats: dict = {}
    got = tr.retrieve(question, 6, stats=stats)
    _assert_same(got, jr.retrieve(question, 6))
    assert len(got) == 6 and "legs_dropped" not in stats
    assert ("scorers_ms" in stats) is case.startswith("scorers")
    if case == "cache_no_dense":
        assert any(d.id.startswith("web-") for d in got)


def test_web_cache_hits_go_first_in_the_dense_leg(world):
    """With the dense leg alone the fused list is that leg as the cache
    made it: the cache's hits, then the corpus's."""
    _jr, tr = _retrievers(world, scorers=False)
    tr.retrievers = tr.retrievers[:1]
    question = "cached web result 3: the scheduler changed on day 3"
    dense_hits = [d.id for d in tr.retrievers[0].retrieve(question, 10)]
    cache_hits = [d.id for d in tr.web_cache.retrieve(question, 10)]
    assert cache_hits[0] == "web-3" and "web-3" not in dense_hits
    assert [d.id for d in tr.retrieve(question, 10)] == (cache_hits + dense_hits)[:10]


class _Broken:
    name, weight = "broken", 5.0

    def score(self, query, documents):
        raise RuntimeError("scorer bug")


def test_a_broken_scorer_is_skipped_as_jax(world, clock):
    ts = Settings(retrieval=RetrievalConfig(mmr_lambda=0.6))
    js = JSettings(retrieval=JRetrievalConfig(mmr_lambda=0.6))
    jr, tr = _retrievers(
        world, port_scorers=[_Broken(), *tscorers.default_scorer_stack(world["temb"], ts)],
        jax_scorers=[_Broken(), *jscorers.default_scorer_stack(world["jemb"], js)])
    _assert_same(tr.retrieve(QUESTIONS[1], 5), jr.retrieve(QUESTIONS[1], 5))


class _Down:
    """A dense leg whose store is out, in either package's error type."""

    name = "dense"

    def __init__(self, exc) -> None:
        self.exc = exc

    def retrieve(self, query, top_k=10):
        raise self.exc

    async def aretrieve(self, query, top_k=10):
        raise self.exc


def test_a_store_outage_drops_its_leg_as_jax(world, clock):
    jr, tr = _retrievers(world)
    jr.retrievers = [_Down(RuntimeError("qdrant unavailable")), jr.retrievers[1]]
    tr.retrievers = [_Down(VectorStoreError("qdrant unavailable")), tr.retrievers[1]]
    stats: dict = {}
    _assert_same(tr.retrieve(QUESTIONS[0], 6, stats=stats), jr.retrieve(QUESTIONS[0], 6))
    assert stats["legs_dropped"] == ["dense"]
    # any other fault of a leg surfaces in the port (a deliberate difference)
    tr.retrievers = [_Down(KeyError("bug")), tr.retrievers[1]]
    with pytest.raises(KeyError):
        tr.retrieve(QUESTIONS[0], 6)
    assert isinstance(tr, HybridRetriever)
