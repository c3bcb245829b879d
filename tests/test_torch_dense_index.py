"""The port's dense index (exact MIPS, torch.matmul + torch.topk) against
``TpuDenseIndex``: the same add / upsert / delete / compaction semantics,
the same hits, and one persistence format that either package loads.
float32 corpora on both sides; scores within 1e-6 (one float32 dot
product each, summed in another order)."""

import numpy as np
import pytest

from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.dense_index import DenseIndexError, TorchDenseIndex

DIM = 16


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    return [f"d{i}" for i in range(n)], rng.standard_normal((n, DIM)).astype(np.float32)


def _both():
    return (TpuDenseIndex(DIM, dtype="float32"),
            TorchDenseIndex(DIM, device="cpu", dtype="float32"))


def _add(ref, port, ids, embs):
    ref.add([JDocument(text=f"text {i}", id=i) for i in ids], embs)
    port.add([Document(text=f"text {i}", id=i) for i in ids], embs)


def _assert_same_hits(ref, port, queries, k):
    for r_hits, p_hits in zip(ref.search_batch(queries, k), port.search_batch(queries, k)):
        assert [d.id for d, _ in p_hits] == [d.id for d, _ in r_hits]
        np.testing.assert_allclose([s for _, s in p_hits], [s for _, s in r_hits],
                                   atol=1e-6, rtol=0)


def test_add_upsert_delete_and_compaction_match():
    ref, port = _both()
    ids, embs = _corpus(40, seed=1)
    _add(ref, port, ids, embs)
    queries = np.random.default_rng(2).standard_normal((3, DIM)).astype(np.float32)
    _assert_same_hits(ref, port, queries, 7)
    # upsert: a re-added id tombstones its old row; duplicates in one batch: last wins
    up_ids, up_embs = ["d3", "d5", "d5"], -embs[[3, 5, 6]]
    _add(ref, port, up_ids, up_embs)
    _assert_same_hits(ref, port, queries, 7)
    # deleting past a quarter of the rows compacts the table
    gone = [f"d{i}" for i in range(0, 40, 3)]
    assert port.delete(gone) == ref.delete(gone)
    assert port.size == ref.size == 40 - len(gone)
    _assert_same_hits(ref, port, queries, 50)
    assert [d.id for d in port.documents()] == [d.id for d in ref.documents()]


def test_persistence_round_trips_across_packages(tmp_path):
    ref, port = _both()
    ids, embs = _corpus(12, seed=3)
    _add(ref, port, ids, embs)
    port.delete(["d4"])
    ref.delete(["d4"])
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    queries = np.random.default_rng(4).standard_normal((2, DIM)).astype(np.float32)
    _assert_same_hits(TpuDenseIndex.load(tmp_path / "port", dtype="float32"),
                      TorchDenseIndex.load(tmp_path / "ref", device="cpu", dtype="float32"),
                      queries, 5)


def test_bf16_corpus_and_input_checks():
    index = TorchDenseIndex(DIM, device="cpu")  # default bf16 corpus, as on the card
    ids, embs = _corpus(10, seed=5)
    index.add([Document(text=i, id=i) for i in ids], embs)
    hits = index.search(embs[7], top_k=3)
    assert hits[0][0].id == "d7" and abs(hits[0][1] - 1.0) < 1e-2
    assert [d.metadata["retriever"] for d in index.retrieve(embs[7], 2)] == ["dense"] * 2
    with pytest.raises(DenseIndexError):
        index.add([Document(text="x")], np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(DenseIndexError):
        index.search_batch(np.zeros((1, DIM + 1), np.float32))
    assert TorchDenseIndex(DIM, device="cpu").search(embs[0]) == []


def test_search_sees_each_write_whole():
    """One thread adds batches (with upserts, so rows are tombstoned and
    compacted) while another searches: every hit's score is the inner
    product of the query with that document's own vector, so no search
    pairs a matrix row with another write's document. Joins time out."""
    import sys
    import threading

    port = TorchDenseIndex(DIM, device="cpu", dtype="float32")
    rng = np.random.default_rng(7)
    vectors: dict[str, np.ndarray] = {}
    stop, errors = threading.Event(), []

    def write():
        for step in range(300):
            ids = [f"d{(step * 5 + j) % 90}" for j in range(12)]
            embs = rng.standard_normal((len(ids), DIM)).astype(np.float32)
            embs /= np.linalg.norm(embs, axis=1, keepdims=True)
            docs = [Document(text=i, id=i, metadata={"v": e.tolist()}) for i, e in zip(ids, embs)]
            port.add(docs, embs)
        stop.set()

    def read():
        q = np.ones((1, DIM), np.float32) / np.sqrt(DIM)
        while not stop.is_set():
            try:
                for doc, score in port.search_batch(q, 8)[0]:
                    want = float(q[0] @ np.asarray(doc.metadata["v"], np.float32))
                    assert abs(score - want) < 1e-5, (doc.id, score, want)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)
                return

    threads = [threading.Thread(target=write), threading.Thread(target=read)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert port.size == 90 and len(port.embeddings()) == 90
