"""Ingestion in the port (``ops/chunking.py``, ``ops/ingest.py``, the
embedder's cache and coalescer) against the JAX package on the same
inputs.

The chunker's pieces must be equal strings; each reader's text equal;
``DocumentIngestor.ingest_path`` over one temp directory must give the
same chunks (text, metadata, order; document ids are made deterministic
on both sides by one uuid sequence), the same stats but ``elapsed_s``, the
same skips and errors, and vectors within atol 1e-5 (the tiny encoder in
float32, weights made by the JAX init and carried across). The embedding
cache's hits, misses and LFU evictions equal JAX's on one sequence of
operations; coalesced query embeds from 8 threads equal one-at-a-time
embeds within atol 1e-6, and no coalesced batch exceeds ``coalesce_max``.
Every thread join has a timeout."""

import contextlib
import dataclasses
import io
import threading
import uuid
import zipfile

import jax
import numpy as np
import pytest

from sentio_tpu.config import ChunkingConfig as JChunkingConfig
from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder
from sentio_tpu.ops.bm25 import BM25Index as JBM25Index
from sentio_tpu.ops.chunking import ChunkingError as JChunkingError
from sentio_tpu.ops.chunking import TextChunker as JTextChunker
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu.ops.embedder import EmbeddingCache as JEmbeddingCache
from sentio_tpu.ops.embedder import TpuEmbedder
from sentio_tpu.ops.ingest import DocumentIngestor as JDocumentIngestor
from sentio_tpu.ops.ingest import IngestError as JIngestError
from sentio_tpu_torch.config import ChunkingConfig, EmbedderConfig, Settings
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops.bm25 import BM25Index
from sentio_tpu_torch.ops.chunking import ChunkingError, TextChunker
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import EmbeddingCache, TorchEmbedder
from sentio_tpu_torch.ops.ingest import DocumentIngestor, IngestError
from sentio_tpu_torch.runtime.weights import encoder_from_jax

JOIN_S = 120.0
VECTOR_ATOL = 1e-5
COALESCE_ATOL = 1e-6
WORDS = ["page", "slot", "tick", "radix", "prefix", "decode", "kernel", "tensor", "batch",
         "token", "cache", "shard"]


def seeded_text(seed: int, n_words: int, separators: bool = True) -> str:
    """Words from a seeded list, with sentence, line and paragraph breaks
    when ``separators``; without, one unbroken run of letters."""
    rng = np.random.default_rng(seed)
    words = [str(w) for w in rng.choice(WORDS, size=n_words)]
    if not separators:
        return "".join(words)
    out = []
    for w in words:
        out.append(w)
        r = rng.random()
        out.append(". " if r < 0.1 else "\n" if r < 0.14 else "\n\n" if r < 0.16 else " ")
    return "".join(out)


@contextlib.contextmanager
def fixed_uuids():
    """``uuid.uuid4`` as a counter (both packages' ``Document`` ids come
    from it), so the two sides mint the same ids in the same order."""
    counter = iter(range(1, 1 << 30))
    real = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    try:
        yield
    finally:
        uuid.uuid4 = real


# ------------------------------------------------------------------ chunking

CHUNK_CASES = [
    # (strategy, size, overlap, seed, words, separators)
    ("recursive", 512, 64, 0, 400, True),
    ("recursive", 128, 16, 1, 300, True),
    ("recursive", 64, 0, 2, 200, True),
    ("recursive", 100, 30, 3, 120, False),  # no separator at all
    ("recursive", 512, 64, 4, 12, True),  # shorter than one chunk
    ("fixed", 200, 50, 5, 300, True),
    ("sentence", 160, 20, 6, 300, True),
    ("sentence", 90, 10, 7, 80, False),
]


@pytest.mark.parametrize("strategy,size,overlap,seed,n_words,separators", CHUNK_CASES)
def test_split_text_matches_jax(strategy, size, overlap, seed, n_words, separators):
    text = seeded_text(seed, n_words, separators)
    got = TextChunker(ChunkingConfig(strategy, size, overlap)).split_text(text)
    want = JTextChunker(JChunkingConfig(strategy, size, overlap)).split_text(text)
    assert got == want
    assert got and all(len(c) <= size for c in got)


@pytest.mark.parametrize("strategy,size,overlap", [("recursive", 96, 12), ("sentence", 64, 8)])
def test_split_documents_matches_jax(strategy, size, overlap):
    texts = [seeded_text(10 + i, 60 + 40 * i) for i in range(3)] + ["   ", "short one"]
    meta = [{"source": f"doc-{i}.md", "k": i} for i in range(len(texts))]
    port = TextChunker(ChunkingConfig(strategy, size, overlap))
    ref = JTextChunker(JChunkingConfig(strategy, size, overlap))
    got = port.split([Document(text=t, metadata=dict(m), id=f"d{i}")
                      for i, (t, m) in enumerate(zip(texts, meta))])
    want = ref.split([JDocument(text=t, metadata=dict(m), id=f"d{i}")
                      for i, (t, m) in enumerate(zip(texts, meta))])
    assert [(d.id, d.text, d.metadata) for d in got] == [(d.id, d.text, d.metadata)
                                                         for d in want]
    assert port.get_stats() == ref.get_stats()


@pytest.mark.parametrize("kwargs", [dict(chunk_size=0), dict(chunk_size=10, chunk_overlap=10),
                                    dict(strategy="words")])
def test_chunker_refuses_what_jax_refuses(kwargs):
    with pytest.raises(ChunkingError) as got:
        TextChunker(ChunkingConfig(**kwargs))
    with pytest.raises(JChunkingError) as want:
        JTextChunker(JChunkingConfig(**kwargs))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- readers


def docx_bytes(paragraphs) -> bytes:
    body = "".join(f'<w:p><w:r><w:t xml:space="preserve">{p}</w:t></w:r></w:p>'
                   for p in paragraphs)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        zf.writestr("word/document.xml",
                    f'<?xml version="1.0"?><w:document><w:body>{body}</w:body></w:document>')
    return buf.getvalue()


FILES = {
    "notes.txt": seeded_text(20, 150).encode(),
    "readme.md": ("# Title\n\n" + seeded_text(21, 90)).encode(),
    "guide.rst": seeded_text(22, 40).encode(),
    "data.json": b'{"title": "Pages", "body": ["a slot", {"k": "the tick"}], "n": 3}',
    "bad.json": b"{not json at all",
    "rows.jsonl": b'{"q": "what is a page"}\nnot json line\n\n{"a": ["x", "y"]}\n',
    "table.csv": b"name,role\nradix,prefix cache\n,,\ndecode,kernel\n",
    "table.tsv": b"a\tb\nslot\tpage\n",
    "page.html": (b"<html><head><style>p{}</style><script>var x=1;</script></head>"
                  b"<body><h1>Heading</h1><p>Visible text about pages.</p></body></html>"),
    "doc.docx": docx_bytes(["First paragraph about ticks.", "Second &amp; last."]),
    "conf.yaml": b"name: pages\nitems:\n  - one slot\n  - two ticks\n",
    "scan.pdf": b"%PDF-1.4 not really a pdf",
}


@pytest.fixture(scope="module")
def files_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest_files")
    for name, data in FILES.items():
        (root / name).write_bytes(data)
    (root / "empty.txt").write_bytes(b"   \n")
    (root / "broken.docx").write_bytes(b"PK not a zip")
    (root / "image.bin").write_bytes(b"\x00\x01")
    sub = root / "nested"
    sub.mkdir()
    (sub / "deep.md").write_bytes(seeded_text(23, 70).encode())
    return root


def _load(ingestor, path):
    try:
        return [(d.text, d.metadata) for d in ingestor.load_file(path)]
    except (IngestError, JIngestError) as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("name", sorted(FILES) + ["empty.txt", "broken.docx"])
def test_each_reader_gives_jax_text(files_dir, name):
    """txt, md, rst, json (and malformed json), jsonl, csv, tsv, html and
    docx give JAX's text and metadata; yaml and pdf give whatever JAX gives
    here (the parsed text or its plain text, JAX's IngestError message)."""
    path = files_dir / name
    got = _load(DocumentIngestor(embedder=object(), dense_index=object()), path)
    want = _load(JDocumentIngestor(embedder=object(), dense_index=object(),
                                   settings=JSettings()), path)
    assert got == want


# ------------------------------------------------------------------ ingestor


@pytest.fixture(scope="module")
def encoder():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    return enc, jax.tree.map(np.asarray, init_encoder(jax.random.PRNGKey(31), enc))


def port_embedder(encoder, **cfg):
    enc, tree = encoder
    return TorchEmbedder(EmbedderConfig(model_preset="tiny", **cfg),
                         params=encoder_from_jax(tree),
                         model_config=EncoderConfig(**dataclasses.asdict(enc)), device="cpu")


def jax_embedder(encoder, **cfg):
    enc, tree = encoder
    return TpuEmbedder(JEmbedderConfig(model_preset="tiny", **cfg), params=tree,
                       model_config=enc)


def _chunks_of(index):
    return [(d.id, d.text, d.metadata) for d in index.documents()]


def test_ingest_path_matches_jax(encoder, files_dir):
    chunking = dict(chunk_size=160, chunk_overlap=24)
    with fixed_uuids():
        port_embed = port_embedder(encoder, coalesce=False)
        port = DocumentIngestor(embedder=port_embed, dense_index=TorchDenseIndex(
            port_embed.dimension, device="cpu", dtype="float32"), sparse_index=BM25Index(),
            settings=Settings(chunking=ChunkingConfig(**chunking)))
        got = port.ingest_path(files_dir)
    with fixed_uuids():
        ref = JDocumentIngestor(embedder=jax_embedder(encoder, coalesce=False),
                                dense_index=TpuDenseIndex(dim=encoder[0].dim, dtype="float32"),
                                sparse_index=JBM25Index(),
                                settings=JSettings(chunking=JChunkingConfig(**chunking)))
        want = ref.ingest_path(files_dir)
    strip = lambda stats: {k: v for k, v in stats.to_dict().items() if k != "elapsed_s"}  # noqa: E731
    assert strip(got) == strip(want)
    assert got.files_skipped >= 3 and got.errors  # image.bin, broken.docx, scan.pdf
    assert _chunks_of(port.dense_index) == _chunks_of(ref.dense_index)
    assert port._sparse_index.doc_ids == ref._sparse_index.doc_ids
    np.testing.assert_allclose(port.dense_index.embeddings(),
                               ref.dense_index._embeddings[ref.dense_index._alive],
                               atol=VECTOR_ATOL, rtol=0)
    assert port.clear() == ref.clear()
    assert port.dense_index.size == 0 and port._sparse_index.size == 0
    # ingesting a file again: the cache serves every chunk
    hits0 = port_embed.cache.hits
    stats = port.ingest_path(files_dir / "nested")
    assert port_embed.cache.hits - hits0 == stats.chunks_embedded > 0
    port_embed.close()


def test_ingest_document_matches_jax(encoder):
    text = seeded_text(40, 200)
    with fixed_uuids():
        embed = port_embedder(encoder, coalesce=False)
        port = DocumentIngestor(embedder=embed, dense_index=TorchDenseIndex(
            embed.dimension, device="cpu", dtype="float32"))
        got = port.ingest_document(text, {"source": "api"})
    with fixed_uuids():
        ref = JDocumentIngestor(embedder=jax_embedder(encoder, coalesce=False),
                                dense_index=TpuDenseIndex(dim=encoder[0].dim, dtype="float32"),
                                settings=JSettings())
        want = ref.ingest_document(text, {"source": "api"})
    assert got.to_dict()["chunks_stored"] == want.to_dict()["chunks_stored"] > 1
    assert _chunks_of(port.dense_index) == _chunks_of(ref.dense_index)


# ------------------------------------------------- embedding cache, coalescer


def test_embedding_cache_matches_jax(monkeypatch):
    """One sequence of puts and gets on a 4-entry cache: the same hits,
    misses, sizes and LFU victims after every operation."""
    rng = np.random.default_rng(5)
    keys = [f"text {i}" for i in range(7)]
    ops = [("put" if rng.random() < 0.4 else "get", str(rng.choice(keys))) for _ in range(120)]
    port, ref = EmbeddingCache(max_size=4, ttl_s=0), JEmbeddingCache(max_size=4, ttl_s=0)
    vec = np.ones(3, np.float32)
    for op, key in ops:
        if op == "put":
            port.put(key, vec)
            ref.put(key, vec)
        else:
            assert (port.get(key) is None) == (ref.get(key) is None)
        assert port.stats() == ref.stats()
        assert set(port._store) == set(ref._store)
    assert port.stats()["hits"] > 0 and port.stats()["misses"] > 0


def test_embedding_cache_ttl_expires():
    cache = EmbeddingCache(max_size=4, ttl_s=1e-9)
    cache.put("a", np.zeros(2, np.float32))
    assert cache.get("a") is None and cache.stats()["size"] == 0


def test_coalesced_embeds_equal_one_at_a_time(encoder):
    """8 threads released together embed one query each through the
    coalescer (cache off, so every query reaches the device path); each
    vector equals the same query embedded alone, and no batch holds more
    than ``coalesce_max`` rows."""
    embed = port_embedder(encoder, coalesce=True, coalesce_max=4, coalesce_deadline_ms=50.0,
                          cache_size=0)
    queries = [f"which {w} holds the {v}?" for w, v in zip(WORDS[:8], WORDS[4:12])]
    out: list = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def run(i):
        start.wait(timeout=JOIN_S)
        out[i] = np.asarray(embed.embed_device([queries[i]]))[0]

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    alone = np.stack([embed.embed_tensor([q])[0].numpy() for q in queries])
    np.testing.assert_allclose(np.stack(out), alone, atol=COALESCE_ATOL, rtol=0)
    stats = embed.get_stats()["coalescer"]
    assert stats["items"] == len(queries)
    assert 1 <= stats["max_batch"] <= 4
    assert stats["batches"] >= 2
    embed.close()


def test_query_cache_hit_does_no_device_work(encoder):
    """A query embedded once (and cached from the background thread) is
    served from the cache: host vectors, no coalescer batch."""
    embed = port_embedder(encoder, coalesce=True)
    first = embed.embed_device(["a repeated question"])
    deadline = threading.Event()
    for _ in range(200):  # the cache is filled off the caller's thread
        if embed.cache.stats()["size"]:
            break
        deadline.wait(0.01)
    batches = embed.get_stats()["coalescer"]["batches"]
    again = embed.embed_device(["a repeated question"])
    assert isinstance(again, np.ndarray)
    assert embed.get_stats()["coalescer"]["batches"] == batches
    assert embed.stats["cache_hits"] == 1
    np.testing.assert_allclose(again[0], np.asarray(first)[0], atol=COALESCE_ATOL, rtol=0)
    embed.close()
