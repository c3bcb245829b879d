"""Measured reference-architecture baseline — ``sentio_tpu/eval/
baseline.py`` on the standard library.

The reference stack itself cannot run here; what can be measured is its
architecture: the same pipeline shape (retrieve with dense + sparse fused
→ rerank → select → generate → verify) with every model step behind a real
loopback HTTP hop, served by :class:`MockModelServer` with the reference's
own mock-mode semantics (hash embeddings, a decaying default ranking, a
canned chat). Zero network latency and zero model compute make it a lower
bound for the reference: every millisecond it records is architecture
cost (HTTP framing, JSON, Python-loop retrieval math).

The server runs on ``http.server`` (HTTP/1.1 keep-alive) and the pipeline's
client keeps one persistent connection per thread, as the JAX baseline's
``httpx.Client`` does: a connection per call would add a handshake to
every hop and flatter the port in the north-star comparison.
``http_calls`` counts the calls each surface served.
"""

from __future__ import annotations

import hashlib
import json
import math
import re
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from sentio_tpu_torch.infra.http_client import HttpClient
from sentio_tpu_torch.models.document import Document

RRF_K = 20  # the reference's tuned value


def hash_embed(texts: Sequence[str], dim: int) -> np.ndarray:
    """Deterministic hash-seeded unit vectors with token-level signal —
    ``sentio_tpu/ops/embedder.py::HashEmbedder._embed_batch``."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, text in enumerate(texts):
        seed = int.from_bytes(hashlib.sha256(text.lower().encode()).digest()[:8], "little")
        vec = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
        # sorted: the same summation order in every process
        for tok in sorted(set(text.lower().split())):
            tseed = int.from_bytes(hashlib.md5(tok.encode()).digest()[:8], "little")
            vec += 4.0 * np.random.default_rng(tseed).standard_normal(dim).astype(np.float32)
        out[i] = vec / max(np.linalg.norm(vec), 1e-9)
    return out


# ------------------------------------------------------- loopback mock APIs


class _MockHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_MockHTTPServer"
    # an idle keep-alive connection is dropped after this long
    timeout = 60
    # headers and body go out as two writes: with Nagle's algorithm on, the
    # body waits for the client's delayed ACK of the headers (~40 ms a hop);
    # aiohttp sets TCP_NODELAY too
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args) -> None:  # noqa: D102 — silent
        pass

    def do_POST(self) -> None:  # noqa: N802 — http.server's naming
        mock = self.server.mock
        length = int(self.headers.get("Content-Length", "0") or 0)
        raw = self.rfile.read(length) if length else b""
        route = {"/v1/embeddings": mock._embeddings, "/v1/rerank": mock._rerank,
                 "/v1/chat/completions": mock._chat}.get(self.path)
        if route is None:
            self._reply(404, {"error": "not found"})
            return
        if mock.rtt_s:
            time.sleep(mock.rtt_s)
        self._reply(200, route(json.loads(raw or b"{}")))

    def _reply(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _MockHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, mock: "MockModelServer") -> None:
        self.mock = mock
        super().__init__(("127.0.0.1", 0), _MockHandler)


class MockModelServer:
    """The reference's three remote-model surfaces on loopback, with its
    mock-mode semantics: deterministic hash embeddings, the identity rerank
    with decaying scores, a canned chat. ``calls`` counts each surface's
    calls."""

    def __init__(self, dim: int = 1024, rtt_ms: float = 0.0) -> None:
        self.dim = dim
        self.rtt_s = max(rtt_ms, 0.0) / 1000.0
        self.port: Optional[int] = None
        self.calls: dict = defaultdict(int)
        self._calls_lock = threading.Lock()
        self._server: Optional[_MockHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _count(self, surface: str) -> None:
        with self._calls_lock:
            self.calls[surface] += 1

    def _embeddings(self, body: dict) -> dict:
        self._count("embeddings")
        vecs = hash_embed(body["input"], self.dim)
        return {"data": [{"embedding": v.tolist(), "index": i} for i, v in enumerate(vecs)]}

    def _rerank(self, body: dict) -> dict:
        self._count("rerank")
        n = len(body["documents"])
        # the reference's default ranking: original order, 1.0 - 0.1 * idx
        results = [{"index": i, "relevance_score": max(1.0 - 0.1 * i, 0.0)} for i in range(n)]
        return {"results": results[: body.get("top_n", n)]}

    def _chat(self, body: dict) -> dict:
        self._count("chat")
        content = body["messages"][-1]["content"]
        if '"verdict"' in content or "citations_ok" in content:
            reply = '{"verdict": "pass", "citations_ok": true, "notes": []}'
        else:
            first = content.splitlines()[0][:120] if content else ""
            reply = f"Based on the provided sources: {first}"
        return {"choices": [{"message": {"content": reply}}]}

    def start(self) -> "MockModelServer":
        self._server = _MockHTTPServer(self)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="mock-model-api", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


# ---------------------------------------------- reference-shape host pipeline


class _PyBM25:
    """rank_bm25-style Okapi scorer: a Python dict walk per document per
    query, the reference's sparse leg."""

    def __init__(self, docs: Sequence[Document], k1: float = 1.5, b: float = 0.75) -> None:
        self.k1, self.b = k1, b
        self.docs = list(docs)
        self.doc_tfs: list[dict[str, int]] = []
        df: dict[str, int] = defaultdict(int)
        lens = []
        for doc in docs:
            toks = doc.content.lower().split()
            tf: dict[str, int] = defaultdict(int)
            for t in toks:
                tf[t] += 1
            self.doc_tfs.append(dict(tf))
            lens.append(len(toks))
            for t in tf:
                df[t] += 1
        n = max(len(self.docs), 1)
        self.avgdl = sum(lens) / n if lens else 0.0
        self.doc_lens = lens
        self.idf = {t: math.log(1.0 + (n - d + 0.5) / (d + 0.5)) for t, d in df.items()}

    def top_k(self, query: str, k: int) -> list[tuple[int, float]]:
        q_toks = query.lower().split()
        scores = []
        for di, tf in enumerate(self.doc_tfs):  # the hot Python loop
            s = 0.0
            norm = self.k1 * (1 - self.b + self.b * self.doc_lens[di] / max(self.avgdl, 1e-9))
            for t in q_toks:
                f = tf.get(t)
                if f:
                    s += self.idf.get(t, 0.0) * f * (self.k1 + 1) / (f + norm)
            if s > 0:
                scores.append((di, s))
        scores.sort(key=lambda x: -x[1])
        return scores[:k]


class ReferenceShapePipeline:
    """The reference's ``/chat`` hot path with its process boundaries:
    embed-query HTTP → dense cosine → Python BM25 → RRF dict merge → scorer
    plugins (keyword regex, a semantic re-embed over HTTP, an MMR loop) →
    rerank HTTP → token-budget select → generate HTTP → verify HTTP."""

    def __init__(self, server: MockModelServer, documents: Sequence[Document],
                 top_k: int = 10, use_rerank: bool = True, use_verify: bool = True,
                 use_scorers: bool = True) -> None:
        self.server = server
        self.docs = list(documents)
        self.top_k = top_k
        self.use_rerank = use_rerank
        self.use_verify = use_verify
        self.use_scorers = use_scorers
        self.client = HttpClient(server.base_url, timeout=30.0)
        # corpus ingestion as the reference does it: embed calls of <= 100
        # texts over HTTP
        texts = [d.content for d in self.docs]
        vecs = [self._embed_http(texts[start : start + 100])
                for start in range(0, len(texts), 100)]
        self.matrix = np.concatenate(vecs, axis=0) if vecs else np.zeros((0, server.dim))
        self.matrix /= np.maximum(np.linalg.norm(self.matrix, axis=1, keepdims=True), 1e-9)
        self.bm25 = _PyBM25(self.docs)

    def close(self) -> None:
        self.client.close()

    def _embed_http(self, texts: list[str]) -> np.ndarray:
        resp = self.client.post("/v1/embeddings", {"input": texts})
        resp.raise_for_status()
        return np.asarray([d["embedding"] for d in resp.json()["data"]], np.float32)

    def _rerank_http(self, query: str, docs: list[Document], top_n: int) -> list[Document]:
        resp = self.client.post("/v1/rerank", {"query": query,
                                               "documents": [d.content for d in docs],
                                               "top_n": top_n})
        resp.raise_for_status()
        return [docs[r["index"]] for r in resp.json()["results"]]

    def _chat_http(self, prompt: str) -> str:
        resp = self.client.post("/v1/chat/completions",
                                {"messages": [{"role": "user", "content": prompt}],
                                 "max_tokens": 1024})
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"]

    def retrieve(self, query: str) -> list[Document]:
        pool = self.top_k * 2
        q_vec = self._embed_http([query])[0]
        q_vec /= max(np.linalg.norm(q_vec), 1e-9)
        sims = self.matrix @ q_vec
        dense_idx = np.argsort(-sims)[:pool]
        sparse_hits = self.bm25.top_k(query, pool)

        fused: dict[int, float] = defaultdict(float)  # the RRF dict merge
        for rank, di in enumerate(dense_idx):
            fused[int(di)] += 1.0 / (RRF_K + rank)
        for rank, (di, _s) in enumerate(sparse_hits):
            fused[di] += 1.0 / (RRF_K + rank)

        merged = [self.docs[di] for di in fused]
        if self.use_scorers and merged:
            # keyword overlap scorer
            q_words = set(re.findall(r"\w+", query.lower()))
            for di in list(fused):
                words = set(re.findall(r"\w+", self.docs[di].content.lower()))
                fused[di] += 0.8 * len(q_words & words) / max(len(q_words), 1)
            # semantic scorer: re-embeds the candidates over HTTP per query
            doc_vecs = self._embed_http([d.content for d in merged])
            for (di, _), vec in zip(fused.items(), doc_vecs):
                denom = max(np.linalg.norm(vec) * np.linalg.norm(q_vec), 1e-9)
                fused[di] += 0.5 * float(np.dot(vec, q_vec) / denom)
            # MMR diversification: a greedy O(k²) Python loop
            chosen: list[int] = []
            cand = list(fused)
            while cand and len(chosen) < self.top_k:
                best, best_score = None, -1e9
                for di in cand:
                    red = 0.0
                    for cj in chosen:
                        a = doc_vecs[merged.index(self.docs[di])]
                        b = doc_vecs[merged.index(self.docs[cj])]
                        red = max(red, float(np.dot(a, b) / max(
                            np.linalg.norm(a) * np.linalg.norm(b), 1e-9)))
                    score = 0.7 * fused[di] - 0.3 * red
                    if score > best_score:
                        best, best_score = di, score
                chosen.append(best)
                cand.remove(best)
            ranked = chosen
        else:
            ranked = [di for di, _ in sorted(fused.items(), key=lambda x: -x[1])[: self.top_k]]
        return [self.docs[di] for di in ranked[: self.top_k]]

    def chat(self, question: str) -> tuple[list[Document], str]:
        docs = self.retrieve(question)
        if self.use_rerank and docs:
            docs = self._rerank_http(question, docs, self.top_k)
        # token-budget select: ~4 chars a token, 2,000 tokens
        budget_chars = 2000 * 4
        selected, used = [], 0
        for doc in docs:
            if used + len(doc.content) > budget_chars and selected:
                break
            selected.append(doc)
            used += len(doc.content)
        context = "\n\n".join(f"[{i}] Source: {d.metadata.get('source', d.id)}\n{d.content}"
                              for i, d in enumerate(selected, 1))
        answer = self._chat_http(f"{context}\n\nQuestion: {question}\nAnswer:")
        if self.use_verify:
            self._chat_http(f'Audit this answer. Reply JSON {{"verdict": ..., '
                            f'"citations_ok": ...}}\nAnswer: {answer}\n'
                            f"Context: {context[:2000]}")
        return selected, answer


def measure_baseline(documents: Sequence[Document], queries: Sequence[tuple[str, str]],
                     dim: int = 1024, rtt_ms: float = 0.0, use_scorers: bool = True):
    """Stand up the loopback mock APIs, run the reference-shape pipeline
    over the queries and return its :class:`EvalResult`, with the ingest
    seconds, each surface's HTTP calls and the connections the client
    opened in ``extras``."""
    from sentio_tpu_torch.eval.harness import run_queries

    server = MockModelServer(dim=dim, rtt_ms=rtt_ms).start()
    t0 = time.perf_counter()
    pipeline = ReferenceShapePipeline(server, documents, use_scorers=use_scorers)
    ingest_s = time.perf_counter() - t0
    try:
        result = run_queries("reference-baseline", pipeline.chat, queries)
        result.extras["ingest_s"] = round(ingest_s, 2)
        result.extras["http_calls"] = dict(server.calls)
        result.extras["http_connections"] = pipeline.client.connections_opened
        return result
    finally:
        pipeline.close()
        server.stop()
