"""Exact MIPS retrieval on the card — the counterpart of
``sentio_tpu/ops/dense_index.py::TpuDenseIndex``.

The index is the corpus embedding matrix itself, resident on the device
in bf16: a query batch is one ``[Q, D] @ [D, N]`` matmul and a top-k
(``torch.matmul`` + ``torch.topk``; the JAX package leaves the same work to
XLA, outside any Pallas kernel). The host keeps the float32 master copy and
the documents, with the same add / upsert / tombstone / compaction rules
and the same ``.npz`` + ``.json`` persistence, so an index saved by either
package loads in the other.

Writes may run while other threads search (``/upload`` during ``/chat``):
a lock serializes the mutations and the building of the device snapshot,
and a search reads one snapshot — the corpus matrix, its valid mask and
the document list it was built from — so it sees the index whole before a
write or whole after it, never a matrix and a document list of different
lengths.

On a device mesh (``mesh``) the rows shard over every mesh axis, as
JAX's ``P(axes, None)``: each coordinate holds a contiguous block of the
padded corpus on its device and takes its local top-k, and the
candidates, gathered on the mesh's first device, are merged by one more
top-k into JAX's order and scores (its ``_build_topk``).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.parallel.collectives import all_gather, broadcast


class DenseIndexError(Exception):
    pass


def _scores(qn, corpus, valid):
    """[Q, N] float32 inner products, invalid rows at -inf."""
    scores = torch.matmul(qn.to(corpus.dtype), corpus.t()).float()
    return torch.where(valid[None, :], scores, float("-inf"))


class TorchDenseIndex:
    """Exact top-k cosine/MIPS index. Embeddings are L2-normalized at add
    time, so inner product == cosine."""

    def __init__(self, dim: int, device=None, dtype: str = "bfloat16", mesh=None) -> None:
        self.dim = dim
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.dtype = dtype
        self._embeddings = np.zeros((0, dim), np.float32)  # host master
        self._documents: list[Document] = []
        self._id_to_row: dict[str, int] = {}
        self._alive = np.zeros(0, bool)
        self._device_state = None  # (corpus, valid, documents, alive) — rebuilt lazily
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ crud

    @property
    def size(self) -> int:
        return int(self._alive.sum())

    def documents(self) -> list[Document]:
        with self._lock:
            return [doc for doc, ok in zip(self._documents, self._alive) if ok]

    def add(self, documents: Sequence[Document], embeddings: np.ndarray) -> None:
        with self._lock:
            self._add(documents, embeddings)

    def _add(self, documents: Sequence[Document], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise DenseIndexError(
                f"expected embeddings [N, {self.dim}], got {embeddings.shape}"
            )
        if len(documents) != embeddings.shape[0]:
            raise DenseIndexError("documents/embeddings length mismatch")
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        embeddings = embeddings / np.maximum(norms, 1e-9)
        # duplicate ids within one batch: last write wins
        last_by_id = {doc.id: i for i, doc in enumerate(documents)}
        if len(last_by_id) != len(documents):
            keep = sorted(last_by_id.values())
            documents = [documents[i] for i in keep]
            embeddings = embeddings[keep]
        for doc in documents:
            if doc.id in self._id_to_row:  # upsert: tombstone the old row
                self._alive[self._id_to_row[doc.id]] = False
        base = len(self._documents)
        self._embeddings = np.concatenate([self._embeddings, embeddings])
        self._alive = np.concatenate([self._alive, np.ones(len(documents), bool)])
        for off, doc in enumerate(documents):
            self._documents.append(doc)
            self._id_to_row[doc.id] = base + off
        self._device_state = None
        self._maybe_compact()

    def delete(self, ids: Sequence[str]) -> int:
        n = 0
        with self._lock:
            for doc_id in ids:
                row = self._id_to_row.pop(doc_id, None)
                if row is not None and self._alive[row]:
                    self._alive[row] = False
                    n += 1
            if n:
                self._device_state = None
                self._maybe_compact()
        return n

    def embeddings(self) -> np.ndarray:
        """[size, D] float32 host vectors of the live documents, in
        :meth:`documents` order."""
        with self._lock:
            return self._embeddings[self._alive]

    def clear(self) -> None:
        with self._lock:
            self._embeddings = np.zeros((0, self.dim), np.float32)
            self._documents = []
            self._id_to_row = {}
            self._alive = np.zeros(0, bool)
            self._device_state = None

    def _maybe_compact(self, dead_fraction: float = 0.25) -> None:
        """Drop tombstoned rows once they pass ``dead_fraction`` of the table."""
        total = len(self._documents)
        dead = total - int(self._alive.sum())
        if total == 0 or dead / total <= dead_fraction:
            return
        keep = np.flatnonzero(self._alive)
        self._embeddings = self._embeddings[keep]
        self._documents = [self._documents[i] for i in keep]
        self._alive = np.ones(len(keep), bool)
        self._id_to_row = {doc.id: i for i, doc in enumerate(self._documents)}
        self._device_state = None

    # ---------------------------------------------------------------- search

    def _ensure_device(self):
        """The search snapshot ``(corpus, valid, documents, alive)``: the
        corpus uploaded (dead rows zeroed and masked) with 25% growth
        padding so appends amortize uploads, the document list its rows
        index, and its count of live rows. On a mesh, corpus and valid are
        lists of each coordinate's row block, on its device."""
        with self._lock:
            if self._device_state is None:
                shards = self.mesh.size if self.mesh is not None else 1
                n = len(self._documents)
                n_pad = max(shards, int(np.ceil(n * 1.25 / shards)) * shards)
                corpus = np.zeros((n_pad, self.dim), np.float32)
                if n:
                    corpus[:n] = self._embeddings * self._alive[:, None]
                valid = np.zeros(n_pad, bool)
                valid[:n] = self._alive
                dt = getattr(torch, self.dtype)
                devices = [self.device] if self.mesh is None else list(self.mesh.devices.flat)
                blocks = [(torch.as_tensor(c, device=d).to(dt), torch.as_tensor(v, device=d))
                          for c, v, d in zip(np.split(corpus, shards), np.split(valid, shards),
                                             devices)]
                corpus_t, valid_t = ((blocks[0][0], blocks[0][1]) if self.mesh is None else
                                     ([c for c, _ in blocks], [v for _, v in blocks]))
                self._device_state = (corpus_t, valid_t, list(self._documents),
                                      int(self._alive.sum()))
            return self._device_state

    def search_batch(self, queries, top_k: int = 10) -> list[list[tuple[Document, float]]]:
        """queries [Q, D] (host array or device tensor) → per-query
        (Document, cosine score) in descending order."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise DenseIndexError(f"expected queries [Q, {self.dim}], got {tuple(q.shape)}")
        corpus, valid, documents, alive = self._ensure_device()
        if alive == 0:
            return [[] for _ in range(q.shape[0])]
        qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)
        k = min(top_k, alive)
        if self.mesh is None:
            best, rows = torch.topk(_scores(qn, corpus, valid), k, dim=1)
        else:
            best, rows = self._sharded_topk(qn, corpus, valid, k)
        best, rows = best.cpu().numpy(), rows.cpu().numpy()
        out: list[list[tuple[Document, float]]] = []
        for qi in range(q.shape[0]):
            hits = []
            for s, r in zip(best[qi], rows[qi]):
                if s <= -1e29 or len(hits) >= k:
                    break
                hits.append((documents[int(r)], float(s)))
            out.append(hits)
        return out

    def _sharded_topk(self, qn, corpus: list, valid: list, k: int):
        """Each row block's local top-k, its rows made global, the
        candidates gathered in block order and merged by a last top-k."""
        n_local = corpus[0].shape[0]
        k_local = min(max(k, 1), n_local)
        k_out = min(k, len(corpus) * k_local)
        cand_s, cand_i = [], []
        for i, (c, v, q) in enumerate(zip(corpus, valid, broadcast(qn, [c.device for c in
                                                                           corpus]))):
            s, r = torch.topk(_scores(q, c, v), k_local, dim=1)
            cand_s.append(s)
            cand_i.append(r + i * n_local)
        cat_s, cat_i = all_gather(cand_s, self.device, 1), all_gather(cand_i, self.device, 1)
        best, pos = torch.topk(cat_s, k_out, dim=1)
        return best, torch.gather(cat_i, 1, pos)

    def search(self, query, top_k: int = 10) -> list[tuple[Document, float]]:
        return self.search_batch(query[None, :], top_k)[0]

    def retrieve(self, query_embedding, top_k: int = 10) -> list[Document]:
        out = []
        for doc, score in self.search(query_embedding, top_k):
            meta = dict(doc.metadata)
            meta["score"] = score
            meta["retriever"] = "dense"
            out.append(Document(text=doc.text, metadata=meta, id=doc.id))
        return out

    # ------------------------------------------------------------ persistence

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            keep = self._alive
            embeddings = self._embeddings[keep]
            docs = [self._documents[i].to_dict() for i in np.flatnonzero(keep)]
        np.savez_compressed(path.with_suffix(".npz"), embeddings=embeddings)
        path.with_suffix(".json").write_text(json.dumps({"dim": self.dim, "documents": docs}))

    @classmethod
    def load(cls, path, device=None, dtype: str = "bfloat16", mesh=None) -> "TorchDenseIndex":
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        index = cls(dim=int(meta["dim"]), device=device, dtype=dtype, mesh=mesh)
        embeddings = np.load(path.with_suffix(".npz"))["embeddings"]
        docs = [Document.from_dict(d) for d in meta["documents"]]
        if docs:
            index.add(docs, embeddings)
        return index
