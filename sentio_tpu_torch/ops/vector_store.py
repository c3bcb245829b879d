"""Pluggable vector stores — the counterpart of
``sentio_tpu/ops/vector_store.py``: the exact index on the card and an
external Qdrant collection, behind one registry (``INDEX_BACKEND`` /
``VECTOR_STORE``: ``tpu`` or ``qdrant``).

:class:`QdrantVectorStore` speaks Qdrant's REST API over the port's
:class:`~sentio_tpu_torch.infra.http_client.HttpClient` (the machine with
the card has neither ``httpx`` nor ``qdrant-client``), with JAX's rules:

* a pool of ``pool_size`` clients taken round-robin, so concurrent
  retrieval legs do not queue on one connection;
* every operation runs breaker(retry(op)): connection failures, 5xx and a
  2xx body that is not JSON are transient (:class:`TransientStoreError`)
  and retried with jittered backoff, then counted by a breaker named
  ``qdrant:<collection>`` (on ``/health/detailed`` and
  ``sentio_circuit_breaker_state``); a 4xx is not retried and proves the
  store is up; an open breaker raises :class:`VectorStoreError` at once;
* a daemon thread probes ``/collections`` every ``health_interval_s`` and
  :meth:`~QdrantVectorStore.health` answers from its last verdict;
* the collection is made on first use (cosine distance: the embedder's
  vectors are unit-norm, so its ranking is the card index's inner
  product); point ids are UUIDv5 hashes of the document ids, which ride in
  the payload; :meth:`~QdrantVectorStore.documents` scrolls the whole
  collection (BM25 is rebuilt from it), ``add`` upserts in batches of 128.

Both stores take a query as a host array or a tensor on the card; the
Qdrant store copies it to the host once a call.
"""

from __future__ import annotations

import http.client
import itertools
import logging
import threading
import uuid
from typing import Any, Optional, Protocol, Sequence

import numpy as np

from sentio_tpu_torch.infra.exceptions import VectorStoreError
from sentio_tpu_torch.infra.http_client import HttpClient
from sentio_tpu_torch.infra.resilience import CircuitBreaker, RetryPolicy, unregister_breaker
from sentio_tpu_torch.models.document import Document

logger = logging.getLogger(__name__)

__all__ = ["VectorStore", "VectorStoreError", "TransientStoreError", "QdrantVectorStore",
           "get_vector_store"]

_UUID_NS = uuid.UUID("8a6e0804-2bd0-4672-b79d-d97027f9071a")
_TEXT_KEYS = ("text", "content", "page_content", "body")


class VectorStore(Protocol):
    """What retrieval and ingestion need of a store."""

    dim: int

    @property
    def size(self) -> int: ...
    def documents(self) -> list[Document]: ...
    def add(self, documents: Sequence[Document], embeddings: np.ndarray) -> None: ...
    def delete(self, ids: Sequence[str]) -> int: ...
    def clear(self) -> None: ...
    def search(self, query, top_k: int = 10) -> list[tuple[Document, float]]: ...
    def search_batch(self, queries, top_k: int = 10) -> list[list[tuple[Document, float]]]: ...
    def retrieve(self, query_embedding, top_k: int = 10) -> list[Document]: ...


class TransientStoreError(VectorStoreError):
    """A connection failure or a 5xx — retried; a 4xx is not."""


def _point_id(doc_id: str) -> str:
    return str(uuid.uuid5(_UUID_NS, doc_id))


def _payload_to_document(payload: dict, point_id: str) -> Document:
    """A payload as a Document; the text may sit under any of several keys
    (payloads written by other tools)."""
    text = ""
    for key in _TEXT_KEYS:
        val = payload.get(key)
        if isinstance(val, str) and val:
            text = val
            break
    meta = payload.get("metadata")
    if not isinstance(meta, dict):
        meta = {k: v for k, v in payload.items() if k not in (*_TEXT_KEYS, "doc_id")}
    return Document(text=text, id=str(payload.get("doc_id") or point_id), metadata=dict(meta))


def _host(x) -> np.ndarray:
    """A query (host array or tensor, on any device) as float32 on the host."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _hits(result: list) -> list[tuple[Document, float]]:
    return [(_payload_to_document(hit.get("payload") or {}, str(hit["id"])),
             float(hit["score"])) for hit in result]


class QdrantVectorStore:
    """An external Qdrant collection over its REST API (see the module)."""

    def __init__(self, dim: int, url: str = "http://localhost:6333",
                 collection: str = "sentio", api_key: str = "", timeout_s: float = 10.0,
                 pool_size: int = 3, health_interval_s: float = 30.0,
                 retry: Optional[RetryPolicy] = None) -> None:
        self.dim = dim
        self.collection = collection
        headers = {"api-key": api_key} if api_key else {}
        self._clients = [HttpClient(url, timeout=timeout_s, headers=headers)
                         for _ in range(max(int(pool_size), 1))]
        self._rr = itertools.count()
        self._breaker = CircuitBreaker(name=f"qdrant:{collection}", failure_threshold=5,
                                       recovery_timeout_s=max(health_interval_s, 5.0))
        self._retry = retry or RetryPolicy(max_attempts=3, base_delay_s=0.1, max_delay_s=2.0,
                                           retry_on=(TransientStoreError,))
        self._bootstrapped = False
        self._bootstrap_lock = threading.Lock()
        self._health_interval = float(health_interval_s)
        self._healthy: Optional[bool] = None  # None until the loop reports
        self._stop = threading.Event()
        self._health_lock = threading.Lock()
        self._health_thread: Optional[threading.Thread] = None

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def _next_client(self) -> HttpClient:
        return self._clients[next(self._rr) % len(self._clients)]

    # ------------------------------------------------------------------ http

    def _raw_request(self, method: str, path: str, json_body: Optional[dict]) -> dict:
        try:
            resp = self._next_client().request(method, path, json_body)
        except (OSError, http.client.HTTPException) as exc:
            raise TransientStoreError(f"qdrant {method} {path}: {exc}") from exc
        if resp.status_code >= 400:
            text = resp.content[:300].decode("utf-8", "replace")
            error = TransientStoreError if resp.status_code >= 500 else VectorStoreError
            raise error(f"qdrant {method} {path} -> {resp.status_code}: {text}")
        try:
            return resp.json()
        except ValueError as exc:
            # a 2xx body that is not JSON (a proxy in the way) stays inside
            # the store's error contract
            raise TransientStoreError(f"qdrant {method} {path}: non-JSON 2xx body") from exc

    def _request(self, method: str, path: str, json_body: Optional[dict] = None) -> dict:
        self._ensure_health_loop()
        if not self._breaker.allow():
            raise VectorStoreError(f"qdrant unavailable: circuit {self._breaker.name} open")
        try:
            out = self._retry.run(self._raw_request, method, path, json_body)
        except TransientStoreError:
            self._breaker.record_failure()
            raise
        except VectorStoreError:
            # a 4xx proves the store is up: client errors never open the
            # circuit on a healthy store
            self._breaker.record_success()
            raise
        self._breaker.record_success()
        return out

    # ---------------------------------------------------------------- health

    def _ensure_health_loop(self) -> None:
        if (self._health_interval <= 0 or self._health_thread is not None
                or self._stop.is_set()):
            return
        with self._health_lock:  # the first concurrent requests start one prober
            if self._health_thread is not None or self._stop.is_set():
                return
            self._health_thread = threading.Thread(
                target=self._health_loop, name=f"qdrant-health-{self.collection}", daemon=True)
            self._health_thread.start()

    def _health_loop(self) -> None:
        while not self._stop.wait(self._health_interval):
            ok = self._probe()
            if ok != self._healthy:
                logger.info("qdrant %s health: %s", self.collection,
                            "recovered" if ok else "DOWN")
            self._healthy = ok

    def _probe(self) -> bool:
        try:
            # past the breaker: the loop is how an open breaker's store is
            # seen to recover without live traffic
            self._raw_request("GET", "/collections", None)
            return True
        except Exception:  # noqa: BLE001 — a probe failure of any kind is "not healthy"
            return False

    def _ensure_collection(self) -> None:
        if self._bootstrapped:
            return
        # serialized, so two first queries do not race the create; a 409
        # from another process's create is success
        with self._bootstrap_lock:
            if self._bootstrapped:
                return
            exists = True
            try:
                self._request("GET", f"/collections/{self.collection}")
            except TransientStoreError:
                raise
            except VectorStoreError as exc:
                if "-> 404" not in str(exc):
                    raise
                exists = False
            if not exists:
                try:
                    self._request("PUT", f"/collections/{self.collection}",
                                  {"vectors": {"size": self.dim, "distance": "Cosine"}})
                except VectorStoreError as exc:
                    if "409" not in str(exc):
                        raise
            self._bootstrapped = True

    def health(self) -> bool:
        if self._stop.is_set():
            return False  # a closed store is not healthy
        self._ensure_health_loop()
        if self._healthy is not None:
            return self._healthy
        return self._probe()

    # ------------------------------------------------------------------ crud

    @property
    def size(self) -> int:
        self._ensure_collection()
        out = self._request("POST", f"/collections/{self.collection}/points/count",
                            {"exact": True})
        return int(out["result"]["count"])

    def add(self, documents: Sequence[Document], embeddings) -> None:
        embeddings = _host(embeddings)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise VectorStoreError(f"expected embeddings [N, {self.dim}], got "
                                   f"{embeddings.shape}")
        if len(documents) != embeddings.shape[0]:
            raise VectorStoreError("documents/embeddings length mismatch")
        self._ensure_collection()
        points = [{"id": _point_id(doc.id), "vector": emb.tolist(),
                   "payload": {"doc_id": doc.id, "text": doc.text, "metadata": doc.metadata}}
                  for doc, emb in zip(documents, embeddings)]
        for start in range(0, len(points), 128):
            self._request("PUT", f"/collections/{self.collection}/points?wait=true",
                          {"points": points[start:start + 128]})

    def delete(self, ids: Sequence[str]) -> int:
        if not ids:
            return 0
        self._ensure_collection()
        pids = [_point_id(i) for i in ids]
        # which of these exist (by id, no payloads): counting before and
        # after would race concurrent writers
        existing = self._request("POST", f"/collections/{self.collection}/points",
                                 {"ids": pids, "with_payload": False, "with_vector": False})
        n = len(existing.get("result") or [])
        self._request("POST", f"/collections/{self.collection}/points/delete?wait=true",
                      {"points": pids})
        return n

    def clear(self) -> None:
        self._request("DELETE", f"/collections/{self.collection}")
        self._bootstrapped = False

    def documents(self) -> list[Document]:
        """Every document of the collection, scrolled 256 at a time."""
        self._ensure_collection()
        docs: list[Document] = []
        offset = None
        while True:
            body: dict = {"limit": 256, "with_payload": True, "with_vector": False}
            if offset is not None:
                body["offset"] = offset
            result = self._request("POST", f"/collections/{self.collection}/points/scroll",
                                   body)["result"]
            docs.extend(_payload_to_document(pt.get("payload") or {}, str(pt["id"]))
                        for pt in result["points"])
            offset = result.get("next_page_offset")
            if offset is None:
                return docs

    # ---------------------------------------------------------------- search

    def search(self, query, top_k: int = 10) -> list[tuple[Document, float]]:
        self._ensure_collection()
        out = self._request("POST", f"/collections/{self.collection}/points/search",
                            {"vector": _host(query).reshape(-1).tolist(), "limit": int(top_k),
                             "with_payload": True})
        return _hits(out["result"])

    def search_batch(self, queries, top_k: int = 10) -> list[list[tuple[Document, float]]]:
        self._ensure_collection()
        body = {"searches": [{"vector": q.tolist(), "limit": int(top_k), "with_payload": True}
                             for q in _host(queries)]}
        out = self._request("POST", f"/collections/{self.collection}/points/search/batch",
                            body)
        return [_hits(result) for result in out["result"]]

    def retrieve(self, query_embedding, top_k: int = 10) -> list[Document]:
        out = []
        for doc, score in self.search(query_embedding, top_k):
            meta = dict(doc.metadata)
            meta["score"] = score
            meta["retriever"] = "qdrant"
            out.append(Document(text=doc.text, id=doc.id, metadata=meta))
        return out

    def close(self) -> None:
        """Stop the health loop, close the clients, and take the breaker out
        of the registry."""
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2.0)
            self._health_thread = None
        for client in self._clients:
            client.close()
        unregister_breaker(self._breaker)


def get_vector_store(name: str, dim: int, device=None, settings: Any = None,
                     mesh=None, **kwargs: Any) -> Any:
    """The registry: ``tpu`` (the exact index on ``device``, the default,
    its rows sharded over ``mesh`` when one is given) or ``qdrant`` (the
    REST store, its URL, collection and key from ``settings.retrieval``
    unless given; a mesh means nothing to it)."""
    if name == "tpu":
        from sentio_tpu_torch.ops.dense_index import TorchDenseIndex

        return TorchDenseIndex(dim=dim, device=device, dtype=kwargs.pop("dtype", "bfloat16"),
                               mesh=mesh)
    if name == "qdrant":
        r = settings.retrieval if settings is not None else None
        url = kwargs.pop("url", "") or (r.qdrant_url if r else "") or "http://localhost:6333"
        collection = kwargs.pop("collection", None) or (r.collection_name if r else "sentio")
        if "api_key" not in kwargs and r is not None:
            kwargs["api_key"] = r.qdrant_api_key
        kwargs.pop("dtype", None)
        return QdrantVectorStore(dim=dim, url=url, collection=collection, **kwargs)
    raise VectorStoreError(f"unknown vector store {name!r} (expected: tpu, qdrant)")
