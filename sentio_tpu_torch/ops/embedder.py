"""Bi-encoder embedder on the card — ``sentio_tpu/ops/embedder.py::
TpuEmbedder`` in PyTorch, with the JAX service wrapper's host services.

Texts are tokenized host-side, padded to the same sequence and batch
buckets as the JAX embedder, run through the encoder with the flash kernel
as its attention, and mean-pooled into L2-normalized vectors.

As in JAX, :meth:`TorchEmbedder.embed_many` (ingest) goes through an LFU
cache with a TTL (``EMBEDDING_CACHE_SIZE``, ``EMBEDDING_CACHE_TTL``), and
:meth:`TorchEmbedder.embed_device` (the dense retrieval leg's query) does
too: a full hit does no device work; a single-text miss is coalesced with
other threads' queries into one padded device batch
(``EMBED_COALESCE_MAX``, ``EMBED_COALESCE_DEADLINE_MS``) by a dispatcher
thread, and the cache is filled from a background thread so the caller
never waits on the host copy.

``EMBEDDER_PROVIDER`` picks the embedder (:func:`get_embedder`): ``tpu``
the bi-encoder, any other name :class:`HashEmbedder` (the JAX package's
hash-seeded vectors, no model). ``EMBEDDER_CHECKPOINT`` loads an encoder
with the tokenizer of ``EMBEDDER_TOKENIZER``.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import EmbedderConfig
from sentio_tpu_torch.kernels import select_encoder_attn_fn
from sentio_tpu_torch.parallel.sharding import ENCODER_TP_RULES, shard_params
from sentio_tpu_torch.models.tokenizer import ByteTokenizer, batch_encode
from sentio_tpu_torch.models.transformer import (
    EncoderConfig,
    encoder_forward,
    init_encoder,
    mean_pool,
)
from sentio_tpu_torch.parallel.batcher import ThreadBatcher, bucket_size
from sentio_tpu_torch.runtime.weights import load_encoder, load_tokenizer

logger = logging.getLogger(__name__)


class EmbeddingCache:
    """LFU with a TTL, thread-safe — a copy of the JAX ``EmbeddingCache``."""

    def __init__(self, max_size: int = 10_000, ttl_s: float = 3600.0) -> None:
        self.max_size = max_size
        self.ttl_s = ttl_s
        self._store: dict[str, tuple[np.ndarray, float, int]] = {}  # key -> (vec, t, hits)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(text: str) -> str:
        return hashlib.sha256(text.encode()).hexdigest()

    def get(self, text: str) -> Optional[np.ndarray]:
        k = self.key(text)
        with self._lock:
            entry = self._store.get(k)
            if entry is None:
                self.misses += 1
                return None
            vec, t, hits = entry
            if self.ttl_s > 0 and time.perf_counter() - t > self.ttl_s:
                del self._store[k]
                self.misses += 1
                return None
            self._store[k] = (vec, t, hits + 1)
            self.hits += 1
            return vec

    def put(self, text: str, vec: np.ndarray) -> None:
        if self.max_size <= 0:  # caching disabled
            return
        k = self.key(text)
        with self._lock:
            if len(self._store) >= self.max_size and k not in self._store:
                # evict least-frequently-used
                victim = min(self._store.items(), key=lambda kv: kv[1][2])[0]
                del self._store[victim]
            self._store[k] = (vec, time.perf_counter(), 0)

    def clear(self) -> int:
        """Drop every entry; returns how many there were."""
        with self._lock:
            n = len(self._store)
            self._store.clear()
            return n

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._store),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
            }


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


class BaseEmbedder:
    """The JAX ``BaseEmbedder``'s service wrapper: the LFU cache, the stats
    and ``embed_many`` over a provider's ``_embed_batch``."""

    def __init__(self, config: Optional[EmbedderConfig]) -> None:
        self.config = config or EmbedderConfig()
        self.cache = EmbeddingCache(self.config.cache_size, self.config.cache_ttl_s)
        self.stats = {"requests": 0, "texts": 0, "errors": 0, "time_s": 0.0}
        # encoder forwards (each one flash launch a layer on the card)
        self.forwards = 0
        self._forwards_lock = threading.Lock()

    def _embed_batch(self, texts: list[str]) -> np.ndarray:  # [B, dim] float32
        raise NotImplementedError

    def close(self) -> None:
        """Stop the provider's threads, if any."""

    def get_stats(self) -> dict:
        return {**self.stats, "cache": self.cache.stats()}

    def embed_many(self, texts: Sequence[str]) -> np.ndarray:
        """[N, D] float32 host array: cached texts from the cache, the rest
        embedded in batches of ``config.batch_size`` and cached."""
        t0 = time.perf_counter()
        self.stats["requests"] += 1
        self.stats["texts"] += len(texts)
        out = np.zeros((len(texts), self.dimension), np.float32)
        missing: list[tuple[int, str]] = []
        for i, text in enumerate(texts):
            cached = self.cache.get(text)
            if cached is not None:
                out[i] = cached
            else:
                missing.append((i, text))
        try:
            for start in range(0, len(missing), self.config.batch_size):
                chunk = missing[start : start + self.config.batch_size]
                vecs = self._embed_batch([t for _, t in chunk])
                for (i, text), vec in zip(chunk, vecs):
                    out[i] = vec
                    self.cache.put(text, vec)
        except Exception:
            self.stats["errors"] += 1
            raise
        finally:
            self.stats["time_s"] += time.perf_counter() - t0
        return out


class HashEmbedder(BaseEmbedder):
    """``EMBEDDER_PROVIDER`` other than ``tpu`` — the JAX ``HashEmbedder``:
    deterministic hash-seeded unit vectors of ``config.dim``, no model and
    no device work. ``device`` is where the index that searches them lives
    (query vectors are handed to it as host arrays)."""

    def __init__(self, config: Optional[EmbedderConfig] = None, device=None) -> None:
        super().__init__(config)
        self.device = resolve_device(device)

    @property
    def dimension(self) -> int:
        return self.config.dim

    def _embed_batch(self, texts: list[str]) -> np.ndarray:
        return hash_embed(texts, self.dimension)

    def embed_device(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed_many(list(texts))


class TorchEmbedder(BaseEmbedder):
    BUCKETS = (16, 32, 64, 128, 256, 512)
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

    def __init__(self, config: Optional[EmbedderConfig] = None, params: Optional[dict] = None,
                 model_config: Optional[EncoderConfig] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 tokenizer=None, mesh=None) -> None:
        super().__init__(config)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if params is None and self.config.checkpoint_path:
            # real weights: an encoder checkpoint and its own tokenizer
            params, model_config = load_encoder(self.config.checkpoint_path,
                                                device=self.device)
            tokenizer = tokenizer or load_tokenizer(self.config.tokenizer_path, model_config)
        self.model_config = model_config or (
            EncoderConfig.tiny() if self.config.model_preset == "tiny" else EncoderConfig.base()
        )
        self.tokenizer = tokenizer or ByteTokenizer(self.model_config.vocab_size)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = init_encoder(self.model_config, generator, self.device)
        # on a mesh: ENCODER_TP_RULES, computed on the first data
        # coordinate's tp shards (JAX replicates the encoder over dp)
        self.mesh = mesh
        if mesh is not None:
            params = shard_params(params, mesh, ENCODER_TP_RULES).group(0)
        self.params = params
        # JAX's policy: the flash kernel per tp shard at sp 1, plain
        # attention on an sp mesh (the ring is causal-only)
        self.attn_fn = select_encoder_attn_fn(mesh, self.model_config.n_heads)
        # built eagerly; the dispatcher thread starts on the first submit
        self._query_batcher: Optional[ThreadBatcher] = None
        if self.config.coalesce:
            def process(batch_texts: list[str]) -> list[torch.Tensor]:
                out = self._embed_device_batch(batch_texts)
                # each caller gets its own [1, D] device slice (no download)
                return [out[i : i + 1] for i in range(len(batch_texts))]

            self._query_batcher = ThreadBatcher(
                process, max_size=self.config.coalesce_max,
                deadline_ms=self.config.coalesce_deadline_ms, name="embed-coalescer")

    @property
    def dimension(self) -> int:
        return self.model_config.dim

    def close(self) -> None:
        """Stop the coalescer's dispatcher thread."""
        if self._query_batcher is not None:
            self._query_batcher.close()

    def get_stats(self) -> dict:
        stats = super().get_stats()
        if self._query_batcher is not None:
            stats["coalescer"] = self._query_batcher.stats.snapshot()
        return stats

    def _embed_batch(self, texts: list[str]) -> np.ndarray:
        return self.embed_tensor(texts).cpu().numpy()

    def embed_device(self, texts: Sequence[str]):
        """[n, D] query vectors for the index: a full cache hit returns the
        cached host vectors (no device work); a single text is coalesced
        with other threads' queries; several texts are one batch. Misses
        stay on the device and fill the cache from a background thread."""
        texts = list(texts)
        cached = [self.cache.get(t) for t in texts]
        if all(c is not None for c in cached):
            self.stats["cache_hits"] = self.stats.get("cache_hits", 0) + len(texts)
            return np.stack(cached).astype(np.float32)
        if len(texts) == 1 and self._query_batcher is not None:
            return self._query_batcher.submit(texts[0])
        return self._embed_device_batch(texts)

    def _embed_device_batch(self, texts: list[str]) -> torch.Tensor:
        out = self.embed_tensor(texts)
        if self.cache.max_size > 0:  # cache off: skip the host copy

            def fill_cache() -> None:
                try:
                    host = out.cpu().numpy()
                    for text, vec in zip(texts, host):
                        self.cache.put(text, vec)
                except Exception as exc:  # best-effort, but never silent
                    logger.warning("embed_device background cache fill failed: %s", exc)

            threading.Thread(target=fill_cache, name="embedder-cache-fill",
                             daemon=True).start()
        return out

    def embed_tensor(self, texts: Sequence[str]) -> torch.Tensor:
        """[n, D] float32 on the device, no host copy (the dense retrieval
        leg feeds it straight to the index)."""
        ids, mask = batch_encode(
            self.tokenizer, list(texts),
            max_len=min(self.config.max_tokens, self.model_config.max_len),
        )
        # pad sequence AND batch to buckets, as the JAX embedder does
        n = ids.shape[0]
        width = bucket_size(ids.shape[1], self.BUCKETS)
        rows = bucket_size(n, self.BATCH_BUCKETS)
        ids = np.pad(ids, ((0, rows - n), (0, width - ids.shape[1])),
                     constant_values=self.tokenizer.pad_id)
        mask = np.pad(mask, ((0, rows - n), (0, width - mask.shape[1])))
        ids_t = torch.as_tensor(ids, device=self.device)
        mask_t = torch.as_tensor(mask, device=self.device)
        with self._forwards_lock:
            self.forwards += 1
        with torch.inference_mode():
            hidden = encoder_forward(self.params, self.model_config, ids_t, mask_t,
                                     attn_fn=self.attn_fn)
            return mean_pool(hidden, mask_t)[:n]


def get_embedder(config: Optional[EmbedderConfig] = None, device=None, **kwargs):
    """``EMBEDDER_PROVIDER``: ``tpu`` builds the bi-encoder (``kwargs`` go
    to it); any other name, an unknown one too, the hash embedder, as the
    JAX registry falls back."""
    config = config or EmbedderConfig()
    if config.provider == "tpu":
        return TorchEmbedder(config, device=device, **kwargs)
    return HashEmbedder(config, device=device)
