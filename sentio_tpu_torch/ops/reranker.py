"""Cross-encoder reranking on the card — the counterpart of
``sentio_tpu/ops/reranker.py::CrossEncoderReranker``.

(query, doc) pairs are encoded as ``[CLS] q [SEP] d [SEP]``, padded to the
JAX reranker's row buckets, and scored in batches of ``config.batch_size``
through the cross-encoder with the flash kernel as its attention. When
scoring fails the reranker keeps the original order with decaying scores
and sets ``fallback_used``, as the JAX reranker does; ``/chat`` reports it
as ``metadata.rerank_fallback``. ``RERANKER_CHECKPOINT`` loads a
``save_pytree`` cross-encoder checkpoint, with the tokenizer of
``RERANKER_TOKENIZER``. ``RERANKER_KIND`` picks the reranker
(:func:`get_reranker`): ``cross_encoder``, or ``passthrough``
(:class:`PassthroughReranker`, the retrieval order kept).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.config import RerankConfig
from sentio_tpu_torch.kernels import select_encoder_attn_fn
from sentio_tpu_torch.parallel.sharding import ENCODER_TP_RULES, shard_params
from sentio_tpu_torch.models.cross_encoder import cross_encoder_scores, init_cross_encoder
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.tokenizer import ByteTokenizer, batch_encode_pairs
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.parallel.batcher import bucket_size
from sentio_tpu_torch.runtime.weights import load_model, load_tokenizer

logger = logging.getLogger(__name__)


@dataclass
class RerankingResult:
    documents: list[Document]
    scores: list[float]
    model: str
    fallback_used: bool = False


class Reranker:
    """The JAX ``Reranker``: ``rerank`` orders by a provider's ``_score``,
    keeping the original order with decaying scores when scoring fails."""

    name = "base"

    def _score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        raise NotImplementedError

    def rerank(self, query: str, documents: Sequence[Document],
               top_k: Optional[int] = None) -> RerankingResult:
        documents = list(documents)
        if not documents:
            return RerankingResult([], [], self.name)
        top_k = top_k if top_k is not None else len(documents)
        try:
            scores = np.asarray(self._score(query, documents), np.float32)
            if scores.shape != (len(documents),):
                raise ValueError(f"scorer returned shape {scores.shape}")
        except Exception:  # noqa: BLE001 — the JAX reranker's degradation
            logger.exception("%s rerank failed; keeping original order", self.name)
            return self._default_ranking(documents, top_k)
        order = np.argsort(-scores, kind="stable")[:top_k]
        out_docs, out_scores = [], []
        for i in order:
            doc = documents[int(i)]
            meta = dict(doc.metadata)
            # a stale fused score would make a later sort-by-score undo the rerank
            meta.pop("hybrid_score", None)
            meta["rerank_score"] = float(scores[int(i)])
            meta["score"] = float(scores[int(i)])
            out_docs.append(Document(text=doc.text, metadata=meta, id=doc.id))
            out_scores.append(float(scores[int(i)]))
        return RerankingResult(out_docs, out_scores, self.name)

    def _default_ranking(self, documents: list[Document], top_k: int) -> RerankingResult:
        """Original order, decaying scores 1.0 − 0.1·idx floored at 0.1."""
        docs, scores = [], []
        for i, doc in enumerate(documents[:top_k]):
            score = max(1.0 - 0.1 * i, 0.1)
            meta = dict(doc.metadata)
            meta.pop("hybrid_score", None)
            meta["rerank_score"] = score
            meta["score"] = score
            docs.append(Document(text=doc.text, metadata=meta, id=doc.id))
            scores.append(score)
        return RerankingResult(docs, scores, self.name, fallback_used=True)


class PassthroughReranker(Reranker):
    """Keeps retrieval order (scores preserved) — the JAX
    ``PassthroughReranker``."""

    name = "passthrough"

    def _score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        return np.asarray([d.score(1.0 - 0.01 * i) for i, d in enumerate(documents)],
                          np.float32)


class CrossEncoderReranker(Reranker):
    """Batched (query, doc) pair scoring."""

    name = "cross_encoder"
    ROW_BUCKETS = (1, 2, 4, 8, 16, 32)

    def __init__(self, config: Optional[RerankConfig] = None, params: Optional[dict] = None,
                 model_config: Optional[EncoderConfig] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 tokenizer=None, mesh=None) -> None:
        self.config = config or RerankConfig()
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if params is None and self.config.checkpoint_path:
            params, model_config = load_model(
                self.config.checkpoint_path, expect_family="cross-encoder",
                device=self.device)
            tokenizer = tokenizer or load_tokenizer(self.config.tokenizer_path, model_config)
        # the default container builds the tiny cross-encoder when no
        # checkpoint is configured
        self.model_config = model_config or EncoderConfig.tiny()
        self.tokenizer = tokenizer or ByteTokenizer(self.model_config.vocab_size)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(7)
            params = init_cross_encoder(self.model_config, generator, self.device)
        # on a mesh: ENCODER_TP_RULES, computed on the first data
        # coordinate's tp shards (JAX replicates the encoder over dp)
        self.mesh = mesh
        if mesh is not None:
            params = shard_params(params, mesh, ENCODER_TP_RULES).group(0)
        self.params = params
        # JAX's policy: the flash kernel per tp shard at sp 1, plain
        # attention on an sp mesh (the ring is causal-only)
        self.attn_fn = select_encoder_attn_fn(mesh, self.model_config.n_heads)
        # encoder forwards (each one flash launch a layer on the card)
        self.forwards = 0
        self._forwards_lock = threading.Lock()

    def _score(self, query: str, documents: Sequence[Document]) -> np.ndarray:
        max_len = min(self.config.max_pair_tokens, self.model_config.max_len)
        pairs = [(query, d.content) for d in documents]
        scores = np.zeros(len(pairs), np.float32)
        for start in range(0, len(pairs), self.config.batch_size):
            chunk = pairs[start : start + self.config.batch_size]
            ids, mask, types = batch_encode_pairs(self.tokenizer, chunk, max_len)
            rows = bucket_size(len(chunk), self.ROW_BUCKETS)
            pad = rows - len(chunk)
            if pad:
                ids = np.pad(ids, ((0, pad), (0, 0)), constant_values=self.tokenizer.pad_id)
                mask = np.pad(mask, ((0, pad), (0, 0)))
                mask[len(chunk):, 0] = True  # keep pad rows' softmax non-degenerate
                types = np.pad(types, ((0, pad), (0, 0)))
            with self._forwards_lock:
                self.forwards += 1
            with torch.inference_mode():
                out = cross_encoder_scores(
                    self.params, self.model_config,
                    torch.as_tensor(ids, device=self.device),
                    torch.as_tensor(mask, device=self.device),
                    torch.as_tensor(types, device=self.device),
                    attn_fn=self.attn_fn,
                )
            scores[start : start + len(chunk)] = out.cpu().numpy()[: len(chunk)]
        return scores


_RERANKERS = {"cross_encoder": CrossEncoderReranker, "passthrough": PassthroughReranker}


def get_reranker(kind: Optional[str] = None, **kwargs) -> Reranker:
    """``RERANKER_KIND``: the JAX registry's names and its ``ValueError``
    for any other; ``kwargs`` go to the cross-encoder."""
    kind = kind or RerankConfig().kind
    cls = _RERANKERS.get(kind)
    if cls is None:
        raise ValueError(f"unknown reranker {kind!r}; known: {sorted(_RERANKERS)}")
    return cls(**kwargs) if cls is CrossEncoderReranker else cls()
