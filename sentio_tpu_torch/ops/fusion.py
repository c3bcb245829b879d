"""Rank fusion for hybrid retrieval — a copy of ``sentio_tpu/ops/fusion.py``.

``rrf``, ``weighted_rrf`` and ``comb_sum`` (per-list min-max normalization)
over ranked Document lists from independent retrieval legs; the output is
one list deduplicated by id, with ``hybrid_score`` and ``score`` metadata,
sorted descending. Pure host code: fusion over a few dozen candidates is
not device work.
"""

from __future__ import annotations

from typing import Optional, Sequence

from sentio_tpu_torch.models.document import Document

FUSION_METHODS = ("rrf", "weighted_rrf", "comb_sum")


def _minmax(scores: list[float]) -> list[float]:
    if not scores:
        return scores
    lo, hi = min(scores), max(scores)
    if hi - lo < 1e-12:
        return [1.0 for _ in scores]
    return [(s - lo) / (hi - lo) for s in scores]


def fuse(
    result_lists: Sequence[Sequence[Document]],
    method: str = "rrf",
    weights: Optional[Sequence[float]] = None,
    rrf_k: int = 60,
    top_k: Optional[int] = None,
) -> list[Document]:
    """Fuse ranked lists into one. Deduplicates by document id, merging
    metadata with earlier lists taking precedence on conflicts."""
    if method not in FUSION_METHODS:
        raise ValueError(f"unknown fusion method {method!r}; expected one of {FUSION_METHODS}")
    if weights is None:
        weights = [1.0] * len(result_lists)
    if len(weights) != len(result_lists):
        raise ValueError("weights length must match number of result lists")

    fused: dict[str, float] = {}
    docs: dict[str, Document] = {}

    for li, results in enumerate(result_lists):
        w = float(weights[li])
        if method == "comb_sum":
            raw = [d.score() for d in results]
            normed = _minmax(raw)
            contributions = [w * s for s in normed]
        else:  # rrf / weighted_rrf operate on ranks only
            w_eff = w if method == "weighted_rrf" else 1.0
            contributions = [w_eff / (rrf_k + rank + 1) for rank in range(len(results))]
        for doc, contrib in zip(results, contributions):
            fused[doc.id] = fused.get(doc.id, 0.0) + contrib
            if doc.id in docs:
                merged = dict(doc.metadata)
                merged.update(docs[doc.id].metadata)
                docs[doc.id].metadata = merged
            else:
                docs[doc.id] = Document(text=doc.text, metadata=dict(doc.metadata), id=doc.id)

    ranked = sorted(fused.items(), key=lambda kv: kv[1], reverse=True)
    if top_k is not None:
        ranked = ranked[:top_k]
    out = []
    for doc_id, score in ranked:
        doc = docs[doc_id]
        doc.metadata["hybrid_score"] = score
        doc.metadata["score"] = score
        out.append(doc)
    return out
