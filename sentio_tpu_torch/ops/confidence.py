"""Answer-confidence scoring for the verify gate — a copy of
``sentio_tpu/ops/confidence.py``.

The LLM self-audit (ops/verifier.py) costs a full decode round-trip on
the same engine as the answer. Most of that spend buys nothing: when the
model decoded its answer with uniformly high token probability AND
retrieval produced a clearly-separated top document, the audit almost
always returns ``pass``. This module turns the
two signals the serving path already computes for free into one calibrated
confidence score in [0, 1]:

* **generation logprobs** — the per-token logprob accumulators the paged
  engine carries through its decode sub-steps (runtime/paged.py): the
  mean token probability ``exp(logprob_mean)`` says how sure the model was on average, the worst token ``exp(logprob_min)``
  catches a single hallucinated span hiding inside an otherwise confident
  answer;
* **retrieval support** — the fused scores on the selected documents
  (ops/fusion.py / ops/scorers.py): a top document that clearly separates
  from the runner-up means the answer had one strong source to ground on,
  a flat score profile means the generator was synthesizing from noise.

``confidence_score`` returns ``None`` whenever the logprob signal is
missing (non-paged providers, speculative decode, cancelled requests) —
the gate then NEVER skips, so confidence gating degrades to plain
always-verify instead of silently skipping on blind spots.

Calibration: the weights below were chosen so that a greedy decode whose
every token carries >= ~0.9 probability over a well-separated source scores
above the default ``VERIFY_CONFIDENCE_THRESHOLD`` (0.75), while random-init
or high-entropy decodes score near the mean token probability (tiny). They
are knobs, not constants of nature — the eval quality gate
(``eval/verify_gate.json``, held in tests/test_torch_eval.py and on the
card by chip_smoke.py's ``quality_gates`` phase) pins
gated-vs-always-verify verdict agreement so a calibration change that makes
garbage look confident fails tier-1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = [
    "confidence_score",
    "retrieval_support",
    "WEIGHT_MEAN",
    "WEIGHT_MIN",
    "WEIGHT_RETRIEVAL",
]

# contribution weights; sum to 1.0 so the score stays in [0, 1]
WEIGHT_MEAN = 0.6
WEIGHT_MIN = 0.2
WEIGHT_RETRIEVAL = 0.2


def retrieval_support(documents: Sequence) -> float:
    """[0, 1] — how clearly the top retrieved document separates from the
    rest. 1.0 means the top fused score dominates the runner-up outright;
    0.5 means a single document with no competition (weak evidence either
    way); 0.0 means no documents or a flat / inverted score profile.
    Works on any object with a ``score()`` method (models/document.py)."""
    scores = sorted((float(d.score()) for d in documents), reverse=True)
    if not scores:
        return 0.0
    if len(scores) == 1:
        return 0.5
    top, second = scores[0], scores[1]
    if top <= 0.0:
        return 0.0
    margin = (top - second) / (abs(top) + 1e-12)
    return 0.5 + 0.5 * max(min(margin, 1.0), 0.0)


def confidence_score(
    logprob_mean: Optional[float],
    logprob_min: Optional[float],
    documents: Sequence = (),
) -> Optional[float]:
    """Calibrated answer confidence in [0, 1], or ``None`` when there is no
    logprob signal to score (the gate must then run the verifier — absence
    of evidence is not confidence)."""
    if logprob_mean is None:
        return None
    mean_p = math.exp(min(float(logprob_mean), 0.0))
    min_p = (
        math.exp(min(float(logprob_min), 0.0))
        if logprob_min is not None else mean_p
    )
    score = (
        WEIGHT_MEAN * mean_p
        + WEIGHT_MIN * min_p
        + WEIGHT_RETRIEVAL * retrieval_support(documents)
    )
    return max(min(score, 1.0), 0.0)
