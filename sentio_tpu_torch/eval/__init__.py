"""Evaluation harness — the counterpart of ``sentio_tpu/eval``.

:mod:`.dataset` builds the seeded synthetic retrieval-QA bundle,
:mod:`.harness` runs a pipeline over it (recall@10, p50 / p95, QPS),
:mod:`.runner` runs the five configurations and the measured
reference-architecture baseline (:mod:`.baseline`), and
:mod:`.train_encoder` trains the bi-encoder in-tree. ``quant_gate.json``
and ``verify_gate.json`` are copies of the JAX package's committed quality
gates.
"""

from sentio_tpu_torch.eval.dataset import EvalBundle, build_bundle
from sentio_tpu_torch.eval.harness import EvalResult, recall_at_k, run_queries

__all__ = ["EvalBundle", "build_bundle", "EvalResult", "recall_at_k", "run_queries"]
