"""Run pipeline configurations over an EvalBundle: recall@10, p50, QPS —
a copy of ``sentio_tpu/eval/harness.py``.

A pipeline under test is just ``fn(question) -> (documents, answer)``; the
harness times it (optionally with concurrent callers, which is how the
batched-serving config is exercised — concurrency IS the batch on this
stack) and scores retrieval against the gold ids.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

PipelineFn = Callable[[str], tuple[Sequence, str]]


@dataclass
class EvalResult:
    name: str
    n_queries: int
    recall_at_10: float
    p50_ms: float
    p95_ms: float
    qps: float
    errors: int = 0
    extras: dict = field(default_factory=dict)

    def row(self) -> dict:
        return {
            "config": self.name,
            "recall@10": round(self.recall_at_10, 3),
            "p50_ms": round(self.p50_ms, 1),
            "p95_ms": round(self.p95_ms, 1),
            "qps": round(self.qps, 2),
            "n": self.n_queries,
            **({"errors": self.errors} if self.errors else {}),
            **self.extras,
        }


def recall_at_k(retrieved_ids: Sequence[str], gold_id: str, k: int = 10) -> float:
    return 1.0 if gold_id in list(retrieved_ids)[:k] else 0.0


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(len(sorted_vals) * q), len(sorted_vals) - 1)
    return sorted_vals[idx]


def run_queries(
    name: str,
    fn: PipelineFn,
    queries: Sequence[tuple[str, str]],
    concurrent: int = 1,
    warmup: int = 1,
) -> EvalResult:
    """Execute every (question, gold_id) through ``fn``.

    ``concurrent`` > 1 drives the queries from that many worker threads —
    wall-clock QPS then reflects batched/coalesced serving, while per-query
    latency still measures each caller's own wait.
    """
    for i in range(min(warmup, len(queries))):
        fn(queries[i][0])

    latencies: list[float] = []
    hits: list[float] = []
    errors = 0
    lock = threading.Lock()

    def one(question: str, gold_id: str) -> None:
        nonlocal errors
        t0 = time.perf_counter()
        try:
            docs, _answer = fn(question)
            dt_ms = (time.perf_counter() - t0) * 1000.0
            ids = [getattr(d, "id", d) for d in docs]
            with lock:
                latencies.append(dt_ms)
                hits.append(recall_at_k(ids, gold_id, 10))
        except Exception:
            with lock:
                errors += 1

    t_start = time.perf_counter()
    if concurrent <= 1:
        for question, gold_id in queries:
            one(question, gold_id)
    else:
        pending = list(queries)
        idx_lock = threading.Lock()

        def worker() -> None:
            while True:
                with idx_lock:
                    if not pending:
                        return
                    question, gold_id = pending.pop(0)
                one(question, gold_id)

        threads = [threading.Thread(target=worker, name=f"eval-worker-{i}")
                   for i in range(concurrent)]
        for t in threads:
            t.start()
        for t in threads:
            # bounded: a worker wedged inside a hung provider call must not
            # hang the whole eval run past the per-query budget
            t.join(timeout=600.0)
        stragglers = sum(1 for t in threads if t.is_alive())
        if stragglers:
            # surfaced, not silent: the result below aggregates a PARTIAL
            # run (the snapshot under the lock keeps the straggler's late
            # appends from racing the sort)
            logging.getLogger(__name__).warning(
                "%d eval worker(s) still wedged after the 600s join; "
                "aggregating partial results", stragglers,
            )
    wall_s = time.perf_counter() - t_start

    with lock:
        latencies = sorted(latencies)
        hits = list(hits)
        n_errors = errors
    n_ok = len(latencies)
    return EvalResult(
        name=name,
        n_queries=len(queries),
        recall_at_10=(sum(hits) / len(hits)) if hits else 0.0,
        p50_ms=_percentile(latencies, 0.50),
        p95_ms=_percentile(latencies, 0.95),
        qps=n_ok / wall_s if wall_s > 0 else 0.0,
        errors=n_errors,
    )
