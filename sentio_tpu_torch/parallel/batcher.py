"""Shape bucketing, copied from ``sentio_tpu/parallel/batcher.py``."""

from __future__ import annotations

from typing import Sequence


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; past every bucket, n itself (callers pad by
    ``bucket - n``, which must never go negative)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return n


def floor_bucket(n: int, buckets: Sequence[int]) -> int:
    """Largest bucket <= n (min(buckets) if none fit) — for quantities that
    must round DOWN, like decode step counts bounded by cache headroom."""
    best = min(buckets)
    for b in sorted(buckets):
        if b <= n:
            best = b
    return best
