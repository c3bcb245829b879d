"""Fault injection — a copy of ``sentio_tpu/infra/faults.py`` for the
port's failure seams.

Named injection points sit at the serving path's failure-relevant seams
(``paged.step`` at the top of every engine tick, ``paged.admit_scatter``
before each admission's prefill dispatch, ``engine.reset`` in crash
containment, ``replica.rebuild`` as a replica rebuild starts). They do
nothing until a test or a chip drill arms them with a
:class:`FaultRule`: fail N times, skip the first N hits, fail with a
probability under a seeded RNG, add latency, or **stall** — block inside the
point for a time or until an event is set, the wedged dispatch that raises
nothing and that the replica tier's watchdog (``runtime/replica.py``) exists
to detect.

Usage::

    with inject("paged.step", error=RuntimeError("tick died"), times=2):
        ...  # the next two ticks raise, the third proceeds

    release = threading.Event()
    with inject("paged.step", stall_event=release, stall_s=60.0, times=1):
        ...  # the next tick wedges until release.set() (60 s cap)

Points are process-global and thread-safe; :func:`reset` disarms every
point. An unarmed :func:`hit` is one test of an empty dict. The socket
transport's frame points (``hit_frame``) and the crash fault
(``kill_process``) belong to the process and socket replica tier, which is
not ported.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional

__all__ = ["FaultRule", "arm", "disarm", "reset", "hit", "inject", "active_rules"]


@dataclass
class FaultRule:
    """What an armed point does when it is hit.

    * ``error`` — raised as a fresh copy (``type(error)(*error.args)``).
    * ``times`` — fire on at most N hits (None: on every hit).
    * ``skip`` — let the first N hits pass; fire from hit N + 1.
    * ``probability`` — fire with this probability under ``rng``.
    * ``delay_s`` — sleep before (optionally) raising.
    * ``stall_s`` / ``stall_event`` — block on the calling thread for
      ``stall_s`` seconds or until ``stall_event`` is set, whichever comes
      first (``stall_s=None`` with an event waits for the event alone);
      then raise ``error`` if one is set.

    ``hits``, ``fired`` and ``stalled`` count what happened."""

    error: Optional[BaseException] = None
    times: Optional[int] = None
    probability: float = 1.0
    delay_s: float = 0.0
    stall_s: Optional[float] = None
    stall_event: Optional[threading.Event] = None
    skip: int = 0
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    hits: int = 0
    fired: int = 0
    stalled: int = 0

    def should_fire(self) -> bool:
        # hits is counted before this check: skip=N lets hits 1..N pass
        if self.hits <= self.skip:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        return self.probability >= 1.0 or self.rng.random() < self.probability


_rules: dict[str, FaultRule] = {}
_lock = threading.Lock()


def arm(point: str, rule: FaultRule) -> None:
    with _lock:
        _rules[point] = rule


def disarm(point: str) -> None:
    with _lock:
        _rules.pop(point, None)


def reset() -> None:
    with _lock:
        _rules.clear()


def active_rules() -> dict[str, FaultRule]:
    with _lock:
        return dict(_rules)


def hit(point: str) -> None:
    """Called by the serving code at an injection point; does nothing
    unless ``point`` is armed."""
    if not _rules:  # nothing armed anywhere
        return
    with _lock:
        rule = _rules.get(point)
        if rule is None:
            return
        rule.hits += 1
        fire = rule.should_fire()
        if not fire:
            return
        rule.fired += 1
        stalls = rule.stall_s is not None or rule.stall_event is not None
        if stalls:
            rule.stalled += 1
        error, delay, stall_s, stall_event = (rule.error, rule.delay_s, rule.stall_s,
                                              rule.stall_event)
    # stall outside the lock: a wedged point must not block every other hit
    if stall_event is not None:
        stall_event.wait(stall_s)
    elif stalls and stall_s > 0:
        time.sleep(stall_s)
    if delay > 0:
        time.sleep(delay)
    if error is not None:
        raise type(error)(*error.args)


@contextmanager
def inject(point: str, error: Optional[BaseException] = None, times: Optional[int] = None,
           probability: float = 1.0, delay_s: float = 0.0, stall_s: Optional[float] = None,
           stall_event: Optional[threading.Event] = None, skip: int = 0,
           seed: int = 0) -> Iterator[FaultRule]:
    """Arm ``point`` for the block and yield its rule (for ``hits`` /
    ``fired`` / ``stalled``). Leaving the block disarms the point but does
    not release a thread already stalled in it: set the event."""
    rule = FaultRule(error=error, times=times, probability=probability, delay_s=delay_s,
                     stall_s=stall_s, stall_event=stall_event, skip=skip,
                     rng=random.Random(seed))
    arm(point, rule)
    try:
        yield rule
    finally:
        disarm(point)
