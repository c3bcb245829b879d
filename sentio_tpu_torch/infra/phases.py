"""Tick-phase time attribution: where a pump-loop millisecond goes — a
copy of ``sentio_tpu/infra/phases.py``.

Every pump iteration of the generation service gets a named-phase
decomposition, so host work is separable from time blocked on the device.
Phases are plain ``perf_counter`` deltas.

The phase set is FIXED and BOUNDED (``TICK_PHASES``): unknown keys are
rejected at the writer.

Phase glossary (one pump iteration, in canonical order):
``inbox_drain``
    Service-side mutex section at the loop top: heartbeat stamp, cancelled/
    expired sweeps, engine ``submit`` for every inbox ticket.
``admission_build``
    Host-side admission work inside ``engine.step()``: tokenization, radix
    matching, page allocation, padded numpy array assembly — everything in
    ``_admit``/``_advance_prefill`` EXCEPT the prefill calls.
``prefill_dispatch``
    Host call time of the prefill launches (asynchronous on the device;
    this is what they cost the PUMP THREAD — the GIL-held part).
``decode_dispatch``
    Host call time of the decode tick (graph replays or eager sub-steps)
    plus its merge/budget prep — again host-side cost of asynchronous
    launches.
``device_wait``
    Time blocked on device results: the harvest's wait on the tick's
    event and any blocking first-token fold. With ``pipeline_depth=2`` the dispatch overlaps the previous
    fetch, so the wait measured in iteration N is for the tick dispatched
    at N-1 — it is charged to the iteration that HARVESTS it, which is
    where the wall clock actually went (per-iteration conservation holds).
``deliver``
    Service-side mutex section after the tick: TTFT stamping, stream-queue
    pushes, result/event completion.
``other``
    Everything else measured inside the iteration — kept explicit so
    per-tick conservation (``sum(phase_ms) == pump_ms``) holds by
    construction, not by tolerance.

``idle`` is not a tick phase: it is the duty-cycle complement (wall time
with no pump iteration running — pump down, or gaps between bursts).
"""

from __future__ import annotations

import time

__all__ = [
    "TICK_PHASES",
    "ENGINE_PHASES",
    "HOST_PHASES",
    "DUTY_STATES",
    "PhaseTimer",
    "duty_fractions",
    "phases_to_ms",
]

# the one bounded key set
TICK_PHASES = (
    "inbox_drain",
    "admission_build",
    "prefill_dispatch",
    "decode_dispatch",
    "device_wait",
    "deliver",
    "other",
)

# the subset engine.step() itself attributes (the service adds the rest)
ENGINE_PHASES = (
    "admission_build",
    "prefill_dispatch",
    "decode_dispatch",
    "device_wait",
    "other",
)

# duty-cycle rollup: every phase that burns the host thread vs. blocked on
# the device
HOST_PHASES = tuple(p for p in TICK_PHASES if p != "device_wait")

DUTY_STATES = ("host", "device", "idle")


class _PhaseSpan:
    """Tiny enter/exit timer — two perf_counter calls and a dict add."""

    __slots__ = ("_timer", "_key", "_t0")

    def __init__(self, timer: "PhaseTimer", key: str) -> None:
        self._timer = timer
        self._key = key

    def __enter__(self) -> "_PhaseSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._timer.add(self._key, time.perf_counter() - self._t0)
        return False


class PhaseTimer:
    """Per-iteration phase accumulator. NOT thread-safe by design — one
    timer belongs to one pump/engine thread; cross-thread aggregation
    happens on snapshots. A region may be entered many times per tick
    (every prefill dispatch adds to ``prefill_dispatch``); keys outside
    the constructor's set are rejected so the bounded-set guarantee is
    enforced at the writer."""

    __slots__ = ("acc",)

    def __init__(self, keys: tuple = TICK_PHASES) -> None:
        self.acc: dict[str, float] = dict.fromkeys(keys, 0.0)

    def reset(self) -> None:
        for key in self.acc:
            self.acc[key] = 0.0

    def add(self, key: str, seconds: float) -> None:
        # KeyError on an unknown phase is deliberate: a typo'd phase name
        # must fail the tick that introduced it
        self.acc[key] += seconds

    def phase(self, key: str) -> _PhaseSpan:
        """Context manager timing one region into ``key``."""
        if key not in self.acc:
            raise KeyError(f"unknown phase {key!r} (bounded set: {tuple(self.acc)})")
        return _PhaseSpan(self, key)

    def total(self) -> float:
        return sum(self.acc.values())


def phases_to_ms(phase_s: dict) -> dict:
    """Seconds per phase → the flight records' ``phase_ms`` (ms, 3
    decimals)."""
    return {k: round(v * 1e3, 3) for k, v in phase_s.items()}


def sum_phase_totals(rows) -> tuple:
    """Fold per-replica stats rows (each with cumulative ``phase_seconds``
    and ``duty_elapsed_s``) into ``(phase_totals, duty_elapsed_s)`` for the
    set; a row without phase data adds nothing."""
    totals: dict[str, float] = {}
    elapsed = 0.0
    for row in rows:
        for key, val in (row.get("phase_seconds") or {}).items():
            totals[key] = totals.get(key, 0.0) + float(val)
        elapsed += float(row.get("duty_elapsed_s", 0.0))
    return totals, elapsed


def duty_fractions(phase_totals: dict, elapsed_s: float) -> dict:
    """Fold cumulative phase seconds into host/device/idle fractions of
    ``elapsed_s`` wall time, summing to exactly 1.0. Measurement skew
    (busy marginally exceeding elapsed on a coarse clock) clamps idle at 0
    and renormalizes."""
    if elapsed_s <= 0:
        return {"host": 0.0, "device": 0.0, "idle": 1.0}
    host = sum(phase_totals.get(k, 0.0) for k in HOST_PHASES)
    device = phase_totals.get("device_wait", 0.0)
    idle = max(elapsed_s - host - device, 0.0)
    total = host + device + idle
    return {
        "host": round(host / total, 6),
        "device": round(device / total, 6),
        "idle": round(idle / total, 6),
    }
