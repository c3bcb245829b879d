"""The duty-cycle autoscaler — ``sentio_tpu/runtime/autoscaler.py`` for the
port's replica tier: a load-following policy loop over a ``ReplicaSet``.

Every replica reports its pump's duty cycle (host / device / idle) and its
backlog, and :meth:`ReplicaSet.fleet_load` folds them into one sample from
cached probes (a worker replica answers from its pushed status frames, so
a poll costs no RPC). This module closes the loop:

:class:`AutoscalePolicy`
    A clock-free decision kernel: :meth:`~AutoscalePolicy.observe` folds
    ``(busy, backlog)`` samples into a sliding ``window_s``;
    :meth:`~AutoscalePolicy.decide` returns ``"out"`` / ``"in"`` / ``None``
    with a reason. A window's mean busy fraction or backlog fraction at or
    above the scale-out thresholds grows the fleet; a mean busy at or below
    ``in_busy`` with the backlog under a quarter of ``out_backlog`` shrinks
    it. A decision needs a window covered to 80%; hysteresis is the gap
    between the thresholds (``in_busy <= out_busy`` whatever the settings
    say); each direction has its cooldown, scale-in counted from the last
    change in either direction; min / max clamp every decision.

:class:`Autoscaler`
    The actuator thread (``fleet-autoscaler``): samples the set, feeds the
    policy and acts — scale-out through a launcher (a zero-argument
    callable; :func:`socket_worker_launcher` spawns a socket worker that
    registers with the elastic-join slot ``-1``), scale-in by retiring the
    most idle serving replica through :meth:`ReplicaSet.retire` (inbox
    handoff, drain, close, slot release). Each executed decision is an
    ``autoscale_decision`` flight event and a
    ``sentio_tpu_autoscale_decisions_total{direction,reason}`` sample. A
    decision whose action fails (no launcher, a launch that raises, a
    refused retire) is logged and counted ``skipped``.

``build_pipeline`` builds an ``Autoscaler`` only under ``AUTOSCALE=1``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional

from sentio_tpu_torch.analysis.sanitizer import make_lock
from sentio_tpu_torch.infra.flight import get_flight_recorder
from sentio_tpu_torch.infra.metrics import get_metrics

logger = logging.getLogger(__name__)

__all__ = ["AutoscalePolicy", "Autoscaler", "socket_worker_launcher"]


class AutoscalePolicy:
    """The scale-out / scale-in decision kernel (no clock, no thread).

    Callers own the clock: the same monotonic ``now`` goes to
    :meth:`observe` and :meth:`decide`. A decision needs a window whose
    samples span at least 80% of ``window_s``, so one hot poll after start
    or after a scale event (which clears the window) cannot flap the
    fleet."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4, window_s: float = 15.0,
                 out_busy: float = 0.75, in_busy: float = 0.15, out_backlog: float = 0.5,
                 out_cooldown_s: float = 30.0, in_cooldown_s: float = 60.0) -> None:
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.window_s = max(float(window_s), 0.1)
        self.out_busy = min(max(float(out_busy), 0.0), 1.0)
        # hysteresis: the scale-in threshold never reaches past scale-out's
        self.in_busy = min(max(float(in_busy), 0.0), self.out_busy)
        self.out_backlog = min(max(float(out_backlog), 0.0), 1.0)
        self.out_cooldown_s = max(float(out_cooldown_s), 0.0)
        self.in_cooldown_s = max(float(in_cooldown_s), 0.0)
        self._mutex = make_lock("AutoscalePolicy._mutex")
        self._samples: deque = deque()  # guarded-by: _mutex
        self._last_out: Optional[float] = None  # guarded-by: _mutex
        self._last_change: Optional[float] = None  # guarded-by: _mutex

    def observe(self, now: float, busy_fraction: float, backlog_fraction: float) -> None:
        """Fold one fleet sample into the sliding window."""
        with self._mutex:
            self._samples.append((float(now), float(busy_fraction), float(backlog_fraction)))
            self._prune_locked(now)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def note_scaled(self, now: float, direction: str) -> None:
        """Book an executed decision: start the cooldowns and clear the
        window (its samples describe the old fleet)."""
        with self._mutex:
            if direction == "out":
                self._last_out = now
            self._last_change = now
            self._samples.clear()

    def _means_locked(self) -> tuple[float, float]:
        n = len(self._samples)
        return (sum(s[1] for s in self._samples) / n, sum(s[2] for s in self._samples) / n)

    def decide(self, now: float, current_replicas: int) -> tuple:
        """``("out" | "in", reason)`` or ``(None, reason)``."""
        with self._mutex:
            self._prune_locked(now)
            if len(self._samples) < 2:
                return None, "window_warming"
            span = self._samples[-1][0] - self._samples[0][0]
            if span + 1e-9 < self.window_s * 0.8:
                return None, "window_warming"
            busy, backlog = self._means_locked()
            if busy >= self.out_busy or backlog >= self.out_backlog:
                if current_replicas >= self.max_replicas:
                    return None, "at_max"
                if self._last_out is not None and now - self._last_out < self.out_cooldown_s:
                    return None, "out_cooldown"
                return "out", "busy" if busy >= self.out_busy else "backlog"
            if busy <= self.in_busy and backlog <= self.out_backlog / 4.0:
                if current_replicas <= self.min_replicas:
                    return None, "at_min"
                if self._last_change is not None and \
                        now - self._last_change < self.in_cooldown_s:
                    return None, "in_cooldown"
                return "in", "idle"
            return None, "steady"

    def saturated(self, now: float) -> bool:
        """Whether the window's mean load is at or above the scale-out
        thresholds (the at-max alert gauge)."""
        with self._mutex:
            self._prune_locked(now)
            if not self._samples:
                return False
            busy, backlog = self._means_locked()
            return busy >= self.out_busy or backlog >= self.out_backlog


def socket_worker_launcher(address, spec) -> Callable[[], None]:
    """The launcher of a local socket fleet: each call spawns one worker
    process (``torch.multiprocessing``'s spawn context, so the weight
    tensors in ``spec`` reach it as CUDA IPC handles onto the router's
    memory: no second copy on the card) that dials the registry at
    ``address`` with the elastic-join slot ``-1``; the registry grants a
    slot and the set's membership source wires the worker in (remote
    workers just register with the slot ``-1`` on their own). The worker
    belongs to the fleet from its registration on, and its replica's close
    shuts it down; the launcher's ``close(join_timeout_s)`` reaps what it
    launched (a worker that never joined, or one that outlived its set, is
    terminated)."""
    address = tuple(address)
    procs: list = []
    mutex = threading.Lock()

    def launch() -> None:
        from sentio_tpu_torch.runtime.worker import _spawn_context, worker_main_socket

        proc = _spawn_context().Process(target=worker_main_socket, args=(address, spec, -1),
                                        name="sentio-elastic-worker", daemon=True)
        proc.start()
        with mutex:
            for p in list(procs):
                if not p.is_alive():
                    p.join(timeout=0.1)  # an exited worker is reaped here
                    procs.remove(p)
            procs.append(proc)
        logger.info("launched elastic worker pid=%s", proc.pid)

    def close(join_timeout_s: float = 10.0) -> None:
        with mutex:
            mine = list(procs)
            procs.clear()
        deadline = time.perf_counter() + max(join_timeout_s, 0.0)
        for proc in mine:
            proc.join(timeout=max(deadline - time.perf_counter(), 0.1))
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)

    launch.close = close
    return launch


class Autoscaler:
    """The actuator thread over a ``ReplicaSet``: one poll is one
    :meth:`step` (sample ``fleet_load()``, feed the policy, act). A launch
    in flight counts toward the maximum until a replica joins or
    ``launch_grace_s`` passes, so a slow spawn and warmup cannot let the
    policy fire past the bound. :meth:`step` is public so tests drive the
    loop on a synthetic clock; the loop outlives any failed pass."""

    def __init__(self, replica_set, policy: AutoscalePolicy,
                 launcher: Optional[Callable[[], None]] = None, poll_interval_s: float = 1.0,
                 launch_grace_s: float = 120.0) -> None:
        self._set = replica_set
        self.policy = policy
        self.launcher = launcher
        self.poll_interval_s = max(float(poll_interval_s), 0.05)
        self.launch_grace_s = max(float(launch_grace_s), 1.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mutex = make_lock("Autoscaler._mutex")
        self._decisions = {"out": 0, "in": 0}  # guarded-by: _mutex
        self._skipped = 0  # guarded-by: _mutex
        self._pending_launches: list = []  # guarded-by: _mutex
        self._last_serving: Optional[int] = None  # guarded-by: _mutex

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the autoscaler outlives any bad pass
                logger.exception("autoscale pass failed")

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One observe → decide → act pass; the executed direction or
        None."""
        now = time.monotonic() if now is None else now
        load = self._set.fleet_load()
        self.policy.observe(now, load["busy"], load["backlog_fraction"])
        serving = int(load["serving"])
        with self._mutex:
            # a rise in serving replicas absorbs one pending launch each;
            # launches older than the grace are presumed dead
            if self._last_serving is not None and serving > self._last_serving:
                del self._pending_launches[:serving - self._last_serving]
            self._last_serving = serving
            self._pending_launches = [t for t in self._pending_launches
                                      if now - t < self.launch_grace_s]
            pending = len(self._pending_launches)
        effective = serving + pending
        direction, reason = self.policy.decide(now, effective)
        at_max = effective >= self.policy.max_replicas
        get_metrics().record_fleet_saturation(
            1.0 if (at_max and self.policy.saturated(now)) else 0.0)
        if direction is None:
            return None
        ok = self._scale_out(reason) if direction == "out" else self._scale_in(load, reason)
        if ok:
            self.policy.note_scaled(now, direction)
            with self._mutex:
                self._decisions[direction] += 1
                if direction == "out":
                    self._pending_launches.append(now)
            self._book_decision(direction, reason)
            return direction
        with self._mutex:
            self._skipped += 1
        return None

    def _scale_out(self, reason: str) -> bool:
        if self.launcher is None:
            logger.debug("scale-out wanted (%s) but no launcher is wired", reason)
            return False
        try:
            self.launcher()
        except Exception:  # noqa: BLE001 — a failed launch is booked skipped, the loop goes on
            logger.exception("elastic worker launch failed")
            return False
        return True

    def _scale_in(self, load: dict, reason: str) -> bool:
        per = load.get("replicas") or []
        if not per:
            return False
        # the most idle first; backlog breaks ties, so a replica holding
        # queued work is not drained while an emptier one exists
        target = min(per, key=lambda p: (p["busy"], p["backlog"]))
        try:
            result = self._set.retire(target["replica"])
        except Exception:  # noqa: BLE001 — the last-serving guard, races: the next poll retries
            logger.info("scale-in of replica %s refused", target["replica"], exc_info=True)
            return False
        return bool(result.get("retired"))

    def _book_decision(self, direction: str, reason: str) -> None:
        logger.info("autoscale decision: %s (%s)", direction, reason)
        get_metrics().record_autoscale_decision(direction, reason)
        get_flight_recorder().record_tick(event="autoscale_decision", direction=direction,
                                          reason=reason)

    def stats(self) -> dict:
        with self._mutex:
            return {"scale_out": self._decisions["out"], "scale_in": self._decisions["in"],
                    "skipped": self._skipped, "pending_launches": len(self._pending_launches)}

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the loop (a retire in the middle of a pass blocks up to its
        drain deadline); the launcher's workers are the set's to close,
        then :meth:`reap` collects them."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        self._thread = None

    def reap(self, join_timeout_s: float = 10.0) -> None:
        """Reap every worker the launcher started (after the set closed
        its replicas)."""
        close = getattr(self.launcher, "close", None)
        if close is not None:
            close(join_timeout_s)
