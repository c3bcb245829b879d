"""The port's fault injection (``infra/faults.py``) against JAX's
``sentio_tpu.infra.faults``: the same rule, hit the same number of times,
fires on the same hits in both — for each ``FaultRule`` field (``error``,
``times``, ``skip``, ``probability`` under a seed, ``delay_s``,
``stall_s``, ``stall_event``) — plus ``inject`` as a context manager,
``reset``, and hits from 8 threads at once, which fire exactly ``times``
times. Every wait has a timeout."""

import threading
import time

import pytest

from sentio_tpu.infra import faults as jfaults
from sentio_tpu_torch.infra import faults

JOIN_S = 30.0


@pytest.fixture(autouse=True)
def _disarmed():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def fire_pattern(module, rule_kwargs: dict, hits: int) -> tuple[list[bool], tuple]:
    """Hit an armed point ``hits`` times; which hits raised, and the rule's
    counters."""
    seed = rule_kwargs.pop("seed", 0)
    with module.inject("drill.point", error=RuntimeError("boom"), seed=seed,
                       **rule_kwargs) as rule:
        fired = []
        for _ in range(hits):
            try:
                module.hit("drill.point")
                fired.append(False)
            except RuntimeError as exc:
                assert str(exc) == "boom"
                fired.append(True)
    return fired, (rule.hits, rule.fired, rule.stalled)


@pytest.mark.parametrize("rule", [
    {},
    {"times": 2},
    {"skip": 3},
    {"skip": 1, "times": 2},
    {"probability": 0.3, "seed": 7},
    {"probability": 0.5, "seed": 11, "times": 3},
    {"probability": 0.5, "seed": 11, "skip": 2},
], ids=["always", "times", "skip", "skip_times", "probability", "probability_times",
        "probability_skip"])
def test_fire_pattern_matches_jax(rule):
    ours = fire_pattern(faults, dict(rule), 12)
    theirs = fire_pattern(jfaults, dict(rule), 12)
    assert ours == theirs
    if "times" in rule:
        assert sum(ours[0]) <= rule["times"]
    if "skip" in rule:
        assert not any(ours[0][: rule["skip"]])


def test_unarmed_points_do_nothing():
    faults.hit("never.armed")
    with faults.inject("other.point", error=RuntimeError("x")):
        faults.hit("never.armed")
    assert faults.active_rules() == {}


def test_delay_then_error():
    with faults.inject("slow.point", error=TimeoutError("late"), delay_s=0.05, times=1) as rule:
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError, match="late"):
            faults.hit("slow.point")
        assert time.perf_counter() - t0 >= 0.05
        faults.hit("slow.point")  # times=1: the second hit passes
    assert (rule.hits, rule.fired) == (2, 1)


def test_stall_for_seconds_without_error():
    with faults.inject("wedge", stall_s=0.05, times=1) as rule:
        t0 = time.perf_counter()
        faults.hit("wedge")
        assert time.perf_counter() - t0 >= 0.05
    assert (rule.fired, rule.stalled) == (1, 1)


def test_stall_event_wedges_the_calling_thread_until_released():
    """A stall holds only the thread that hit the point: other points (and
    other threads hitting them) go on; setting the event releases it, then
    the rule's error raises."""
    release = threading.Event()
    outcome = {}

    def victim():
        try:
            faults.hit("pump.tick")
            outcome["r"] = "passed"
        except RuntimeError as exc:
            outcome["r"] = str(exc)

    with faults.inject("pump.tick", stall_event=release, error=RuntimeError("died"),
                       times=1) as rule:
        t = threading.Thread(target=victim, name="stalled-victim", daemon=True)
        t.start()
        deadline = time.monotonic() + JOIN_S
        while rule.stalled == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert rule.stalled == 1
        faults.hit("some.other.point")  # not blocked by the stall
        assert t.is_alive() and "r" not in outcome
        release.set()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert outcome["r"] == "died"


def test_inject_disarms_on_exit_and_reset_clears_all():
    with faults.inject("a", error=RuntimeError("a")):
        assert set(faults.active_rules()) == {"a"}
    assert faults.active_rules() == {}
    faults.hit("a")  # disarmed
    faults.arm("b", faults.FaultRule(error=RuntimeError("b")))
    faults.arm("c", faults.FaultRule(error=RuntimeError("c")))
    with pytest.raises(RuntimeError):
        faults.hit("b")
    faults.disarm("b")
    faults.hit("b")
    faults.reset()
    faults.hit("c")
    assert faults.active_rules() == {}


def test_error_is_a_fresh_copy_each_hit():
    with faults.inject("copy", error=ValueError("same text")):
        raised = []
        for _ in range(2):
            with pytest.raises(ValueError) as info:
                faults.hit("copy")
            raised.append(info.value)
    assert raised[0] is not raised[1]
    assert str(raised[0]) == str(raised[1]) == "same text"


def test_times_holds_under_eight_threads():
    """8 threads hit one point 200 times each, with a short switch
    interval: every hit is counted and exactly ``times`` of them fire."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        fired = [0] * 8
        start = threading.Barrier(8)

        def hammer(k):
            start.wait(timeout=JOIN_S)
            for _ in range(200):
                try:
                    faults.hit("contended")
                except RuntimeError:
                    fired[k] += 1

        with faults.inject("contended", error=RuntimeError("x"), times=37, skip=5) as rule:
            threads = [threading.Thread(target=hammer, args=(k,), name=f"hammer-{k}",
                                        daemon=True) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=JOIN_S)
            assert not any(t.is_alive() for t in threads)
        assert (rule.hits, rule.fired, sum(fired)) == (1600, 37, 37)
    finally:
        sys.setswitchinterval(old)
