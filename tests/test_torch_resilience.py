"""The port's resilience primitives (``infra/resilience.py``) against JAX's,
under one fake clock: the circuit breaker's state machine, stats and
health (and its registry), the retry policy's delays and outcomes with one
seeded generator, the breaker + retry + timeout combinator (JAX's on a
coroutine, the port's on a worker thread), the decorators and the health
checker. The port's breaker also sets ``sentio_circuit_breaker_state`` on
each transition."""

import asyncio
import random
import threading

import pytest

from sentio_tpu.infra import resilience as jres
from sentio_tpu_torch.infra import resilience as tres
from sentio_tpu_torch.infra.metrics import get_metrics


@pytest.fixture
def clock(monkeypatch):
    """``time.monotonic`` and ``time.sleep`` for both packages: sleeping
    advances the clock and is recorded."""
    state = {"now": 1000.0, "slept": []}

    def sleep(s):
        state["slept"].append(round(s, 9))
        state["now"] += s

    monkeypatch.setattr("time.monotonic", lambda: state["now"])
    monkeypatch.setattr("time.sleep", sleep)
    return state


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


SCRIPT = ["fail", "fail", "ok", "fail", "fail", "fail", "call", "wait:5", "call", "wait:30",
          "ok", "fail", "wait:31", "ok", "ok", "ok", "call_fail", "call"]


def _run_script(mod, clock, name):
    clock.update(now=1000.0, slept=[])
    b = mod.CircuitBreaker(name=name, failure_threshold=3, recovery_timeout_s=30.0,
                           success_threshold=2)
    out = []
    for step in SCRIPT:
        if step == "fail":
            out.append(("allow", b.allow()))
            b.record_failure()
        elif step == "ok":
            out.append(("allow", b.allow()))
            b.record_success()
        elif step == "call":
            out.append(_outcome(b.call, lambda: "done"))
        elif step == "call_fail":
            out.append(_outcome(b.call, lambda: 1 / 0))
        else:
            clock["now"] += float(step.split(":")[1])
        out.append((b.state.value, b.health(), vars(b.stats)))
    return out, b


def test_breaker_state_machine_matches_jax(clock):
    got, tb = _run_script(tres, clock, "parity-breaker")
    want, jb = _run_script(jres, clock, "parity-breaker")
    assert got == want
    assert tres.registered_breakers()["parity-breaker"] is tb
    assert jres.registered_breakers()["parity-breaker"] is jb
    tres.unregister_breaker(tb)
    assert "parity-breaker" not in tres.registered_breakers()


def test_breaker_transitions_reach_metrics(clock):
    b = tres.CircuitBreaker(name="metric-breaker", failure_threshold=1, recovery_timeout_s=1.0)
    try:
        b.record_failure()
        text = get_metrics().export_prometheus().decode()
        assert 'sentio_circuit_breaker_state{name="metric-breaker"} 2.0' in text
        clock["now"] += 2.0
        assert b.allow() and b.state is tres.CircuitState.HALF_OPEN
        assert 'sentio_circuit_breaker_state{name="metric-breaker"} 1.0' in \
            get_metrics().export_prometheus().decode()
    finally:
        tres.unregister_breaker(b)


def _flaky(fails, exc=ValueError):
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        if calls["n"] <= fails:
            raise exc(f"attempt {calls['n']}")
        return x * 2

    return fn, calls


@pytest.mark.parametrize("fails,attempts,retry_on", [(0, 3, "all"), (2, 3, "all"),
                                                     (3, 3, "all"), (1, 1, "all"),
                                                     (1, 3, "key")])
def test_retry_policy_matches_jax(clock, fails, attempts, retry_on):
    results = []
    for mod in (tres, jres):
        clock["slept"] = []
        policy = mod.RetryPolicy(max_attempts=attempts, base_delay_s=0.2, max_delay_s=0.5,
                                 jitter=0.25, rng=random.Random(7),
                                 retry_on=(Exception,) if retry_on == "all" else (KeyError,))
        fn, calls = _flaky(fails)
        results.append((_outcome(policy.run, fn, 21), calls["n"], list(clock["slept"])))
    assert results[0] == results[1]
    assert [tres.RetryPolicy(rng=random.Random(3)).delay(a) for a in range(6)] == \
        [jres.RetryPolicy(rng=random.Random(3)).delay(a) for a in range(6)]
    assert _outcome(tres.RetryPolicy(max_attempts=0).run, lambda: 1) == \
        _outcome(jres.RetryPolicy(max_attempts=0).run, lambda: 1)


@pytest.mark.parametrize("case", ["ok", "flaky", "timeout", "open"])
def test_resilient_call_matches_jax(case):
    """The port's sync combinator and JAX's coroutine one: the same result
    or error, the same attempts and the same breaker state."""
    release = threading.Event()

    def port_fn(x):
        calls["port"] += 1
        if case == "flaky" and calls["port"] < 2:
            raise ValueError("flaky")
        if case == "timeout":
            release.wait(2.0)
        return x + 1

    async def jax_fn(x):
        calls["jax"] += 1
        if case == "flaky" and calls["jax"] < 2:
            raise ValueError("flaky")
        if case == "timeout":
            await asyncio.sleep(2.0)
        return x + 1

    calls = {"port": 0, "jax": 0}
    policy = dict(max_attempts=2, base_delay_s=0.001, max_delay_s=0.001)
    tb = tres.CircuitBreaker(name=f"rc-{case}", failure_threshold=2)
    jb = jres.CircuitBreaker(name=f"rc-{case}", failure_threshold=2)
    if case == "open":
        for b in (tb, jb):
            b.record_failure()
            b.record_failure()
    tcall = tres.ResilientCall(f"rc-{case}", breaker=tb, retry=tres.RetryPolicy(**policy),
                               timeout_s=0.05)
    jcall = jres.ResilientCall(f"rc-{case}", breaker=jb, retry=jres.RetryPolicy(**policy),
                               timeout_s=0.05)
    try:
        got = _outcome(tcall.execute, port_fn, 1)
        release.set()
        want = _outcome(lambda: asyncio.run(jcall.execute(jax_fn, 1)))
    finally:
        release.set()
        tcall.close()
        tres.unregister_breaker(tb)
    assert got == want
    assert calls["port"] == calls["jax"]
    assert (tb.state, vars(tb.stats)) == (tres.CircuitState(jb.state.value), vars(jb.stats))


def test_decorators_match_jax(clock):
    out = []
    for mod in (tres, jres):
        b = mod.CircuitBreaker(name="deco", failure_threshold=2)
        fn, calls = _flaky(1)
        wrapped = mod.with_retry(mod.RetryPolicy(max_attempts=3, rng=random.Random(1)))(
            mod.with_circuit_breaker(b)(fn))
        out.append((_outcome(wrapped, 5), calls["n"], b.state.value, vars(b.stats),
                    wrapped.__name__))
        if mod is tres:
            tres.unregister_breaker(b)
    assert out[0] == out[1]


def test_health_checker_matches_jax(monkeypatch):
    monkeypatch.setattr("time.time", lambda: 5.0)

    def boom():
        raise RuntimeError("probe down")

    probes = {"up": lambda: True, "down": lambda: 0, "boom": boom}
    checker = tres.HealthChecker(interval_s=0.01)
    jchecker = jres.HealthChecker(interval_s=0.01)
    for name, probe in probes.items():
        checker.register(name, probe)
        jchecker.register(name, probe)
    checker.start()

    async def jax_once():
        jchecker.start()
        while len(jchecker.results()) < len(probes):
            await asyncio.sleep(0.005)
        await jchecker.stop()

    asyncio.run(jax_once())
    try:
        deadline = threading.Event()
        for _ in range(400):
            if len(checker.results()) == len(probes):
                break
            deadline.wait(0.005)
        assert checker.results() == jchecker.results()
        assert checker.results()["boom"] == {"ok": False, "error": "probe down", "at": 5.0}
    finally:
        checker.stop()
    assert checker._thread is None
