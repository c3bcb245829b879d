"""The port's thread-mode replica tier (``runtime/replica.py``) against
JAX's ``sentio_tpu.runtime.replica``.

Both sides run a tiny float32 Llama on shared weights (made by the JAX
init, carried by sentio_tpu_torch.runtime.weights), each replica its own
engine and service; the sets run with ``supervise=False`` and supervision
is stepped by ``_supervise_once()``, with the same fault rules armed in
each package (``sentio_tpu.infra.faults`` on the JAX side):

* ``TenantFairQueue`` — one seeded script of admit / recharge / release /
  set_capacity calls and clock steps (a fake clock) over several tenants,
  weights, headroom, the batch tier, refills and ``MAX_TRACKED`` overflow:
  every outcome, shed reason, message and ``stats()`` equal;
* routing — the replica each request lands on (affinity, stickiness
  overflow, least-loaded), the routing counters, and the float32 greedy
  tokens of ``generate`` and joined ``generate_stream``, token-exact,
  with replicas tied at the best prefix hit (the first takes it);
* isolation — a shared service, engine, allocator, pool or radix tree is
  refused with JAX's message;
* supervision — the tick-failure and error-rate breakers, DEGRADED and
  healing, a latched-broken replica's failover, quarantine and in-place
  rebuild, backoff after a failed rebuild, the quarantine inbox handoff,
  the stall watchdog's abandon and leaked pump, and the warmup stand-down:
  the health-state sequence and the counters equal;
* resume by replay (the port alone; JAX's resume tests fail in the seed,
  ROADMAP §C): a mid-stream death after delivered tokens resumes on the
  survivor with text equal to the uninterrupted greedy stream's (and the
  JAX tokens), one admission per attempt and nothing pending, also for a
  bucketed tenant key; an exhausted budget and an opt-out keep the typed
  error with the ledger balanced.

Every thread join and wait has a timeout."""

import dataclasses
import random
import threading
import time

import jax
import numpy as np
import pytest

from sentio_tpu.infra import faults as jfaults
from sentio_tpu.infra.exceptions import ReplicaUnavailable as JUnavailable
from sentio_tpu.infra.exceptions import ServiceOverloaded as JOverloaded
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime import replica as jreplica
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.infra.exceptions import ReplicaUnavailable, ServiceOverloaded
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.runtime import replica
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.service import PagedGenerationService
from sentio_tpu_torch.runtime.weights import llama_from_jax
from _sanitize import _sanitized  # noqa: F401  (arms the module)


ENGINE_KW = dict(max_slots=2, page_size=8, max_pages_per_seq=8, steps_per_tick=2,
                 max_tick_steps=2)
JOIN_S = 120.0
SIDES = {
    "jax": dict(Service=JService, Set=jreplica.ReplicaSet,
                Queue=jreplica.TenantFairQueue, module=jreplica, faults=jfaults,
                Unavailable=JUnavailable, Overloaded=JOverloaded),
    "torch": dict(Service=PagedGenerationService,
                  Set=replica.ReplicaSet, Queue=replica.TenantFairQueue, module=replica,
                  faults=faults, Unavailable=ReplicaUnavailable, Overloaded=ServiceOverloaded),
}
# the fault points, named once: JAX's committed chaos-coverage inventory
# (sentio_tpu/analysis/fault_points.json, held by test_failure_surface.py)
# maps the JAX package's own tests, and counts only literal names
STEP, RESET, REBUILD = "paged.step", "engine.reset", "replica.rebuild"
PROMPT_A = "the decode pump owns every page of the pool"
PROMPT_B = "a radix tree shares prompt heads between turns"


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(13), jcfg))
    return jcfg, tree, llama_from_jax(tree)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def make_engine(weights, side, base=None, **kw):
    jcfg, tree, port_params = weights
    kw = {**ENGINE_KW, **kw}
    if side == "jax":
        if base is not None:
            kw.update(params=base.params, tokenizer=base.tokenizer)
        return JEngine(model_config=jcfg, **{"params": tree, **kw})
    return ContinuousBatchingEngine(model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                                    params=port_params, device="cpu", **kw)


def make_set(weights, side, n=2, svc_kw=None, **set_kw):
    """``n`` replicas on shared weights, each warmed by one short request
    before any fault arms, behind a set without a supervisor thread."""
    S = SIDES[side]
    engines = [make_engine(weights, side)]
    for _ in range(n - 1):
        engines.append(make_engine(weights, side, base=engines[0]))
    services = [S["Service"](e, default_timeout_s=JOIN_S, **(svc_kw or {})) for e in engines]
    for i, svc in enumerate(services):
        svc.generate(f"warm replica {i}", max_new_tokens=2, timeout_s=JOIN_S)
    return S["Set"](services, supervise=False, **set_kw)


def cold_emas(rs):
    """Zero each replica's TTFT EMA: least-loaded routing then breaks ties
    by backlog and index, not by wall-clock TTFTs that differ per run."""
    for svc in rs._services:
        with svc._mutex:
            svc._ttft_ema = 0.0


def states(rs):
    return [r["state"] for r in rs.health_summary()["replicas"]]


def counters(rs):
    stats = rs.stats()
    return {k: stats[k] for k in ("failovers", "handed_off", "stall_quarantines",
                                  "pump_leaked", "stream_resumes", "resume_exhausted",
                                  "routing")}


def wait_until(predicate, timeout_s=JOIN_S):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def both(scenario, weights):
    """Run ``scenario(side, weights)`` on each package; its traces must be
    equal. Returns the port's."""
    traces = {side: scenario(side, weights) for side in ("jax", "torch")}
    assert traces["torch"] == traces["jax"]
    return traces["torch"]


# --------------------------------------------------------------- WFQ


class FakeClock:
    def __init__(self) -> None:
        self.t = 1000.0

    def perf_counter(self) -> float:
        return self.t


def wfq_script(seed: int, n: int = 400) -> list:
    rng = random.Random(seed)
    tenants = [f"t{i}" for i in range(7)] + ["overflow"]
    ops = []
    for _ in range(n):
        r = rng.random()
        tenant = rng.choice(tenants)
        priority = "batch" if rng.random() < 0.3 else "interactive"
        if r < 0.45:
            ops.append(("admit", tenant, rng.randint(1, 300), priority, rng.random() < 0.85))
        elif r < 0.7:
            ops.append(("release", tenant, rng.randint(1, 300),
                        rng.choice([None, rng.randint(0, 400)])))
        elif r < 0.8:
            ops.append(("recharge", tenant, rng.randint(1, 300), priority))
        elif r < 0.84:
            ops.append(("capacity", rng.randint(2, 40)))
        else:
            ops.append(("tick", rng.uniform(0.0, 2.0)))
    return ops


def run_wfq(side, cfg: dict, ops: list, clock: FakeClock) -> list:
    S = SIDES[side]
    q = S["Queue"](**cfg)
    trace = []
    for op in ops:
        try:
            if op[0] == "admit":
                out = ("ok", q.admit(op[1], op[2], priority=op[3], reserve=op[4]))
            elif op[0] == "release":
                out = ("ok", q.release(op[1], op[2], actual_tokens=op[3]))
            elif op[0] == "recharge":
                out = ("ok", q.recharge(op[1], op[2], priority=op[3]))
            elif op[0] == "capacity":
                out = ("ok", q.set_capacity(op[1]))
            else:
                clock.t += op[1]
                out = ("ok", None)
        except S["Overloaded"] as exc:
            out = ("shed", exc.status, dict(exc.details), str(exc))
        trace.append((out, q.stats()))
    return trace


@pytest.mark.parametrize("case", [
    dict(seed=1, cfg=dict(capacity=16), tracked=256),
    dict(seed=2, cfg=dict(capacity=24, weights={"t0": 4.0, "t1": 0.5},
                          refill_tokens_per_s=50.0, burst_tokens=200, headroom=2,
                          batch_shed_fraction=0.5), tracked=4),
    dict(seed=3, cfg=dict(capacity=8, weights={"t2": 2.0}, refill_tokens_per_s=10.0,
                          burst_tokens=64, headroom=0, batch_shed_fraction=0.3), tracked=3),
    dict(seed=4, cfg=dict(capacity=40, default_weight=0.5, refill_tokens_per_s=5.0,
                          burst_tokens=100, batch_shed_fraction=1.0, min_quota=2),
         tracked=5),
], ids=["quota", "weights_refill_overflow", "tight", "default_weight_min_quota"])
def test_tenant_fair_queue_matches_jax(case, monkeypatch):
    """Every outcome (the charged key, or the shed's status, details and
    message) and the whole ``stats()`` after each call equal JAX's."""
    ops = wfq_script(case["seed"])
    traces = {}
    for side in ("jax", "torch"):
        clock = FakeClock()
        S = SIDES[side]
        monkeypatch.setattr(S["module"], "time", clock)
        monkeypatch.setattr(S["Queue"], "MAX_TRACKED", case["tracked"])
        traces[side] = run_wfq(side, dict(case["cfg"]), ops, clock)
    assert traces["torch"] == traces["jax"]
    outcomes = [out[0] for out, _ in traces["torch"]]
    assert "shed" in outcomes and "ok" in outcomes
    reasons = {out[2]["shed_reason"] for out, _ in traces["torch"] if out[0] == "shed"}
    assert reasons & {"tenant_quota", "priority_batch"}


# ----------------------------------------------------------- routing


def routing_script(side, weights, monkeypatch):
    rs = make_set(weights, side)
    trace = []
    try:
        def request(prompt, stream=False):
            cold_emas(rs)
            if stream:
                text = "".join(rs.generate_stream(prompt, max_new_tokens=6,
                                                  timeout_s=JOIN_S))
                trace.append(("stream", text))
            else:
                result = rs.generate(prompt, max_new_tokens=6, timeout_s=JOIN_S)
                trace.append((result.replica_id, result.tokens, result.prefix_hit_tokens))

        request(PROMPT_A + " one")          # cold: least loaded, index 0
        cold_emas(rs)
        # replica 1 learns PROMPT_B's head through its own service
        rs._services[1].generate(PROMPT_B + " seed", max_new_tokens=2, timeout_s=JOIN_S)
        request(PROMPT_A + " two")          # affinity: replica 0
        request(PROMPT_B + " again")        # affinity: replica 1
        request(PROMPT_B + " streamed", stream=True)
        request("zzzzzzzzzzzzzzzzzzzzzzzzz")  # cold: replica 0
        # replica 0 projects the longer wait: cold traffic goes to 1
        monkeypatch.setattr(rs._services[0], "projected_wait", lambda: 1.0)
        monkeypatch.setattr(rs._services[1], "projected_wait", lambda: 0.25)
        request("yyyyyyyyyyyyyyyyyyyyyyyyy")
        # replica 0 holds PROMPT_A but is backlogged past stickiness
        monkeypatch.setattr(rs._services[0], "backlog", lambda: 100)
        request(PROMPT_A + " three")
        trace.append(rs.stats()["routing"])
    finally:
        rs.close()
    return trace


def test_routing_and_greedy_tokens_match_jax(weights, monkeypatch):
    trace = both(lambda side, w: routing_script(side, w, monkeypatch), weights)
    replicas = [t[0] for t in trace if isinstance(t, tuple) and t[0] != "stream"]
    assert replicas == [0, 0, 1, 0, 1, 1]
    assert trace[-1] == {"affinity": 3, "least_loaded": 4, "affinity_overflow": 1}
    assert all(t[1] for t in trace if isinstance(t, tuple))


def tie_script(side, weights, monkeypatch):
    rs = make_set(weights, side)
    try:
        for svc in rs._services:
            svc.generate(PROMPT_A + " seed", max_new_tokens=2, timeout_s=JOIN_S)
        cold_emas(rs)
        level = rs.generate(PROMPT_A + " level", max_new_tokens=4, timeout_s=JOIN_S)
        monkeypatch.setattr(rs._services[0], "projected_wait", lambda: 1.0)
        monkeypatch.setattr(rs._services[1], "projected_wait", lambda: 0.25)
        tie = rs.generate(PROMPT_A + " tie", max_new_tokens=4, timeout_s=JOIN_S)
        return (level.replica_id, tie.replica_id, tie.prefix_hit_tokens,
                rs.stats()["routing"], level.tokens, tie.tokens)
    finally:
        rs.close()


def test_affinity_ties_take_the_first_replica_as_jax(weights, monkeypatch):
    """Replicas tied at the best prefix hit (each holds the same head, as
    every replica holds the warmed ``/chat`` template head): the first
    takes the request, at equal load and while it projects the longer
    wait, on both packages, with the same greedy tokens."""
    trace = both(lambda side, w: tie_script(side, w, monkeypatch), weights)
    assert trace[:2] == (0, 0) and trace[2] > 0
    assert trace[3] == {"affinity": 2, "least_loaded": 0, "affinity_overflow": 0}


# --------------------------------------------------------- isolation


@pytest.mark.parametrize("part", ["service", "engine", "allocator", "pool", "radix"])
def test_isolation_refused_with_jax_message(weights, part):
    messages = {}
    for side in ("jax", "torch"):
        S = SIDES[side]
        e0 = make_engine(weights, side)
        e1 = make_engine(weights, side, base=e0)
        s0 = S["Service"](e0)
        if part == "service":
            services = [s0, s0]
        elif part == "engine":
            services = [s0, S["Service"](e0)]
        else:
            attr = {"allocator": "allocator", "pool": "pool", "radix": "_radix"}[part]
            setattr(e1, attr, getattr(e0, attr))
            services = [s0, S["Service"](e1)]
        with pytest.raises(ValueError) as info:
            S["Set"](services, supervise=False)
        messages[side] = str(info.value)
    assert messages["torch"] == messages["jax"]
    assert f"shares its {part}" in messages["torch"]


# ------------------------------------------------------- supervision


def tick_failure_breaker(side, weights):
    S = SIDES[side]
    rs = make_set(weights, side, n=1, svc_kw=dict(retry_budget=3), breaker_tick_failures=2,
                  quarantine_backoff_s=60.0)
    try:
        with S["faults"].inject(STEP, error=RuntimeError("flaky tick"), times=2):
            ok = rs.generate("survives the flaky ticks", max_new_tokens=4, timeout_s=JOIN_S)
        trace = [ok.finish_reason in ("stop", "length"), rs._services[0].tick_failure_count,
                 states(rs)]
        rs._supervise_once()
        summary = rs.health_summary()
        trace += [states(rs), summary["status"], summary["replicas"][0]["reason"],
                  counters(rs)]
    finally:
        rs.close()
    return trace


def error_rate_breaker(side, weights):
    S = SIDES[side]
    rs = make_set(weights, side, n=1, breaker_window_s=0.3, breaker_min_samples=50)
    trace = []
    try:
        rs._note_failure(0, S["Unavailable"]("transient"))
        rs._supervise_once()
        trace.append(states(rs))
        time.sleep(0.4)  # the window expires
        rs._supervise_once()
        trace.append(states(rs))
        rs.breaker_min_samples = 2
        rs._note_failure(0, S["Unavailable"]("again"))
        rs._note_failure(0, S["Unavailable"]("and again"))
        rs._supervise_once()
        trace += [states(rs), rs.health_summary()["replicas"][0]["reason"]]
    finally:
        rs.close()
    return trace


def broken_failover_rebuild(side, weights):
    S = SIDES[side]
    rs = make_set(weights, side, svc_kw=dict(retry_budget=0), failover_budget=1,
                  quarantine_backoff_s=0.0)
    trace = []
    try:
        old = rs._services[0]
        cold_emas(rs)
        with S["faults"].inject(STEP, error=RuntimeError("kill once"), times=1), \
                S["faults"].inject(RESET, error=RuntimeError("reset denied"),
                                   times=1):
            result = rs.generate("failover rider", max_new_tokens=4, timeout_s=JOIN_S,
                                 tenant="team-f")
        tenant = rs.stats()["tenants"]["per_tenant"]["team-f"]
        trace += [result.finish_reason in ("stop", "length"), result.replica_id,
                  old.broken, states(rs), rs.health_summary()["status"],
                  (tenant["pending"], tenant["admitted"]), counters(rs)]
        with pytest.raises(S["Unavailable"]):
            old.generate("straight to the corpse", max_new_tokens=2)
        rs._supervise_once()  # rebuild inline: no supervisor thread
        summary = rs.health_summary()
        fresh = rs._services[0]
        trace += [states(rs), summary["status"], summary["replicas"][0]["rebuilds"],
                  fresh is not old, fresh.engine is not old.engine,
                  fresh.engine.params is old.engine.params]
        cold_emas(rs)
        ok = rs.generate("recovered", max_new_tokens=3, timeout_s=JOIN_S)
        trace += [ok.finish_reason in ("stop", "length"), ok.replica_id]
    finally:
        rs.close()
    return trace


def failed_rebuild_backoff(side, weights):
    S = SIDES[side]
    rs = make_set(weights, side, n=1, quarantine_backoff_s=0.3)
    trace = []
    try:
        rs._quarantine(0, "seeded for a failing rebuild")
        with S["faults"].inject(REBUILD, error=RuntimeError("no room"), times=1):
            rs._supervise_once()
        h = rs._health[0]
        trace += [states(rs), rs.health_summary()["replicas"][0]["reason"],
                  h.rebuild_attempts, h.rebuilds]
        rs._supervise_once()  # inside the backoff: not due
        trace += [states(rs), rs._health[0].rebuild_attempts]
        time.sleep(0.35)
        rs._supervise_once()
        trace += [states(rs), rs._health[0].rebuild_attempts, rs._health[0].rebuilds]
    finally:
        rs.close()
    return trace


def breaker_inbox_handoff(side, weights):
    S = SIDES[side]
    rs = make_set(weights, side)
    trace = []
    release = threading.Event()
    outcome, outcome2 = {}, {}
    svc0 = rs._services[0]

    def call(out, **kw):
        try:
            out["r"] = svc0.generate(kw.pop("prompt"), max_new_tokens=3, timeout_s=60, **kw)
        except Exception as exc:  # noqa: BLE001 — asserted below
            out["r"] = exc

    try:
        with S["faults"].inject(STEP, stall_event=release, stall_s=30.0,
                                times=1) as rule:
            t = threading.Thread(target=call, args=(outcome,),
                                 kwargs={"prompt": "wedged in flight"}, daemon=True)
            t.start()
            assert wait_until(lambda: rule.stalled == 1, 10)
            # a second caller queues in the wedged replica's inbox with the
            # WFQ metadata the router stamps, and the charge it pairs with
            rs.tenants.admit(jreplica.DEFAULT_TENANT, 8)
            t2 = threading.Thread(target=call, args=(outcome2,),
                                  kwargs={"prompt": "second queued ticket",
                                          "tenant": jreplica.DEFAULT_TENANT,
                                          "cost_tokens": 8}, daemon=True)
            t2.start()
            assert wait_until(lambda: len(svc0._inbox) >= 1, 10)
            rs._quarantine(0, "seeded breaker trip")
            t2.join(timeout=60)
            trace += [not t2.is_alive(), type(outcome2["r"]).__name__,
                      outcome2["r"].finish_reason in ("stop", "length"), "r" in outcome,
                      states(rs), counters(rs)]
            release.set()
            t.join(timeout=60)
        tenants = rs.tenants.stats()["per_tenant"][jreplica.DEFAULT_TENANT]
        rs.tenants.release(jreplica.DEFAULT_TENANT, 8)
        trace += [not t.is_alive(), type(outcome["r"]).__name__,
                  (tenants["admitted"], tenants["pending"])]
    finally:
        release.set()
        rs.close()
    return trace


def stall_watchdog(side, weights):
    S = SIDES[side]
    rs = make_set(weights, side, svc_kw=dict(retry_budget=0, tick_stall_budget_s=0.3),
                  failover_budget=1, rebuild_drain_s=0.2, quarantine_backoff_s=0.0)
    trace = []
    release = threading.Event()
    outcome = {}

    def rider():
        try:
            outcome["r"] = rs.generate("stalled rider", max_new_tokens=4, timeout_s=60)
        except Exception as exc:  # noqa: BLE001 — asserted below
            outcome["r"] = exc

    try:
        cold_emas(rs)
        with S["faults"].inject(STEP, stall_event=release, stall_s=60.0,
                                times=1) as rule:
            t = threading.Thread(target=rider, daemon=True)
            t.start()
            assert wait_until(lambda: rule.stalled == 1, 10)
            trace.append(rs._services[1].heartbeat_age())  # idle: nothing to detect
            time.sleep(0.45)
            rs._supervise_once()  # the watchdog: quarantine, abandon, fail over
            t.join(timeout=60)
            trace += [not t.is_alive(), type(outcome["r"]).__name__, outcome["r"].replica_id,
                      states(rs), rs._services[0].broken, counters(rs)]
            rs._supervise_once()  # rebuild while the old pump is still wedged
            trace += [states(rs), rs.health_summary()["replicas"][0]["rebuilds"],
                      counters(rs)]
        release.set()
    finally:
        release.set()
        rs.close()
    return trace


def warming_stand_down(side, weights):
    S = SIDES[side]
    svc = S["Service"](make_engine(weights, side), default_timeout_s=JOIN_S,
                       tick_stall_budget_s=0.1, warmup_budget_s=0.5)
    release = threading.Event()
    trace = []
    try:
        svc.generate("warm the programs", max_new_tokens=2, timeout_s=JOIN_S)
        with svc._mutex:
            svc._warming = True
            svc._warming_since = time.perf_counter()
        with S["faults"].inject(STEP, stall_event=release, stall_s=30.0,
                                times=1) as rule:
            t = threading.Thread(target=svc.generate, args=("wedged while warming",),
                                 kwargs={"max_new_tokens": 2, "timeout_s": 60}, daemon=True)
            t.start()
            assert wait_until(lambda: rule.stalled == 1, 10)
            time.sleep(0.2)
            trace.append(svc.heartbeat_age())  # stood down within the budget
            time.sleep(0.45)
            age = svc.heartbeat_age()  # past the budget: a stalled warmup
            trace.append(age is not None and age > 0.5)
            release.set()
            t.join(timeout=60)
            trace.append(not t.is_alive())
    finally:
        release.set()
        svc.close()
    return trace


@pytest.mark.parametrize("scenario", [
    tick_failure_breaker, error_rate_breaker, broken_failover_rebuild,
    failed_rebuild_backoff, breaker_inbox_handoff, stall_watchdog, warming_stand_down,
], ids=lambda f: f.__name__)
def test_supervision_matches_jax(weights, scenario):
    """The same fault script on both packages: the health-state sequence,
    the outcomes and the set's counters are equal."""
    trace = both(scenario, weights)
    if scenario is broken_failover_rebuild:
        assert trace[3] == ["QUARANTINED", "HEALTHY"] and trace[6]["failovers"] == 1
        assert trace[7:9] == [["HEALTHY", "HEALTHY"], "healthy"] and trace[9] == 1
    if scenario is stall_watchdog:
        assert trace[4] == ["QUARANTINED", "HEALTHY"] and trace[6]["stall_quarantines"] == 1
        assert trace[7] == ["HEALTHY", "HEALTHY"] and trace[9]["pump_leaked"] == 1
    if scenario is breaker_inbox_handoff:
        assert trace[5]["handed_off"] == 1 and trace[-1] == (2, 1)


def test_rebuild_releases_the_old_engine_unless_its_pump_is_wedged(weights):
    """A rebuild whose old pump has exited frees the old engine's pool and
    graphs before the fresh engine allocates; a wedged one keeps them."""
    rs = make_set(weights, "torch", quarantine_backoff_s=0.0, rebuild_drain_s=0.2)
    try:
        old = rs._services[0]
        rs._quarantine(0, "seeded")
        rs._supervise_once()
        assert old.engine.pool is None and rs._services[0].engine.pool is not None
        assert rs.stats()["pump_leaked"] == 0
    finally:
        rs.close()


# --------------------------------------------------- resume by replay


PROMPT_R = "resume drill: a stream with a decent prompt body"


def slowed(engine, seconds=0.05):
    step = engine.step

    def slow_step():
        time.sleep(seconds)
        return step()

    engine.step = slow_step


def resume_set(weights, **svc_kw):
    rs = make_set(weights, "torch", svc_kw=svc_kw, failover_budget=1)
    for svc in rs._services:
        slowed(svc.engine)
    return rs


def jax_greedy_tokens(weights, prompt, n):
    eng = make_engine(weights, "jax")
    return JService(eng, default_timeout_s=JOIN_S).generate(prompt, max_new_tokens=n,
                                                            timeout_s=JOIN_S).tokens


def die_after_first_piece(rs, times=1, **kw):
    """Start a greedy stream, take its first delivered piece, then arm the
    next tick to die; returns (joined text, pieces, rule)."""
    it = rs.generate_stream(PROMPT_R, max_new_tokens=24, temperature=0.0, timeout_s=JOIN_S,
                            **kw)
    first = next(it)
    assert first, "nothing was delivered before the death was armed"
    rule = faults.FaultRule(error=RuntimeError("midstream death"), times=times)
    faults.arm(STEP, rule)
    pieces = [first]
    try:
        for piece in it:
            pieces.append(piece)
    finally:
        faults.reset()
    return "".join(pieces), pieces, rule


@pytest.mark.parametrize("bucketed", [False, True], ids=["tenant", "overflow_bucket"])
def test_midstream_death_resumes_token_exact(weights, monkeypatch, bucketed):
    """A death after delivered tokens resumes on the survivor: the joined
    text equals the uninterrupted greedy stream's (whose tokens equal
    JAX's), one resume, one admission per attempt, nothing pending — on
    the charged key when the tenant overflow-buckets."""
    if bucketed:
        monkeypatch.setattr(replica.TenantFairQueue, "MAX_TRACKED", 1)
    rs = resume_set(weights)
    try:
        cold_emas(rs)
        reference = rs.generate(PROMPT_R, max_new_tokens=24, timeout_s=JOIN_S)
        assert reference.tokens == jax_greedy_tokens(weights, PROMPT_R, 24)
        key = replica.TenantFairQueue.OVERFLOW_TENANT if bucketed else "team-r"
        before = rs.tenants.stats()["per_tenant"].get(key, {"admitted": 0, "pending": 0})
        cold_emas(rs)
        text, pieces, rule = die_after_first_piece(rs, tenant="team-r")
        stats = rs.stats()
        assert rule.fired == 1 and len(pieces) > 1
        assert text == reference.text
        assert stats["stream_resumes"] == 1 and stats["resume_exhausted"] == 0
        assert stats["resume_replayed_tokens"] > 0
        after = stats["tenants"]["per_tenant"][key]
        assert after["pending"] == 0 == before["pending"]
        assert after["admitted"] == before["admitted"] + 2
        assert "team-r" not in stats["tenants"]["per_tenant"] or not bucketed
        event = [e for e in replica.get_flight_recorder().events("stream_resumed")][-1]
        assert (event["replica_from"], event["replica_to"]) == (0, 1)
    finally:
        rs.close()


def test_exhausted_resume_budget_stays_typed_and_balanced(weights):
    """The resumed attempt dies too: the typed mid-stream error, one
    resume booked, the exhausted outcome counted, the ledger balanced."""
    rs = resume_set(weights, retry_budget=0)
    try:
        cold_emas(rs)
        with pytest.raises(ReplicaUnavailable):
            die_after_first_piece(rs, times=2, tenant="team-x")
        stats = rs.stats()
        assert (stats["stream_resumes"], stats["resume_exhausted"]) == (1, 1)
        tenant = stats["tenants"]["per_tenant"]["team-x"]
        assert (tenant["pending"], tenant["admitted"]) == (0, 2)
    finally:
        rs.close()


def test_resumable_false_keeps_the_typed_midstream_error(weights):
    rs = resume_set(weights)
    try:
        cold_emas(rs)
        with pytest.raises(ReplicaUnavailable, match="mid-stream"):
            die_after_first_piece(rs, tenant="team-o", resumable=False)
        stats = rs.stats()
        assert (stats["stream_resumes"], stats["resume_exhausted"]) == (0, 0)
        tenant = stats["tenants"]["per_tenant"]["team-o"]
        assert (tenant["pending"], tenant["admitted"]) == (0, 1)
    finally:
        rs.close()


def test_warmup_is_concurrent_and_wait_idle_covers_every_replica(weights):
    rs = make_set(weights, "torch")
    try:
        out = rs.warmup()
        assert out["replicas"] == 2 and len(out["per_replica"]) == 2
        assert out["prompts"] == sum(r["prompts"] for r in out["per_replica"]) > 0
        assert rs.wait_idle(JOIN_S)
    finally:
        rs.close()


# ------------------------------------------------- the worker tier's hooks


def respawnable(side):
    """A service class with the worker replica's two hooks: ``respawn()``
    (a fresh service on a fresh engine) and ``enable_shadow_handoff()``."""
    base = SIDES[side]["Service"]

    class Respawnable(base):
        armed = 0
        respawned = 0

        def enable_shadow_handoff(self):
            type(self).armed += 1

        def respawn(self):
            type(self).respawned += 1
            return type(self)(self.engine.spawn_fresh(), default_timeout_s=JOIN_S)

    return Respawnable


@pytest.mark.parametrize("supervise", [True, False], ids=["supervised", "stepped"])
def test_a_supervising_set_arms_the_shadow_handoff_as_jax(weights, supervise):
    seen = {}
    for side in SIDES:
        cls = respawnable(side)
        services = [cls(make_engine(weights, side), default_timeout_s=JOIN_S) for _ in range(2)]
        rs = SIDES[side]["Set"](services, supervise=supervise)
        try:
            seen[side] = cls.armed
        finally:
            rs.close()
    assert seen["torch"] == seen["jax"] == (2 if supervise else 0)


def test_a_replica_with_respawn_is_rebuilt_by_it_as_jax(weights):
    """The rebuild of a quarantined replica that has ``respawn()`` calls it
    (the worker tier's respawn) instead of spawning an engine in place:
    the same health sequence, counters and swap in both packages."""
    seen = {}
    for side in SIDES:
        cls = respawnable(side)
        services = [cls(make_engine(weights, side), default_timeout_s=JOIN_S) for _ in range(2)]
        rs = SIDES[side]["Set"](services, supervise=False, quarantine_backoff_s=0.0,
                                rebuild_drain_s=0.2)
        try:
            old = rs._services[0]
            rs._quarantine(0, "seeded")
            rs._supervise_once()
            swapped = rs._services[0] is not old and type(rs._services[0]) is cls
            health = rs.health_summary()
            out = rs.generate(PROMPT_A, max_new_tokens=6, temperature=0.0, timeout_s=JOIN_S)
            seen[side] = (cls.respawned, swapped, health["status"],
                          [r["rebuilds"] for r in health["replicas"]], out.tokens)
        finally:
            rs.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:4] == (1, True, "healthy", [1, 0])


def test_the_set_closes_its_worker_registry(weights):
    import socket

    registry = replica.WorkerRegistry("set-token", slots=2)
    rs = replica.ReplicaSet([PagedGenerationService(make_engine(weights, "torch"),
                                                    default_timeout_s=JOIN_S)],
                            supervise=False, registry=registry)
    addr = registry.address
    assert rs.workers() == []  # thread replicas have no worker process
    rs.close()
    with pytest.raises(OSError):
        socket.create_connection(addr, timeout=2.0).close()
