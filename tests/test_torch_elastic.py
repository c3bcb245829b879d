"""The port's elastic fleet (``runtime/autoscaler.py``, the registry's
elastic joins, ``ReplicaSet``'s join and retire, the worker's deregister,
the stitched ``/debug/flight`` and the fleet trace) against the JAX
package on the CPU, with tiny float32 models:

* ``AutoscalePolicy`` — the same ``(direction, reason)`` and saturation as
  JAX's over seeded synthetic ``(now, busy, backlog)`` sequences, covering
  the window's coverage gate, hysteresis, the clamps and both cooldowns;
  the ``AUTOSCALE_*`` settings' defaults and environment reading, and the
  policy's clamps;
* the ``WorkerRegistry`` — one script of elastic joins, a release and a
  rejoin, a redial of a retired slot, an injected join fault, run on both
  packages' registries: the same acks, rejections, epochs and counters;
* ``ReplicaSet`` — growing under load (the WFQ capacity re-derived, the
  joiner routed to), a stream in flight on a retired replica equal to
  JAX's uninterrupted greedy tokens, the inbox handed to a survivor, the
  last serving replica refused typed, injected join and retire faults
  leaving the set unchanged, a flap storm conserving pages;
* the ``Autoscaler`` loop, the same synthetic load driving both packages'
  loops over a scripted set: out then in, a skipped launch, a pending
  launch counted toward the maximum; and the port's loop over a real set;
* a socket worker spawned with ``slot=-1`` on the CPU joins a supervising
  set, serves JAX's greedy tokens, deregisters (a graceful retire, its
  slot released, a redial rejected) and rejoins on the reused slot at a
  higher epoch;
* ``build_fleet_trace`` and the stitched flight record equal to JAX's on
  the same inputs; the live ``/debug/flight`` of a worker-served request
  under ``REPLICA_MODE=process`` is ``stitched`` (with the worker's engine
  section and ticks), a dead worker listed in ``replicas_unavailable``;
* the three fleet families' Prometheus samples equal to JAX's collector's
  after the same calls.

The membership fault points are named through the port's constants, every
wait has a timeout, and every set, autoscaler and worker is closed."""

import dataclasses
import json
import multiprocessing
import random
import re
import threading
import time

import jax
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from sentio_tpu.config import ServeConfig as JServeConfig
from sentio_tpu.infra import faults as jfaults
from sentio_tpu.infra.chrome_trace import build_fleet_trace as jbuild_fleet_trace
from sentio_tpu.infra.metrics import MetricsCollector as JMetricsCollector
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime import autoscaler as jautoscaler
from sentio_tpu.runtime import replica as jreplica
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu.runtime.transport import FrameProtocolError as JFrameProtocolError
from sentio_tpu.runtime.transport import dial as jdial
from sentio_tpu.runtime.transport import send_hello as jsend_hello
from sentio_tpu_torch import __main__ as cli
from sentio_tpu_torch.config import ServeConfig
from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.infra.chrome_trace import build_fleet_trace
from sentio_tpu_torch.infra.exceptions import ReplicaUnavailable
from sentio_tpu_torch.infra.metrics import MetricsCollector
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.tokenizer import ByteTokenizer
from sentio_tpu_torch.runtime import autoscaler, replica
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, PagedResult
from sentio_tpu_torch.runtime.service import PagedGenerationService
from sentio_tpu_torch.runtime.transport import FrameProtocolError, dial, send_hello
from sentio_tpu_torch.runtime.weights import llama_from_jax
from sentio_tpu_torch.runtime.worker import STREAM_CHUNK_POINT, ProcessReplica, WorkerSpec
from _sanitize import _sanitized  # noqa: F401  (arms the module)


ENGINE_KW = dict(max_slots=2, page_size=8, max_pages_per_seq=8, steps_per_tick=2,
                 max_tick_steps=2)
JOIN_S = 120.0
BUILD_S = 120.0
TOKEN = "elastic-test-token"
PROMPT = "an elastic fleet grows and shrinks"
NEW_TOKENS = 8
# the fault points, through constants (JAX's committed inventory counts the
# literal names its own tests arm)
JOIN, RETIRE, ELASTIC_JOIN = replica.JOIN_POINT, replica.RETIRE_POINT, replica.ELASTIC_JOIN_POINT
STEP = "paged." + "step"


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(29), jcfg))
    return jcfg, tree, llama_from_jax(tree)


@pytest.fixture(scope="module")
def reference(weights):
    """JAX's service on the shared weights: PROMPT's greedy tokens and
    text."""
    jcfg, tree, _ = weights
    svc = JService(JEngine(model_config=jcfg, params=tree, **ENGINE_KW),
                   default_timeout_s=JOIN_S)
    try:
        result = svc.generate(PROMPT, max_new_tokens=NEW_TOKENS, temperature=0.0)
    finally:
        svc.close()
    return {"tokens": list(result.tokens), "text": result.text}


@pytest.fixture(autouse=True)
def _disarmed():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def port_config(weights) -> LlamaConfig:
    return LlamaConfig(**dataclasses.asdict(weights[0]))


def make_service(weights, **svc_kw) -> PagedGenerationService:
    engine = ContinuousBatchingEngine(model_config=port_config(weights), params=weights[2],
                                      device="cpu", **ENGINE_KW)
    svc = PagedGenerationService(engine, default_timeout_s=JOIN_S, **svc_kw)
    svc.generate("warm the replica", max_new_tokens=2, timeout_s=JOIN_S)
    return svc


def pages_conserved(rs) -> None:
    for s in rs.stats()["replicas"]:
        assert s["free_pages"] + s.get("prefix_cache_pages", 0) == s["total_pages"] - 1, s


def wait_for(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


# --------------------------------------------------------------- the policy


POLICY_CASES = {
    "defaults": dict(),
    "short_window": dict(min_replicas=1, max_replicas=3, window_s=1.0, out_cooldown_s=2.0,
                         in_cooldown_s=3.0),
    "hysteresis_clamped": dict(min_replicas=2, max_replicas=2, window_s=0.5, out_busy=0.4,
                               in_busy=0.9, out_backlog=0.3),
    "no_cooldowns": dict(min_replicas=0, max_replicas=5, window_s=2.0, out_cooldown_s=0.0,
                         in_cooldown_s=0.0, out_backlog=2.0),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_policy_decisions_match_jax(case, seed):
    """One seeded sequence of loads (hot, idle and middling stretches,
    polls 0.05–0.6 s apart) into both policies, a decision executed (the
    fleet resized, ``note_scaled``) whenever one fires: every decision,
    reason and saturation reading equal."""
    kw = POLICY_CASES[case]
    ours, theirs = autoscaler.AutoscalePolicy(**kw), jautoscaler.AutoscalePolicy(**kw)
    assert vars(ours).keys() >= {"min_replicas", "max_replicas", "window_s", "out_busy",
                                 "in_busy", "out_backlog", "out_cooldown_s", "in_cooldown_s"}
    for key in ("min_replicas", "max_replicas", "window_s", "out_busy", "in_busy",
                "out_backlog", "out_cooldown_s", "in_cooldown_s"):
        assert getattr(ours, key) == getattr(theirs, key), key
    rng = random.Random(seed)
    now, fleet = 1000.0, max(ours.min_replicas, 1)
    regime = "hot"
    seen = set()
    for _ in range(600):
        if rng.random() < 0.05:
            regime = rng.choice(["hot", "idle", "middle", "backlog"])
        busy, backlog = {"hot": (rng.uniform(0.8, 1.0), rng.uniform(0.0, 0.2)),
                         "idle": (rng.uniform(0.0, 0.1), rng.uniform(0.0, 0.05)),
                         "middle": (rng.uniform(0.2, 0.7), rng.uniform(0.0, 0.3)),
                         "backlog": (rng.uniform(0.0, 0.5), rng.uniform(0.5, 1.0))}[regime]
        now += rng.uniform(0.05, 0.6)
        for policy in (ours, theirs):
            policy.observe(now, busy, backlog)
        got, want = ours.decide(now, fleet), theirs.decide(now, fleet)
        assert got == want, (now, fleet, got, want)
        assert ours.saturated(now) == theirs.saturated(now)
        seen.add(want[1])
        if want[0] is not None:
            for policy in (ours, theirs):
                policy.note_scaled(now, want[0])
            fleet += 1 if want[0] == "out" else -1
    assert "window_warming" in seen


def test_autoscale_settings_match_jax(monkeypatch):
    """The ten ``AUTOSCALE_*`` settings: JAX's names and defaults, read
    from the environment as JAX reads them."""
    keys = [f.name for f in dataclasses.fields(ServeConfig) if f.name.startswith("autoscale")]
    assert len(keys) == 10
    assert {k: getattr(ServeConfig(), k) for k in keys} == \
        {k: getattr(JServeConfig(), k) for k in keys}
    env = {"AUTOSCALE": "1", "AUTOSCALE_MIN_REPLICAS": "2", "AUTOSCALE_MAX_REPLICAS": "1",
           "AUTOSCALE_WINDOW_S": "0.01", "AUTOSCALE_OUT_BUSY": "1.7",
           "AUTOSCALE_IN_BUSY": "0.9", "AUTOSCALE_OUT_BACKLOG": "0.25",
           "AUTOSCALE_OUT_COOLDOWN_S": "-3", "AUTOSCALE_IN_COOLDOWN_S": "7.5",
           "AUTOSCALE_POLL_INTERVAL_S": "0.01"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ours, theirs = ServeConfig.from_env(), JServeConfig.from_env()
    assert {k: getattr(ours, k) for k in keys} == {k: getattr(theirs, k) for k in keys}
    # the clamps are the policy's and the loop's, the same in both
    kw = dict(min_replicas=ours.autoscale_min_replicas, max_replicas=ours.autoscale_max_replicas,
              window_s=ours.autoscale_window_s, out_busy=ours.autoscale_out_busy,
              in_busy=ours.autoscale_in_busy, out_backlog=ours.autoscale_out_backlog,
              out_cooldown_s=ours.autoscale_out_cooldown_s,
              in_cooldown_s=ours.autoscale_in_cooldown_s)
    p, q = autoscaler.AutoscalePolicy(**kw), jautoscaler.AutoscalePolicy(**kw)
    clamped = {k: getattr(p, k) for k in kw}
    assert clamped == {k: getattr(q, k) for k in kw}
    assert clamped == dict(min_replicas=2, max_replicas=2, window_s=0.1, out_busy=1.0,
                           in_busy=0.9, out_backlog=0.25, out_cooldown_s=0.0,
                           in_cooldown_s=7.5)
    loop = autoscaler.Autoscaler(None, p, poll_interval_s=ours.autoscale_poll_interval_s,
                                 launch_grace_s=0.1)
    jloop = jautoscaler.Autoscaler(None, q, poll_interval_s=ours.autoscale_poll_interval_s,
                                   launch_grace_s=0.1)
    assert (loop.poll_interval_s, loop.launch_grace_s) == \
        (jloop.poll_interval_s, jloop.launch_grace_s) == (0.05, 1.0)


# ------------------------------------------------------------- the registry


def registry_script(reg_cls, dial_fn, hello_fn, proto_error, fault_mod) -> list:
    """Joins with slot -1, a release, a rejoin, a retired slot's redial, a
    fixed slot's hello and an injected join fault, on one registry of one
    fixed slot; every ack, rejection, epoch and counter."""
    reg = reg_cls(TOKEN, slots=1)
    out: list = []
    links: list = []

    def joins(n):
        # a join is queued just after its registration is counted, each
        # handshake on a thread of its own: the order is the threads'
        got: list = []
        wait_for(lambda: got.extend(reg.drain_joins()) or len(got) >= n, 10, f"{n} joins")
        return sorted(got)

    def hello(slot, pid):
        t = dial_fn(reg.address)
        links.append(t)
        try:
            ack = hello_fn(t, TOKEN, slot, pid)
        except proto_error as exc:
            return ("rejected", str(exc))
        return ("ack", ack["slot"], ack["epoch"])

    try:
        out.append(hello(0, 10))
        out.append(hello(-1, 11))
        out.append(hello(-1, 12))
        out.append(("joins", joins(2), reg.drain_joins()))
        out.append(("await", reg.await_registration(1, 5.0)[2]))
        reg.release_slot(1)
        reg.release_slot(1)  # a second release is a no-op
        out.append(hello(1, 11))  # the retired incarnation redials
        out.append(hello(-1, 13))  # reuses the released slot, its epoch kept
        with fault_mod.inject(ELASTIC_JOIN, error=RuntimeError("chaos: join flap"), times=1):
            out.append(hello(-1, 14))
        out.append(hello(-1, 15))  # the fault leaked no slot
        out.append(hello(7, 16))
        out.append(("joins", joins(2)))
        stats = reg.stats()
        out.append({k: stats[k] for k in ("epochs", "registrations", "rejections", "slots",
                                          "free_slots", "elastic_joins", "released_slots")})
        out.append([reg.current_epoch(i) for i in range(stats["slots"])])
    finally:
        for t in links:
            t.close()
        reg.close()
    return out


def test_registry_elastic_joins_match_jax():
    ours = registry_script(replica.WorkerRegistry, dial, send_hello, FrameProtocolError,
                           faults)
    theirs = registry_script(jreplica.WorkerRegistry, jdial, jsend_hello,
                             JFrameProtocolError, jfaults)
    assert ours == theirs
    assert ours[1] == ("ack", 1, 1) and ours[2] == ("ack", 2, 1)
    assert ours[5] == ("rejected", "registration rejected: slot 1 was retired")
    assert ours[6] == ("ack", 1, 2)  # the reused slot, a higher epoch
    assert ours[7][0] == "rejected" and "join flap" in ours[7][1]
    assert ours[8] == ("ack", 3, 1)


# ------------------------------------------------------------ the replica set


def test_grow_under_load_then_retire_a_stream_token_exact(weights, reference, monkeypatch):
    """Grown 1 → 3 at runtime (the WFQ capacity follows), the joiners
    routed to; a stream in flight on the replica retired from another
    thread finishes with JAX's uninterrupted greedy tokens, the slot parks
    RETIRED, routing avoids it, a second retire is a no-op."""
    svc0 = make_service(weights, max_queue=8)
    rs = replica.ReplicaSet([svc0], supervise=False)
    try:
        assert rs.tenants.capacity == 8
        idx = [rs.add_replica(make_service(weights, max_queue=8)) for _ in range(2)]
        assert idx == [1, 2] and rs.tenants.capacity == 24
        fleet = rs.stats()["fleet"]
        assert (fleet["live_replicas"], fleet["joined"]) == (3, 2)
        routed: list = []
        orig = rs._route

        def spy(toks, count=True, exclude=frozenset()):
            i, hit = orig(toks, count=count, exclude=exclude)
            routed.append(i)
            return i, hit

        monkeypatch.setattr(rs, "_route", spy)
        assert rs._eligible() == [0, 1, 2]
        # replica 0 out of the healthy set for a moment: the joiners serve
        rs._transition(0, replica.HEALTH_DEGRADED, "test: route to the joiners")
        for i in range(4):
            assert isinstance(rs.generate(f"spread load {i}", max_new_tokens=2,
                                          timeout_s=JOIN_S), PagedResult)
        rs._transition(0, replica.HEALTH_HEALTHY, "test: back")
        assert set(routed) <= {1, 2} and routed, routed
        routed.clear()
        stats_out: dict = {}
        stream = rs.generate_stream(PROMPT, max_new_tokens=NEW_TOKENS, temperature=0.0,
                                    timeout_s=JOIN_S, stats_out=stats_out)
        first = next(stream)
        serving = routed[-1]
        box: dict = {}
        t = threading.Thread(target=lambda: box.update(r=rs.retire(serving, deadline_s=60.0)))
        t.start()
        rest = "".join(stream)
        t.join(timeout=90)
        assert not t.is_alive()
        assert first + rest == reference["text"]
        assert stats_out["tokens"] == len(reference["tokens"])
        assert box["r"]["retired"] is True and box["r"]["drained"] is True
        assert rs._health[serving].state == replica.HEALTH_RETIRED
        assert rs.tenants.capacity == 16 and rs.live_replicas == 2
        assert serving not in [r["replica"] for r in rs.health_summary()["replicas"]]
        assert isinstance(rs.generate(PROMPT, max_new_tokens=3, timeout_s=JOIN_S), PagedResult)
        assert routed[-1] != serving
        assert rs.retire(serving)["retired"] is False
        assert rs.stats()["fleet"]["retired"] == 1
        pages_conserved(rs)
    finally:
        rs.close()


def test_retire_hands_the_inbox_to_a_survivor(weights):
    """A retire moves the never-dispatched inbox at once (not after the
    drain deadline the wedged replica blows): the queued caller wakes
    with the survivor's result, the WFQ recharged."""
    svc0, svc1 = make_service(weights), make_service(weights)
    rs = replica.ReplicaSet([svc0, svc1], supervise=False)
    release = threading.Event()
    threads = []
    try:
        wedged: dict = {}
        queued: dict = {}

        def call(box, prompt, **kw):
            try:
                box["r"] = svc0.generate(prompt, max_new_tokens=3, temperature=0.0,
                                         timeout_s=60, **kw)
            except Exception as exc:  # noqa: BLE001 — asserted below
                box["r"] = exc

        with faults.inject(STEP, stall_event=release, stall_s=30.0, times=1) as rule:
            threads.append(threading.Thread(target=call, args=(wedged, "wedged in flight")))
            threads[-1].start()
            wait_for(lambda: rule.stalled == 1, 10, "the wedge")
            rs.tenants.admit(replica.DEFAULT_TENANT, 8)
            threads.append(threading.Thread(
                target=call, args=(queued, "queued behind the wedge"),
                kwargs=dict(tenant=replica.DEFAULT_TENANT, cost_tokens=8)))
            threads[-1].start()
            wait_for(lambda: len(svc0._inbox) >= 1, 10, "the queued ticket")
            result = rs.retire(0, deadline_s=1.0)
            assert result["retired"] is True and result["handed_off"] >= 1
            assert rs.stats()["handed_off"] >= 1
            threads[-1].join(timeout=60)
            assert isinstance(queued["r"], PagedResult), queued["r"]
            assert queued["r"].finish_reason in ("stop", "length")
            assert queued["r"].replica_id == 1
        rs.tenants.release(replica.DEFAULT_TENANT, 8)
    finally:
        release.set()
        for t in threads:
            t.join(timeout=60)
        rs.close()


def test_retire_of_the_last_serving_replica_is_refused_typed(weights):
    rs = replica.ReplicaSet([make_service(weights)], supervise=False)
    try:
        with pytest.raises(ReplicaUnavailable) as info:
            rs.retire(0)
        assert info.value.details.get("reason") == "last_serving"
        assert info.value.retryable is False
        assert isinstance(rs.generate("still serving", max_new_tokens=2, timeout_s=JOIN_S),
                          PagedResult)
    finally:
        rs.close()


@pytest.mark.parametrize("point", ["join", "retire"])
def test_injected_membership_faults_leave_the_set_unchanged(weights, point):
    """A join fault: never half-joined (members, capacity, health), the
    same joiner lands on retry; a retire fault fires before any
    transition: the replica serves on, never drained."""
    rs = replica.ReplicaSet([make_service(weights), make_service(weights)], supervise=False)
    joiner = None
    try:
        if point == "join":
            joiner = make_service(weights)
            capacity = rs.tenants.capacity
            with faults.inject(JOIN, error=RuntimeError("chaos: join flap"), times=1):
                with pytest.raises(RuntimeError, match="join flap"):
                    rs.add_replica(joiner)
            assert rs.stats()["fleet"]["live_replicas"] == 2
            assert rs.tenants.capacity == capacity and rs.replicas == 2
            assert rs.add_replica(joiner) == 2
            joiner = None
            assert rs.stats()["fleet"]["live_replicas"] == 3
        else:
            with faults.inject(RETIRE, error=RuntimeError("chaos: retire flap"), times=1):
                with pytest.raises(RuntimeError, match="retire flap"):
                    rs.retire(0)
            assert rs._health[0].state == replica.HEALTH_HEALTHY
            assert rs.stats()["fleet"]["retired"] == 0
        assert isinstance(rs.generate("membership flap survivor", max_new_tokens=2,
                                      timeout_s=JOIN_S), PagedResult)
    finally:
        if joiner is not None:
            joiner.close()
        rs.close()


@pytest.mark.parametrize("failure", ["join_fault", "gap"])
def test_a_failed_join_gives_its_registry_slot_back(weights, failure):
    """Socket mode: a joiner the set cannot wire in is closed and its
    registry slot released, so the fleet grows again. ``join_fault``: an
    injected ``replica.join`` fault on the one joiner; ``gap``: of two
    joiners the first fails to come up (the membership source releases its
    slot) and the second's slot would leave a gap in the set."""
    registry = replica.WorkerRegistry(TOKEN, slots=1)
    rs = replica.ReplicaSet([make_service(weights)], registry=registry, supervise=False)
    links: list = []
    queued: list = []
    fail_first = [failure == "gap"]

    def hello() -> int:
        t = dial(registry.address)
        links.append(t)
        return send_hello(t, TOKEN, -1, 100 + len(links))["slot"]

    def source():
        out = []
        for slot in sorted(queued):  # handshakes queue their joins concurrently
            if fail_first[0]:
                fail_first[0] = False  # its warmup failed: the source releases it
                registry.release_slot(slot)
                continue
            out.append((slot, make_service(weights)))
        queued.clear()
        return out

    def joined(n: int) -> None:
        wait_for(lambda: queued.extend(registry.drain_joins()) or len(queued) >= n, 10,
                 f"{n} registry joins")

    rs.set_membership_source(source, release_slot=registry.release_slot)
    try:
        n = 1 if failure == "join_fault" else 2
        assert [hello() for _ in range(n)] == list(range(1, n + 1))
        joined(n)
        if failure == "join_fault":
            with faults.inject(JOIN, error=RuntimeError("chaos: join flap"), times=1):
                rs._supervise_once()
        else:
            rs._supervise_once()
        assert rs.live_replicas == 1 and rs.replicas == 1
        assert registry.stats()["free_slots"] == list(range(1, n + 1))
        # the released slots are granted again, lowest first, and join
        assert [hello() for _ in range(n)] == list(range(1, n + 1))
        joined(n)
        rs._supervise_once()
        assert rs.live_replicas == n + 1 and registry.stats()["free_slots"] == []
        assert [registry.current_epoch(i) for i in range(1, n + 1)] == [2] * n
        assert isinstance(rs.services[n].generate("a rejoined slot serves", max_new_tokens=2,
                                                  timeout_s=JOIN_S), PagedResult)
    finally:
        rs.close()
        for t in links:
            t.close()


def test_joins_returned_out_of_slot_order_all_join(weights):
    """Two joins the source returns highest slot first (their handshakes
    raced) are both wired in: the set attaches the lowest slot first."""
    registry = replica.WorkerRegistry(TOKEN, slots=1)
    rs = replica.ReplicaSet([make_service(weights)], registry=registry, supervise=False)
    links: list = []
    queued: list = []
    try:
        for pid in (101, 102):
            links.append(dial(registry.address))
            send_hello(links[-1], TOKEN, -1, pid)
        wait_for(lambda: queued.extend(registry.drain_joins()) or len(queued) >= 2, 10,
                 "2 registry joins")

        def source():
            out = [(slot, make_service(weights)) for slot in sorted(queued, reverse=True)]
            queued.clear()
            return out

        rs.set_membership_source(source, release_slot=registry.release_slot)
        rs._supervise_once()
        assert rs.live_replicas == 3 and registry.stats()["free_slots"] == []
    finally:
        rs.close()
        for t in links:
            t.close()


@pytest.mark.parametrize("end", ["attach", "close"])
def test_a_warming_joiner_never_holds_up_supervision(weights, end):
    """A supervising set polls its membership source on a thread of its
    own: while a joiner warms (the source blocks), the supervisor's passes
    go on; the warmed joiner is wired in by the next pass (``attach``), or,
    when the set closes first, closed and never wired in (``close``)."""
    rs = replica.ReplicaSet([make_service(weights)], probe_interval_s=0.05)
    passes: list = []
    supervise_once = rs._supervise_once

    def counted() -> None:
        passes.append(time.monotonic())
        supervise_once()

    rs._supervise_once = counted
    entered, warmed = threading.Event(), threading.Event()
    joiner = make_service(weights)

    def source():
        if entered.is_set():
            return []
        entered.set()
        warmed.wait(JOIN_S)  # a joiner's spawn and warmup
        return [(None, joiner)]

    rs.set_membership_source(source)
    try:
        assert entered.wait(10)
        n = len(passes)
        wait_for(lambda: len(passes) >= n + 5, 10, "supervisor passes while a joiner warms")
        assert rs.live_replicas == 1
        if end == "attach":
            warmed.set()
            wait_for(lambda: rs.live_replicas == 2, 10, "the warmed joiner wired in")
            assert rs.services[1] is joiner and not joiner.closed
        else:
            threading.Timer(0.3, warmed.set).start()
            rs.close()
            wait_for(lambda: joiner.closed, 10, "the late joiner closed")
            assert rs.replicas == 1
    finally:
        warmed.set()
        rs.close()
        if not joiner.closed:
            joiner.close()
    assert not any(t.name == "replica-join" and t.is_alive() for t in threading.enumerate())


def test_a_flap_storm_conserves_pages_and_leaks_nothing(weights):
    rs = replica.ReplicaSet([make_service(weights), make_service(weights)], supervise=False)
    try:
        for cycle in range(3):
            idx = rs.add_replica(make_service(weights, max_queue=8))
            assert idx == 2  # one slot, reused
            for i in range(2):
                assert isinstance(rs.generate(f"flap storm c{cycle} r{i}", max_new_tokens=2,
                                              timeout_s=JOIN_S), PagedResult)
            assert rs.retire(idx, deadline_s=30.0)["retired"] is True
            assert rs.stats()["fleet"]["live_replicas"] == 2
        fleet = rs.stats()["fleet"]
        assert (fleet["joined"], fleet["retired"]) == (3, 3)
        assert fleet["retire_drain_p95_s"] >= 0.0
        assert rs.stats()["pump_leaked"] == 0
        pages_conserved(rs)
    finally:
        rs.close()
    wait_for(lambda: not any(t.name == "paged-decode-pump" and t.is_alive()
                             for t in threading.enumerate()), 10, "the pumps to exit")


# ------------------------------------------------------------- the autoscaler


class ScriptedSet:
    """A set the loop drives: membership from ``fleet``, the load from
    ``drive``; ``retire`` refuses the last serving replica as a set does."""

    def __init__(self, drive: dict, fleet: int = 1) -> None:
        self.drive, self.fleet, self.retired = drive, fleet, []

    def fleet_load(self) -> dict:
        return {"serving": self.fleet, "busy": self.drive["busy"],
                "backlog_fraction": self.drive["backlog"],
                "replicas": [{"replica": i, "busy": self.drive["busy"] + 0.01 * i,
                              "backlog": i % 2} for i in range(self.fleet)]}

    def retire(self, idx: int) -> dict:
        if self.fleet <= 1:
            raise RuntimeError("last serving replica")
        self.fleet -= 1
        self.retired.append(idx)
        return {"retired": True}


def loop_script(module, scenario: str) -> list:
    drive = {"busy": 0.95, "backlog": 0.8}
    rs = ScriptedSet(drive)
    launches: list = []

    def joining_launcher():
        launches.append(1)
        rs.fleet += 1  # joins at once

    if scenario == "out_then_in":
        policy = module.AutoscalePolicy(min_replicas=1, max_replicas=2, window_s=1.0,
                                        out_cooldown_s=0.0, in_cooldown_s=0.0)
        loop = module.Autoscaler(rs, policy, launcher=joining_launcher)
        times = [100.0, 100.3, 100.6, 100.9, 101.2, 101.5, 101.8, 102.1]
        idle_from = 103.5
        times += [103.5, 103.8, 104.1, 104.4, 105.0]
    elif scenario == "skipped":
        policy = module.AutoscalePolicy(min_replicas=1, max_replicas=4, window_s=1.0,
                                        out_cooldown_s=0.0)
        loop = module.Autoscaler(rs, policy)
        times, idle_from = [200.0 + 0.3 * i for i in range(6)], None
    else:  # pending: a launch that never joins holds the bound until its grace
        policy = module.AutoscalePolicy(min_replicas=1, max_replicas=2, window_s=1.0,
                                        out_cooldown_s=0.0)
        loop = module.Autoscaler(rs, policy, launcher=lambda: launches.append(1),
                                 launch_grace_s=5.0)
        times = [300.0, 300.3, 300.6, 300.9, 301.2, 301.5, 301.8, 302.1, 302.4,
                 306.0, 306.3, 306.6, 306.9]
        idle_from = None
    out = []
    try:
        for t in times:
            if idle_from is not None and t >= idle_from:
                drive.update(busy=0.0, backlog=0.0)
            out.append((t, loop.step(now=t), rs.fleet, loop.stats()))
    finally:
        loop.close()
    return out + [("launches", len(launches), "retired", rs.retired)]


@pytest.mark.parametrize("scenario", ["out_then_in", "skipped", "pending"])
def test_autoscaler_loop_matches_jax(scenario):
    ours, theirs = loop_script(autoscaler, scenario), loop_script(jautoscaler, scenario)
    assert ours == theirs
    steps = [row[1] for row in ours[:-1]]
    if scenario == "out_then_in":
        assert steps.count("out") == 1 and steps.count("in") == 1
        assert ours[-1] == ("launches", 1, "retired", [0])
    elif scenario == "skipped":
        assert set(steps) == {None} and ours[-2][3]["skipped"] >= 1
    else:
        assert steps.count("out") == 2 and ours[8][3]["pending_launches"] == 1


def test_autoscaler_over_a_real_set_scales_out_then_in(weights, monkeypatch):
    """The loop over a port set (the load steered, the membership real):
    out through a launcher that joins a replica, back in by retiring the
    most idle; the decisions counted on /metrics' families and the flight
    recorder."""
    from sentio_tpu_torch.infra.flight import get_flight_recorder
    from sentio_tpu_torch.infra.metrics import get_metrics

    rs = replica.ReplicaSet([make_service(weights, max_queue=8)], supervise=False)
    drive = {"busy": 0.95, "backlog": 0.8}
    orig = rs.fleet_load

    def steered():
        load = orig()
        load.update(busy=drive["busy"], backlog_fraction=drive["backlog"])
        for p in load["replicas"]:
            p["busy"] = drive["busy"]
        return load

    monkeypatch.setattr(rs, "fleet_load", steered)
    loop = autoscaler.Autoscaler(
        rs, autoscaler.AutoscalePolicy(min_replicas=1, max_replicas=2, window_s=1.0,
                                       out_cooldown_s=0.0, in_cooldown_s=0.0),
        launcher=lambda: rs.add_replica(make_service(weights, max_queue=8)))
    decisions = get_metrics().autoscale_decisions.values()
    try:
        assert [loop.step(now=t) for t in (100.0, 100.3, 100.6, 100.9)] == \
            [None, None, None, "out"]
        assert rs.stats()["fleet"]["live_replicas"] == 2
        drive.update(busy=0.0, backlog=0.0)
        assert [loop.step(now=t) for t in (103.5, 103.8, 104.1, 104.4)] == \
            [None, None, None, "in"]
        fleet = rs.stats()["fleet"]
        assert (fleet["live_replicas"], fleet["retired"]) == (1, 1)
        assert get_metrics().fleet_size.values() == {(): 1.0}
        after = get_metrics().autoscale_decisions.values()
        for key in (("out", "busy"), ("in", "idle")):
            assert after.get(key, 0) - decisions.get(key, 0) == 1
        events = [t for t in get_flight_recorder().timeline()
                  if t.get("event") == "autoscale_decision"]
        assert [e["direction"] for e in events[-2:]] == ["out", "in"]
    finally:
        loop.close()
        rs.close()


def test_the_loop_thread_starts_once_and_stops():
    rs = ScriptedSet({"busy": 0.5, "backlog": 0.1})
    loop = autoscaler.Autoscaler(rs, autoscaler.AutoscalePolicy(), poll_interval_s=0.05)
    try:
        loop.start()
        loop.start()
        assert sum(t.name == "fleet-autoscaler" and t.is_alive()
                   for t in threading.enumerate()) == 1
        time.sleep(0.2)
        assert loop.stats()["scale_out"] == loop.stats()["scale_in"] == 0
    finally:
        loop.close()
    assert not any(t.name == "fleet-autoscaler" and t.is_alive() for t in threading.enumerate())


# ---------------------------------------------------------- a socket worker


def elastic_spec(weights) -> WorkerSpec:
    return WorkerSpec(factory_kwargs=dict(
        model_family="llama", model_config=dataclasses.asdict(port_config(weights)),
        params=weights[2], engine_kwargs=dict(ENGINE_KW), device="cpu",
        service_kwargs={"replica_id": -1, "default_timeout_s": JOIN_S}),
        auth_token=TOKEN, reconnect=True, status_interval_s=0.05, telemetry_interval_s=0.2)


def test_a_socket_worker_joins_leaves_and_rejoins(weights, reference):
    """The launcher's worker dials with ``slot=-1``: the supervisor attaches
    it at slot 1 (epoch 1), it serves JAX's greedy tokens; its deregister
    is a graceful retire (the slot released, a redial rejected typed); a
    second launch reuses slot 1 at epoch 2 and serves again; closing the
    set and reaping the launcher leaves no process."""
    registry = replica.WorkerRegistry(TOKEN, slots=1)
    rs = replica.ReplicaSet([make_service(weights)], registry=registry,
                            probe_interval_s=0.05)
    tok = ByteTokenizer(weights[0].vocab_size)
    spec = elastic_spec(weights)

    def source():
        return [(slot, ProcessReplica(spec, tok, replica_id=slot, transport_mode="socket",
                                      registry=registry, adopt_registration=True,
                                      build_timeout_s=BUILD_S, partition_timeout_s=10.0))
                for slot in registry.drain_joins()]

    rs.set_membership_source(source, release_slot=registry.release_slot)
    launcher = autoscaler.socket_worker_launcher(registry.address, spec)
    try:
        for epoch in (1, 2):
            launcher()
            wait_for(lambda: rs.live_replicas == 2, BUILD_S, f"join #{epoch}")
            worker = rs.services[1]
            assert worker.replica_id == 1 and worker.epoch == epoch
            assert registry.current_epoch(1) == epoch
            result = worker.generate(PROMPT, max_new_tokens=NEW_TOKENS, temperature=0.0,
                                     timeout_s=JOIN_S)
            assert list(result.tokens) == reference["tokens"] and result.replica_id == 1
            assert worker.stats()["completed"] >= 1
            worker.request_leave("test leave")
            wait_for(lambda: rs._health[1].state == replica.HEALTH_RETIRED, 60,
                     f"retire #{epoch}")
            assert worker.deregister_requested == "test leave" and worker.closed
            assert registry.stats()["free_slots"] == [1]
            t = dial(registry.address)
            try:
                with pytest.raises(FrameProtocolError, match="slot 1 was retired"):
                    send_hello(t, TOKEN, 1, 99)
            finally:
                t.close()
        fleet = rs.stats()["fleet"]
        assert (fleet["joined"], fleet["retired"], fleet["live_replicas"]) == (2, 2, 1)
    finally:
        rs.close()
        launcher.close()
    assert not [p for p in multiprocessing.active_children()
                if p.name == "sentio-elastic-worker"]


def test_a_retired_workers_lagging_stream_ends_on_that_worker(weights, reference,
                                                              monkeypatch):
    """A worker answers the retire's drain only once its answers' last
    frames are sent: a stream in flight on the retired worker whose frames
    lag behind its engine (a delay between delivered chunks) ends there,
    not by a resume on the survivor after the close cut it, with JAX's
    greedy text."""
    spec = WorkerSpec(factory_kwargs=dict(
        model_family="llama", model_config=dataclasses.asdict(port_config(weights)),
        params=weights[2], engine_kwargs=dict(ENGINE_KW), device="cpu",
        service_kwargs={"replica_id": 1, "default_timeout_s": JOIN_S}),
        status_interval_s=0.05, telemetry_interval_s=0)
    worker = ProcessReplica(spec, ByteTokenizer(weights[0].vocab_size), replica_id=1,
                            build_timeout_s=BUILD_S)
    rs = replica.ReplicaSet([make_service(weights), worker], supervise=False)
    try:
        worker.inject_fault(STREAM_CHUNK_POINT, delay_s=0.25)
        # the stream to the worker; a resume (exclude holds it) to the survivor
        monkeypatch.setattr(rs, "_route", lambda toks, count=True, exclude=frozenset():
                            (0 if 1 in exclude else 1, 0))
        stats_out: dict = {}
        stream = rs.generate_stream(PROMPT, max_new_tokens=NEW_TOKENS, temperature=0.0,
                                    timeout_s=JOIN_S, stats_out=stats_out)
        first = next(stream)
        box: dict = {}
        t = threading.Thread(target=lambda: box.update(r=rs.retire(1, deadline_s=60.0)))
        t.start()
        rest = "".join(stream)
        t.join(timeout=90)
        assert not t.is_alive()
        assert first + rest == reference["text"]
        assert stats_out["replica_id"] == 1 and stats_out["tokens"] == len(reference["tokens"])
        assert rs.stats()["stream_resumes"] == 0
        assert box["r"]["retired"] is True and box["r"]["drained"] is True
        assert rs._health[1].state == replica.HEALTH_RETIRED
    finally:
        rs.close()


# ------------------------------------------------- fleet trace and stitching


def fleet_workers(uncertainty=0.0005) -> list:
    tick = {"tick": 7, "t_s": 2.0, "pump_ms": 10.0, "phase_ms": {"other": 10.0}, "replica": 0}
    record = {"request_id": "w1", "t_start_s": 1.5, "latency_ms": 100.0,
              "engine": {"replica_id": 0, "t_submit_s": 1.6, "tokens": 4}}
    return [{"replica": 1, "epoch": 2, "shift_s": 3.0, "uncertainty_s": uncertainty,
             "ticks": [tick], "records": [record]},
            {"replica": 0, "epoch": 1, "shift_s": 0.0, "uncertainty_s": None,
             "ticks": [dict(tick, t_s=1.0)], "records": []},
            {"replica": 0, "epoch": 2, "shift_s": -1.0, "uncertainty_s": 0.0,
             "ticks": [], "records": [], "status": "retired"},
            {"replica": 2, "epoch": 1, "shift_s": 0.5, "uncertainty_s": 0.002,
             "ticks": [], "records": [], "status": "dead"}]


@pytest.mark.parametrize("uncertainty", [0.0005, None])
def test_fleet_trace_matches_jax(uncertainty):
    router_ticks = [{"tick": 1, "t_s": 1.0, "pump_ms": 4.0, "replica": 0}]
    router_records = [{"request_id": "r1", "t_start_s": 0.5, "latency_ms": 20.0,
                       "engine": {"replica_id": 0, "t_submit_s": 0.6, "tokens": 2}}]
    ours = build_fleet_trace(fleet_workers(uncertainty), router_ticks=router_ticks,
                             router_records=router_records)
    theirs = jbuild_fleet_trace(fleet_workers(uncertainty), router_ticks=router_ticks,
                                router_records=router_records)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    names = {e["pid"]: e["args"]["name"] for e in ours["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names[1001] == "worker 0 epoch 1 (clock unaligned)"
    assert names[1002] == "worker 0 epoch 2 (clock ±0.0ms) (retired)"
    assert names[3001] == "worker 2 epoch 1 (clock ±2.0ms) (dead)"


class FlightSvc:
    """A worker replica as the stitcher sees it."""

    def __init__(self, record=None, fail=False, replica_id=0, shift=(3.0, 0.0005)):
        self.replica_id, self.epoch = replica_id, 2
        self._record, self._fail, self._shift = record, fail, shift

    def fetch_flight(self, request_id=None, last=None, timeout_s=5.0):
        if self._fail:
            raise RuntimeError("worker gone")
        return {"record": self._record, "replica": self.replica_id, "epoch": self.epoch}

    def flight_shift_s(self, router_origin_s):
        return self._shift


def worker_record() -> dict:
    return {"request_id": "r1", "engine": {"t_submit_s": 1.0, "tokens": 5, "replica_id": 0},
            "ticks": [{"tick": 3, "t_s": 2.0, "pump_ms": 4.0,
                       "phase_ms": {"device_wait": 3.0, "other": 1.0}}],
            "ticks_truncated": True}


STITCH_CASES = {
    "thread": None,
    "stitched": [FlightSvc(record=worker_record())],
    "dead_worker_named": [FlightSvc(fail=True, replica_id=0),
                          FlightSvc(record=worker_record(), replica_id=1)],
    "remote": [FlightSvc(record=None)],
    "remote_and_dead": [FlightSvc(record=None), FlightSvc(fail=True, replica_id=1,
                                                          shift=(0.0, None))],
    "unaligned": [FlightSvc(record=worker_record(), shift=(0.25, None))],
}


@pytest.mark.parametrize("case", sorted(STITCH_CASES))
def test_stitched_flight_record_matches_jax(case):
    """JAX's ``_stitch_flight_record`` and the port's on the same members
    and router record, case for case."""
    from sentio_tpu.serve.app import _stitch_flight_record
    from sentio_tpu_torch.serve.app import stitch_flight_record

    members = STITCH_CASES[case]

    class Set:
        _services = members

    class Container:
        def peek(self, name):
            return Set() if members is not None else object()

    class Pipeline:
        replica_set = Set() if members is not None else None

    def router_record():
        return {"request_id": "r1", "t_start_s": 10.0, "latency_ms": 50.0,
                "engine": {"queue_depth": 1}}

    ours = stitch_flight_record(Pipeline(), "r1", router_record())
    theirs = _stitch_flight_record(Container(), "r1", router_record())
    assert ours == theirs
    assert ours["engine_window"] == {"thread": "local", "remote": "remote",
                                     "remote_and_dead": "remote"}.get(case, "stitched")


def fleet_lanes(trace: dict) -> dict:
    """The worker lanes' names, the clock bound cut off."""
    return {e["pid"]: re.sub(r" \(clock [^)]*\)", "", e["args"]["name"])
            for e in trace["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "process_name" and e["pid"] >= 1000}


def test_live_debug_flight_of_a_worker_served_request_is_stitched(weights):
    """``REPLICA_MODE=process``, two workers behind the server: a chat's
    ``/debug/flight`` holds the worker's engine section and ticks on the
    router's clock (``stitched``), also as a Chrome trace; the CLI's fleet
    trace has a lane per worker incarnation; once the worker that served it
    is killed, its lane is marked dead, and the record is the router's
    alone (``remote``), naming that worker in ``replicas_unavailable``."""
    import http.client

    from sentio_tpu_torch.config import GeneratorConfig, Settings
    from sentio_tpu_torch.models.document import Document
    from sentio_tpu_torch.models.transformer import EncoderConfig
    from sentio_tpu_torch.pipeline import build_pipeline
    from sentio_tpu_torch.serve.app import create_server

    settings = Settings(
        generator=GeneratorConfig(max_new_tokens=6, verifier_max_tokens=6, kv_page_size=16,
                                  kv_max_pages_per_seq=64, max_batch_size=4),
        serve=ServeConfig(replicas=2, replica_mode="process", replica_supervise=False))
    pipeline = build_pipeline(settings, device="cpu", llama_config=port_config(weights),
                              llama_params=weights[2], embedder_config=EncoderConfig.tiny(),
                              reranker_config=EncoderConfig.tiny())
    server = create_server(settings, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name="elastic-test-server",
                              daemon=True)
    thread.start()

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        pipeline.ingest([Document(text=f"passage {i} about paged decoding", id=f"d{i}")
                         for i in range(6)])
        body = json.dumps({"question": "what is paged decoding?", "thread_id": "stitch-me"})
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST", "/chat", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        resp.read()
        conn.close()
        status, record = get("/debug/flight/stitch-me")
        assert status == 200
        assert record["engine_window"] == "stitched"
        owner = record["engine_replica"]
        assert record["engine"]["tokens"] > 0 and record["ticks"]
        assert "clock_uncertainty_s" in record and "replicas_unavailable" not in record
        assert all(abs(sum(t["phase_ms"].values()) - t["pump_ms"]) <= 0.5
                   for t in record["ticks"] if "phase_ms" in t)
        status, chrome = get("/debug/flight/stitch-me?format=chrome")
        assert status == 200 and any(e["name"].startswith("tick ")
                                     for e in chrome["traceEvents"])
        lanes = fleet_lanes(cli._fleet_trace(pipeline))
        # pipe workers hold epoch 0 (epochs are the socket registry's)
        assert lanes == {1000: "worker 0 epoch 0", 2000: "worker 1 epoch 0"}
        served = pipeline.replica_set.services[owner]
        served.kill()
        wait_for(lambda: served.broken, 30, "the killed worker to be seen dead")
        lanes = fleet_lanes(cli._fleet_trace(pipeline))
        assert lanes[1000 * (owner + 1)] == f"worker {owner} epoch 0 (dead)"
        status, record = get("/debug/flight/stitch-me")
        # the worker that held the engine section is gone: the router's view
        # alone, and it says so
        assert record["engine_window"] == "remote" and "engine_replica" not in record
        assert record["replicas_unavailable"] == [
            {"replica": owner, "error": "ReplicaUnavailable"}]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        pipeline.close()


# ---------------------------------------------------------- /metrics families


FLEET_FAMILIES = ("sentio_tpu_fleet_live_replicas", "sentio_tpu_autoscale_decisions_total",
                  "sentio_tpu_fleet_at_max_saturated")


def fleet_samples(text: str) -> dict:
    out = {}
    for family in text_string_to_metric_families(text):
        samples = sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                         for s in family.samples if not s.name.endswith("_created"))
        name = family.name + ("_total" if family.type == "counter" else "")
        if name in FLEET_FAMILIES:
            out[name] = (family.type, family.documentation, samples)
    return out


def test_fleet_families_render_as_jax():
    ours, theirs = MetricsCollector(), JMetricsCollector()
    for m in (ours, theirs):
        m.record_fleet_size(1)
        m.record_autoscale_decision("out", "backlog")
        m.record_fleet_size(2)
        m.record_autoscale_decision("out", "busy")
        m.record_autoscale_decision("in", "idle")
        m.record_autoscale_decision("out", "backlog")
        m.record_fleet_saturation(1.0)
        m.record_fleet_saturation(0.0)
        m.record_fleet_size(1)
    got = fleet_samples(ours.export_prometheus().decode())
    want = fleet_samples(theirs.export_prometheus().decode())
    assert set(got) == set(FLEET_FAMILIES) and got == want
    assert got["sentio_tpu_autoscale_decisions_total"][2][0] == (
        "sentio_tpu_autoscale_decisions_total", (("direction", "in"), ("reason", "idle")), 1.0)
