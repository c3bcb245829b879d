"""The port's worker tier (``runtime/worker.py``) against the JAX package on
the CPU, with tiny float32 models.

* the exception codec's dict is JAX's ``_encode_exc`` for every shared
  exception class (the module named in the port's package), and a dict
  decodes to the same type and wire surface;
* a ``ProcessReplica`` over a spawned worker, through the spawn pipe and
  through a socket registered with a ``WorkerRegistry``, gives the greedy
  tokens and the stream pieces of JAX's in-process
  ``PagedGenerationService``: both load one checkpoint written by JAX's
  ``save_pytree`` (the worker through ``checkpoint_path``);
* a worker-side deadline, a shed and a mid-stream failure cross the
  boundary typed; a SIGKILL fails in-flight calls typed with no handoff,
  and a supervising ``ReplicaSet`` hands them to the survivor and respawns
  the worker; a socket worker is respawned, then healed after a half-open
  partition, each at a higher epoch, its pre-partition frames counted
  stale; ``stats`` carries the worker's launch tallies; telemetry merges;
* tensors in the spawn arguments are shared, not copied: a change the test
  makes to the router's tensor after the spawn reaches the worker's first
  forward;
* ``close`` and ``drain`` leave ``multiprocessing.active_children()``
  empty.

One spawned worker per transport serves the module (fixtures); each
fault point is named through a constant; every wait has a timeout and
every set is closed."""

import dataclasses
import gc
import multiprocessing
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sentio_tpu.infra import exceptions as jexc
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama as jinit_llama
from sentio_tpu.runtime import worker as jworker
from sentio_tpu.runtime.checkpoint import save_pytree
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.service import GenerationTimeout as JTimeout
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu.runtime.weights import load_model as jload_model
from sentio_tpu_torch.infra import exceptions as exc
from sentio_tpu_torch.infra.metrics import MetricsCollector, get_metrics, set_metrics
from sentio_tpu_torch.kernels import KERNELS
from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
from sentio_tpu_torch.models.tokenizer import ByteTokenizer
from sentio_tpu_torch.runtime import worker
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.replica import ReplicaSet, WorkerRegistry
from sentio_tpu_torch.runtime.service import GenerationTimeout, PagedGenerationService
from sentio_tpu_torch.runtime.worker import ProcessReplica, WorkerSpec
from _sanitize import _sanitized  # noqa: F401  (arms the module)


ENGINE_KW = dict(max_slots=2, page_size=8, max_pages_per_seq=8, steps_per_tick=2,
                 max_tick_steps=2)
PROMPTS = ["what is a page?", "who owns a slot in the decode batch?", "a",
           "where does scratch live " * 2]
NEW_TOKENS = 12
JOIN_S = 60.0
BUILD_S = 120.0
TOKEN = "worker-test-token"
# fault points, named through constants
PAGED_STEP = "paged." + "step"
RECV_R0 = "transport.recv." + "r0"


@pytest.fixture(scope="module", autouse=True)
def fresh_metrics():
    """A collector of the module's own, as JAX's worker tests keep: the
    process-wide one carries the epoch fence of every worker an earlier
    module ran (a socket set leaves replica 0 at epoch 1), which would drop
    each frame of this module's pipe worker (epoch 0) as stale."""
    old = get_metrics()
    set_metrics(MetricsCollector())
    yield
    set_metrics(old)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("worker-ck")
    cfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, jinit_llama(jax.random.PRNGKey(21), cfg))
    save_pytree(root / "llama", tree, meta={"family": "llama", "config": cfg.__dict__})
    return str(root / "llama")


@pytest.fixture(scope="module")
def reference(checkpoint):
    """JAX's in-process service on the checkpoint: each prompt's greedy
    tokens and stream pieces."""
    params, cfg, _tok = jload_model(checkpoint, expect_family="llama")
    svc = JService(JEngine(model_config=cfg, params=params, **ENGINE_KW),
                   default_timeout_s=JOIN_S)
    try:
        tokens = [svc.generate(p, max_new_tokens=NEW_TOKENS, temperature=0.0).tokens
                  for p in PROMPTS]
        pieces = [list(svc.generate_stream(p, max_new_tokens=NEW_TOKENS, temperature=0.0))
                  for p in PROMPTS]
    finally:
        svc.close()
    return {"tokens": tokens, "pieces": pieces}


def spec_for(checkpoint=None, **kw) -> WorkerSpec:
    factory = dict(checkpoint_path=checkpoint or "", engine_kwargs=dict(ENGINE_KW),
                   service_kwargs=kw.pop("service_kwargs", {}), device="cpu",
                   **kw.pop("factory", {}))
    if not checkpoint and "params" not in factory:
        factory["model_config"] = dataclasses.asdict(
            dataclasses.replace(LlamaConfig.tiny(), dtype="float32"))
    return WorkerSpec(factory_kwargs=factory, **kw)


def tokenizer():
    return ByteTokenizer(LlamaConfig.tiny().vocab_size)


@pytest.fixture(scope="module")
def pipe_worker(checkpoint):
    pr = ProcessReplica(spec_for(checkpoint, service_kwargs={"max_queue": 2},
                                 telemetry_interval_s=0.2),
                        tokenizer(), replica_id=0, build_timeout_s=BUILD_S)
    yield pr
    pr.close()


@pytest.fixture(scope="module")
def socket_worker(checkpoint):
    # the link's budgets are 1 s each way, and a stall of this process that
    # long reads as a partition on both ends: a full collection over the
    # heap that earlier modules left here can take that long under a loaded
    # run, so what exists now is left out of every collection
    gc.freeze()
    registry = WorkerRegistry(TOKEN, slots=1)
    spec = spec_for(checkpoint, service_kwargs={"max_queue": 2}, auth_token=TOKEN,
                    reconnect=True, status_interval_s=0.05, router_silence_timeout_s=1.0)
    pr = ProcessReplica(spec, tokenizer(), replica_id=0, build_timeout_s=BUILD_S,
                        transport_mode="socket", registry=registry, partition_timeout_s=1.0,
                        ping_interval_s=0.2, heal_grace_s=10.0)
    state = {"replica": pr, "registry": registry}
    yield state
    state["replica"].close()
    registry.close()
    gc.unfreeze()


@pytest.fixture(params=["pipe", "socket"])
def replica(request, pipe_worker, socket_worker):
    return pipe_worker if request.param == "pipe" else socket_worker["replica"]


# ------------------------------------------------------------------ codec


SHARED = [("SentioError", ("boom",), {}), ("ValidationError", ("bad field",), {}),
          ("RateLimitError", (), {"retry_after_s": 7.0}),
          ("ServiceOverloaded", ("queue full",), {"status": 429, "retry_after_s": 2.0}),
          ("DeadlineExceededError", ("late",), {}),
          ("ServiceUnavailableError", ("down",), {}),
          ("ReplicaUnavailable", ("dead",), {"details": {"replica": 1}})]


@pytest.mark.parametrize("name,args,kwargs", SHARED, ids=[s[0] for s in SHARED])
def test_exception_codec_matches_jax(name, args, kwargs):
    ours = worker._encode_exc(getattr(exc, name)(*args, **kwargs))
    theirs = jworker._encode_exc(getattr(jexc, name)(*args, **kwargs))
    assert ours.pop("module").replace("sentio_tpu_torch", "sentio_tpu") == theirs.pop("module")
    assert ours == theirs
    back = worker._decode_exc({**ours, "module": "x"})
    assert type(back) is getattr(exc, name)
    assert (back.status, back.details, back.retryable, back.code.value, str(back)) == \
        (ours["status"], ours["details"], ours["retryable"], ours["code"], ours["message"])


@pytest.mark.parametrize("ours,theirs,decoded", [
    (ValueError("v"), ValueError("v"), ValueError),
    (GenerationTimeout("t"), JTimeout("t"), GenerationTimeout),
    (KeyError("k"), KeyError("k"), KeyError),
], ids=["builtin", "generation_timeout", "keyerror"])
def test_other_exceptions_cross_by_name(ours, theirs, decoded):
    a, b = worker._encode_exc(ours), jworker._encode_exc(theirs)
    assert a.pop("module").replace("sentio_tpu_torch", "sentio_tpu") == b.pop("module")
    assert a == b
    assert type(worker._decode_exc(a)) is decoded


def test_unknown_exception_decodes_to_a_runtime_error_naming_it():
    got = worker._decode_exc({"cls": "WeirdBug", "message": "x"})
    assert type(got) is RuntimeError and "WeirdBug" in str(got)


# ----------------------------------------------------------------- parity


def test_greedy_tokens_match_jax_service(replica, reference):
    got = [replica.generate(p, max_new_tokens=NEW_TOKENS, temperature=0.0).tokens
           for p in PROMPTS]
    assert got == reference["tokens"]


def test_stream_pieces_match_jax_service(replica, reference):
    got = []
    for p in PROMPTS:
        stats: dict = {}
        got.append(list(replica.generate_stream(p, max_new_tokens=NEW_TOKENS,
                                                temperature=0.0, stats_out=stats)))
        assert stats["replica_id"] == 0 and stats["tokens"] >= 1
    assert got == reference["pieces"]


def test_concurrent_generates_share_the_worker(replica, reference):
    out: list = [None] * 2

    def run(i):
        out[i] = replica.generate(PROMPTS[i], max_new_tokens=NEW_TOKENS, temperature=0.0)

    threads = [threading.Thread(target=run, args=(i,), name=f"test-worker-gen-{i}",
                                daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert [r.tokens for r in out] == reference["tokens"][:2]


def test_prefix_probe_and_ready_surface(replica):
    toks = tokenizer().encode(PROMPTS[3], add_bos=True)
    replica.generate(PROMPTS[3], max_new_tokens=2, temperature=0.0)
    assert replica.engine.peek_prefix(toks) >= ENGINE_KW["page_size"]
    assert (replica.engine.page_size, replica.engine.max_slots) == (8, 2)
    assert replica.engine.cfg.dim == LlamaConfig.tiny().dim
    assert replica.max_queue == 2 and not replica.broken and replica.pid


# ----------------------------------------------------- typed errors across


def test_worker_side_deadline_is_typed(replica):
    # a relative microsecond has passed when the worker admits it: its own
    # typed error, raised in the worker
    with pytest.raises(exc.DeadlineExceededError, match="before submit"):
        replica.generate(PROMPTS[1], max_new_tokens=40, deadline_s=1e-6)
    # a deadline passing while every tick crawls: the pump's expiry, or the
    # admission's projected-wait shed once the worker's TTFT average has
    # warmed (as the service decides it); typed either way
    replica.inject_fault(PAGED_STEP, delay_s=0.2)
    try:
        with pytest.raises((exc.DeadlineExceededError, exc.ServiceOverloaded)) as info:
            replica.generate(PROMPTS[1], max_new_tokens=40, temperature=0.0, deadline_s=0.05)
    finally:
        replica.reset_faults()
    if isinstance(info.value, exc.ServiceOverloaded):
        assert info.value.status == 503 and "deadline budget" in str(info.value)
    with pytest.raises(exc.DeadlineExceededError):
        # already expired: raised router-side, never shipped as "no deadline"
        replica.generate(PROMPTS[1], deadline_ts=time.perf_counter() - 1.0)


def test_shed_is_typed(replica):
    replica.inject_fault(PAGED_STEP, delay_s=0.05)
    errors: list = []

    def run():
        try:
            replica.generate(PROMPTS[0], max_new_tokens=6, temperature=0.0)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, name=f"test-worker-shed-{i}", daemon=True)
               for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        replica.reset_faults()
    assert errors and all(type(e) is exc.ServiceOverloaded for e in errors), errors
    assert errors[0].status == 429 and "queue full" in str(errors[0])


def test_mid_stream_failure_is_typed(replica):
    replica.inject_fault(PAGED_STEP, error=RuntimeError("tick died"), skip=2)
    got: list = []
    try:
        with pytest.raises(exc.ReplicaUnavailable) as info:
            for piece in replica.generate_stream(PROMPTS[1], max_new_tokens=40,
                                                 temperature=0.0):
                got.append(piece)
    finally:
        replica.reset_faults()
    assert got and info.value.details["reason"] == "mid_stream"
    replica.generate(PROMPTS[0], max_new_tokens=2)  # the worker serves on


def test_stats_carry_the_workers_launch_tallies(replica):
    stats = replica.stats()
    report = stats["worker"]
    assert report["pid"] == replica.pid
    assert report["launches"] == {k.name: 0 for k in KERNELS}  # CPU tensors never launch
    assert report["graph_variants"] == 3 and report["foreign_modules"] == []
    assert stats["replica"] == 0 and stats["completed"] >= len(PROMPTS)


def test_an_armed_routers_workers_check_their_ticks(replica):
    """A worker builds its engine under the environment it inherited, so
    under the module's SENTIO_SANITIZE=1 every worker's engine is armed; a
    SanitizerError in a worker's tick is contained there as the tick
    failure it is (the request requeued and answered), counted in the
    stats the router's supervisor reads."""
    from sentio_tpu_torch.analysis.sanitizer import SanitizerError

    before = replica.stats()
    assert before["worker"]["sanitized"] is True
    replica.inject_fault(PAGED_STEP, times=1,
                         error=SanitizerError("page conservation violated: leaked=[3]"))
    try:
        out = replica.generate(PROMPTS[0], max_new_tokens=4)
    finally:
        replica.reset_faults()
    assert out.finish_reason in ("stop", "length")
    assert replica.stats()["tick_failures"] == before["tick_failures"] + 1


def test_telemetry_and_flight_reach_the_router(pipe_worker):
    pipe_worker.generate(PROMPTS[0], max_new_tokens=4, request_id="flight-probe")
    deadline = time.perf_counter() + JOIN_S
    while pipe_worker.telemetry_age() is None and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert pipe_worker.telemetry_age() is not None
    assert get_metrics().worker_telemetry_epoch(0) is not None
    record = pipe_worker.fetch_flight("flight-probe")
    assert record["pid"] == pipe_worker.pid and record["record"]["engine"]["admissions"]
    assert pipe_worker.clock_sync() is not None


# ------------------------------------------------------------------ weights


def local_tokens(cfg, params) -> list:
    svc = PagedGenerationService(ContinuousBatchingEngine(model_config=cfg, params=params,
                                                          device="cpu", **ENGINE_KW))
    try:
        return svc.generate(PROMPTS[1], max_new_tokens=NEW_TOKENS, temperature=0.0).tokens
    finally:
        svc.close()


def test_spawn_arguments_share_the_router_tensors():
    """The worker's weights are the router's tensors: a change made after
    the spawn, before any forward, shows in the worker's tokens."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype="float32")
    params = init_llama(cfg, torch.Generator().manual_seed(3), "cpu")
    spec = spec_for(factory={"params": params, "model_config": dataclasses.asdict(cfg)},
                    telemetry_interval_s=0)
    pr = ProcessReplica(spec, tokenizer(), build_timeout_s=BUILD_S)
    try:
        assert params["lm_head"]["weight"].is_shared()
        with torch.no_grad():
            params["lm_head"]["weight"].mul_(-1.0)
        got = pr.generate(PROMPTS[1], max_new_tokens=NEW_TOKENS, temperature=0.0).tokens
    finally:
        pr.close()
    want = local_tokens(cfg, params)
    with torch.no_grad():
        params["lm_head"]["weight"].mul_(-1.0)
    unchanged = local_tokens(cfg, params)
    assert got == want and got != unchanged


# ---------------------------------------------------------------- failures


def _slow_generate(pr, out: dict, key: str, **kw):
    try:
        out[key] = pr.generate(PROMPTS[1], max_new_tokens=200, temperature=0.0, **kw)
    except Exception as e:  # noqa: BLE001 — asserted by the caller
        out[key] = e


def test_sigkill_without_handoff_fails_typed_then_respawns(checkpoint, reference):
    pr = ProcessReplica(spec_for(checkpoint, telemetry_interval_s=0), tokenizer(),
                        build_timeout_s=BUILD_S)
    fresh = None
    try:
        pr.inject_fault(PAGED_STEP, delay_s=0.05)
        out: dict = {}
        t = threading.Thread(target=_slow_generate, args=(pr, out, "r"),
                             name="test-worker-kill", daemon=True)
        t.start()
        deadline = time.perf_counter() + JOIN_S
        while pr.backlog() == 0 and time.perf_counter() < deadline:
            time.sleep(0.02)
        pr.kill()
        t.join(timeout=JOIN_S)
        assert isinstance(out["r"], exc.ReplicaUnavailable)
        assert out["r"].details["reason"] == "worker_dead"
        assert pr.broken
        with pytest.raises(exc.ReplicaUnavailable):
            pr.generate(PROMPTS[0])
        fresh = pr.respawn()
        assert fresh.pid != pr.pid
        assert fresh.generate(PROMPTS[0], max_new_tokens=NEW_TOKENS).tokens == \
            reference["tokens"][0]
    finally:
        pr.close()
        if fresh is not None:
            fresh.close()


def test_supervising_set_hands_a_killed_workers_tickets_to_the_survivor(checkpoint,
                                                                        reference):
    services = [ProcessReplica(spec_for(checkpoint, telemetry_interval_s=0), tokenizer(),
                               replica_id=i, build_timeout_s=BUILD_S) for i in range(2)]
    rs = ReplicaSet(services, probe_interval_s=0.05, quarantine_backoff_s=0.05,
                    rebuild_drain_s=0.5)
    deaths0 = get_metrics().worker_deaths.values().get(("0",), 0.0)
    try:
        want = rs.generate(PROMPTS[1], max_new_tokens=200, temperature=0.0).tokens
        victim = rs.services[0]
        victim.inject_fault(PAGED_STEP, delay_s=0.05)
        out: dict = {}
        t = threading.Thread(target=_slow_generate, args=(rs, out, "r"),
                             name="test-worker-handoff", daemon=True)
        t.start()
        deadline = time.perf_counter() + JOIN_S
        while victim.backlog() == 0 and time.perf_counter() < deadline:
            time.sleep(0.02)
        victim.kill()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        result = out["r"]
        assert not isinstance(result, Exception), result
        assert result.tokens == want and result.replica_id == 1
        deadline = time.perf_counter() + JOIN_S
        while time.perf_counter() < deadline:
            # the handoff pass books its count after the adopted ticket can
            # already have been answered
            if rs.stats()["handed_off"] >= 1:
                break
            time.sleep(0.02)
        assert rs.stats()["handed_off"] >= 1
        while time.perf_counter() < deadline:
            health = rs.health_summary()
            if health["status"] == "healthy" and health["replicas"][0]["rebuilds"] == 1:
                break
            time.sleep(0.05)
        assert health["status"] == "healthy" and health["replicas"][0]["rebuilds"] == 1
        assert rs.services[0] is not victim and rs.services[0].pid != victim.pid
        assert get_metrics().worker_deaths.values()[("0",)] == deaths0 + 1
        assert rs.services[0].generate(PROMPTS[0], max_new_tokens=NEW_TOKENS).tokens == \
            reference["tokens"][0]
    finally:
        rs.close()


def test_socket_worker_respawns_then_heals_at_higher_epochs(socket_worker, reference):
    from sentio_tpu_torch.infra import faults

    pr, registry = socket_worker["replica"], socket_worker["registry"]
    epoch0, pid0 = pr.epoch, pr.pid
    pr.kill()
    deadline = time.perf_counter() + JOIN_S
    while not pr.broken and time.perf_counter() < deadline:
        time.sleep(0.02)
    pr.close()
    respawned = pr.respawn()
    socket_worker["replica"] = respawned
    assert respawned.epoch > epoch0 and respawned.pid != pid0
    assert respawned.generate(PROMPTS[0], max_new_tokens=NEW_TOKENS).tokens == \
        reference["tokens"][0]
    # the half-open partition: the router's reads from slot 0 stall
    release = threading.Event()
    stale0 = registry.stale_frames(0)
    faults.arm(RECV_R0, faults.FaultRule(stall_event=release, stall_s=JOIN_S, times=1))
    try:
        t0 = time.perf_counter()
        while not respawned.broken and time.perf_counter() - t0 < JOIN_S:
            time.sleep(0.02)
        detected_s = time.perf_counter() - t0
        assert respawned._death_kind == "partition"
        assert detected_s <= respawned.partition_timeout_s + 1.0
        respawned.drain(deadline_s=1.0)  # a heal candidate: no shutdown, no reap
        healed = respawned.respawn()
        socket_worker["replica"] = healed
        assert healed.pid == respawned.pid and healed.epoch > respawned.epoch
    finally:
        release.set()
        faults.reset()
    deadline = time.perf_counter() + JOIN_S
    while registry.stale_frames(0) == stale0 and time.perf_counter() < deadline:
        time.sleep(0.02)
    assert registry.stale_frames(0) > stale0
    assert healed.generate(PROMPTS[0], max_new_tokens=NEW_TOKENS).tokens == \
        reference["tokens"][0]


def test_drain_and_close_leave_no_children(checkpoint):
    pr = ProcessReplica(spec_for(checkpoint, telemetry_interval_s=0), tokenizer(),
                        build_timeout_s=BUILD_S)
    pid = pr.pid
    assert pr.drain(deadline_s=2.0)["drained"]
    assert all(p.pid != pid for p in multiprocessing.active_children())
    with pytest.raises(exc.ReplicaUnavailable):
        pr.generate(PROMPTS[0])


def test_backlog_is_the_routers_in_flight_count(pipe_worker):
    """The routing backlog counts the generates and streams this router
    has in flight on the worker, at once: not the worker's last status
    frame (up to an interval old)."""
    pipe_worker.inject_fault(PAGED_STEP, delay_s=0.05)
    out: dict = {}
    t = threading.Thread(target=_slow_generate, args=(pipe_worker, out, "r"),
                         kwargs={"timeout_s": JOIN_S}, name="test-backlog", daemon=True)
    try:
        t.start()
        deadline = time.perf_counter() + 5.0
        while pipe_worker.backlog() < 1 and time.perf_counter() < deadline:
            time.sleep(0.001)
        assert pipe_worker.backlog() == 1
        it = pipe_worker.generate_stream(PROMPTS[0], max_new_tokens=4)
        assert pipe_worker.backlog() == 1  # a stream counts from its first next()
        assert next(it) is not None and pipe_worker.backlog() == 2
        list(it)
    finally:
        t.join(timeout=JOIN_S)
        pipe_worker.reset_faults()
    assert pipe_worker.backlog() == 0 and not isinstance(out["r"], Exception), out


def test_a_simultaneous_burst_spreads_over_the_workers(checkpoint):
    """Six generates of one prompt released together on two workers with
    stickiness 0.5 x 2 slots: the first worker keeps the affinity while its
    backlog allows, the rest overflow to the other, as thread mode routes
    them (the backlog the router reads is exact at each decision)."""
    services = [ProcessReplica(spec_for(checkpoint, telemetry_interval_s=0), tokenizer(),
                               replica_id=i, build_timeout_s=BUILD_S) for i in range(2)]
    rs = ReplicaSet(services, supervise=False, affinity_stickiness=0.5)
    try:
        rs.generate(PROMPTS[3], max_new_tokens=2)  # both trees cold but one
        services[0].inject_fault(PAGED_STEP, delay_s=0.05)
        services[1].inject_fault(PAGED_STEP, delay_s=0.05)
        out: dict = {}
        barrier = threading.Barrier(6)

        def run(k):
            barrier.wait(timeout=JOIN_S)
            out[k] = rs.generate(PROMPTS[3], max_new_tokens=16, timeout_s=JOIN_S).replica_id

        threads = [threading.Thread(target=run, args=(k,), name=f"test-burst-{k}", daemon=True)
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        rs.close()
    assert sorted(out) == list(range(6)) and set(out.values()) == {0, 1}, out


def test_no_worker_outlives_the_module(pipe_worker, socket_worker):
    """Last: close both module workers here (their fixtures close again,
    a no-op) and find no child left."""
    pipe_worker.close()
    socket_worker["replica"].close()
    deadline = time.perf_counter() + JOIN_S
    while multiprocessing.active_children() and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert multiprocessing.active_children() == []

