"""The port's generation service (``runtime/service.py``) and the engine
parts it drives, against the JAX ``PagedGenerationService`` and engine.

Both sides run a tiny float32 Llama on shared weights (made by the JAX
init, carried by sentio_tpu_torch.runtime.weights); the JAX engine takes
its XLA decode path. Greedy tokens are compared exactly. The lifecycle
cases run the same scenario against each side (``side`` = jax / torch) and
assert the same outcome: shedding, deadlines (queued and mid-decode),
cancel, ``ignore_eos``, per-request seeds, prior tokens, crash containment,
drain and close. A slow engine (every tick sleeps) makes the timing cases
deterministic. Every thread join and wait here has a timeout."""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

from sentio_tpu.infra.exceptions import DeadlineExceededError as JDeadline
from sentio_tpu.infra.exceptions import ReplicaUnavailable as JUnavailable
from sentio_tpu.infra.exceptions import ServiceOverloaded as JOverloaded
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.service import GenerationTimeout as JTimeout
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu_torch.infra.exceptions import (
    DeadlineExceededError,
    ReplicaUnavailable,
    ServiceOverloaded,
)
from sentio_tpu_torch.infra.phases import TICK_PHASES
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.service import GenerationTimeout, PagedGenerationService
from sentio_tpu_torch.runtime.weights import llama_from_jax

ENGINE_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=8, steps_per_tick=4,
                 max_tick_steps=4)
JOIN_S = 120.0
PROMPTS = ["what is a page?", "who owns a slot in the decode batch?", "why a radix tree",
           "a", "where does scratch live " * 3]
SIDES = ["jax", "torch"]
ERRORS = {"jax": dict(overloaded=JOverloaded, deadline=JDeadline, unavailable=JUnavailable,
                      timeout=JTimeout),
          "torch": dict(overloaded=ServiceOverloaded, deadline=DeadlineExceededError,
                        unavailable=ReplicaUnavailable, timeout=GenerationTimeout)}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    return jcfg, jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(9), jcfg))


def make_engine(weights, side, **kw):
    jcfg, tree = weights
    kw = {**ENGINE_KW, **kw}
    if side == "jax":
        return JEngine(model_config=jcfg, params=tree, **kw)
    return ContinuousBatchingEngine(model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                                    params=llama_from_jax(tree), device="cpu", **kw)


def make_service(engine, side, **kw):
    cls = JService if side == "jax" else PagedGenerationService
    return cls(engine, default_timeout_s=JOIN_S, **kw)


@pytest.fixture(scope="module")
def jax_engine(weights):
    """One JAX engine shared by the cases that leave it usable: each new
    JAX engine compiles its programs again."""
    return make_engine(weights, "jax")


def engine_for(side, weights, jax_engine):
    return jax_engine if side == "jax" else make_engine(weights, "torch")


def slow(engine, seconds=0.05):
    """Make every tick of ``engine`` take at least ``seconds``."""
    step = engine.step

    def slowed():
        time.sleep(seconds)
        return step()

    engine.step = slowed
    return engine


def wait_until(predicate, timeout_s=JOIN_S):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def pages_reclaimed(svc):
    s = svc.stats()
    return (s["active_slots"] == 0
            and s["free_pages"] + s.get("prefix_cache_pages", 0) == s["total_pages"] - 1)


def concurrent(fn, args_list):
    """Run ``fn(*args)`` for each args on its own thread, all released at
    once; results in order."""
    out = [None] * len(args_list)
    start = threading.Barrier(len(args_list))

    def run(i, args):
        try:
            start.wait(timeout=JOIN_S)
            out[i] = fn(*args)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            out[i] = exc

    threads = [threading.Thread(target=run, args=(i, a), daemon=True)
               for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    for r in out:
        if isinstance(r, Exception):
            raise r
    return out


def test_concurrent_greedy_tokens_match_jax(weights, jax_engine):
    """Five callers at once on each side: each request's greedy tokens,
    finish reason and prompt length agree, and the port's callers shared
    decode ticks."""
    results = {}
    for side in SIDES:
        svc = make_service(engine_for(side, weights, jax_engine), side)
        try:
            results[side] = concurrent(
                lambda p: svc.generate(p, max_new_tokens=24, temperature=0.0),
                [(p,) for p in PROMPTS])
            stats = svc.stats()
        finally:
            svc.close()
    for r, p in zip(results["jax"], results["torch"]):
        assert (p.tokens, p.finish_reason, p.prompt_tokens) == (
            r.tokens, r.finish_reason, r.prompt_tokens)
    assert stats["max_active_slots"] > 1, stats
    assert stats["completed"] == len(PROMPTS)


def test_stream_pieces_join_to_generate(weights, jax_engine):
    ref_svc = make_service(jax_engine, "jax")
    svc = make_service(make_engine(weights, "torch"), "torch")
    try:
        for prompt in PROMPTS[:3]:
            result = svc.generate(prompt, max_new_tokens=10)
            want = result.text
            stats = {}
            pieces = list(svc.generate_stream(prompt, max_new_tokens=10, stats_out=stats))
            assert "".join(pieces) == want
            assert stats["tokens"] == len(result.tokens)
            assert "".join(ref_svc.generate_stream(prompt, max_new_tokens=10)) == want
    finally:
        svc.close()
        ref_svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_queue_full_sheds(weights, jax_engine, side):
    svc = make_service(engine_for(side, weights, jax_engine), side, max_queue=0)
    try:
        with pytest.raises(ERRORS[side]["overloaded"]) as info:
            svc.generate("no room", max_new_tokens=2)
        assert info.value.status == 429
        assert "retry_after_s" in info.value.details
        assert svc.stats()["shed"] == 1
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_deadline_shedding(weights, jax_engine, side):
    """A past deadline is refused at submit; a deadline the projected wait
    (the TTFT EMA scaled by backlog) exceeds sheds with 503; a cold
    service never sheds on projection."""
    svc = make_service(engine_for(side, weights, jax_engine), side)
    try:
        with pytest.raises(ERRORS[side]["deadline"]):
            svc.generate("late", max_new_tokens=2, deadline_ts=time.perf_counter() - 1.0)
        assert svc.projected_wait() is None
        svc.check_admission(deadline_ts=time.perf_counter() + 0.01)
        svc._ttft_ema = 10.0
        with pytest.raises(ERRORS[side]["overloaded"]) as info:
            svc.generate("too slow", max_new_tokens=2, deadline_s=1.0)
        assert info.value.status == 503
        assert svc.stats()["shed"] == 2
        assert svc.projected_wait() == pytest.approx(10.0)
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_engine_expires_a_queued_request(weights, side):
    """A request whose deadline passed while queued comes back expired,
    before any prefill."""
    engine = make_engine(weights, side)
    rid = engine.submit("gone", max_new_tokens=4, deadline_ts=time.perf_counter() - 1.0)
    live = engine.submit("kept", max_new_tokens=4)
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    assert (done[rid].finish_reason, done[rid].tokens, done[rid].prompt_tokens) == (
        "expired", [], 0)
    assert done[live].finish_reason in ("stop", "length")
    assert engine.prefill_tokens_total == done[live].prompt_tokens


@pytest.mark.parametrize("side", SIDES)
def test_deadline_cancels_mid_decode(weights, side):
    svc = make_service(slow(make_engine(weights, side, steps_per_tick=1, max_tick_steps=1)),
                       side)
    try:
        with pytest.raises(ERRORS[side]["deadline"]):
            svc.generate("expire me mid decode", max_new_tokens=100, deadline_s=0.3)
        assert wait_until(lambda: pages_reclaimed(svc))
        assert svc.stats()["expired"] >= 1
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_timeout_cancels_and_frees_the_slot(weights, side):
    svc = make_service(slow(make_engine(weights, side, steps_per_tick=1, max_tick_steps=1)),
                       side)
    try:
        with pytest.raises(ERRORS[side]["timeout"]):
            svc.generate("slow request", max_new_tokens=100, timeout_s=0.2)
        assert wait_until(lambda: pages_reclaimed(svc))
        assert svc.stats()["cancelled"] >= 1
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_abandoned_stream_cancels(weights, side):
    svc = make_service(slow(make_engine(weights, side, steps_per_tick=1, max_tick_steps=1,
                                        ignore_eos=True), 0.02), side)
    try:
        it = svc.generate_stream("stream to abandon", max_new_tokens=100)
        next(it)
        it.close()
        assert wait_until(lambda: pages_reclaimed(svc) and svc.backlog() == 0)
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_engine_cancel(weights, side):
    """cancel drops a queued request and retires an admitted one, freeing
    its pages; an unknown id is False."""
    engine = make_engine(weights, side, max_slots=1)
    a = engine.submit("admitted first", max_new_tokens=30)
    b = engine.submit("queued behind", max_new_tokens=30)
    engine.step()
    assert engine.cancel(b) and engine.cancel(a)
    assert not engine.cancel(12345)
    while engine.has_work:
        assert engine.step() == []
    s = engine.stats()
    assert s["active_slots"] == 0 and s["queued"] == 0
    assert s["free_pages"] + s.get("prefix_cache_pages", 0) == s["total_pages"] - 1


def test_ignore_eos_and_prior_tokens_match_jax(weights):
    """ignore_eos runs every row to its budget; prior tokens are admitted
    after the prompt and only what follows them is emitted."""
    out = {}
    for side in SIDES:
        engine = make_engine(weights, side, ignore_eos=True)
        plain = engine.run_all(PROMPTS[:3], max_new_tokens=9, temperature=0.0)
        rid = engine.submit(PROMPTS[1], max_new_tokens=6, prior_tokens=[65, 66, 67])
        done = {}
        while engine.has_work:
            for r in engine.step():
                done[r.request_id] = r
        out[side] = plain + [done[rid]]
    for r, p in zip(out["jax"], out["torch"]):
        assert (p.tokens, p.finish_reason, p.prompt_tokens) == (
            r.tokens, r.finish_reason, r.prompt_tokens)
    assert all(len(p.tokens) == 9 and p.finish_reason == "length" for p in out["torch"][:3])
    assert out["torch"][3].prompt_tokens == len(PROMPTS[1]) + 1 + 3


@pytest.mark.parametrize("side", SIDES)
def test_per_request_seed(weights, side):
    """A seed folds into the engine's generator at admission: two engines
    in the same state draw alike for the same seed and otherwise for
    another, and a repeat on one engine draws anew (its state moved)."""
    def draw(engine, seed):
        (result,) = [r for r in _drain_one(engine, engine.submit(
            "sample me", max_new_tokens=12, temperature=1.0, seed=seed))]
        return result.tokens

    a, b = make_engine(weights, side), make_engine(weights, side)
    first = draw(a, 7)
    assert draw(b, 7) == first
    assert draw(a, 7) != first
    c = make_engine(weights, side)
    assert draw(c, 8) != first


def _drain_one(engine, rid):
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    return [done[rid]]


@pytest.mark.parametrize("side", SIDES)
def test_crash_requeues_within_budget(weights, side):
    engine = make_engine(weights, side)
    svc = make_service(engine, side, retry_budget=1)
    step, calls = engine.step, {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device fault")
        return step()

    engine.step = flaky
    try:
        out = svc.generate("survives one bad tick", max_new_tokens=4)
        assert out.finish_reason in ("stop", "length")
        stats = svc.stats()
        assert (stats["requeued"], stats["tick_failures"]) == (1, 1)
        assert not svc.broken
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_failed_reset_latches_broken(weights, side):
    engine = make_engine(weights, side)
    svc = make_service(engine, side, retry_budget=0)

    def fail():
        raise RuntimeError("device lost")

    engine.step = fail
    engine.reset = fail
    try:
        out = svc.generate("doomed", max_new_tokens=4)
        assert out.finish_reason == "error"
        assert svc.broken
        with pytest.raises(ERRORS[side]["unavailable"]):
            svc.generate("after", max_new_tokens=2)
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_drain_and_close_return(weights, side):
    svc = make_service(slow(make_engine(weights, side), 0.01), side)
    results = []
    worker = threading.Thread(
        target=lambda: results.append(svc.generate("in flight", max_new_tokens=8)),
        daemon=True)
    worker.start()
    assert wait_until(lambda: svc.backlog() > 0 or results, 30)
    outcome = svc.drain(deadline_s=60)
    worker.join(timeout=JOIN_S)
    assert not worker.is_alive()
    assert outcome["drained"] and outcome["abandoned"] == 0
    assert results and results[0].finish_reason in ("stop", "length")
    with pytest.raises((ERRORS[side]["overloaded"], ERRORS[side]["unavailable"])):
        svc.generate("after drain", max_new_tokens=2)
    svc.close()  # a second close returns too
    assert svc.closed


@pytest.mark.parametrize("side", SIDES)
def test_ttft_and_phase_accounting(weights, jax_engine, side):
    """TTFT samples land in the engine's stats; the service's phase totals
    cover the bounded phase set and the duty cycle sums to 1."""
    engine = engine_for(side, weights, jax_engine)
    svc = make_service(engine, side)
    try:
        svc.reset_duty_cycle()
        count0 = engine.ttft_count
        concurrent(lambda p: svc.generate(p, max_new_tokens=6), [(p,) for p in PROMPTS[:2]])
        stats = svc.stats()
    finally:
        svc.close()
    assert engine.ttft_count - count0 == 2
    assert stats["ttft_p50_ms"] > 0
    assert set(stats["phase_seconds"]) == set(TICK_PHASES)
    assert sum(stats["phase_seconds"].values()) > 0
    assert sum(stats["duty_cycle"].values()) == pytest.approx(1.0, abs=1e-5)


def test_engine_shapes_and_ladder_match_jax(weights, jax_engine):
    port = make_engine(weights, "torch", steps_per_tick=16, max_tick_steps=64)
    ref = make_engine(weights, "jax", steps_per_tick=16, max_tick_steps=64)
    assert port.tick_step_sizes() == ref.tick_step_sizes()
    space = jax_engine.compile_variant_space()
    widths, priors = make_engine(weights, "torch").prefill_shapes()
    assert widths == sorted({d["width"] for d in space["paged.prefill_scatter"]})
    assert priors == sorted({d["pnb"] for d in space["paged.prior_prefill_scatter"]})


def test_force_tick_steps_pins_the_tick(weights):
    engine = make_engine(weights, "torch", steps_per_tick=4, max_tick_steps=8)
    engine.force_tick_steps = 2
    engine.submit("pinned", max_new_tokens=20)
    engine.step()
    assert engine.total_sub_steps == 2
    engine.force_tick_steps = 3  # off the ladder: ignored
    engine.step()
    assert engine.total_sub_steps == 2 + 8


def test_warmup_runs_every_shape_and_resets_the_ema(weights):
    engine = make_engine(weights, "torch")
    svc = make_service(engine, "torch")
    try:
        stats = svc.warmup()
        widths, priors = engine.prefill_shapes()
        assert stats["prompts"] >= len(widths) + len(engine.tick_step_sizes()) + 2
        assert stats["graph_captures"] == 0  # no graphs on the CPU
        assert svc.projected_wait() is None
        assert svc.generate("after warmup", max_new_tokens=4).finish_reason in (
            "stop", "length")
    finally:
        svc.close()


@pytest.mark.parametrize("side", SIDES)
def test_reset_and_spawn_fresh_serve_as_new(weights, side):
    """After reset() (a failed tick's recovery) and on spawn_fresh() (a new
    engine on the same weights), greedy requests give the tokens a fresh
    engine gives; reset drops what was queued or admitted."""
    engine = make_engine(weights, side)
    want = [r.tokens for r in engine.run_all(PROMPTS[:3], max_new_tokens=8)]
    engine.submit("dropped by the reset", max_new_tokens=8)
    engine.step()
    engine.reset()
    assert not engine.has_work
    s = engine.stats()
    assert s["free_pages"] == s["total_pages"] - 1 and s["active_slots"] == 0
    assert [r.tokens for r in engine.run_all(PROMPTS[:3], max_new_tokens=8)] == want
    fresh = engine.spawn_fresh()
    assert fresh is not engine and fresh.params is engine.params
    assert fresh.allocator is not engine.allocator
    assert [r.tokens for r in fresh.run_all(PROMPTS[:3], max_new_tokens=8)] == want
