"""The port's runtime sanitizer (``SENTIO_SANITIZE=1``) against JAX's, case
for case with ``tests/test_sanitize.py``: lock ownership, the engine's
single-driver guard, cross-replica ownership, the per-tick engine
invariants (bf16 and int8 pools), the pool's layout (``QuantPages`` and a
mesh engine's ``ShardedPool`` too), the runtime lock order, Eraser-style
locksets and the generation service under the sanitizer.

The generic checks (locks, order, locksets) run once with each package's
sanitizer and must raise the same messages. The engine cases drive the
port's tiny engine on the CPU; the parity cases run JAX's and the port's
engines, both armed, on shared float32 tiny-Llama weights (made by
``init_llama``, carried by ``llama_from_jax``) under one workload and hold
them to the same greedy tokens, the same page accounting wherever both are
quiescent, and the same ``SanitizerError`` message for each injected fault.
"""

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sentio_tpu.analysis import sanitizer as jax_san
from sentio_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JaxEngine
from sentio_tpu_torch.analysis import sanitizer as san
from sentio_tpu_torch.analysis.sanitizer import (
    OwnedLock,
    SanitizerError,
    check_engine_invariants,
)
from sentio_tpu_torch.kernels.paged_attention import QuantPages
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, ShardedPool, quantize_kv
from sentio_tpu_torch.runtime.weights import llama_from_jax
from _sanitize import _sanitized  # noqa: F401  (arms the module)

PROMPT = "a reasonably long prompt that spans multiple cache pages easily"
PACKAGES = {"port": san, "jax": jax_san}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _engine(**kw):
    """The port's tiny engine on the CPU, at test_sanitize.py's geometry."""
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_pages_per_seq", 4)
    kw.setdefault("steps_per_tick", 4)
    return ContinuousBatchingEngine(device="cpu", **kw)


def _raised(fn) -> str:
    """The SanitizerError message ``fn`` raises (either package's)."""
    with pytest.raises((SanitizerError, jax_san.SanitizerError)) as info:
        fn()
    return str(info.value)


def _in_thread(fn, name: str = "intruder") -> list:
    caught: list = []

    def run():
        try:
            fn()
        except (SanitizerError, jax_san.SanitizerError) as exc:
            caught.append(exc)

    t = threading.Thread(target=run, name=name)
    t.start()
    t.join()
    return caught


class TestLockOwnership:
    def test_make_lock_returns_owned_lock(self, pkg):
        assert pkg.enabled()
        lock = pkg.make_lock("test")
        assert isinstance(lock, pkg.OwnedLock)

    def test_assert_held_raises_when_not_held(self, pkg):
        lock = pkg.make_lock("test")
        with pytest.raises(pkg.SanitizerError, match="not held"):
            pkg.assert_held(lock)

    def test_assert_held_passes_inside_with(self, pkg):
        lock = pkg.make_lock("test")
        with lock:
            pkg.assert_held(lock)
        with pytest.raises(pkg.SanitizerError):
            pkg.assert_held(lock)

    def test_plain_lock_no_ops(self, pkg, monkeypatch):
        monkeypatch.delenv("SENTIO_SANITIZE")
        lock = pkg.make_lock("test")
        assert not isinstance(lock, pkg.OwnedLock)
        assert isinstance(lock, type(threading.Lock()))
        pkg.assert_held(lock)  # no-op, never raises

    def test_held_by_other_thread_raises(self, pkg):
        lock = pkg.make_lock("test")
        lock.acquire()
        try:
            err = _in_thread(lambda: pkg.assert_held(lock), name="other")
        finally:
            lock.release()
        assert err, "assert_held must reject a non-owner thread"

    def test_messages_match_jax(self):
        msgs = []
        for mod in (san, jax_san):
            lock = mod.make_lock("Svc._mutex")
            msgs.append(_raised(lambda: mod.assert_held(lock)))
        assert msgs[0] == msgs[1]
        assert "lock-held contract violated: Svc._mutex" in msgs[0]


class TestThreadGuard:
    def test_cross_thread_step_raises(self):
        eng = _engine()
        eng.submit(PROMPT, max_new_tokens=4)  # binds this thread as driver
        caught = _in_thread(eng.step)
        assert caught, "cross-thread engine.step must raise under sanitize"
        assert "single-threaded" in str(caught[0])
        # the rightful driver still works
        while eng.has_work:
            eng.step()
        check_engine_invariants(eng)

    def test_cross_thread_submit_raises(self):
        eng = _engine()
        eng.step()  # bind
        assert _in_thread(lambda: eng.submit("hi", max_new_tokens=2))

    @pytest.mark.parametrize("op", ["warm_prefix", "cancel", "reset"])
    def test_every_mutating_entry_is_guarded(self, op):
        eng = _engine()
        eng.step()  # bind
        call = {"warm_prefix": lambda: eng.warm_prefix(PROMPT),
                "cancel": lambda: eng.cancel(0), "reset": eng.reset}[op]
        caught = _in_thread(call)
        assert caught and f"ContinuousBatchingEngine.{op} called from thread " \
            f"'intruder'" in str(caught[0])

    def test_peek_prefix_is_not_guarded(self):
        eng = _engine()
        eng.run_all([PROMPT], max_new_tokens=2)  # binds, fills the tree
        hits: list = []
        t = threading.Thread(target=lambda: hits.append(
            eng.peek_prefix(eng.tokenizer.encode(PROMPT, add_bos=True))))
        t.start()
        t.join()
        assert hits and hits[0] > 0

    def test_ownership_migrates_from_dead_thread(self):
        eng = _engine()
        t = threading.Thread(target=lambda: eng.submit(PROMPT, max_new_tokens=2))
        t.start()
        t.join()
        # the binding thread is dead: the next driver inherits cleanly
        while eng.has_work:
            eng.step()

    def test_message_matches_jax(self, parity_weights):
        msgs = []
        for side in ("jax", "port"):
            eng = _parity_engine(parity_weights, side)
            eng.submit(PROMPT, max_new_tokens=2)
            caught = _in_thread(eng.step)
            msgs.append(str(caught[0]))
            while eng.has_work:
                eng.step()
        assert msgs[0] == msgs[1]


class TestCrossReplicaOwnership:
    """Pump-thread ownership is per replica: a thread that drives replica
    0 is still an intruder on replica 1."""

    def test_cross_replica_mutation_raises(self):
        e0, e1 = _engine(), _engine()
        ready, release = threading.Event(), threading.Event()

        def replica_one_pump():
            e1.submit("replica one work", max_new_tokens=2)  # binds e1
            ready.set()
            release.wait(timeout=60)

        t = threading.Thread(target=replica_one_pump, name="r1-pump")
        t.start()
        ready.wait(timeout=60)
        e0.submit("replica zero work", max_new_tokens=2)
        caught: list = []
        try:
            try:
                e1.step()
            except SanitizerError as exc:
                caught.append(exc)
        finally:
            release.set()
            t.join(timeout=60)
        assert caught, "cross-replica engine.step must raise under sanitize"
        assert "single-threaded" in str(caught[0])
        while e0.has_work:
            e0.step()
        # replica 1's owner died: ownership migrates and it finishes too
        while e1.has_work:
            e1.step()

    def test_replica_set_names_guards_per_replica(self):
        from sentio_tpu_torch.runtime.replica import ReplicaSet
        from sentio_tpu_torch.runtime.service import PagedGenerationService

        e0, e1, e2 = _engine(), _engine(), _engine()
        rs = ReplicaSet([PagedGenerationService(e0), PagedGenerationService(e1)])
        try:
            assert "[r0]" in e0._san.name and "[r1]" in e1._san.name
            # an elastic join is named after the slot it takes
            assert rs.add_replica(PagedGenerationService(e2)) == 2
            assert e2._san.name == "ContinuousBatchingEngine[r2]"
        finally:
            rs.close()


class TestEngineInvariants:
    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_clean_run_passes(self, kv_quant):
        eng = _engine(kv_quant=kv_quant)
        results = eng.run_all([PROMPT, "short one"], max_new_tokens=6)
        assert len(results) == 2
        check_engine_invariants(eng)  # idle state is also conserved

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_injected_page_leak_caught(self, kv_quant):
        eng = _engine(kv_quant=kv_quant)
        eng.run_all([PROMPT], max_new_tokens=4)
        leaked = eng.allocator._free.pop()
        assert leaked > 0
        eng.submit("short one", max_new_tokens=2)
        with pytest.raises(SanitizerError, match=f"leaked=\\[{leaked}\\]"):
            while eng.has_work:
                eng.step()

    def test_injected_double_own_caught(self):
        eng = _engine()
        eng.run_all([PROMPT], max_new_tokens=4)
        eng.allocator._free.insert(0, eng.allocator._free[0])
        with pytest.raises(SanitizerError, match="duplicates"):
            eng.submit("short one", max_new_tokens=2)
            while eng.has_work:
                eng.step()

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_injected_refcount_leak_caught(self, kv_quant):
        eng = _engine(kv_quant=kv_quant)
        eng.run_all([PROMPT], max_new_tokens=4)
        radix = eng._radix
        assert radix is not None and not radix.empty
        node = next(iter(radix.root.children.values()))
        radix.lock(node)
        eng.submit("short one", max_new_tokens=2)
        with pytest.raises(SanitizerError, match="refcount"):
            while eng.has_work:
                eng.step()

    def test_disabled_engine_skips_checks(self, monkeypatch):
        monkeypatch.delenv("SENTIO_SANITIZE")
        eng = _engine()
        assert eng._san is None
        eng.run_all([PROMPT], max_new_tokens=2)
        # injected corruption goes unnoticed without the sanitizer
        eng.allocator._free.pop()
        eng.submit("short one", max_new_tokens=2)
        while eng.has_work:
            eng.step()

    @pytest.mark.parametrize("engine_kw", [dict(prefill_chunk=8), dict(pipeline_depth=2),
                                           dict(num_pages=7, max_slots=3)],
                             ids=["chunked", "depth2", "tight_pool"])
    def test_each_tick_is_checked(self, engine_kw, monkeypatch):
        """Every step of chunked prefill, pipelined ticks and a pool too
        small for every slot runs the check once, clean."""
        from sentio_tpu_torch.runtime import paged

        calls: list = []
        real = paged.check_engine_invariants
        monkeypatch.setattr(paged, "check_engine_invariants",
                            lambda e: (calls.append(e), real(e)))
        eng = _engine(**engine_kw)
        eng.run_all([PROMPT, "short one", PROMPT[::-1]], max_new_tokens=6)
        steps = len(calls)
        assert steps > 0 and all(c is eng for c in calls)
        eng.step()
        assert len(calls) == steps + 1


class TestQuantPoolRepr:
    """The pool-layout half: an int8 pool is ``QuantPages`` (int8 codes,
    f16 scales of the codes' shape minus the vector axis), an unquantized
    pool plain tensors of the model dtype, a mesh engine's shards each
    ``Hkv / tp`` heads on its own device, every pool on the engine's
    device."""

    def test_clean_int8_tick_passes(self):
        eng = _engine(kv_quant="int8")
        eng.run_all([PROMPT], max_new_tokens=4)
        check_engine_invariants(eng)

    def test_densified_pool_caught(self):
        eng = _engine(kv_quant="int8")
        eng.run_all([PROMPT], max_new_tokens=2)
        eng.pool.k = eng.pool.k.q  # the dense-copy regression
        with pytest.raises(SanitizerError, match="pytree"):
            check_engine_invariants(eng)

    def test_scale_dtype_drift_caught(self):
        eng = _engine(kv_quant="int8")
        eng.run_all([PROMPT], max_new_tokens=2)
        eng.pool.k = QuantPages(eng.pool.k.q, eng.pool.k.s.float())
        with pytest.raises(SanitizerError, match="dtypes"):
            check_engine_invariants(eng)

    def test_scale_shape_mismatch_caught(self):
        eng = _engine(kv_quant="int8")
        eng.run_all([PROMPT], max_new_tokens=2)
        eng.pool.v = QuantPages(eng.pool.v.q, eng.pool.v.s[:, :-1])
        with pytest.raises(SanitizerError, match="scale shape"):
            check_engine_invariants(eng)

    def test_quant_pool_on_unquantized_engine_caught(self):
        eng = _engine()
        eng.run_all([PROMPT], max_new_tokens=2)
        eng.pool.k = QuantPages(*quantize_kv(eng.pool.k))
        with pytest.raises(SanitizerError, match="unquantized"):
            check_engine_invariants(eng)

    @pytest.mark.parametrize("drift", ["codes", "pages"])
    def test_quant_pages_layout_drift_caught(self, drift):
        eng = _engine(kv_quant="int8")
        eng.run_all([PROMPT], max_new_tokens=2)
        q, s = eng.pool.k
        if drift == "codes":
            eng.pool.k = QuantPages(q.to(torch.int16), s)
            match = "q=torch.int16"
        else:
            eng.pool.k = QuantPages(q[:, :-1], s[:, :-1])
            match = "shape .* drifted"
        with pytest.raises(SanitizerError, match=match):
            check_engine_invariants(eng)

    def test_plain_pool_dtype_drift_caught(self):
        eng = _engine()
        eng.run_all([PROMPT], max_new_tokens=2)
        eng.pool.v = eng.pool.v.to(torch.float16)
        with pytest.raises(SanitizerError, match="dtype drifted"):
            check_engine_invariants(eng)

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_pool_off_the_engine_device_caught(self, kv_quant):
        """A pool on the CPU under a CUDA engine is the silent fallback the
        check guards against (metadata only: no card needed to read it)."""
        eng = _engine(kv_quant=kv_quant)
        eng.run_all([PROMPT], max_new_tokens=2)
        check_engine_invariants(eng)
        eng.device = torch.device("cuda")
        with pytest.raises(SanitizerError,
                           match="pool.k lies on cpu but its engine computes on cuda"):
            check_engine_invariants(eng)

    def test_pool_tensor_on_another_device_caught(self):
        eng = _engine()
        eng.run_all([PROMPT], max_new_tokens=2)
        eng.pool.k = torch.empty_like(eng.pool.k, device="meta")
        with pytest.raises(SanitizerError, match="pool.k lies on meta"):
            check_engine_invariants(eng)

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_sharded_pool_checked_per_shard(self, kv_quant):
        eng = _mesh_engine(kv_quant)
        assert isinstance(eng.pool, ShardedPool) and len(eng.pool.shards) == 2
        eng.run_all([PROMPT, "short one"], max_new_tokens=4)
        check_engine_invariants(eng)
        shard = eng.pool.shards[1]
        if kv_quant == "int8":
            shard.k = QuantPages(torch.empty_like(shard.k.q, device="meta"), shard.k.s)
        else:
            shard.k = torch.empty_like(shard.k, device="meta")
        with pytest.raises(SanitizerError, match=r"pool.shards\[1\].k lies on meta"):
            check_engine_invariants(eng)

    def test_sharded_pool_head_count_caught(self):
        eng = _mesh_engine("none")
        eng.run_all([PROMPT], max_new_tokens=2)
        shard = eng.pool.shards[0]
        shard.v = torch.cat([shard.v, shard.v], dim=3)  # Hkv heads, not Hkv / tp
        with pytest.raises(SanitizerError,
                           match=r"pool.shards\[0\].v holds 2 kv heads, want 1 \(Hkv 2 / tp 2\)"):
            check_engine_invariants(eng)

    def test_sharded_pool_quantization_disagreement_caught(self):
        eng = _mesh_engine("none")
        eng.run_all([PROMPT], max_new_tokens=2)
        shard = eng.pool.shards[1]
        shard.k = QuantPages(*quantize_kv(shard.k))
        with pytest.raises(SanitizerError, match=r"pool.shards\[1\].k is a QuantPages"):
            check_engine_invariants(eng)


def _mesh_engine(kv_quant: str) -> ContinuousBatchingEngine:
    """A tp=2 engine laid over the CPU twice: one pool a shard."""
    cpu = torch.device("cpu")
    mesh = build_mesh(MeshConfig(dp_size=1, tp_size=2), devices=[cpu, cpu])
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype="float32")
    return ContinuousBatchingEngine(model_config=cfg, mesh=mesh, kv_quant=kv_quant,
                                    max_slots=2, page_size=8, max_pages_per_seq=4,
                                    steps_per_tick=4)


class TestLockOrderRuntime:
    """Per-thread acquisition stacks and the process-wide order-edge set
    (tests that build inverse orders reset it first)."""

    def test_inversion_raises_and_leaves_nothing_held(self, pkg):
        pkg._reset_lock_order()
        a, b = pkg.make_lock("tsan-A"), pkg.make_lock("tsan-B")
        with a:
            with b:
                pass  # establishes A -> B
        with b:
            with pytest.raises(pkg.SanitizerError, match="inversion"):
                with a:
                    pass
            # the check runs before the underlying acquire
            assert not a.locked()
        assert pkg.held_lock_names() == frozenset()

    def test_inversion_caught_across_threads(self, pkg):
        pkg._reset_lock_order()
        a, b = pkg.make_lock("tsan-X"), pkg.make_lock("tsan-Y")

        def establishes():
            with a:
                with b:
                    pass

        t = threading.Thread(target=establishes, name="edge-setter")
        t.start()
        t.join()
        with b:
            with pytest.raises(pkg.SanitizerError, match="pick one global order"):
                with a:
                    pass

    def test_consistent_order_never_raises(self, pkg):
        pkg._reset_lock_order()
        a, b = pkg.make_lock("tsan-C"), pkg.make_lock("tsan-D")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert pkg.held_lock_names() == frozenset()

    def test_reentrant_blocking_acquire_raises(self, pkg):
        lock = pkg.make_lock("tsan-E")
        with lock:
            with pytest.raises(pkg.SanitizerError, match="self-deadlock"):
                lock.acquire()

    def test_same_name_nesting_is_not_an_inversion(self, pkg):
        pkg._reset_lock_order()
        a1, a2 = pkg.make_lock("tsan-F"), pkg.make_lock("tsan-F")
        with a1:
            with a2:
                pass
        with a2:
            with a1:
                pass

    def test_messages_match_jax(self):
        msgs = []
        for mod in (san, jax_san):
            mod._reset_lock_order()
            a, b = mod.make_lock("tsan-G"), mod.make_lock("tsan-H")

            def edge(a=a, b=b):
                with a:
                    with b:
                        pass

            t = threading.Thread(target=edge, name="edge-setter")
            t.start()
            t.join()
            with b:
                msgs.append(_raised(a.acquire))
            lock = mod.make_lock("tsan-I")
            with lock:
                msgs.append(_raised(lock.acquire))
            mod._reset_lock_order()
        assert msgs[:2] == msgs[2:]

    def test_serving_locks_keep_one_order(self):
        """Concurrent chats through an armed two-replica set take the set's,
        the fair queue's, the services', the recorder's and the metrics'
        owned locks without one order inversion or self-deadlock (either
        would fail a caller or a tick)."""
        from sentio_tpu_torch.runtime.replica import ReplicaSet
        from sentio_tpu_torch.runtime.service import PagedGenerationService

        san._reset_lock_order()
        rs = ReplicaSet([PagedGenerationService(_engine()), PagedGenerationService(_engine())])
        results: list = []
        try:
            for _ in range(2):
                threads = [threading.Thread(target=lambda i=i: results.append(
                    rs.generate(f"{PROMPT} {i}", max_new_tokens=4, tenant=f"t{i % 2}")))
                    for i in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
            assert len(results) == 8
            assert all(r.finish_reason in ("stop", "length") for r in results)
            assert sum(s.tick_failure_count for s in rs.services) == 0
        finally:
            rs.close()
            san._reset_lock_order()


def _seeded_class(mod):
    """Lockset-checker fixture under ``mod``'s sanitizer: one annotated
    counter, one locked and one unlocked write path."""

    @mod.guard_locksets
    class _Seeded:
        def __init__(self):
            self._mu = mod.make_lock("_Seeded._mu")
            self._count = 0  # guarded-by: _mu

        def locked_bump(self):
            with self._mu:
                self._count += 1

        def unlocked_bump(self):
            self._count += 1

    return _Seeded


SEEDED = {name: _seeded_class(mod) for name, mod in PACKAGES.items()}


@pytest.fixture(params=sorted(SEEDED))
def seeded(request):
    return SEEDED[request.param]


class TestLocksets:
    def test_cross_thread_unlocked_mutation_raises(self, seeded):
        s = seeded()
        s.unlocked_bump()  # first thread: exclusive phase
        caught = _in_thread(s.unlocked_bump, name="racer")
        assert caught, "second-thread unlocked write must empty the lockset"
        assert "_Seeded._count" in str(caught[0])
        assert "_mu" in str(caught[0])

    def test_lockset_empties_on_late_unlocked_write(self, seeded):
        s = seeded()
        t = threading.Thread(target=s.locked_bump, name="sharer")
        t.start()
        t.join()
        s.locked_bump()
        with pytest.raises((SanitizerError, jax_san.SanitizerError),
                           match="candidate lockset"):
            s.unlocked_bump()

    def test_locked_discipline_never_raises(self, seeded):
        s = seeded()
        threads = [threading.Thread(target=s.locked_bump, name=f"bumper-{i}")
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        s.locked_bump()
        assert s._count == 5

    def test_disabled_construction_is_unarmed(self, seeded, monkeypatch):
        monkeypatch.delenv("SENTIO_SANITIZE")
        s = seeded()
        assert "_san_lockset_state" not in s.__dict__
        t = threading.Thread(target=s.unlocked_bump)
        s.unlocked_bump()
        t.start()
        t.join()
        assert s._count == 2

    def test_messages_match_jax(self):
        msgs = []
        for cls in (SEEDED["port"], SEEDED["jax"]):
            s = cls()
            s.unlocked_bump()
            msgs.append(str(_in_thread(s.unlocked_bump, name="racer")[0]))
        assert msgs[0] == msgs[1]

    def test_serving_classes_are_armed(self):
        """The serving classes carry the decorator and parse their own
        annotations into a non-empty spec; built unarmed they carry no
        state."""
        from sentio_tpu_torch.infra.flight import FlightRecorder
        from sentio_tpu_torch.infra.metrics import MetricsCollector
        from sentio_tpu_torch.runtime.replica import ReplicaSet, TenantFairQueue, WorkerRegistry
        from sentio_tpu_torch.runtime.service import PagedGenerationService

        def spec(obj) -> set:
            return set(obj.__dict__["_san_lockset_state"].spec)

        assert "_tick_seq" in spec(FlightRecorder())
        assert {"_inflight", "_worker_last"} <= spec(MetricsCollector())
        assert "_tenants" in spec(TenantFairQueue(8))
        reg = WorkerRegistry("secret", slots=1)
        try:
            assert {"_epochs", "_rejections", "_free"} <= spec(reg)
        finally:
            reg.close()
        svc = PagedGenerationService(_engine())
        rs = ReplicaSet([svc], supervise=False)
        try:
            assert {"_inbox", "_tickets", "_pump", "_engine_lent"} <= spec(svc)
            # pump-thread state is the guard's, not the locksets'
            assert not {"_phase_totals", "_duty_t0"} & spec(svc)
            assert {"_health", "_failovers", "_closed"} <= spec(rs)
        finally:
            rs.close()
        os.environ.pop("SENTIO_SANITIZE")
        try:
            plain = PagedGenerationService(_engine())
            assert plain.engine._san is None
            assert "_san_lockset_state" not in plain.__dict__
            assert not isinstance(plain._mutex, OwnedLock)
        finally:
            os.environ["SENTIO_SANITIZE"] = "1"

    def test_service_unlocked_write_from_second_thread_raises(self):
        """The service's annotations are live: the pump wrote ``_ticks``
        under the mutex, an unlocked write from another thread empties its
        lockset."""
        from sentio_tpu_torch.runtime.service import PagedGenerationService

        svc = PagedGenerationService(_engine())
        try:
            svc.generate(PROMPT, max_new_tokens=4)
            assert svc.wait_idle()
            with pytest.raises(SanitizerError, match=r"PagedGenerationService._ticks "
                                                     r"\(guarded-by: _mutex\)"):
                svc._ticks = 0
        finally:
            svc.close()


class TestServiceUnderSanitizer:
    def test_pump_handoff_and_locks(self):
        from sentio_tpu_torch.runtime.service import PagedGenerationService

        eng = _engine()
        svc = PagedGenerationService(eng)
        assert isinstance(svc._mutex, OwnedLock)
        out = svc.generate(PROMPT, max_new_tokens=4)
        assert out.finish_reason in ("stop", "length")
        # pump bursts rebind: a second generation after the first pump died
        out2 = svc.generate("another prompt entirely", max_new_tokens=4)
        assert out2.finish_reason in ("stop", "length")
        assert svc.tick_failure_count == 0
        svc.close()

    def test_warm_prefix_waits_for_the_pump_and_holds_new_ones(self, monkeypatch):
        """The service lends its engine to the warming thread only once the
        pump is gone; a submit made meanwhile waits in the inbox and its
        pump starts after."""
        from sentio_tpu_torch.runtime.service import PagedGenerationService

        eng = _engine(max_pages_per_seq=8)
        svc = PagedGenerationService(eng)
        real = eng.warm_prefix
        seen: dict = {}

        def warm(text):
            caller = threading.Thread(target=lambda: seen.setdefault(
                "result", svc.generate(PROMPT, max_new_tokens=4)))
            caller.start()
            time.sleep(0.3)
            with svc._mutex:
                seen["pump_running"] = svc._pump_running
                seen["inbox"] = len(svc._inbox)
            seen["caller"] = caller
            return real(text)

        monkeypatch.setattr(eng, "warm_prefix", warm)
        try:
            svc.generate("warm the pump first", max_new_tokens=4)
            assert svc.warm_prefix(PROMPT) > 0
            seen["caller"].join(timeout=60)
            assert (seen["pump_running"], seen["inbox"]) == (False, 1)
            assert seen["result"].finish_reason in ("stop", "length")
            assert seen["result"].prefix_hit_tokens > 0
            assert svc.tick_failure_count == 0
        finally:
            svc.close()


# ---------------------------------------------------------------- parity

HEAD = "You answer from the numbered sources and cite them. "
QUESTIONS = ["what is a page?", "who owns a slot?", "why a radix tree?",
             "where is scratch?", "how do ticks pipeline?"]
PARITY_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=8, num_pages=12,
                 steps_per_tick=4, pipeline_depth=2, prefix_cache=True)


@pytest.fixture(scope="module")
def parity_weights():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype="float32")
    jdcfg = dataclasses.replace(
        JaxLlamaConfig(vocab_size=jcfg.vocab_size, dim=32, n_layers=1, n_heads=2,
                       n_kv_heads=2, mlp_dim=64, max_len=jcfg.max_len), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(23), jcfg))
    dtree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(29), jdcfg))
    cfg = LlamaConfig(**dataclasses.asdict(jcfg))
    dcfg = LlamaConfig(**dataclasses.asdict(jdcfg))
    return {"jax": (jcfg, tree, jdcfg, dtree),
            "port": (cfg, llama_from_jax(tree), dcfg, llama_from_jax(dtree))}


def _parity_engine(weights, side, spec=False, **kw):
    cfg, params, dcfg, dparams = weights[side]
    kw = {**PARITY_KW, **kw}
    if spec:
        kw.update(draft_params=dparams, draft_config=dcfg, spec_k=3)
    if side == "jax":
        return JaxEngine(model_config=cfg, params=params, **kw)
    return ContinuousBatchingEngine(model_config=cfg, params=params, device="cpu", **kw)


def _drain(engine) -> dict:
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    return done


def _accounting(engine) -> tuple:
    return engine.allocator.free_pages, engine._radix.pages_held


def _workload(engine) -> list:
    """Shared heads over a 12-page pool (admission waits on pages, the tree
    evicts), cancels of an admitted and a queued request, a drain, a
    ``reset()`` mid-traffic, then traffic again. Every step of it runs the
    engine's own per-tick check."""
    trace = []
    ids = [engine.submit(HEAD + q, max_new_tokens=10) for q in QUESTIONS]
    early = {}
    for _ in range(2):
        early.update({r.request_id: r for r in engine.step()})
    trace.append(("cancel", engine.cancel(ids[1]), engine.cancel(ids[4])))
    done = {**early, **_drain(engine)}
    trace.append(("results", [(tuple(done[i].tokens), done[i].finish_reason)
                              for k, i in enumerate(ids) if k not in (1, 4)]))
    trace.append(("quiescent", _accounting(engine)))
    for q in QUESTIONS[:3]:
        engine.submit(HEAD + q, max_new_tokens=8)
    engine.step()
    engine.reset()
    trace.append(("after_reset", _accounting(engine), engine.has_work))
    later = [engine.submit(HEAD + q, max_new_tokens=8) for q in QUESTIONS[2:]]
    done = _drain(engine)
    trace.append(("results_after_reset",
                  [(tuple(done[i].tokens), done[i].finish_reason) for i in later]))
    trace.append(("quiescent_after_reset", _accounting(engine)))
    return trace


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec_draft1"])
def test_armed_engines_agree_with_jax(parity_weights, spec):
    """Both packages armed: the same greedy tokens and the same free pages
    and radix pages wherever both engines are quiescent."""
    ref = _parity_engine(parity_weights, "jax", spec)
    port = _parity_engine(parity_weights, "port", spec)
    assert ref._san is not None and port._san is not None
    want, got = _workload(ref), _workload(port)
    assert got == want
    # the pool was the limit: not every request fit at once
    assert want[2][1][0] < PARITY_KW["num_pages"] - 1 or want[2][1][1] > 0


def _inject(engine, fault: str) -> None:
    if fault == "leak":
        engine.allocator._free.pop()
    elif fault == "double_own":
        engine.allocator._free.insert(0, engine.allocator._free[0])
    else:  # a refcount one too high: a pin with no live slot behind it
        engine._radix.lock(next(iter(engine._radix.root.children.values())))


@pytest.mark.parametrize("fault,match", [("leak", "page conservation violated: leaked="),
                                         ("double_own", "page free-list contains duplicates"),
                                         ("refcount", "radix refcount mismatch")])
def test_injected_faults_raise_jax_messages(parity_weights, fault, match):
    msgs = []
    for side in ("jax", "port"):
        eng = _parity_engine(parity_weights, side)
        _drain_all(eng, [HEAD + q for q in QUESTIONS[:2]], max_new_tokens=4)
        _inject(eng, fault)
        eng.submit(HEAD + QUESTIONS[3], max_new_tokens=2)

        def run(eng=eng):
            while eng.has_work:
                eng.step()

        msgs.append(_raised(run))
    assert msgs[0] == msgs[1]
    assert match in msgs[1]


def _drain_all(engine, prompts, max_new_tokens):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new_tokens)
    _drain(engine)
