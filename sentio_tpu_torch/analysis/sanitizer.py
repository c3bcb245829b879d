"""Runtime sanitizer: opt-in dynamic checks for the engine's contracts —
``sentio_tpu/analysis/sanitizer.py`` over the port's engine, with the
same names and messages; only the pool-layout check reads the port's own
pool (:class:`QuantPages`, :class:`ShardedPool`).

Enabled by ``SENTIO_SANITIZE=1`` (read at object construction). Five
checks, all free when disabled:

* **lock ownership** — ``make_lock`` returns an :class:`OwnedLock` that
  records its owning thread; helpers documented as lock-held call
  :func:`assert_held` at entry, so "caller must hold the lock" stops being
  a comment. Disabled, ``make_lock`` returns a plain ``threading.Lock`` and
  ``assert_held`` no-ops.
* **single-driver-thread engine** — the paged engine is touched only by
  one driver (the serving pump, or the test/bench thread driving it
  directly). :class:`ThreadGuard` binds the first mutating caller and
  raises on any mutating entry from a different live thread; the serving
  pump rebinds explicitly at pump start (:func:`bind_engine_owner`) since
  pump threads are born and die per burst.
* **engine invariants** — after every tick,
  :func:`check_engine_invariants` verifies page-pool conservation (every
  page id 1..P-1 is owned by exactly one of: the free list, an active
  slot, the radix cache) and radix refcount consistency (each node's
  refcount equals the number of active slots whose pinned chain crosses
  it), after the pool's layout (:func:`_check_pool_repr`). A leaked or
  double-owned page fails THE TICK THAT LEAKED IT, not a pool-exhaustion
  three workloads later.
* **lock order** — every :class:`OwnedLock` acquisition is checked against
  a global acquired-while-holding edge set; the first blocking acquire
  that reverses an already-observed edge raises *before* taking the lock,
  so the inversion is reported on the run that merely COULD have
  deadlocked, not the run that did. Reentrant blocking acquire of the
  same (non-reentrant) lock raises for the same reason.
* **locksets** — :func:`guard_locksets` is a class decorator that reads
  the class's own ``# guarded-by:`` annotations (via
  :mod:`sentio_tpu_torch.analysis.guarded`) and enforces them dynamically, Eraser-style: each
  annotated attribute carries a candidate lockset, intersected with the
  thread's held locks at every write once a second thread has touched
  it; an empty intersection raises. It sees through ``_locked`` suffixes
  and ``# lock-held:`` markers, because it checks what the thread
  actually holds.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Optional

__all__ = [
    "SanitizerError",
    "enabled",
    "make_lock",
    "assert_held",
    "OwnedLock",
    "ThreadGuard",
    "engine_guard",
    "bind_engine_owner",
    "check_engine_invariants",
    "guard_locksets",
    "held_lock_names",
]


class SanitizerError(RuntimeError):
    """An engine/lock contract was violated (only raised under
    ``SENTIO_SANITIZE=1``)."""


def enabled() -> bool:
    return os.environ.get("SENTIO_SANITIZE", "") == "1"


# ----------------------------------------------------- runtime lock order

# Per-thread stack of (lock name, lock id) currently held, maintained by
# OwnedLock. The stack is what makes both dynamic checks possible: the
# order checker reads it to learn what is held while acquiring, the
# lockset checker reads it to learn what is held while writing.
_held = threading.local()

# Acquired-while-holding edges observed so far, process-global and keyed by
# lock NAME (make_lock names are class-qualified, so two instances of one
# class share an edge — the JAX package's static lock graph aliases the
# same way). Value is
# a human-readable note of who established the edge, for the error message.
_order_edges: dict = {}
_order_guard = threading.Lock()  # plain lock: must not feed its own stack


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def held_lock_names() -> frozenset:
    """Names of every :class:`OwnedLock` the calling thread holds."""
    return frozenset(name for name, _ in _held_stack())


def _reset_lock_order() -> None:
    """Test hook: forget every observed acquisition edge."""
    with _order_guard:
        _order_edges.clear()


def _note_acquire(name: str, obj: object) -> None:
    """Pre-acquire check for a blocking acquire: raises on reentrancy or on
    the first observed order inversion. Runs BEFORE the underlying acquire,
    so a raise leaves nothing newly held."""
    stack = _held_stack()
    cur = threading.current_thread()
    for held_name, held_id in stack:
        if held_id == id(obj):
            raise SanitizerError(
                f"self-deadlock: thread {cur.name!r} blocking on "
                f"{name!r} while already holding it (non-reentrant lock)"
            )
    if not stack:
        return
    with _order_guard:
        for held_name, _hid in stack:
            if held_name == name:
                continue  # distinct instances of one class: no order info
            if (name, held_name) in _order_edges:
                raise SanitizerError(
                    f"lock-order inversion: thread {cur.name!r} acquiring "
                    f"{name!r} while holding {held_name!r}, but the reverse "
                    f"order was already observed "
                    f"({_order_edges[(name, held_name)]}) — two threads "
                    f"entering from opposite edges deadlock; pick one "
                    f"global order"
                )
            _order_edges.setdefault(
                (held_name, name),
                f"{held_name} -> {name} by thread {cur.name!r}",
            )


def _push_held(name: str, obj: object) -> None:
    _held_stack().append((name, id(obj)))


def _pop_held(obj: object) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][1] == id(obj):
            del stack[i]
            return


# ------------------------------------------------------------ lock ownership


class OwnedLock:
    """``threading.Lock`` recording its owning thread, so lock-held helpers
    can assert the caller actually holds it. Not reentrant (neither is the
    lock it wraps). Every acquisition feeds the per-thread held stack and
    the global order-edge set (see the lock-order section above)."""

    def __init__(self, name: str = "lock") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[threading.Thread] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            _note_acquire(self.name, self)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.current_thread()
            _push_held(self.name, self)
        return got

    def release(self) -> None:
        self._owner = None
        _pop_held(self)
        self._lock.release()

    def __enter__(self) -> "OwnedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    @property
    def held_by_me(self) -> bool:
        return self._owner is threading.current_thread()


def make_lock(name: str = "lock"):
    """A lock for a ``guarded-by`` annotated structure: plain
    ``threading.Lock`` normally, :class:`OwnedLock` under the sanitizer."""
    return OwnedLock(name) if enabled() else threading.Lock()


def assert_held(lock) -> None:
    """No-op on a plain lock; on an :class:`OwnedLock`, raise unless the
    calling thread holds it."""
    if isinstance(lock, OwnedLock) and not lock.held_by_me:
        raise SanitizerError(
            f"lock-held contract violated: {lock.name} is not held by "
            f"thread {threading.current_thread().name!r}"
        )


# --------------------------------------------------- single-driver contract


class ThreadGuard:
    """Binds the engine's driver thread and rejects mutating entry from any
    other live thread. First mutating caller binds implicitly (tests/bench
    drive the engine directly); the serving pump rebinds explicitly at pump
    start — an authorized ownership transfer, since the service guarantees
    at most one pump exists."""

    def __init__(self, name: str = "engine") -> None:
        self.name = name
        self._owner: Optional[threading.Thread] = None

    def bind(self) -> None:
        self._owner = threading.current_thread()

    def enter(self, op: str) -> None:
        cur = threading.current_thread()
        owner = self._owner
        if owner is None or owner is cur:
            # baselined cross-thread-race: the guard's own owner field is
            # deliberately lock-free — it exists to DETECT cross-thread
            # entry, and a mutex here would serialize every engine call the
            # sanitizer observes; a torn owner read merely reports the race
            # it was about to report anyway
            self._owner = cur
            return
        if not owner.is_alive():
            # the previous driver died (a finished pump burst): ownership
            # migrates to whoever drives next
            self._owner = cur
            return
        raise SanitizerError(
            f"{self.name}.{op} called from thread {cur.name!r} while the "
            f"engine is owned by live thread {owner.name!r} — the engine is "
            f"single-threaded by contract (runtime/service.py); route calls "
            f"through the pump"
        )


def engine_guard(name: str = "engine") -> Optional[ThreadGuard]:
    """A :class:`ThreadGuard` when sanitizing, else None (so the per-call
    cost in the engine is one attribute test)."""
    return ThreadGuard(name) if enabled() else None


def bind_engine_owner(engine) -> None:
    """Explicitly hand engine ownership to the calling thread (the serving
    pump calls this at pump start). No-op when the engine carries no guard."""
    guard = getattr(engine, "_san", None)
    if guard is not None:
        guard.bind()


# --------------------------------------------------------- lockset checker


class _LocksetState:
    """Per-instance lockset tracking for one guard_locksets instance.

    ``spec`` maps attr -> declared lock attr name (from the class's own
    ``# guarded-by:`` annotations). ``records`` maps attr ->
    ``[last_writer_thread, candidate_lockset_or_None]``; ``None`` marks the
    exclusive phase (only one thread has ever written the attr — Eraser's
    initialization grace period, which also absorbs single-threaded use)."""

    __slots__ = ("spec", "records")

    def __init__(self, spec: dict) -> None:
        self.spec = spec
        self.records: dict = {}


# class -> attr->lock spec parsed from its source (lazily; None = no spec)
_lockset_specs: dict = {}


def _lockset_spec(cls) -> dict:
    spec = _lockset_specs.get(cls)
    if spec is None:
        import inspect
        import textwrap

        from sentio_tpu_torch.analysis.guarded import collect_guarded

        try:
            # mutex-guarded attrs only: THREAD_LOCKS ownership is enforced
            # by ThreadGuard, not locksets
            spec = collect_guarded(textwrap.dedent(inspect.getsource(cls))).get(cls.__name__, {})
        except (OSError, TypeError, SyntaxError):
            spec = {}
        _lockset_specs[cls] = spec
    return spec


def _lockset_write(obj, state: _LocksetState, attr: str) -> None:
    cur = threading.current_thread()
    rec = state.records.get(attr)
    if rec is None:
        state.records[attr] = [cur, None]
        return
    if rec[1] is None and rec[0] is cur:
        return  # still exclusive
    held = held_lock_names()
    cand = held if rec[1] is None else rec[1] & held
    rec[0] = cur
    rec[1] = cand
    if not cand:
        raise SanitizerError(
            f"lockset violation: {type(obj).__name__}.{attr} "
            f"(guarded-by: {state.spec[attr]}) written by thread "
            f"{cur.name!r} and its candidate lockset is now empty — "
            f"no single lock protects every write; this write holds "
            f"{sorted(held) or 'nothing'}"
        )


def _install_lockset_setattr(cls) -> None:
    if "_san_setattr_installed" in cls.__dict__:
        return
    orig = cls.__setattr__

    def __setattr__(self, name, value):
        state = self.__dict__.get("_san_lockset_state")
        if state is not None and name in state.spec:
            _lockset_write(self, state, name)
        orig(self, name, value)

    cls.__setattr__ = __setattr__
    cls._san_setattr_installed = True


def _arm_locksets(obj, cls) -> None:
    spec = _lockset_spec(cls)
    if not spec:
        return
    # only attrs whose declared lock is an OwnedLock on this instance are
    # observable (a plain Lock never feeds the held stack, so checking
    # against it would be all false positives)
    usable = {
        attr: lock for attr, lock in spec.items()
        if isinstance(getattr(obj, lock, None), OwnedLock)
    }
    if not usable:
        return
    _install_lockset_setattr(cls)
    obj.__dict__["_san_lockset_state"] = _LocksetState(usable)


def guard_locksets(cls):
    """Class decorator: enforce the class's own ``# guarded-by:``
    annotations dynamically, Eraser-style (Savage et al., TOSP 1997).

    Free when ``SENTIO_SANITIZE`` is unset: the env is read at instance
    construction, and an unarmed instance pays nothing — ``__setattr__``
    is only replaced on the class once some instance arms, and even then
    the fast path is one dict probe.

    Armed, every rebind of an annotated attribute runs the lockset state
    machine: the first writing thread owns the attr exclusively; the
    moment a second thread writes, the candidate lockset becomes the
    locks that thread holds, and every later write (from any thread)
    intersects it with the writer's held set. Empty intersection raises
    :class:`SanitizerError` — there is provably no single lock protecting
    the attribute, whatever the annotation claims. Writes during
    ``__init__`` predate arming and are exempt. Granularity is attribute
    REBIND (``self.x = ...``, ``self.x += ...``); in-place mutation of a
    guarded container is not seen."""
    orig_init = cls.__init__

    @functools.wraps(orig_init)
    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        if enabled():
            _arm_locksets(self, cls)

    cls.__init__ = __init__
    return cls


# ------------------------------------------------------- engine invariants


def _radix_nodes(radix):
    stack = list(radix.root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        yield node


def _same_device(have, want) -> bool:
    """``have`` (a tensor's device) is ``want``; a ``want`` without an index
    (``cuda``) names whichever card the tensor's index says."""
    return have.type == want.type and (want.index is None or have.index == want.index)


def _check_pool_repr(engine) -> None:
    """KV-pool layout consistency, from host metadata only (type, dtype,
    shape, device; no device sync), so a layout drift fails the tick that
    made it:

    * an unquantized pool's ``k`` and ``v`` are plain tensors of the model
      dtype, never :class:`QuantPages`;
    * an int8 pool's sides are :class:`QuantPages` with int8 codes and f16
      scales whose shape is the codes' minus the vector axis;
    * a :class:`ShardedPool` holds one such pool a tp shard, each with
      ``Hkv / tp`` kv heads on its own shard's device, all agreeing on the
      page size, the page count and the quantization;
    * every pool lies on the engine's device: a pool on the CPU under a
      CUDA engine is a silent fallback."""
    pool = getattr(engine, "pool", None)
    if pool is None:
        return
    import torch

    from sentio_tpu_torch.kernels.paged_attention import QuantPages

    want_quant = getattr(engine, "kv_quant", "none") == "int8"
    cfg = engine.cfg
    engine_dev = torch.device(engine.device)
    shards = getattr(pool, "shards", None)
    if shards is None:
        pools, devices, labels = [pool], [engine_dev], ["pool"]
    else:
        devices = [torch.device(d) for d in getattr(engine.params, "devices", ())]
        if len(devices) != len(shards):
            raise SanitizerError(
                f"pool holds {len(shards)} shards but the engine computes on "
                f"{len(devices)} tp shards"
            )
        pools, labels = list(shards), [f"pool.shards[{i}]" for i in range(len(shards))]
    tp = len(pools)
    heads = cfg.n_kv_heads // tp
    want_shape = (cfg.n_layers, engine.allocator.num_pages, engine.page_size, heads,
                  cfg.head_dim)
    for part, device, label in zip(pools, devices, labels):
        if device.type != engine_dev.type:
            raise SanitizerError(
                f"{label} is placed on {device} but the engine runs on {engine_dev}"
            )
        if part.page_size != engine.page_size:
            raise SanitizerError(
                f"{label}.page_size={part.page_size} but engine "
                f"page_size={engine.page_size}"
            )
        for name in ("k", "v"):
            side = getattr(part, name)
            if not want_quant:
                if isinstance(side, QuantPages):
                    raise SanitizerError(
                        f"{label}.{name} is a QuantPages pytree on an unquantized engine"
                    )
                if not isinstance(side, torch.Tensor):
                    raise SanitizerError(
                        f"{label}.{name} must be a tensor, got {type(side).__name__}"
                    )
                if side.dtype != cfg.torch_dtype:
                    raise SanitizerError(
                        f"{label}.{name} dtype drifted: {side.dtype} (want the model's "
                        f"{cfg.torch_dtype})"
                    )
                leaves = (side,)
            else:
                if not isinstance(side, QuantPages):
                    raise SanitizerError(
                        f"quantized {label}.{name} must be a QuantPages (q, s) pytree, "
                        f"got {type(side).__name__}"
                    )
                q, s = side.q, side.s
                if q.dtype != torch.int8 or s.dtype != torch.float16:
                    raise SanitizerError(
                        f"quantized {label}.{name} dtypes drifted: q={q.dtype} "
                        f"(want int8), s={s.dtype} (want float16)"
                    )
                if tuple(q.shape[:-1]) != tuple(s.shape):
                    raise SanitizerError(
                        f"quantized {label}.{name} scale shape {tuple(s.shape)} does "
                        f"not mirror payload {tuple(q.shape)} minus the vector axis"
                    )
                leaves = (q, s)
            shape = tuple(leaves[0].shape)
            if len(shape) == 5 and shape[3] != heads:
                raise SanitizerError(
                    f"{label}.{name} holds {shape[3]} kv heads, want {heads} "
                    f"(Hkv {cfg.n_kv_heads} / tp {tp})"
                )
            if shape != want_shape:
                raise SanitizerError(
                    f"{label}.{name} shape {shape} drifted from {want_shape} (layers, "
                    f"pages, page size, kv heads, head dim)"
                )
            for t in leaves:
                if not _same_device(t.device, device):
                    raise SanitizerError(
                        f"{label}.{name} lies on {t.device} but its engine computes "
                        f"on {device}"
                    )


def check_engine_invariants(engine) -> None:
    """Page-pool conservation + radix refcount consistency. Called by the
    engine at the end of every tick under the sanitizer.

    Ownership model being verified: page 0 is scratch; every other page id
    is owned by exactly one of (a) the allocator free list, (b) an active
    slot's ``pages`` minus the span it donated to the radix cache, (c) the
    radix tree. Refcounts: each active slot pins the chain from its
    ``prefix_node`` to the root, contributing exactly 1 per node. The pool
    layout check (:func:`_check_pool_repr`) runs first so the int8
    :class:`QuantPages` pool and a mesh's shards are held to the same
    per-tick standard as
    plain tensors."""
    _check_pool_repr(engine)
    alloc = engine.allocator
    free = list(alloc._free)
    free_set = set(free)
    if len(free_set) != len(free):
        raise SanitizerError(
            f"page free-list contains duplicates: "
            f"{sorted(p for p in free_set if free.count(p) > 1)}"
        )
    if 0 in free_set or any(p < 0 or p >= alloc.num_pages for p in free_set):
        raise SanitizerError("free-list holds out-of-range or scratch page ids")

    slot_pages: list[int] = []
    donated: set[int] = set()
    for slot in engine.slots:
        if not slot.active:
            continue
        slot_pages.extend(slot.pages)
        donated.update(slot.donated)
    if len(set(slot_pages)) != len(slot_pages):
        raise SanitizerError("a page id is owned by two active slots")
    slot_owned = set(slot_pages) - donated

    radix = getattr(engine, "_radix", None)
    radix_pages: set[int] = set()
    if radix is not None:
        for node in _radix_nodes(radix):
            for p in node.pages:
                if p in radix_pages:
                    raise SanitizerError(
                        f"radix tree holds page {p} in two nodes"
                    )
                radix_pages.add(p)
        if len(radix_pages) != radix.pages_held:
            raise SanitizerError(
                f"radix pages_held={radix.pages_held} but tree holds "
                f"{len(radix_pages)} pages"
            )

    for a, b, what in (
        (free_set, slot_owned, "free list and an active slot"),
        (free_set, radix_pages, "free list and the radix cache"),
        (slot_owned, radix_pages, "an active slot and the radix cache"),
    ):
        both = a & b
        if both:
            raise SanitizerError(
                f"pages {sorted(both)} owned by {what} simultaneously"
            )

    expected = set(range(1, alloc.num_pages))
    union = free_set | slot_owned | radix_pages
    if union != expected:
        leaked = sorted(expected - union)
        extra = sorted(union - expected)
        raise SanitizerError(
            f"page conservation violated: leaked={leaked} unknown={extra} "
            f"(free={len(free_set)} slot={len(slot_owned)} "
            f"radix={len(radix_pages)} total={alloc.num_pages - 1})"
        )

    if radix is not None:
        expected_rc: dict[int, int] = {}
        for slot in engine.slots:
            if not slot.active:
                continue
            node = slot.prefix_node
            while node is not None and node is not radix.root:
                expected_rc[id(node)] = expected_rc.get(id(node), 0) + 1
                node = node.parent
        for node in _radix_nodes(radix):
            want = expected_rc.get(id(node), 0)
            if node.refcount != want:
                raise SanitizerError(
                    f"radix refcount mismatch on node "
                    f"({len(node.tokens)} tokens, pages {node.pages}): "
                    f"refcount={node.refcount} but {want} live slot chains "
                    f"cross it"
                )
