"""The runtime sanitizer (``SENTIO_SANITIZE=1``) for the serving runtime's
contracts — the dynamic half of ``sentio_tpu/analysis/``.

* :mod:`.sanitizer` — engine entry points assert the single-driver-thread
  contract, annotated locks record their owner so lock-held helpers can
  assert it, every acquisition is checked against one process-wide lock
  order, ``guard_locksets`` classes enforce their ``# guarded-by:``
  annotations Eraser-style, and every engine tick verifies page-pool
  conservation, radix refcounts and the pool's layout.
* :mod:`.guarded` — the ``# guarded-by:`` parser the lockset checker reads
  a class's annotations with.

The lint, audit and check tools of the JAX package read its own source and
its ``jax.jit`` families; they have no counterpart here.

Annotation guide
================

``# guarded-by: <lock>`` — trailing comment on a ``self.<attr> = ...``
assignment: every later rebind of ``self.<attr>`` holds ``self.<lock>``.
The lock names ``engine-thread`` and ``pump-thread`` mark state owned by
one driver thread instead of a mutex (the paged engine, the radix cache,
the pump's telemetry): the engine's entry points enforce that contract
through :class:`.sanitizer.ThreadGuard`, not through locksets.

A helper whose name ends in ``_locked`` (or whose ``def`` line carries
``# lock-held: <lock>``) is called with the lock held, and under the
sanitizer asserts it with :func:`.sanitizer.assert_held`.
"""
