"""``# guarded-by:`` annotations of a class, parsed from its source — the
part of ``sentio_tpu/analysis/locks.py`` that the runtime lockset checker
(:func:`.sanitizer.guard_locksets`) reads.

An attribute annotated ``# guarded-by: <lock>`` on one of its ``self.<attr>
= ...`` assignments (on the assignment's first or last physical line, for a
multi-line initializer) is guarded by ``self.<lock>``; the lock names in
:data:`THREAD_LOCKS` declare single-driver-thread ownership instead, which
the engine's guard enforces, so they are left out here.
"""

from __future__ import annotations

import ast
import re

__all__ = ["THREAD_LOCKS", "collect_guarded"]

_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([\w.-]+)")

# lock "names" that mean thread ownership, not a mutex
THREAD_LOCKS = {"engine-thread", "pump-thread"}


def collect_guarded(text: str) -> dict[str, dict[str, str]]:
    """Every class's mutex-guarded ``self.<attr> = ...  # guarded-by:
    <lock>`` annotations in ``text``: class name -> attr -> lock attribute
    name (e.g. ``"_mutex"``)."""
    lines = text.splitlines()

    def guarded_by(lineno: int):
        m = _GUARDED_RE.search(lines[lineno - 1]) if 1 <= lineno <= len(lines) else None
        return m.group(1) if m else None

    out: dict[str, dict[str, str]] = {}
    for cls in ast.walk(ast.parse(text)):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded: dict[str, str] = {}
        for node in ast.walk(cls):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            attrs = [
                t.attr for t in targets
                if isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"
            ]
            lock = guarded_by(node.lineno) or guarded_by(getattr(node, "end_lineno", node.lineno))
            if attrs and lock is not None and lock not in THREAD_LOCKS:
                guarded.update(dict.fromkeys(attrs, lock))
        if guarded:
            out[cls.name] = guarded
    return out
