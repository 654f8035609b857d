"""Retrace sanitizer: *why* did the engine miss its signature cache again?

`FigaroEngine` counts signature misses per kind (`trace_count`, the JAX
package's trace counter); the zero-retrace append contract is asserted by
diffing those counters. A bare counter diff says "something missed" — this
module says *what*. The engine calls :func:`note_trace` once per miss with
the full dispatch signature; we store each kind's previous key and, on a
miss, name the signature component that diverged plus the trimmed call
stack of the dispatch that triggered it.

Steady-state mode (:func:`expect_no_retrace`) arms a tripwire: once armed,
*every* trace is a ``retrace`` finding. The append stress tests run armed
after warmup, so a contract violation fails with attribution instead of a
counter assert.
"""

from __future__ import annotations

import collections
import threading

from ._state import STATE, trimmed_stack

#: Components of the engine dispatch key, in order. Kept in sync with
#: ``FigaroEngine._signature``'s cache-key layout: one element per key slot.
KEY_COMPONENTS = ("kind", "device", "plan_spec", "mask_layout",
                  "data_abstract", "options", "mesh")

_lock = threading.Lock()
_last_key: dict[str, tuple] = {}
_events: "collections.deque" = collections.deque(maxlen=64)
_armed = False


class TraceEvent:
    __slots__ = ("kind", "diverged", "stack")

    def __init__(self, kind: str, diverged: list[str],
                 stack: tuple[str, ...]) -> None:
        self.kind = kind
        self.diverged = diverged
        self.stack = stack


def reset() -> None:
    global _armed
    with _lock:
        _last_key.clear()
        _events.clear()
        _armed = False


def expect_no_retrace(armed: bool = True) -> None:
    """Arm (or disarm) steady-state mode: any further trace is a finding."""
    global _armed
    with _lock:
        _armed = armed


def events() -> list[TraceEvent]:
    with _lock:
        return list(_events)


def _diff_components(old: tuple, new: tuple) -> list[str]:
    out = []
    for i, label in enumerate(KEY_COMPONENTS):
        o = old[i] if i < len(old) else None
        n = new[i] if i < len(new) else None
        if o != n:
            out.append(label)
    return out or ["<identical key: cache eviction or first use>"]


def note_trace(kind: str, key: tuple) -> None:
    """Called from the engine once per signature miss."""
    stack = trimmed_stack(skip=3, limit=8)
    with _lock:
        prev = _last_key.get(kind)
        diverged = _diff_components(prev, key) if prev is not None else []
        _last_key[kind] = key
        armed = _armed
        _events.append(TraceEvent(kind, diverged, stack))
    if not armed:
        return  # unarmed: warmup compiles are expected, events suffice
    what = ", ".join(diverged) if diverged else "first trace while armed"
    site = stack[-1] if stack else "?"
    STATE.add_finding(
        "retrace",
        f"retrace of kind={kind}: diverged signature component(s): {what}",
        stack=stack,
        details={"kind": kind, "diverged": diverged, "armed": armed},
        dedupe_key=("retrace", kind, tuple(diverged), site),
    )


def last_trace(kind: str) -> TraceEvent | None:
    """Most recent trace event for `kind`, for attribution in tests."""
    with _lock:
        for ev in reversed(_events):
            if ev.kind == kind:
                return ev
    return None
