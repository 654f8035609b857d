"""Sanitizer-aware lock wrappers and the lock-acquisition-order graph.

``san_lock`` / ``san_rlock`` / ``san_condition`` replace the raw
``threading`` factories in the port (tests/test_torch_sanitizer.py holds
every lock of ``src/repro_torch`` to them). When the sanitizer is disabled each
wrapper costs one attribute read per acquire; when enabled it maintains a
per-thread stack of held locks, records every *ordered pair* (held → newly
acquired) into a global lock-order graph, and flags a ``lock-order`` finding
the moment an edge closes a cycle — the classic potential-deadlock signal,
caught even when the interleaving never actually deadlocks.

The wrappers also expose ``held_by_me()`` so the race detector can check
"is the owning lock held on this thread?" without touching CPython
internals, and ``SanCondition.wait`` keeps the held-lock bookkeeping honest
across the release/reacquire that a condition wait performs.
"""

from __future__ import annotations

import threading
from typing import Iterator

from ._state import STATE, trimmed_stack

_graph_lock = threading.Lock()
#: name -> set of names acquired *while* `name` was held.
_ORDER_EDGES: dict[str, set[str]] = {}
#: (a, b) -> trimmed stack of the first time the edge was observed.
_EDGE_SITES: dict[tuple[str, str], tuple[str, ...]] = {}

_tls = threading.local()


def _held_stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def reset_order_graph() -> None:
    with _graph_lock:
        _ORDER_EDGES.clear()
        _EDGE_SITES.clear()


def order_edges() -> dict[str, set[str]]:
    with _graph_lock:
        return {a: set(bs) for a, bs in _ORDER_EDGES.items()}


def _find_cycle(start: str, target: str) -> list[str] | None:
    """Path target -> ... -> start in the edge graph (caller just added the
    edge start -> target, so such a path closes a cycle)."""
    path = [target]
    seen = {target}

    def dfs(node: str) -> bool:
        for nxt in _ORDER_EDGES.get(node, ()):
            if nxt == start:
                path.append(start)
                return True
            if nxt not in seen:
                seen.add(nxt)
                path.append(nxt)
                if dfs(nxt):
                    return True
                path.pop()
        return False

    return path if dfs(target) else None


def _note_acquired(lock: "SanLock") -> None:
    held = _held_stack()
    for entry in held:
        if entry[0] is lock:          # reentrant re-acquire: no new edges
            entry[1] += 1
            return
    stack = None
    with _graph_lock:
        for other, _ in held:
            if other.name == lock.name:
                continue
            edges = _ORDER_EDGES.setdefault(other.name, set())
            if lock.name in edges:
                continue
            edges.add(lock.name)
            if stack is None:
                stack = trimmed_stack(skip=4)
            _EDGE_SITES[(other.name, lock.name)] = stack
            # `cycle` is the pre-existing path lock.name -> ... -> other.name,
            # in forward edge order; the new edge other.name -> lock.name
            # closes it.
            cycle = _find_cycle(other.name, lock.name)
            if cycle is not None:
                loop = [other.name] + cycle
                counter = _EDGE_SITES.get((cycle[0], cycle[1]), ()) \
                    if len(cycle) > 1 else ()
                STATE.add_finding(
                    "lock-order",
                    "lock acquisition cycle (potential deadlock): "
                    + " -> ".join(loop),
                    details={"cycle": loop, "counter_site": list(counter)},
                    dedupe_key=("lock-order", frozenset(loop)),
                )
    held.append([lock, 1])


def _note_released(lock: "SanLock") -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][1] -= 1
            if held[i][1] == 0:
                del held[i]
            return


def _drop_all(lock: "SanLock") -> int:
    """Remove `lock` from the held stack entirely (condition wait releases
    every recursion level); returns the count to restore afterwards."""
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            count = held[i][1]
            del held[i]
            return count
    return 0


def _restore(lock: "SanLock", count: int) -> None:
    if count:
        _held_stack().append([lock, count])


def held_locks() -> Iterator[str]:
    """Names of sanitizer locks held by the current thread."""
    return (entry[0].name for entry in _held_stack())


class SanLock:
    """Wrapper over threading.Lock/RLock with order-graph instrumentation."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str, factory=threading.Lock) -> None:
        self._lock = factory()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got and STATE.enabled:
            _note_acquired(self)
        return got

    def release(self) -> None:
        if STATE.enabled:
            _note_released(self)
        self._lock.release()

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def held_by_me(self) -> bool:
        return any(entry[0] is self for entry in _held_stack())

    def __repr__(self) -> str:
        return f"<SanLock {self.name!r}>"


class SanCondition:
    """Condition-variable wrapper keeping held-lock bookkeeping consistent
    across ``wait`` (which releases the underlying lock in full)."""

    __slots__ = ("_san", "_cond")

    def __init__(self, name: str) -> None:
        self._san = SanLock(name, factory=threading.RLock)
        self._cond = threading.Condition(self._san._lock)
        # The condition shares the SanLock's raw lock, so acquire/release on
        # either keeps the same bookkeeping.

    @property
    def name(self) -> str:
        return self._san.name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._san.acquire(blocking, timeout)

    def release(self) -> None:
        self._san.release()

    def __enter__(self) -> "SanCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def held_by_me(self) -> bool:
        return self._san.held_by_me()

    def wait(self, timeout: float | None = None) -> bool:
        saved = _drop_all(self._san) if STATE.enabled else 0
        try:
            return self._cond.wait(timeout)
        finally:
            if STATE.enabled:
                _restore(self._san, saved)

    def wait_for(self, predicate, timeout: float | None = None):
        # Re-implemented over self.wait so the held-lock bookkeeping sees
        # every release/reacquire (Condition.wait_for would bypass it).
        import time
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<SanCondition {self.name!r}>"


def san_lock(name: str) -> SanLock:
    return SanLock(name, factory=threading.Lock)


def san_rlock(name: str) -> SanLock:
    return SanLock(name, factory=threading.RLock)


def san_condition(name: str) -> SanCondition:
    return SanCondition(name)
