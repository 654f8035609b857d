"""Lockset race detector: observed cross-thread access without the lock.

An *observed* lock-discipline check, Eraser-style. Classes declare their shared
mutable attributes and owning locks with::

    @shared_state({"_plan": "_lock", "appends": "_lock"})
    class PlanHolder: ...

While the sanitizer is enabled, instrumented ``__getattribute__`` /
``__setattr__`` hooks are installed on every registered class. Each access
to a declared attribute records the accessing thread; once an instance has
been touched from two threads, any further access without the owning
``SanLock`` held on the current thread raises a ``race`` finding with the
call site. When the sanitizer is disabled the hooks are *removed* from the
classes, so the off-mode cost is literally zero — plain CPython attribute
lookup.

Attributes that are intentionally accessed lock-free (monotonic flags read
opportunistically, say) are listed in a class-level ``_san_atomic`` tuple
and simply not declared here.
"""

from __future__ import annotations

import threading
import weakref

from ._state import STATE, trimmed_stack

_REGISTRY: list[type] = []
_hooks_installed = False

_obs_lock = threading.Lock()
#: instance -> {attr: set of thread idents that touched it}
_observed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reset_observations() -> None:
    with _obs_lock:
        _observed.clear()


def _check(obj, cls: type, name: str, kind: str) -> None:
    lock_attr = cls._san_shared[name]
    try:
        lock = object.__getattribute__(obj, lock_attr)
    except AttributeError:
        return  # mid-__init__, lock not created yet: single-threaded
    held = getattr(lock, "held_by_me", None)
    if held is None:
        return  # not a sanitizer lock: nothing to observe against
    ident = threading.get_ident()
    with _obs_lock:
        try:
            rec = _observed[obj]
        except KeyError:
            rec = _observed[obj] = {}
        threads = rec.setdefault(name, set())
        threads.add(ident)
        multi = len(threads) > 1
    if multi and not held():
        stack = trimmed_stack(skip=3)
        site = stack[-1] if stack else "?"
        STATE.add_finding(
            "race",
            f"{cls.__name__}.{name} {kind} from a second thread without "
            f"{lock_attr} held",
            stack=stack,
            details={"class": cls.__name__, "attr": name, "kind": kind,
                     "lock": lock_attr},
            dedupe_key=("race", cls.__name__, name, kind, site),
        )


def _make_hooks(cls: type):
    shared = frozenset(cls._san_shared)

    def __getattribute__(self, name):
        if name in shared and STATE.enabled:
            _check(self, cls, name, "read")
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name in shared and STATE.enabled:
            _check(self, cls, name, "write")
        object.__setattr__(self, name, value)

    return __getattribute__, __setattr__


def _install_cls(cls: type) -> None:
    if "__getattribute__" in cls.__dict__:
        return  # already installed
    getter, setter = _make_hooks(cls)
    cls.__getattribute__ = getter
    cls.__setattr__ = setter


def _uninstall_cls(cls: type) -> None:
    for name in ("__getattribute__", "__setattr__"):
        if name in cls.__dict__:
            delattr(cls, name)


def install() -> None:
    global _hooks_installed
    _hooks_installed = True
    for cls in _REGISTRY:
        _install_cls(cls)


def uninstall() -> None:
    global _hooks_installed
    _hooks_installed = False
    for cls in _REGISTRY:
        _uninstall_cls(cls)


def shared_state(attr_locks: dict[str, str]):
    """Class decorator declaring shared mutable attrs and their owning lock
    attribute. Instrumentation only bites while the sanitizer is enabled."""

    def deco(cls: type) -> type:
        cls._san_shared = dict(attr_locks)
        _REGISTRY.append(cls)
        if _hooks_installed:
            _install_cls(cls)
        return cls

    return deco
