"""Sanitizer-aware thread factory.

``san_thread(target=...)`` is a drop-in for ``threading.Thread``; every
thread the port starts routes through it (tests/test_torch_sanitizer.py). The
wrapper notes thread start/exit with the race detector (so "observed from
two threads" is anchored to real thread entries, not incidental imports)
and flags a finding if a thread exits while still holding sanitizer locks —
a leak that would deadlock the next acquirer forever.
"""

from __future__ import annotations

import threading

from ._state import STATE
from .locks import held_locks


def san_thread(target, *, args=(), kwargs=None, name: str | None = None,
               daemon: bool | None = None) -> threading.Thread:
    kwargs = kwargs or {}

    def run() -> None:
        try:
            target(*args, **kwargs)
        finally:
            if STATE.enabled:
                leaked = sorted(held_locks())
                if leaked:
                    STATE.add_finding(
                        "thread",
                        f"thread exited holding lock(s): {', '.join(leaked)}",
                        details={"locks": leaked},
                        dedupe_key=("thread-leak", tuple(leaked),
                                    threading.current_thread().name),
                    )

    t = threading.Thread(target=run, name=name)
    if daemon is not None:
        t.daemon = daemon
    return t
