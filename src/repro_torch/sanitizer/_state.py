"""Shared mutable state for figaro-san.

One module-level :class:`SanitizerState` singleton holds the on/off flag,
per-check toggles, the finding registry, and the thread-local shadow-dispatch
marker. Everything here is stdlib-only; the numerics check imports torch lazily from
its own module. A copy of the JAX package's `repro.sanitizer._state` with
this package's plumbing paths.

The cardinal rule is that the *disabled* path must stay near-free: every
instrumentation site guards on ``STATE.enabled`` (a plain attribute read)
before doing any work, and the race detector's attribute hooks are only
installed on classes while the sanitizer is enabled.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import traceback
from typing import Any, Iterable

#: Frames whose filenames contain one of these fragments are dropped from
#: captured stacks — they are plumbing, not the call site the user wants.
_STACK_NOISE = ("/torch/", "site-packages", "/repro_torch/sanitizer/",
                "/threading.py", "/repro_torch/core/engine.py")


@dataclasses.dataclass(frozen=True)
class SanFinding:
    """One runtime finding. ``check`` names the sub-sanitizer (``race``,
    ``lock-order``, ``retrace``, ``numerics``); ``stack`` is the trimmed
    call-site stack captured when the finding fired."""

    check: str
    message: str
    thread: str
    stack: tuple[str, ...] = ()
    details: dict[str, Any] = dataclasses.field(default_factory=dict, hash=False)

    def render(self) -> str:
        head = f"[figaro-san:{self.check}] {self.message} (thread={self.thread})"
        if not self.stack:
            return head
        return head + "\n" + "\n".join(f"    at {f}" for f in self.stack)


def trimmed_stack(limit: int = 6, skip: int = 2) -> tuple[str, ...]:
    """Trimmed call stack of the current thread: drops sanitizer/torch/stdlib
    plumbing frames, keeps the innermost ``limit`` user frames."""
    frames = traceback.extract_stack()[:-skip]
    keep = [f"{f.filename}:{f.lineno} in {f.name}"
            for f in frames
            if not any(n in f.filename.replace(os.sep, "/")
                       for n in _STACK_NOISE)]
    return tuple(keep[-limit:])


class SanitizerState:
    """Process-wide sanitizer switchboard and finding registry."""

    def __init__(self) -> None:
        self.enabled = False
        self.race = True
        self.retrace = True
        self.numerics = True
        #: Shadow-dispatch sampling: the first dispatch of each signature is
        #: always shadowed; afterwards every ``sample_every``-th dispatch is.
        self.sample_every = 16
        #: Slack multiplier on the analytic rounding-error budget. The model
        #: counts rotations, not the exact constant in front, so the budget
        #: carries an engineering factor like any backward-stability bound.
        self.numerics_slack = 64.0
        self.max_findings = 256
        self._reg_lock = threading.Lock()
        self._findings: list[SanFinding] = []
        self._fingerprints: set[tuple] = set()
        self._tls = threading.local()

    # -- findings ------------------------------------------------------------

    def add_finding(self, check: str, message: str, *,
                    details: dict[str, Any] | None = None,
                    stack: tuple[str, ...] | None = None,
                    dedupe_key: tuple | None = None) -> SanFinding | None:
        """Record a finding (deduped by ``dedupe_key`` when given). Returns
        the finding, or None if it was a duplicate or the registry is full."""
        if stack is None:
            stack = trimmed_stack(skip=3)
        f = SanFinding(check=check, message=message,
                       thread=threading.current_thread().name,
                       stack=stack, details=dict(details or {}))
        with self._reg_lock:
            key = dedupe_key if dedupe_key is not None else (check, message)
            if key in self._fingerprints:
                return None
            if len(self._findings) >= self.max_findings:
                return None
            self._fingerprints.add(key)
            self._findings.append(f)
        return f

    def findings(self, check: str | None = None) -> list[SanFinding]:
        with self._reg_lock:
            out = list(self._findings)
        if check is not None:
            out = [f for f in out if f.check == check]
        return out

    def clear_findings(self) -> None:
        with self._reg_lock:
            self._findings.clear()
            self._fingerprints.clear()

    def report(self) -> str:
        """Human-readable report grouped by check, one block per check."""
        found = self.findings()
        if not found:
            return "figaro-san: no findings"
        by_check: dict[str, list[SanFinding]] = {}
        for f in found:
            by_check.setdefault(f.check, []).append(f)
        lines = [f"figaro-san: {len(found)} finding(s)"]
        for check in sorted(by_check):
            lines.append(f"-- {check} ({len(by_check[check])}) --")
            lines.extend(f.render() for f in by_check[check])
        return "\n".join(lines)

    # -- shadow-dispatch marker ---------------------------------------------

    def shadow_active(self) -> bool:
        return getattr(self._tls, "in_shadow", False)

    def set_shadow(self, active: bool) -> None:
        self._tls.in_shadow = active


STATE = SanitizerState()


def env_enabled(environ: dict[str, str] | None = None) -> bool:
    val = (environ if environ is not None else os.environ).get("FIGARO_SAN", "")
    return val.strip().lower() in ("1", "true", "yes", "on")


def iter_checks() -> Iterable[str]:
    return ("race", "lock-order", "thread", "retrace", "numerics")
