"""figaro-san: the runtime sanitizer layer (dynamic counterpart to figaro-lint).

Three checks, all off by default and enabled together by ``FIGARO_SAN=1`` in
the environment or :func:`enable`:

* **race** (`races`, `locks`, `threads`) — instrumented lock wrappers and a
  lockset detector: per-thread lock-order graph with cycle (potential
  deadlock) findings, plus cross-thread shared-attribute access without the
  owning lock held, on the classes that declare ``@shared_state``.
* **retrace** (`retrace`) — every engine signature miss records its
  dispatch signature and trimmed call stack; steady-state mode turns any
  further miss into a finding that names the diverged signature component.
* **numerics** (`numerics`) — sampled float64 shadow dispatch asserting the
  observed error against the paper's database-size rounding-error budget,
  plus NaN/Inf tripwires on dispatch outputs.

Disabled cost is one attribute read per instrumentation site (the race
hooks are physically removed from the classes). Everything imported here is
stdlib-only; `numerics` (the one torch-dependent module) is imported lazily
by the engine. A copy of the JAX package's `repro.sanitizer` for the port,
with a state of its own: enabling one package's sanitizer leaves the
other's off.
"""

from __future__ import annotations

from . import _state, retrace
from ._state import STATE, SanFinding, env_enabled
from .locks import (SanCondition, SanLock, reset_order_graph, san_condition,
                    san_lock, san_rlock)
from .races import shared_state
from .threads import san_thread

__all__ = [
    "STATE", "SanFinding", "enable", "disable", "enabled", "reset",
    "findings", "report", "san_lock", "san_rlock", "san_condition",
    "san_thread", "shared_state", "SanLock", "SanCondition",
    "expect_no_retrace",
]

expect_no_retrace = retrace.expect_no_retrace


def enabled() -> bool:
    return STATE.enabled


def enable(*, race: bool = True, retrace_check: bool = True,
           numerics: bool = True, sample_every: int | None = None,
           slack: float | None = None) -> None:
    """Turn the sanitizer on (installing the race-detector class hooks)."""
    from . import races

    STATE.race = race
    STATE.retrace = retrace_check
    STATE.numerics = numerics
    if sample_every is not None:
        STATE.sample_every = int(sample_every)
    if slack is not None:
        STATE.numerics_slack = float(slack)
    STATE.enabled = True
    if race:
        races.install()


def disable() -> None:
    """Turn the sanitizer off and remove the race-detector class hooks."""
    from . import races

    STATE.enabled = False
    races.uninstall()


def reset() -> None:
    """Clear findings and observation state (keeps the enabled flag)."""
    from . import races

    STATE.clear_findings()
    races.reset_observations()
    reset_order_graph()
    retrace.reset()
    from . import numerics as _numerics

    _numerics.reset()


def findings(check: str | None = None) -> list[SanFinding]:
    return STATE.findings(check)


def report() -> str:
    return STATE.report()


if env_enabled():  # FIGARO_SAN=1: arm everything at import time
    enable()
