"""FGT007 — the port's threads and locks must route through its sanitizer
(the port's counterpart of the JAX package's FIG007).

The runtime sanitizer (`repro_torch.sanitizer`) can only observe what goes
through its wrappers: a raw ``threading.Lock()`` in the serving stack is
invisible to the lock-order graph and the lockset race detector, so one
forgotten conversion silently blinds it on exactly the code most likely to
race. This rule pins the routing: no ``threading.Thread`` / ``Lock`` /
``RLock`` / ``Condition`` may be named anywhere in ``repro_torch/`` — not
called, not referenced, not imported by name — except through the
sanitizer-aware equivalents (`repro_torch.sanitizer.locks.san_lock` /
``san_rlock`` / ``san_condition``, `repro_torch.sanitizer.threads.san_thread`).

Scope is ``repro_torch/`` without ``repro_torch/sanitizer/`` (the wrappers
are implemented over the raw primitives). Tests, tools and ``chip_smoke.py``
may use raw threading freely. Thread-safe primitives the sanitizer does not
model (``Event``, ``Semaphore``, ``local``, ``queue.Queue``) are not
restricted.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

_WRAPPED = {
    "Thread": "repro_torch.sanitizer.threads.san_thread",
    "Lock": "repro_torch.sanitizer.locks.san_lock",
    "RLock": "repro_torch.sanitizer.locks.san_rlock",
    "Condition": "repro_torch.sanitizer.locks.san_condition",
}


def _in_scope(rel: str | None) -> bool:
    return rel is not None and not rel.startswith("sanitizer/")


class SanRoutingRule(Rule):
    rule_id = "FGT007"
    severity = Severity.ERROR
    fix_hint = ("construct through the sanitizer-aware wrapper instead "
                "(repro_torch.sanitizer.locks.san_lock/san_rlock/"
                "san_condition, repro_torch.sanitizer.threads.san_thread) so "
                "the race detector can observe it")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_scope(port_path(ctx.path)):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "threading":
                for a in node.names:
                    if a.name in _WRAPPED:
                        yield self._raw(ctx, node, f"threading.{a.name}")
            elif isinstance(node, ast.Attribute) \
                    and node.attr in _WRAPPED \
                    and ctx.resolve(node) == f"threading.{node.attr}":
                yield self._raw(ctx, node, f"threading.{node.attr}")

    def _raw(self, ctx, node, dotted: str) -> Finding:
        return self.finding(
            ctx, node,
            f"`{dotted}` bypasses the sanitizer wrappers — use "
            f"`{_WRAPPED[dotted.rsplit('.', 1)[1]]}` so the runtime race "
            f"detector can see it")
