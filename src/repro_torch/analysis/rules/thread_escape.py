"""FGT006 — cross-thread escape: shared mutable attrs must be READ under
the lock too (a copy of the JAX package's FIG006, scoped to
``repro_torch/``).

FGT005 checks *writes*; the bugs it structurally cannot see are unlocked
**reads** of shared mutable state — a ``stats()`` that reads two counters
outside the lock can observe a torn pair, and an unlocked
``if self._threads is not None`` double-check races the locked writer. This
rule closes that gap for the same class population FGT005 covers (classes
whose ``__init__`` creates a lock attribute):

every attribute of such a class that is **mutable** (written or mutated
outside ``__init__``) must be read/mutated only

  * lexically inside a ``with self.<lock>`` region (any of the class's
    locks, matching FGT005's approximation — the runtime sanitizer checks
    the *right* lock), or
  * in a private method whose every in-class call site is lock-held
    (a small interprocedural fixed point: ``_evict_lru`` is only called
    from ``_dispatch``'s locked region, so its accesses count as locked), or
  * via an attribute that is exempt: immutable (only ever assigned in
    ``__init__``), constructed from a thread-safe factory
    (``queue.Queue``, ``threading.Event`` / ``Semaphore``, locks), or
    explicitly annotated in a class-level ``_san_atomic`` tuple (the same
    annotation the runtime race detector honours).

Methods whose bound reference escapes (``Thread(target=self._loop)``) are
thread entries and never inherit a caller's lock. Writes are *not*
re-reported here — they stay FGT005's finding.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path
from .lock_discipline import (_EXEMPT_METHODS, _LOCK_FACTORIES,
                              _lock_attrs, _self_attr_target)

#: Constructors whose instances are internally synchronized — attributes
#: bound to one of these in __init__ may be used lock-free. Locks are listed
#: too: the lock attributes themselves are never findings.
_THREADSAFE_FACTORIES = _LOCK_FACTORIES | frozenset({
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
    "Event", "Semaphore", "BoundedSemaphore", "Barrier", "local",
    "finalize",
})

#: Method names that mutate their receiver in place — `self.x.append(...)`
#: on a plain container is a mutation of shared state.
_MUTATORS = frozenset({
    "add", "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "setdefault",
    "move_to_end", "sort", "reverse", "subtract",
})


@dataclasses.dataclass
class _Access:
    method: str
    attr: str
    kind: str          # "read" | "mutcall"
    locked: bool       # lexically, at the access site
    node: ast.AST


@dataclasses.dataclass
class _ClassFacts:
    locks: set[str]
    methods: set[str]
    atomic: set[str]
    init_factories: dict[str, str]          # attr -> factory base name
    mutated_outside_init: set[str]
    accesses: list[_Access]
    call_sites: dict[str, list[tuple[bool, str]]]  # callee -> (locked, caller)
    thread_entries: set[str]


def _base_callee(ctx: FileContext, call: ast.Call) -> str:
    dotted = ctx.resolve(call.func)
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def _atomic_attrs(cls: ast.ClassDef) -> set[str]:
    """Class-level ``_san_atomic = ("attr", ...)`` literal annotation."""
    out: set[str] = set()
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_san_atomic"
                for t in stmt.targets):
            if isinstance(stmt.value, (ast.Tuple, ast.List, ast.Set)):
                out |= {e.value for e in stmt.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)}
    return out


def _init_factories(ctx: FileContext, cls: ast.ClassDef) -> dict[str, str]:
    out: dict[str, str] = {}
    for stmt in cls.body:
        if not (isinstance(stmt, ast.FunctionDef)
                and stmt.name == "__init__"):
            continue
        for node in ast.walk(stmt):
            value = getattr(node, "value", None)
            if not (isinstance(node, (ast.Assign, ast.AnnAssign))
                    and isinstance(value, ast.Call)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            base = _base_callee(ctx, value)
            for tgt in targets:
                attr = _self_attr_target(tgt)
                if attr is not None and attr not in out:
                    out[attr] = base
    return out


def _iter_own_exprs(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Expression nodes evaluated BY this statement (child statements and
    deferred bodies — nested defs, lambdas — excluded; comprehensions run
    eagerly, so their subtrees are included)."""
    stack = [c for c in ast.iter_child_nodes(stmt)
             if not isinstance(c, (ast.stmt, ast.ExceptHandler,
                                   ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda))
             and not (hasattr(ast, "match_case")
                      and isinstance(c, ast.match_case))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Lambda, ast.stmt)):
                continue
            stack.append(child)


class _MethodScanner:
    """One pass over a method body, FGT005-style lexical lock tracking."""

    def __init__(self, ctx: FileContext, facts: _ClassFacts,
                 method: ast.FunctionDef) -> None:
        self.ctx = ctx
        self.facts = facts
        self.method = method.name
        self.in_init = method.name in _EXEMPT_METHODS
        for stmt in method.body:
            self._walk(stmt, locked=False)

    def _walk(self, stmt: ast.stmt, locked: bool) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            holds = locked or self._with_holds_lock(stmt)
            for item in stmt.items:
                self._scan_expr_tree(item.context_expr, locked)
            for inner in stmt.body:
                self._walk(inner, holds)
            return
        self._record_writes(stmt)
        for expr in [stmt]:
            self._scan_stmt_exprs(expr, locked)
        for inner in ast.iter_child_nodes(stmt):
            if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue  # deferred bodies: their own thread story
            if isinstance(inner, ast.stmt):
                self._walk(inner, locked)
            elif isinstance(inner, ast.ExceptHandler) or (
                    hasattr(ast, "match_case")
                    and isinstance(inner, ast.match_case)):
                for s in inner.body:
                    self._walk(s, locked)

    def _with_holds_lock(self, stmt) -> bool:
        for item in stmt.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            attr = _self_attr_target(expr)
            if attr in self.facts.locks:
                return True
        return False

    def _record_writes(self, stmt: ast.stmt) -> None:
        """Attrs written/augmented by this statement — FGT005's territory;
        here they only mark the attr as mutable."""
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, ast.AugAssign):
            targets = [stmt.target]
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        for tgt in targets:
            for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                      else [tgt]):
                attr = _self_attr_target(t)
                if attr is not None and not self.in_init:
                    self.facts.mutated_outside_init.add(attr)

    # -- expression scanning -------------------------------------------------

    def _scan_stmt_exprs(self, stmt: ast.stmt, locked: bool) -> None:
        consumed = self._write_value_nodes(stmt)
        for node in _iter_own_exprs(stmt):
            self._visit_expr(node, locked, consumed)

    def _scan_expr_tree(self, expr: ast.AST, locked: bool) -> None:
        stack, consumed = [expr], set()
        while stack:
            node = stack.pop()
            self._visit_expr(node, locked, consumed)
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.Lambda, ast.stmt)):
                    stack.append(child)

    @staticmethod
    def _write_value_nodes(stmt: ast.stmt) -> set[int]:
        """The ``self.attr`` Load nodes that are really write receivers —
        ``self._jitted[key] = fn`` loads `_jitted` to store into it; that is
        FGT005's write, not a FGT006 read."""
        out: set[int] = set()
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        for tgt in targets:
            for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                      else [tgt]):
                if isinstance(t, ast.Subscript):
                    t = t.value
                if isinstance(t, ast.Attribute):
                    out.add(id(t))
        return out

    def _visit_expr(self, node: ast.AST, locked: bool,
                    consumed: set[int]) -> None:
        facts = self.facts
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id == "self" \
                    and node.func.attr in facts.methods:
                # self.method(...) — a call site, not a state access.
                facts.call_sites.setdefault(node.func.attr, []).append(
                    (locked, self.method))
                consumed.add(id(node.func))
                return
            attr = _self_attr_target(recv)
            if attr is not None and node.func.attr in _MUTATORS:
                consumed.add(id(node.func))
                consumed.add(id(recv))
                if not self.in_init:
                    facts.mutated_outside_init.add(attr)
                    facts.accesses.append(_Access(
                        self.method, attr, "mutcall", locked, node))
                return
        if isinstance(node, ast.Attribute) and id(node) not in consumed \
                and isinstance(node.ctx, ast.Load):
            attr = _self_attr_target(node)
            if attr is None:
                return
            if attr in facts.methods:
                # A bound-method reference escaping (Thread target etc.):
                # that method can run on any thread, unlocked.
                facts.thread_entries.add(attr)
                return
            if not self.in_init:
                facts.accesses.append(_Access(
                    self.method, attr, "read", locked, node))


def _collect(ctx: FileContext, cls: ast.ClassDef) -> _ClassFacts | None:
    locks = _lock_attrs(ctx, cls)
    if not locks:
        return None
    methods = {m.name for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    facts = _ClassFacts(
        locks=locks, methods=methods, atomic=_atomic_attrs(cls),
        init_factories=_init_factories(ctx, cls),
        mutated_outside_init=set(), accesses=[], call_sites={},
        thread_entries=set())
    for method in cls.body:
        if isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _MethodScanner(ctx, facts, method)
    return facts


def _locked_methods(facts: _ClassFacts) -> set[str]:
    """Fixed point: private methods whose every in-class call site runs with
    a lock held (lexically, or from an already-locked method)."""
    locked: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name in facts.methods:
            if not name.startswith("_") or name.startswith("__"):
                continue  # public/dunder methods are callable from anywhere
            if name in locked or name in facts.thread_entries:
                continue
            sites = facts.call_sites.get(name)
            if not sites:
                continue
            if all(lex or caller in locked for lex, caller in sites):
                locked.add(name)
                changed = True
    return locked


class ThreadEscapeRule(Rule):
    rule_id = "FGT006"
    severity = Severity.ERROR
    fix_hint = ("read the attribute under its owning lock (`with "
                "self._lock:`), make it immutable (assign only in __init__), "
                "bind it to a thread-safe type (queue.Queue, Event, "
                "Semaphore), or annotate it in a class-level `_san_atomic` "
                "tuple if the lock-free access is intentional")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if port_path(ctx.path) is None:
            return
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            facts = _collect(ctx, cls)
            if facts is None:
                continue
            locked_methods = _locked_methods(facts)
            if self.program is not None:
                # The fixed point above assumes a private method's callers
                # are all in-class. figaro-flow makes that a real query:
                # any `X.method` reference outside the class (another
                # module poking the helper) voids the locked-helper
                # exemption for that method.
                locked_methods = {
                    m for m in locked_methods
                    if not self.program.external_method_refs(cls, m)}
            for acc in facts.accesses:
                if acc.locked or acc.method in locked_methods:
                    continue
                attr = acc.attr
                if attr in facts.locks or attr in facts.atomic:
                    continue
                if attr not in facts.mutated_outside_init:
                    continue  # immutable after construction: safe to read
                if facts.init_factories.get(attr) in _THREADSAFE_FACTORIES:
                    continue
                verb = ("reads" if acc.kind == "read"
                        else "mutates (in place)")
                yield self.finding(
                    ctx, acc.node,
                    f"{cls.name}.{acc.method} {verb} shared mutable "
                    f"`self.{attr}` outside a `with self.<lock>` region "
                    f"(locks: {', '.join(sorted(facts.locks))}) — "
                    f"cross-thread escape")
