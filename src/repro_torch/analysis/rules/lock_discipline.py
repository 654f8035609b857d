"""FGT005 — lock-owning classes must write shared state under their lock
(a copy of the JAX package's FIG005, scoped to ``repro_torch/``).

`AsyncFigaroServer` dispatches from background threads while the owning
session keeps dispatching from the caller's thread; `PlanHolder` is shared by
a dataset and every server it spawns; `FigaroEngine`'s signature cache,
graphs and counters are hit from both; the serving link over a mesh
(`_MeshLink`) is shared by a server's threads. Every one of them constructs its locks in
``__init__`` and the concurrency story is exactly "mutations happen inside
``with self._lock``". A bare ``self.x = ...`` added to any other method is a
data race that no single-threaded test will ever catch.

The rule is structural, not name-based: any class whose ``__init__`` creates
a ``threading.Lock`` / ``RLock`` / ``Condition`` attribute is
lock-disciplined, and every attribute write on ``self`` outside ``__init__``
must sit lexically inside a ``with self.<that lock>`` block. Single-threaded
setup paths that deliberately skip the lock carry a line suppression with
the reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

#: Raw threading factories plus the sanitizer-aware wrappers
#: (`repro_torch.sanitizer.locks`) that FGT007 requires port code to use — a
#: class is lock-disciplined whichever spelling it constructs its locks with.
_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition",
                             "san_lock", "san_rlock", "san_condition"})
_EXEMPT_METHODS = frozenset({"__init__", "__new__", "__init_subclass__"})


def _self_attr_target(node: ast.AST) -> str | None:
    """"attr" when ``node`` writes ``self.attr`` or ``self.attr[...]``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lock_attrs(ctx: FileContext, cls: ast.ClassDef) -> set[str]:
    """Attributes assigned a threading lock/condition in __init__."""
    out: set[str] = set()
    for stmt in cls.body:
        if not (isinstance(stmt, ast.FunctionDef)
                and stmt.name == "__init__"):
            continue
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = ctx.resolve(node.value.func)
            base = callee.rsplit(".", 1)[-1] if callee else ""
            if base not in _LOCK_FACTORIES:
                continue
            for tgt in node.targets:
                attr = _self_attr_target(tgt)
                if attr is not None:
                    out.add(attr)
    return out


class LockDisciplineRule(Rule):
    rule_id = "FGT005"
    severity = Severity.ERROR
    fix_hint = ("wrap the write in `with self._lock:` (any of the class's "
                "__init__-created locks), or suppress with a reason if the "
                "path is provably single-threaded")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if port_path(ctx.path) is None:
            return
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(ctx, cls)
            if not locks:
                continue
            for method in cls.body:
                if not isinstance(method, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                    continue
                if method.name in _EXEMPT_METHODS:
                    continue
                yield from self._check_method(ctx, cls, method, locks)

    def _check_method(self, ctx, cls, method, locks) -> Iterator[Finding]:
        for stmt in method.body:
            yield from self._walk(ctx, cls, method, stmt, locks,
                                  locked=False)

    def _walk(self, ctx, cls, method, stmt, locks,
              locked: bool) -> Iterator[Finding]:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            holds = locked or self._with_holds_lock(stmt, locks)
            for inner in stmt.body:
                yield from self._walk(ctx, cls, method, inner, locks, holds)
            return
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
                if attr is not None and not locked:
                    yield self.finding(
                        ctx, stmt,
                        f"{cls.name}.{method.name} writes `self.{attr}` "
                        f"outside a `with self.<lock>` region "
                        f"(locks: {', '.join(sorted(locks))})")
        for inner in ast.iter_child_nodes(stmt):
            if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue  # nested defs run later, on their own thread story
            if isinstance(inner, ast.stmt):
                yield from self._walk(ctx, cls, method, inner, locks, locked)
            elif isinstance(inner, ast.ExceptHandler) or (
                    hasattr(ast, "match_case")
                    and isinstance(inner, ast.match_case)):
                for s in inner.body:
                    yield from self._walk(ctx, cls, method, s, locks, locked)

    @staticmethod
    def _with_holds_lock(stmt, locks) -> bool:
        for item in stmt.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            attr = _self_attr_target(expr)
            if attr in locks:
                return True
        return False
