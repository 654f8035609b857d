"""FGT010 — side effects inside a CUDA-graph capture (the port's
counterpart of the JAX package's FIG010, whose regions are jit traces).

A captured body runs its Python exactly once, at capture; every later call
replays the recorded kernels and runs none of it. Any side effect inside it
— ``self.attr = ...``, mutating a module global or closure container,
``print``, a counter bump, a draw from a global RNG — happens once per
capture, not per call. The symptom is a counter that stops counting once
the graph is captured (the reason `kernels/_platform.py` records launches
into `recording_launches` during a capture), a log line that appears once,
or random numbers frozen into the graph. figaro-flow's captured-context
marking makes the check direct: scan every captured function for
effectful statements.

Exemptions, in order of principle:

  * A lock does not exempt a write: under a capture a counter bumped under
    its lock still runs once per capture and never on replay. Only the
    port's memo caches are exempt, each by name (`_CACHES`) and only when
    written under a module-level lock: a kernel library built and loaded
    once per process (`kernels/_build.py`'s ``_libs`` and ``BUILD_LOG``)
    and the scan kernels' pinned error word, made on first use
    (`kernels/_seg_scan.py`'s ``_error``). Filling them once is their
    meaning, capture or not. The engine's own graph bookkeeping
    (``_graphs``, ``_warm``, ``_captures`` under its locks) runs in
    `_graph_r`/`_capture`, outside the captured region, and needs no
    exemption.
  * An explicit allowlist pins `_platform.count_launch` by qualified name:
    during a capture it counts into the thread's recorder, which the engine
    adds back on every replay.
  * Subscript stores whose base is function-local (parameters included) are
    fine: writes into local tensors and accumulator dicts are the captured
    computation itself, not an escaping effect.
  * ``self`` writes inside ``__init__``/``__post_init__``/``__new__``
    initialize a freshly constructed object, not shared state.
  * An RNG draw that names its generator (``generator=``) is the caller's
    stream, owned by the call.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path
from .thread_escape import _MUTATORS

#: Capture-time bookkeeping that is deliberate: a launch counted during a
#: capture goes to the capturing thread's recorder, which the engine adds to
#: the counts on every replay.
_ALLOWLIST = frozenset({
    "repro_torch.kernels._platform:count_launch",
})

#: (module, global) memo caches filled once per process under their
#: module's lock, wherever the first call comes from.
_CACHES = frozenset({
    ("repro_torch.kernels._build", "_libs"),
    ("repro_torch.kernels._build", "BUILD_LOG"),
    ("repro_torch.kernels._seg_scan", "_error"),
})

#: torch draws (functions and in-place methods) that take ``generator=``.
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})
#: numpy.random / random calls that make a generator rather than draw.
_RNG_MAKERS = frozenset({"default_rng", "Generator", "SeedSequence",
                         "RandomState", "PCG64", "Philox", "Random"})


def _root_name(node: ast.AST) -> ast.Name | None:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node if isinstance(node, ast.Name) else None


def _local_names(fn: ast.AST) -> set[str]:
    """Names bound in this function's own scope (params, assignments, loop
    and with targets, comprehension targets, nested def names) — excluding
    nested function bodies, which are their own captured functions."""
    out: set[str] = set()
    a = fn.args
    for p in (a.posonlyargs + a.args + a.kwonlyargs
              + ([a.vararg] if a.vararg else [])
              + ([a.kwarg] if a.kwarg else [])):
        out.add(p.arg)
    globals_decl: set[str] = set()

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(child.name)
                continue
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, (ast.Global, ast.Nonlocal)):
                globals_decl.update(child.names)
            if isinstance(child, ast.Name) and isinstance(child.ctx,
                                                          ast.Store):
                out.add(child.id)
            walk(child)

    walk(fn)
    return out - globals_decl


class CaptureEffectsRule(Rule):
    rule_id = "FGT010"
    severity = Severity.ERROR
    fix_hint = ("hoist the side effect out of the captured body (do it in "
                "the host-side dispatcher, per call), return the value "
                "instead of mutating shared state, or pass the RNG draw an "
                "explicit generator")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        return iter(())  # whole-program rule: see check_program

    def check_program(self, program) -> Iterator[Finding]:
        graph = program.graph
        for qname in sorted(graph.captured):
            fi = graph.functions[qname]
            if qname in _ALLOWLIST or port_path(fi.ctx.path) is None:
                continue
            mod = graph.modules[fi.module]
            scan = _EffectScanner(fi, mod, graph, _local_names(fi.node))
            chain = tuple(q.split(":", 1)[1]
                          for q in program.captured_chain(qname))
            via = f" (captured via {' -> '.join(chain)})" \
                if len(chain) > 1 else ""
            for node, what in scan.effects:
                yield self.finding(
                    fi.ctx, node,
                    f"`{fi.short}` {what} inside a CUDA-graph capture — "
                    f"the effect runs once per capture, not per call{via}",
                    traced_context=chain)


class _EffectScanner:
    """Lexical walk with a module-lock-held flag (for `_CACHES`)."""

    def __init__(self, fi, mod, graph, local: set[str]) -> None:
        self.fi = fi
        self.mod = mod
        self.graph = graph
        self.local = local
        # In a constructor, `self` IS the fresh local object.
        self.own_self = fi.node.name in ("__init__", "__post_init__",
                                         "__new__")
        self.effects: list[tuple[ast.AST, str]] = []
        for stmt in fi.node.body:
            self._walk(stmt, locked=False)

    def _walk(self, stmt: ast.stmt, locked: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            holds = locked or self._holds_lock(stmt)
            for inner in stmt.body:
                self._walk(inner, holds)
            return
        self._check_stmt(stmt, locked)
        for inner in ast.iter_child_nodes(stmt):
            if isinstance(inner, ast.stmt):
                self._walk(inner, locked)
            elif isinstance(inner, ast.ExceptHandler) or (
                    hasattr(ast, "match_case")
                    and isinstance(inner, ast.match_case)):
                for s in inner.body:
                    self._walk(s, locked)

    def _holds_lock(self, stmt) -> bool:
        return any(isinstance(item.context_expr, ast.Name)
                   and item.context_expr.id in self.mod.module_locks
                   for item in stmt.items)

    def _cache(self, node: ast.AST, locked: bool) -> bool:
        """A write to one of `_CACHES` of this module, under its lock."""
        root = _root_name(node)
        return locked and root is not None \
            and (self.fi.module, root.id) in _CACHES

    def _check_stmt(self, stmt: ast.stmt, locked: bool) -> None:
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for tgt in targets:
            for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                      else [tgt]):
                if not self._cache(t, locked):
                    self._check_target(t)
        for node in ast.walk(stmt) if isinstance(stmt, ast.Expr) else ():
            if isinstance(node, ast.Call):
                self._check_call(node, locked)
        # Calls buried in non-Expr statements (e.g. `x = log(print(y))`)
        # still matter for print/mutators:
        if not isinstance(stmt, ast.Expr):
            for node in _own_exprs(stmt):
                if isinstance(node, ast.Call):
                    self._check_call(node, locked)

    def _check_target(self, t: ast.AST) -> None:
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            if not self.own_self:
                self.effects.append((t, f"writes `self.{t.attr}`"))
            return
        if isinstance(t, ast.Name) and t.id not in self.local:
            self.effects.append((t, f"writes global/closure name `{t.id}`"))
            return
        if isinstance(t, (ast.Subscript, ast.Attribute)):
            root = _root_name(t)
            if root is not None and root.id == "self":
                if not self.own_self:
                    self.effects.append((t, "writes through `self`"))
            elif root is not None and root.id not in self.local:
                self.effects.append(
                    (t, f"mutates global/closure container `{root.id}`"))

    def _check_call(self, node: ast.Call, locked: bool) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "print":
            self.effects.append((node, "calls print()"))
            return
        draw = _rng_draw(self.graph, self.mod, node)
        if draw is not None:
            self.effects.append(
                (node, f"draws from a global RNG (`{draw}` without "
                       f"generator=)"))
            return
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
            recv = func.value
            if isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                self.effects.append(
                    (node, f"mutates `self.{recv.attr}` (.{func.attr})"))
                return
            root = _root_name(recv)
            if root is not None and root.id != "self" \
                    and root.id not in self.local \
                    and not self._cache(recv, locked):
                self.effects.append(
                    (node,
                     f"mutates global/closure `{root.id}` (.{func.attr})"))


def _own_exprs(stmt: ast.stmt):
    """Expressions evaluated by this statement itself (child statements and
    deferred bodies excluded)."""
    stack = [c for c in ast.iter_child_nodes(stmt)
             if isinstance(c, ast.expr) and not isinstance(c, ast.Lambda)]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr) \
                    and not isinstance(child, ast.Lambda):
                stack.append(child)


def _rng_draw(graph, mod, node: ast.Call) -> str | None:
    """The draw's name when ``node`` draws from a global RNG."""
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in _INPLACE_DRAWS:
        return f".{func.attr}()"
    dotted = graph.dotted(mod, func) or ""
    head, _, last = dotted.rpartition(".")
    if head == "torch" and last in _TORCH_DRAWS:
        return dotted
    if head in ("numpy.random", "random") and last not in _RNG_MAKERS:
        return dotted
    return None
