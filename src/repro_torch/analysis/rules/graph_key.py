"""FGT002 — the engine's graph key must cover every option its body reads
(the port's counterpart of the JAX package's FIG002 retrace-hazard).

The port's engine keys each cached signature, and the CUDA graph captured
for it, by the kind and ``options[k] for k in self._STATIC[kind]``
(`core/engine.py`, `FigaroEngine._run`). What the body does with an option
is frozen into the graph at capture. So an option that ``_body`` reads but
``_STATIC`` omits is worse than a JAX retrace: a later call with another
value of it finds the same key and replays the graph captured for the old
value — a silent wrong answer. This rule checks the table against the code
that reads it, per kind:

  * every ``options["x"]`` / ``options.get("x")`` that ``_body`` reads on a
    path a kind takes (branches on ``kind`` are followed: ``if
    kind.startswith("r0"): return r0`` ends the r0 kinds' path) is named
    in that kind's ``_STATIC`` entry;
  * every option the eager ``_tail`` reads for a kind (``k``, ``center``,
    ``label_col``, ``ridge``) is named there too: the tail runs outside
    the graph, but the signature cache keys on the same table;
  * every kind a public method (``qr``, ``svd``, ``pca``,
    ``least_squares``, ``r0``) dispatches through ``self._dispatch(kind,
    ...)`` is in ``_STATIC``, and every name of its entry is passed to the
    dispatch as a keyword that is a parameter of that method (else the key
    lookup fails, or no caller can set the option).

An option passed whole (``f(options)``) to a method of the class is
followed into it; passed anywhere else, it is reported, since the key can
no longer be checked.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

_TABLE = "_STATIC"
_BODY, _TAIL = "_body", "_tail"
_OPTIONS, _KIND = "options", "kind"
_STR_METHODS = frozenset({"removesuffix", "removeprefix"})


def _str_tuples(tree: ast.Module) -> dict[str, frozenset[str]]:
    """Module-level ``NAME = ("a", "b") [+ OTHER]`` string tuples."""
    out: dict[str, frozenset[str]] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            names = _names(stmt.value, out)
            if names is not None:
                out[stmt.targets[0].id] = names
    return out


def _names(node: ast.AST, consts: dict) -> frozenset[str] | None:
    """The strings of a tuple/list literal, a module constant, or a sum of
    them; None when not statically known."""
    if isinstance(node, (ast.Tuple, ast.List)):
        if all(isinstance(e, ast.Constant) and isinstance(e.value, str)
               for e in node.elts):
            return frozenset(e.value for e in node.elts)
        return None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _names(node.left, consts), _names(node.right, consts)
        if left is not None and right is not None:
            return left | right
    return None


def _table(cls: ast.ClassDef, consts: dict) -> dict | None:
    """kind -> (key node, its option names or None)."""
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == _TABLE
                        for t in stmt.targets):
            return {k.value: (k, _names(v, consts))
                    for k, v in zip(stmt.value.keys, stmt.value.values)
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return None


# -- a tiny evaluator of the branches on `kind` ------------------------------

def _str(node: ast.AST, env: dict) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _STR_METHODS and len(node.args) == 1:
        recv, arg = _str(node.func.value, env), _str(node.args[0], env)
        if recv is not None and arg is not None:
            return getattr(recv, node.func.attr)(arg)
    return None


def _strs(node: ast.AST, env: dict) -> tuple[str, ...] | None:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = [_str(e, env) for e in node.elts]
        return None if None in vals else tuple(vals)
    val = _str(node, env)
    return None if val is None else (val,)


def _truth(node: ast.AST, env: dict) -> bool | None:
    """The test's value for this kind, or None when it does not depend on
    the kind alone."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        val = _truth(node.operand, env)
        return None if val is None else not val
    if isinstance(node, ast.BoolOp):
        vals = [_truth(v, env) for v in node.values]
        if isinstance(node.op, ast.And):
            if False in vals:
                return False
            return None if None in vals else True
        if True in vals:
            return True
        return None if None in vals else False
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in ("startswith", "endswith") \
            and len(node.args) == 1:
        recv, arg = _str(node.func.value, env), _strs(node.args[0], env)
        if recv is not None and arg is not None:
            return getattr(recv, node.func.attr)(arg)
    if isinstance(node, ast.Compare) and len(node.ops) == 1:
        left = _str(node.left, env)
        right = _strs(node.comparators[0], env)
        if left is None or right is None:
            return None
        op = node.ops[0]
        if isinstance(op, ast.Eq) and len(right) == 1:
            return left == right[0]
        if isinstance(op, ast.NotEq) and len(right) == 1:
            return left != right[0]
        if isinstance(op, ast.In):
            return left in right
        if isinstance(op, ast.NotIn):
            return left not in right
    return None


class _Reads:
    """The option reads of one method on the path one kind takes."""

    def __init__(self, cls_methods: dict, kind: str | None) -> None:
        self.methods = cls_methods
        self.kind = kind
        self.reads: list[tuple[str, ast.AST]] = []
        self.opaque: list[tuple[str, ast.AST]] = []
        self._seen: set[str] = set()

    def method(self, fn: ast.FunctionDef) -> None:
        params = [p.arg for p in fn.args.posonlyargs + fn.args.args
                  + fn.args.kwonlyargs]
        if _OPTIONS not in params or fn.name in self._seen:
            return
        self._seen.add(fn.name)
        env = {_KIND: self.kind} if _KIND in params and self.kind else {}
        self._walk(fn.body, env)

    def _walk(self, stmts: list[ast.stmt], env: dict) -> bool:
        """Collect along ``stmts``; True when every path ends here."""
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                self._exprs(stmt.test)
                val = _truth(stmt.test, env)
                if val is None:
                    ends = [self._walk(stmt.body, dict(env)),
                            self._walk(stmt.orelse, dict(env))]
                    if all(ends):
                        return True
                elif self._walk(stmt.body if val else stmt.orelse, env):
                    return True
                continue
            if isinstance(stmt, (ast.Return, ast.Raise)):
                self._exprs(stmt)
                return True
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                self._exprs(stmt.value)
                val = _str(stmt.value, env)
                if val is None:
                    env.pop(stmt.targets[0].id, None)
                else:
                    env[stmt.targets[0].id] = val
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._exprs(child)
            bodies = [getattr(stmt, f, None) for f in
                      ("body", "orelse", "finalbody")]
            bodies += [h.body for h in getattr(stmt, "handlers", [])]
            for body in bodies:
                if isinstance(body, list) and body \
                        and isinstance(body[0], ast.stmt):
                    if self._walk(body, dict(env)) \
                            and isinstance(stmt, (ast.With, ast.AsyncWith)):
                        return True
        return False

    def _exprs(self, root: ast.AST) -> None:
        for node in ast.walk(root):
            if isinstance(node, ast.Subscript) \
                    and _is_options(node.value) \
                    and isinstance(node.ctx, ast.Load):
                key = node.slice
                if isinstance(key, ast.Constant) and isinstance(key.value,
                                                                str):
                    self.reads.append((key.value, node))
                else:
                    self.opaque.append(("a computed key", node))
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr == "get" \
                        and _is_options(func.value):
                    if node.args and isinstance(node.args[0], ast.Constant):
                        self.reads.append((node.args[0].value, node))
                    else:
                        self.opaque.append(("a computed key", node))
                    continue
                whole = [a for a in node.args if _is_options(a)] + [
                    kw.value for kw in node.keywords
                    if _is_options(kw.value)]
                if whole:
                    self._follow(node)

    def _follow(self, call: ast.Call) -> None:
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) \
            and isinstance(func.value, ast.Name) \
            and func.value.id == "self" else None
        fn = self.methods.get(name) if name else None
        if fn is None:
            try:
                text = ast.unparse(func)
            except Exception:  # pragma: no cover - unparse is total on 3.9+
                text = "a callee"
            self.opaque.append((f"`{text}` (passed whole)", call))
            return
        self.method(fn)


def _is_options(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == _OPTIONS


def _dispatched_kinds(node: ast.AST) -> tuple[str, ...] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, ast.IfExp):
        a, b = _dispatched_kinds(node.body), _dispatched_kinds(node.orelse)
        if a is not None and b is not None:
            return a + b
    return None


class GraphKeyRule(Rule):
    rule_id = "FGT002"
    severity = Severity.ERROR
    fix_hint = ("name the option in the kind's `_STATIC` entry (it keys "
                "the signature cache and the captured graph), and pass it "
                "from the public method as a keyword of that method")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if port_path(ctx.path) is None:
            return
        consts = _str_tuples(ctx.tree)
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            table = _table(cls, consts)
            if table is None:
                continue
            methods = {m.name: m for m in cls.body
                       if isinstance(m, ast.FunctionDef)}
            for kind, (key, declared) in table.items():
                if declared is None:
                    yield self.finding(
                        ctx, key,
                        f"`{_TABLE}[{kind!r}]` is not a literal tuple of "
                        f"option names — the graph key cannot be checked")
                    continue
                yield from self._check_reads(ctx, methods, kind, declared)
            yield from self._check_public(ctx, methods, table)

    def _check_reads(self, ctx, methods, kind: str,
                     declared: frozenset[str]) -> Iterator[Finding]:
        for name, where in ((_BODY, "is frozen into the captured graph, "
                                    "so a graph captured for one value of "
                                    "it replays for another"),
                            (_TAIL, "runs eagerly, but the signature "
                                    "cache keys on the same table")):
            fn = methods.get(name)
            if fn is None:
                continue
            reads = _Reads(methods, kind)
            reads.method(fn)
            for option, node in reads.reads:
                if option not in declared:
                    yield self.finding(
                        ctx, node,
                        f"`{name}` reads option {option!r} for kind "
                        f"{kind!r}, which `{_TABLE}[{kind!r}]` omits — what "
                        f"`{name}` does with it {where}")
            for what, node in reads.opaque:
                yield self.finding(
                    ctx, node,
                    f"`{name}` reads the options through {what} for kind "
                    f"{kind!r} — the graph key cannot be checked against "
                    f"what it reads")

    def _check_public(self, ctx, methods, table) -> Iterator[Finding]:
        for fn in methods.values():
            if fn.name.startswith("_"):
                continue
            a = fn.args
            params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "_dispatch"
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "self" and call.args):
                    continue
                kinds = _dispatched_kinds(call.args[0])
                if kinds is None or any(kw.arg is None
                                        for kw in call.keywords):
                    continue  # computed kind or **splat: not checkable
                passed = {kw.arg for kw in call.keywords}
                for kind in kinds:
                    if kind not in table:
                        yield self.finding(
                            ctx, call,
                            f"`{fn.name}` dispatches kind {kind!r}, which "
                            f"`{_TABLE}` does not list")
                        continue
                    declared = table[kind][1] or frozenset()
                    for option in sorted(declared - passed):
                        yield self.finding(
                            ctx, call,
                            f"`{fn.name}` dispatches {kind!r} without "
                            f"option {option!r}, which `{_TABLE}[{kind!r}]` "
                            f"keys on — the key lookup fails")
                    for option in sorted((declared & passed) - params):
                        yield self.finding(
                            ctx, call,
                            f"option {option!r} of `{_TABLE}[{kind!r}]` is "
                            f"not a keyword of `{fn.name}` — no caller can "
                            f"set what the graph key holds")
