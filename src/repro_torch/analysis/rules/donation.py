"""FGT011 — a request buffer read again after a donating engine dispatch
(a copy of the JAX package's FIG011, scoped to ``repro_torch/``).

`FigaroEngine` takes the request tensors of every dispatch as its own when
constructed with ``donate_data=True`` (the default): the dispatch owns them
from the call on, drops its references once the body or the graph's
copy-in has read them (it empties its list of them), and a serving queue
recycles such buffers. A caller that reads its request list again, or
dispatches it a second time, relies on buffers the contract gave away. This
rule proves that misuse over the AST:

  * a dispatch call (``engine.r0/qr/svd/pca/least_squares/_dispatch``) whose
    receiver is *provably donating* — a local/module name assigned
    ``FigaroEngine(...)`` without ``donate_data=False`` — and whose data
    argument is a plain name;
  * followed by any load of that name along some path: a later statement
    without an intervening rebind/del, or the dispatch sits in a loop that
    never rebinds the buffer, so iteration two re-dispatches the consumed
    requests.

Receivers built with ``donate_data=False``, from ``default_engine()`` /
``default_session()`` (both non-donating by construction), or not resolvable
to a donating constructor are skipped: the rule proves real misuse, it does
not guess.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

#: dispatch method -> index of the donated data argument in call.args.
_DATA_ARG = {"r0": 1, "qr": 1, "svd": 1, "pca": 1, "least_squares": 2,
             "_dispatch": 2}

#: Constructors/factories that yield a NON-donating engine.
_NON_DONATING = frozenset({"default_engine", "default_session"})


def _donating_names(fn: ast.AST, tree: ast.Module) -> set[str]:
    """Names bound (in this function or at module level) to a donating
    `FigaroEngine(...)` — `donate_data=False` and known non-donating
    factories disqualify."""
    out: set[str] = set()
    scopes: list[ast.AST] = [fn]
    scopes.extend(s for s in tree.body if isinstance(s, ast.Assign))
    for scope in scopes:
        for node in ast.walk(scope):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = node.value.func
            cname = callee.attr if isinstance(callee, ast.Attribute) \
                else (callee.id if isinstance(callee, ast.Name) else "")
            name = node.targets[0].id
            if cname == "FigaroEngine":
                donate = True
                for kw in node.value.keywords:
                    if kw.arg == "donate_data" \
                            and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is False:
                        donate = False
                if donate:
                    out.add(name)
                else:
                    out.discard(name)
            elif cname in _NON_DONATING:
                out.discard(name)
    return out


def _data_name(call: ast.Call, kind: str) -> ast.Name | None:
    for kw in call.keywords:
        if kw.arg == "data":
            return kw.value if isinstance(kw.value, ast.Name) else None
    idx = _DATA_ARG[kind]
    if len(call.args) > idx and isinstance(call.args[idx], ast.Name):
        arg = call.args[idx]
        return arg if not isinstance(arg, ast.Starred) else None
    return None


def _bind_lines(fn: ast.AST, name: str) -> list[int]:
    """Lines where ``name`` is (re)bound or deleted — a rebind between the
    dispatch and a later read means the read sees a fresh buffer."""
    out: list[int] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                          else [t]):
                    if isinstance(e, ast.Name) and e.id == name:
                        out.append(node.lineno)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            t = node.target
            for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                      else [t]):
                if isinstance(e, ast.Name) and e.id == name:
                    out.append(node.lineno)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    out.append(node.lineno)
    return sorted(out)


class DonationRule(Rule):
    rule_id = "FGT011"
    severity = Severity.ERROR
    fix_hint = ("rebind the buffer before reuse (fresh batch per dispatch), "
                "copy it first (`[d.clone() for d in x]`), or build the "
                "engine with "
                "donate_data=False if the caller must keep its inputs")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if port_path(ctx.path) is None:
            return
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_function(ctx, fn)

    def _check_function(self, ctx: FileContext, fn) -> Iterator[Finding]:
        donating = _donating_names(fn, ctx.tree)
        if not donating:
            return
        loops = _loop_map(fn)
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in _DATA_ARG):
                continue
            recv = call.func.value
            if not (isinstance(recv, ast.Name) and recv.id in donating):
                continue
            data = _data_name(call, call.func.attr)
            if data is None:
                continue
            yield from self._check_reuse(ctx, fn, loops, call, recv.id, data)

    def _check_reuse(self, ctx, fn, loops, call: ast.Call, engine: str,
                     data: ast.Name) -> Iterator[Finding]:
        name = data.id
        binds = _bind_lines(fn, name)
        call_end = getattr(call, "end_lineno", call.lineno)
        site = f"`{engine}.{call.func.attr}(...)`"

        # Path 1 — loop body that never rebinds the buffer: iteration 2
        # dispatches (and therefore reads) the already-donated slab.
        for loop in loops.get(id(call), ()):
            loop_end = getattr(loop, "end_lineno", loop.lineno)
            if not any(loop.lineno <= b <= loop_end for b in binds):
                yield self.finding(
                    ctx, call,
                    f"`{name}` is dispatched through {site}'s donated data "
                    f"position inside a loop that never rebinds it — the "
                    f"buffer is consumed on iteration 1 and re-read on "
                    f"iteration 2")
                return  # one finding per call site is enough

        # Path 2 — straight-line read after the dispatch without a rebind.
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Name) and node.id == name
                    and isinstance(node.ctx, ast.Load)
                    and node.lineno > call_end):
                continue
            if any(call_end < b <= node.lineno for b in binds):
                continue
            yield self.finding(
                ctx, call,
                f"`{name}` is read at line {node.lineno} after being passed "
                f"through {site}'s donated data position — the dispatch "
                f"owns the requests it was given")
            return


def _loop_map(fn: ast.AST) -> dict[int, list[ast.AST]]:
    """id(call) -> enclosing For/While loops, innermost last."""
    out: dict[int, list[ast.AST]] = {}

    def walk(node: ast.AST, stack: list[ast.AST]) -> None:
        if isinstance(node, ast.Call):
            out[id(node)] = list(stack)
        push = isinstance(node, (ast.For, ast.AsyncFor, ast.While))
        if push:
            stack = stack + [node]
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            walk(child, stack)

    walk(fn, [])
    return out
