"""FGT003 — hardcoded narrowing dtype literals where dtype must derive
from inputs (the port's counterpart of the JAX package's FIG003).

The paper's accuracy claim (errors on par with database size, not join size)
survives only because the pipeline never silently narrows: data rides in the
caller's I/O dtype end to end, accumulators widen via the one approved idiom

    acc = torch.float64 if x.dtype == torch.float64 else torch.float32

and join counts accumulate in float64 no matter what (float32 rounds exact
counts past 2^24). Inside the port's ``core/`` and ``kernels/`` this rule
flags every narrowing float literal (``torch.float32`` / ``float16`` /
``bfloat16`` / ``half`` / ``float``, and numpy's ``float32`` / ``float16``)
in a function *body*, with four deliberate outs:

  * keyword defaults in a signature (``dtype=torch.float32`` is the
    documented I/O policy surface — the caller chooses);
  * the accumulator idiom above (a conditional expression whose branches
    are both dtype attributes);
  * comparisons and membership tests (``dtype not in (torch.float32,
    torch.float64)`` reads a dtype, it makes none);
  * module-level tables (a kernel's dtype codes and tile shapes, outside
    any function body).

``float64`` and integer dtypes are never a narrowing drift. In
``core/counts.py`` even the outs are closed: any sub-f64 float literal is an
error (count accumulation narrower than f64).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

_NARROWING = {
    "torch": frozenset({"float32", "float16", "bfloat16", "half", "float"}),
    "numpy": frozenset({"float32", "float16"}),
}


def _in_scope(rel: str | None) -> bool:
    return rel is not None and rel.startswith(("core/", "kernels/"))


def _dtype_module(ctx: FileContext, node: ast.AST) -> str | None:
    """"torch" / "numpy" when ``node`` is ``<that module>.<attr>``."""
    if not isinstance(node, ast.Attribute):
        return None
    dotted = ctx.resolve(node)
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    return head if head in _NARROWING and "." not in rest else None


def _narrowing_dtype(ctx: FileContext, node: ast.AST) -> str | None:
    """"torch.float32" for a resolved narrowing dtype literal, else None."""
    head = _dtype_module(ctx, node)
    if head is None or node.attr not in _NARROWING[head]:
        return None
    return f"{head}.{node.attr}"


def _function_bodies(tree: ast.Module) -> set[int]:
    """ids of every node inside a function body (signatures excluded)."""
    inside: set[int] = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in fn.body:
                inside.update(id(n) for n in ast.walk(stmt))
        elif isinstance(fn, ast.Lambda):
            inside.update(id(n) for n in ast.walk(fn.body))
    return inside


class DtypeDriftRule(Rule):
    rule_id = "FGT003"
    severity = Severity.ERROR
    fix_hint = ("derive the dtype from the input (x.dtype) or widen via the "
                "accumulator idiom `torch.float64 if x.dtype == "
                "torch.float64 else torch.float32`")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        rel = port_path(ctx.path)
        if not _in_scope(rel):
            return
        counts_file = rel == "core/counts.py"
        bodies = _function_bodies(ctx.tree)
        allowed = set() if counts_file else self._allowed_nodes(ctx)
        for node in ast.walk(ctx.tree):
            dotted = _narrowing_dtype(ctx, node)
            if dotted is None:
                continue
            if counts_file:
                yield self.finding(
                    ctx, node,
                    f"count accumulation uses `{dotted}` — counts must "
                    f"accumulate in float64 (float32 is exact only to 2^24)",
                    fix_hint="use torch.float64 / np.float64 for all count "
                             "arithmetic")
            elif id(node) in bodies and id(node) not in allowed:
                yield self.finding(
                    ctx, node,
                    f"hardcoded narrowing dtype `{dotted}` in a function "
                    f"body — the I/O-dtype policy derives dtypes from "
                    f"inputs")

    def _allowed_nodes(self, ctx: FileContext) -> set[int]:
        """ids of dtype-literal nodes sitting in an approved context."""
        allowed: set[int] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.IfExp):
                # The accumulator idiom: both branches dtype attributes.
                if (_dtype_module(ctx, node.body)
                        and _dtype_module(ctx, node.orelse)):
                    allowed.add(id(node.body))
                    allowed.add(id(node.orelse))
            elif isinstance(node, ast.Compare):
                # `x.dtype == torch.float64`, `dtype in (...)`: reads.
                for sub in [node.left] + list(node.comparators):
                    allowed.update(id(s) for s in ast.walk(sub))
        return allowed
