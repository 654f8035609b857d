"""FGT008 — the port's import boundaries (the port's counterpart of the JAX
package's FIG008, which keeps that package's planner jax-free).

Three boundaries, each a line the port's users rely on:

  * nothing under ``repro_torch/`` imports ``jax``, ``jaxlib`` or the JAX
    package ``repro``: the port runs on an install with torch alone, and
    keeps its own copy of whatever host code it shares with the reference;
  * ``repro_torch/planner/`` imports no ``torch`` and no ``repro_torch``
    module outside itself: the planner's statistics and cost model run on
    the host at ingest time and duck-type the core containers, so
    `repro_torch.data` can import it without a cycle;
  * ``repro_torch/analysis/`` imports the standard library only (and
    itself): the lint runs where neither torch nor numpy is installed.

Imports under ``if TYPE_CHECKING:`` are erased at runtime and exempt.
Relative imports are resolved against the importing module, so ``from
..core import engine`` in the planner is seen for what it is.
"""

from __future__ import annotations

import ast
import sys
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

_FORBIDDEN_ROOTS = ("jax", "jaxlib", "repro")
_STDLIB = frozenset(sys.stdlib_module_names) | {"__future__"}


def _type_checking_spans(tree: ast.AST) -> list[tuple[int, int]]:
    """Line spans of ``if TYPE_CHECKING:`` bodies."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, ast.If):
            test = node.test
            name = test.id if isinstance(test, ast.Name) else \
                test.attr if isinstance(test, ast.Attribute) else None
            if name == "TYPE_CHECKING":
                last = node.body[-1]
                spans.append((node.lineno, getattr(last, "end_lineno",
                                                   last.lineno)))
    return spans


def _module_of(rel: str) -> list[str]:
    """``planner/cost.py`` → ["repro_torch", "planner", "cost"]."""
    parts = ["repro_torch"] + rel[:-3].split("/")
    return parts[:-1] if parts[-1] == "__init__" else parts


def _imported(node: ast.AST, rel: str) -> list[str]:
    """The absolute module names an import statement names."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if not isinstance(node, ast.ImportFrom):
        return []
    if not node.level:
        return [node.module] if node.module else []
    base = _module_of(rel)
    if not rel.endswith("__init__.py"):
        base = base[:-1]  # module -> its package
    base = base[:len(base) - (node.level - 1)]
    mod = ".".join(base + ([node.module] if node.module else []))
    if node.module:
        return [mod]
    return [f"{mod}.{a.name}" for a in node.names]


def _inside(mod: str, package: str) -> bool:
    return mod == package or mod.startswith(package + ".")


class ImportBoundaryRule(Rule):
    rule_id = "FGT008"
    severity = Severity.ERROR
    fix_hint = ("keep the port torch-only (copy the host code it needs), the "
                "planner numpy+stdlib (duck-type the core containers) and "
                "the analysis stdlib-only")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        rel = port_path(ctx.path)
        if rel is None or not rel.endswith(".py"):
            return
        exempt = _type_checking_spans(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if any(lo <= node.lineno <= hi for lo, hi in exempt):
                continue
            for mod in _imported(node, rel):
                message = self._violation(rel, mod)
                if message is not None:
                    yield self.finding(ctx, node, message)

    @staticmethod
    def _violation(rel: str, mod: str) -> str | None:
        root = mod.split(".")[0]
        if root in _FORBIDDEN_ROOTS:
            return (f"port module imports `{mod}` — repro_torch runs "
                    f"without jax and imports nothing of the JAX package")
        if rel.startswith("planner/"):
            if root == "torch":
                return (f"planner module imports `{mod}` — the planner "
                        f"runs on the host at ingest time, without torch")
            if root == "repro_torch" and \
                    not _inside(mod, "repro_torch.planner"):
                return (f"planner module imports `{mod}` — duck-type the "
                        f"core containers instead (keeps the planner "
                        f"cycle-free and torch-free)")
        if rel.startswith("analysis/") and root not in _STDLIB \
                and not _inside(mod, "repro_torch.analysis"):
            return (f"analysis module imports `{mod}` — the lint imports "
                    f"the standard library only")
        return None
