"""FGT004 — the port's kernel rules (its counterpart of the JAX package's
FIG004, which routes every ``pallas_call`` through the platform policy).

The port's promise about its hand-written kernels is that the card never
quietly takes their plain versions (ROADMAP, "Rules the port keeps"): a
wrapper runs the plain PyTorch version only for tensors on the CPU and
launches the kernel or raises for tensors on the card. Nothing at run time
holds that on the CPU, where no kernel ever launches. This rule holds it
in the source:

  (a) a wrapper in ``kernels/<name>/ops.py`` chooses plain or kernel only
      through ``_platform.is_cpu``: it makes no device test of its own
      (``.is_cuda``, ``.device.type``, ``torch.cuda.is_available()``), and
      every function there that calls into its ``kernel`` module asks
      ``is_cpu`` first;
  (b) no ``try`` whose body builds, imports or launches a kernel, or
      calls a wrapper (``repro_torch.kernels.<name>.ops``, or what the
      kernel package re-exports from it), has a handler that does anything
      but raise — a handler that returns, or goes on to the plain version,
      is the fallback the port forbids, in a wrapper or in the code that
      calls it;
  (c) nothing under ``kernels/`` or ``core/`` reads the environment
      (``os.environ``, ``os.getenv``): no environment switch picks a path.
      `kernels/_build.py`'s toolchain lookup (``_nvcc``, ``CUDA_HOME``) is
      exempt by name;
  (d) no kernel is built and ``triton`` is not imported when a module is
      imported: a build (``_build.*``, ``torch.utils.cpp_extension.load*``)
      or an ``import triton`` at module level fails every host without a
      toolchain, the CPU test host among them.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

_OPS = re.compile(r"^kernels/[A-Za-z_0-9]+/ops\.py$")

#: (file below repro_torch/, function) that may read the environment.
_ENV_EXEMPT = frozenset({("kernels/_build.py", "_nvcc")})

def _is_build(dotted: str) -> bool:
    """A call that builds or loads a kernel library: anything of
    `kernels/_build.py`, ``torch.utils.cpp_extension.load*``,
    ``ctypes.CDLL``."""
    head, _, last = dotted.rpartition(".")
    return head.rpartition(".")[2] == "_build" \
        or ("cpp_extension" in head and last.startswith("load")) \
        or dotted == "ctypes.CDLL"


def _is_launch(dotted: str) -> bool:
    """A call into a kernel module (``kernel.fused_node_pass``, a
    ``repro_torch.kernels.<name>.kernel`` function, `_seg_scan.launch`)."""
    parts = dotted.split(".")
    return len(parts) >= 2 and (parts[-2] == "kernel"
                                or dotted.endswith("_seg_scan.launch"))


def _is_wrapper(dotted: str) -> bool:
    """A call into a kernel's wrapper: ``repro_torch.kernels.<name>.ops.f``
    or the package's re-export ``repro_torch.kernels.<name>.f`` (not a
    ``*_ref`` plain version, and not the private ``_build``, ``_platform``
    or ``_seg_scan``)."""
    parts = dotted.split(".")
    if parts[:2] != ["repro_torch", "kernels"] or len(parts) < 4 \
            or parts[2].startswith("_"):
        return False
    return parts[3] == "ops" if len(parts) == 5 \
        else len(parts) == 4 and not parts[3].endswith("_ref")


def _imports_triton(node: ast.AST) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name.split(".")[0] == "triton" for a in node.names)
    return isinstance(node, ast.ImportFrom) and not node.level \
        and (node.module or "").split(".")[0] == "triton"


def _module_level(tree: ast.Module) -> Iterator[ast.AST]:
    """Nodes that run when the module is imported: everything but function
    bodies (class bodies run; their methods do not)."""
    stack: list[ast.AST] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            continue
        if isinstance(node, ast.Lambda):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _functions(tree: ast.Module) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class KernelLaunchRule(Rule):
    rule_id = "FGT004"
    severity = Severity.ERROR
    fix_hint = ("choose plain or kernel with `_platform.is_cpu(...)` only; "
                "let a build or launch error raise; build, load and import "
                "triton inside the function that launches; no environment "
                "switches")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        rel = port_path(ctx.path)
        if rel is None:
            return
        if _OPS.match(rel):
            yield from self._check_wrapper(ctx)
        yield from self._check_fallbacks(ctx)
        if rel.startswith(("kernels/", "core/")):
            yield from self._check_environment(ctx, rel)
        yield from self._check_import_time(ctx)

    # -- (a) the wrapper's choice ----------------------------------------

    def _check_wrapper(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in _functions(ctx.tree):
            asks = False
            launches = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) and (
                        node.attr == "is_cuda"
                        or (node.attr == "type" and _is_device(node.value))):
                    yield self.finding(
                        ctx, node,
                        f"`{fn.name}` tests the device itself "
                        f"(`{ast.unparse(node)}`) — a wrapper chooses plain "
                        f"or kernel through `_platform.is_cpu` only")
                if not isinstance(node, ast.Call):
                    continue
                dotted = ctx.resolve(node.func) or ""
                if dotted.endswith("cuda.is_available"):
                    yield self.finding(
                        ctx, node,
                        f"`{fn.name}` asks `torch.cuda.is_available()` — a "
                        f"wrapper chooses by where its tensors lie, through "
                        f"`_platform.is_cpu`")
                elif dotted.endswith("is_cpu"):
                    asks = True
                elif _is_launch(dotted):
                    launches.append(node)
            if launches and not asks:
                yield self.finding(
                    ctx, launches[0],
                    f"`{fn.name}` calls its kernel without asking "
                    f"`_platform.is_cpu` — CPU tensors must take the plain "
                    f"version, and only they")

    # -- (b) no fallback ----------------------------------------------------

    def _check_fallbacks(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            what = self._kernel_work(ctx, node.body)
            if what is None:
                continue
            for handler in node.handlers:
                if len(handler.body) == 1 \
                        and isinstance(handler.body[0], ast.Raise):
                    continue
                yield self.finding(
                    ctx, handler,
                    f"a handler of a `try` that {what} does more than "
                    f"raise — the card must never fall back quietly")

    def _kernel_work(self, ctx: FileContext,
                     body: list[ast.stmt]) -> str | None:
        for stmt in body:
            for node in ast.walk(stmt):
                if _imports_triton(node):
                    return "imports triton"
                if isinstance(node, ast.Call):
                    dotted = ctx.resolve(node.func) or ""
                    if _is_build(dotted):
                        return f"builds a kernel (`{dotted}`)"
                    if _is_launch(dotted):
                        return f"launches a kernel (`{dotted}`)"
                    if _is_wrapper(dotted):
                        return f"calls a kernel's wrapper (`{dotted}`)"
        return None

    # -- (c) no environment switch ------------------------------------------

    def _check_environment(self, ctx: FileContext,
                           rel: str) -> Iterator[Finding]:
        exempt: set[int] = set()
        for fn in _functions(ctx.tree):
            if (rel, fn.name) in _ENV_EXEMPT:
                exempt.update(id(n) for n in ast.walk(fn))
        for node in ast.walk(ctx.tree):
            if id(node) in exempt:
                continue
            if isinstance(node, ast.ImportFrom) and node.module == "os" \
                    and any(a.name in ("environ", "getenv")
                            for a in node.names):
                yield self._env(ctx, node, "from os import environ/getenv")
            elif isinstance(node, ast.Attribute) \
                    and node.attr in ("environ", "getenv") \
                    and ctx.resolve(node) in ("os.environ", "os.getenv"):
                yield self._env(ctx, node, ctx.resolve(node))

    def _env(self, ctx, node, what: str) -> Finding:
        return self.finding(
            ctx, node,
            f"`{what}` under kernels/ or core/ — no environment switch may "
            f"pick a kernel or a path")

    # -- (d) nothing at import time ----------------------------------------

    def _check_import_time(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _module_level(ctx.tree):
            if _imports_triton(node):
                yield self.finding(
                    ctx, node,
                    "`triton` imported at module level — import it inside "
                    "the function that launches (hosts without triton "
                    "import every module)")
            elif isinstance(node, ast.Call):
                dotted = ctx.resolve(node.func) or ""
                if _is_build(dotted):
                    yield self.finding(
                        ctx, node,
                        f"`{dotted}` runs at module level — build and load "
                        f"a kernel inside the function that launches it")


def _is_device(node: ast.AST) -> bool:
    """``x.device`` or a name ``device``."""
    return (isinstance(node, ast.Attribute) and node.attr == "device") \
        or (isinstance(node, ast.Name) and node.id == "device")
