"""figaro-flow for the port: the whole-program call graph and the capture
regions of CUDA graphs.

The port's hot path runs under a CUDA-graph capture
(`core/engine.py`'s ``with torch.cuda.graph(...)`` around the engine's
``_body``): what the body does on the host runs once, at capture, and
never on a replay, and a host sync inside a capture fails on the card only.
A helper three calls below ``_body`` is invisible to any one-file rule.
This module builds the cross-file layer the capture rules run on:

  * `Program`   — every `FileContext` of one analysis run plus the lazily
    built call graph / dataflow; `_run_rules` hands it to
    `Rule.check_program`.
  * `CallGraph` — functions indexed by qualified name (``module:Class.method``
    / ``module:outer.<locals>.inner``), call edges resolved through
    module-level names, ``self.method`` dispatch, module-level instances,
    local function bindings (including ``functools.partial``), and import
    aliases — absolute aliases from `FileContext.aliases`, relative imports
    resolved by reusing `imports.ImportGraph._from_base`.
  * capture regions — the callee of every call lexically inside a
    ``with torch.cuda.graph(...)`` block and every callable handed to
    ``torch.cuda.make_graphed_callables`` is a *capture root*; every
    function transitively reachable from one is *captured context*, with
    the root→function chain kept for finding attribution.

Resolution is best-effort and sound-for-the-repo rather than general Python:
a name that cannot be resolved statically simply contributes no edge. Pure
stdlib, like everything under `repro_torch.analysis` (a retargeted copy of
the JAX package's ``analysis/callgraph.py``, whose roots are jit regions).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

from .framework import FileContext
from .imports import ImportGraph

#: Lock factories (mirrors rules/lock_discipline._LOCK_FACTORIES without the
#: import cycle risk — the rules package imports this module's consumers).
_LOCK_FACTORY_NAMES = frozenset({"Lock", "RLock", "Condition", "san_lock",
                                 "san_rlock", "san_condition"})

#: The context managers whose body is captured into a CUDA graph.
_CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})

#: Parameters of a capture root that are constants of each captured graph:
#: the engine keys a graph by its kind and that kind's options (FGT002 holds
#: the key whole), so within one graph they never change.
_GRAPH_KEY_PARAMS = frozenset({"kind", "options"})


def module_name_of(path: str) -> str:
    """Dotted module name for a repo-relative posix path.

    ``src/repro_torch/core/engine.py`` → ``repro_torch.core.engine``; paths
    outside a
    ``src/`` layout (tests, fixtures in temp dirs) map structurally the same
    way, which is all cross-file resolution needs.
    """
    parts = [p for p in path.split("/") if p and p != "."]
    if parts and parts[0] == "src":
        parts = parts[1:]
    if not parts:
        return "<module>"
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    elif parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    return ".".join(parts) if parts else "<module>"


@dataclasses.dataclass
class ClassInfo:
    name: str
    qname: str                      # "repro_torch.core.engine:FigaroEngine"
    node: ast.ClassDef
    methods: dict[str, str]         # method name -> function qname


@dataclasses.dataclass
class FunctionInfo:
    qname: str
    module: str
    name: str
    ctx: FileContext
    node: ast.FunctionDef | ast.AsyncFunctionDef
    cls: ast.ClassDef | None        # enclosing class, if a method
    parent: str | None              # enclosing function qname, if nested
    local_defs: dict[str, str] = dataclasses.field(default_factory=dict)
    bindings: dict[str, str] = dataclasses.field(default_factory=dict)
    calls: list[ast.Call] = dataclasses.field(default_factory=list)
    assigns: list[ast.Assign] = dataclasses.field(default_factory=list)
    #: calls lexically inside a ``with torch.cuda.graph(...)`` block
    captured_calls: list[ast.Call] = dataclasses.field(default_factory=list)

    @property
    def short(self) -> str:
        return self.qname.split(":", 1)[1]

    def params(self) -> list[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args]

    def kwonly(self) -> list[str]:
        return [p.arg for p in self.node.args.kwonlyargs]

    def is_method(self) -> bool:
        ps = self.params()
        return self.cls is not None and bool(ps) and ps[0] in ("self", "cls")


@dataclasses.dataclass
class ModuleInfo:
    name: str
    ctx: FileContext
    functions: dict[str, str] = dataclasses.field(default_factory=dict)
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    instances: dict[str, str] = dataclasses.field(default_factory=dict)
    aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    module_locks: set[str] = dataclasses.field(default_factory=set)
    calls: list[ast.Call] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class Root:
    qname: str
    kind: str                       # "cuda.graph" | "make_graphed_callables"
    static: frozenset[str] = frozenset()


class CallGraph:
    """Functions, edges, capture roots, and the captured-context closure."""

    def __init__(self) -> None:
        self.functions: dict[str, FunctionInfo] = {}
        self.modules: dict[str, ModuleInfo] = {}
        self.edges: dict[str, set[str]] = {}
        self.roots: dict[str, Root] = {}
        #: qname -> call chain from a root (root first, self last).
        self.captured: dict[str, tuple[str, ...]] = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, contexts: Iterable[FileContext]) -> "CallGraph":
        graph = cls()
        for ctx in contexts:
            graph._index_module(ctx)
        graph._resolve_relative_aliases()
        for mod in graph.modules.values():
            graph._resolve_module(mod)
        graph._mark_captured()
        return graph

    def _index_module(self, ctx: FileContext) -> None:
        mod = ModuleInfo(name=module_name_of(ctx.path), ctx=ctx,
                         aliases=dict(ctx.aliases))
        self.modules[mod.name] = mod
        for stmt in ctx.tree.body:
            value = getattr(stmt, "value", None)
            if isinstance(stmt, ast.Assign) and isinstance(value, ast.Call):
                base = _last_component(ctx.resolve(value.func) or "")
                for t in stmt.targets:
                    if isinstance(t, ast.Name) \
                            and base in _LOCK_FACTORY_NAMES:
                        mod.module_locks.add(t.id)
        _Indexer(self, mod).visit_body(ctx.tree.body)
        # Module-level instances: NAME = ClassName(...) — resolved after all
        # classes of this module are indexed.
        for stmt in ctx.tree.body:
            value = getattr(stmt, "value", None)
            if isinstance(stmt, ast.Assign) and isinstance(value, ast.Call) \
                    and isinstance(value.func, ast.Name) \
                    and value.func.id in mod.classes:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        mod.instances[t.id] = mod.classes[value.func.id].qname

    def _resolve_relative_aliases(self) -> None:
        """`from ._state import STATE` → alias STATE → dotted name, reusing
        imports.ImportGraph's relative-import climbing."""
        packages = set()
        for name, mod in self.modules.items():
            if mod.ctx.path.endswith("__init__.py"):
                packages.add(name)
            parts = name.split(".")
            for i in range(1, len(parts)):
                packages.add(".".join(parts[:i]))
        ig = ImportGraph(src_root="", edges={}, packages=packages,
                         modules={m: i.ctx.path
                                  for m, i in self.modules.items()})
        for mod in self.modules.values():
            for node in ast.walk(mod.ctx.tree):
                if not (isinstance(node, ast.ImportFrom) and node.level):
                    continue
                base = ig._from_base(mod.name, node)
                if base is None:
                    continue
                for a in node.names:
                    if a.name != "*":
                        mod.aliases[a.asname or a.name] = f"{base}.{a.name}"

    def _resolve_module(self, mod: ModuleInfo) -> None:
        fns = [f for f in self.functions.values() if f.module == mod.name]
        for fi in fns:                       # bindings before edges: children
            for assign in fi.assigns:        # look bindings up in parents
                self._record_binding(fi, mod, assign)
        for fi in fns:
            self.edges.setdefault(fi.qname, set())
            for call in fi.calls:
                self._record_call(fi, mod, call)
            for call in fi.captured_calls:
                self._add_root(fi, mod, call.func, "cuda.graph",
                               self._capture_static(fi, mod, call))
        for call in mod.calls:               # module level: roots only
            self._detect_call_root(None, mod, call)

    def _record_binding(self, fi: FunctionInfo, mod: ModuleInfo,
                        assign: ast.Assign) -> None:
        if len(assign.targets) != 1 \
                or not isinstance(assign.targets[0], ast.Name):
            return
        target = self.resolve_callable(fi, mod, assign.value,
                                       use_bindings=False)
        if target is not None:
            fi.bindings[assign.targets[0].id] = target

    def _record_call(self, fi: FunctionInfo, mod: ModuleInfo,
                     call: ast.Call) -> None:
        callee = self.resolve_callable(fi, mod, call.func)
        if callee is not None:
            self.edges[fi.qname].add(callee)
        # A program-function reference handed to any call (map_result,
        # functools.reduce, a leaf_qr= kwarg...) is conservatively an edge:
        # the receiver may invoke it from the caller's context.
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            ref = self.resolve_callable(fi, mod, arg)
            if ref is not None:
                self.edges[fi.qname].add(ref)
        self._detect_call_root(fi, mod, call)

    # -- name resolution -----------------------------------------------------

    def dotted(self, mod: ModuleInfo, node: ast.AST) -> str | None:
        """Alias-expanded dotted chain (absolute AND relative imports)."""
        parts = _dotted_parts(node)
        if parts is None:
            return None
        head = mod.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def resolve_callable(self, fi: FunctionInfo | None, mod: ModuleInfo,
                         node: ast.AST, *,
                         use_bindings: bool = True) -> str | None:
        """Function qname a callee/function-reference expression names."""
        node = self._unwrap_partial(mod, node)
        if isinstance(node, ast.Name):
            scope = fi
            while scope is not None:
                if node.id in scope.local_defs:
                    return scope.local_defs[node.id]
                if use_bindings and node.id in scope.bindings:
                    return scope.bindings[node.id]
                scope = self.functions.get(scope.parent) \
                    if scope.parent else None
            if node.id in mod.functions:
                return mod.functions[node.id]
            if node.id in mod.classes:
                return self._class_init(mod.classes[node.id])
            dotted = mod.aliases.get(node.id)
            return self._resolve_dotted(dotted) if dotted else None
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                    and fi is not None and fi.cls is not None:
                info = self._class_of(fi)
                return info.methods.get(node.attr) if info else None
            if isinstance(base, ast.Name):
                if base.id in mod.classes:
                    return mod.classes[base.id].methods.get(node.attr)
                if base.id in mod.instances:
                    cls_q = mod.instances[base.id]
                    info = self._class_by_qname(cls_q)
                    return info.methods.get(node.attr) if info else None
            dotted = self.dotted(mod, node)
            return self._resolve_dotted(dotted) if dotted else None
        return None

    def _unwrap_partial(self, mod: ModuleInfo, node: ast.AST) -> ast.AST:
        if isinstance(node, ast.Call) and node.args:
            dotted = self.dotted(mod, node.func) or ""
            if _last_component(dotted) == "partial":
                return self._unwrap_partial(mod, node.args[0])
        return node

    def _resolve_dotted(self, dotted: str) -> str | None:
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = self.modules.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            if len(rest) == 1:
                if rest[0] in mod.functions:
                    return mod.functions[rest[0]]
                if rest[0] in mod.classes:
                    return self._class_init(mod.classes[rest[0]])
            elif len(rest) == 2:
                if rest[0] in mod.classes:
                    return mod.classes[rest[0]].methods.get(rest[1])
                if rest[0] in mod.instances:
                    info = self._class_by_qname(mod.instances[rest[0]])
                    if info is not None:
                        return info.methods.get(rest[1])
            return None
        return None

    def _class_init(self, info: ClassInfo) -> str | None:
        return info.methods.get("__init__") \
            or info.methods.get("__post_init__")

    def _class_of(self, fi: FunctionInfo) -> ClassInfo | None:
        if fi.cls is None:
            return None
        mod = self.modules[fi.module]
        for info in mod.classes.values():
            if info.node is fi.cls:
                return info
        return None

    def _class_by_qname(self, qname: str) -> ClassInfo | None:
        mod = self.modules.get(qname.split(":", 1)[0])
        if mod is None:
            return None
        for info in mod.classes.values():
            if info.qname == qname:
                return info
        return None

    # -- capture roots -----------------------------------------------------

    def _detect_call_root(self, fi: FunctionInfo | None, mod: ModuleInfo,
                          call: ast.Call) -> None:
        """``torch.cuda.make_graphed_callables(fn_or_tuple, samples)``: each
        callable it is handed is captured (every parameter a sample)."""
        dotted = self.dotted(mod, call.func) or ""
        if _last_component(dotted) != "make_graphed_callables" \
                or "torch" not in dotted:
            return
        target = call.args[0] if call.args else next(
            (kw.value for kw in call.keywords if kw.arg == "callables"), None)
        targets = target.elts if isinstance(target, (ast.Tuple, ast.List)) \
            else [target] if target is not None else []
        for t in targets:
            self._add_root(fi, mod, t, "make_graphed_callables", frozenset())

    def _capture_static(self, fi: FunctionInfo, mod: ModuleInfo,
                        call: ast.Call) -> frozenset[str]:
        """Parameters of a captured callee that are constants of the graph:
        its keyword-only ones, those with a constant default, and those the
        engine keys each graph by (`_GRAPH_KEY_PARAMS`)."""
        qname = self.resolve_callable(fi, mod, call.func)
        cf = self.functions.get(qname) if qname else None
        if cf is None:
            return frozenset()
        a = cf.node.args
        pos = a.posonlyargs + a.args
        static = {p.arg for p in a.kwonlyargs}
        static |= {p.arg for p, d in zip(pos[len(pos) - len(a.defaults):],
                                         a.defaults)
                   if isinstance(d, ast.Constant)}
        static |= {p.arg for p in pos} & _GRAPH_KEY_PARAMS
        return frozenset(static)

    def _add_root(self, fi: FunctionInfo | None, mod: ModuleInfo,
                  target: ast.AST, kind: str, static: frozenset[str]) -> None:
        qname = self.resolve_callable(fi, mod, target)
        if qname is not None and qname not in self.roots:
            self.roots[qname] = Root(qname, kind, static)

    def _mark_captured(self) -> None:
        queue = [q for q in self.roots if q in self.functions]
        for q in queue:
            self.captured[q] = (q,)
        while queue:
            src = queue.pop()
            for dst in sorted(self.edges.get(src, ())):
                if dst not in self.captured and dst in self.functions:
                    self.captured[dst] = self.captured[src] + (dst,)
                    queue.append(dst)

    # -- reports -------------------------------------------------------------

    def render_text(self) -> str:
        lines = [f"figaro-flow call graph: {len(self.functions)} function(s),"
                 f" {sum(len(e) for e in self.edges.values())} edge(s),"
                 f" {len(self.roots)} capture root(s),"
                 f" {len(self.captured)} captured-context function(s)"]
        for q in sorted(self.roots):
            lines.append(f"capture root [{self.roots[q].kind}]: {q}")
        for mname in sorted(self.modules):
            fns = sorted((f for f in self.functions.values()
                          if f.module == mname), key=lambda f: f.qname)
            if not fns:
                continue
            lines.append(f"\n{mname}  ({self.modules[mname].ctx.path})")
            for fi in fns:
                mark = "host"
                if fi.qname in self.roots:
                    mark = f"capture root [{self.roots[fi.qname].kind}]"
                elif fi.qname in self.captured:
                    chain = " -> ".join(
                        q.split(":", 1)[1] for q in self.captured[fi.qname])
                    mark = f"captured via {chain}"
                lines.append(f"  {fi.short:40s} {mark}")
                for dst in sorted(self.edges.get(fi.qname, ())):
                    lines.append(f"    -> {dst}")
        return "\n".join(lines)


class _Indexer:
    """Pass 1: index functions/classes and attach each Call/Assign to its
    innermost enclosing function. Lambdas do not open a scope — their body
    belongs to the enclosing def. A call inside a ``with torch.cuda.graph``
    block of a function is also recorded as captured there."""

    def __init__(self, graph: CallGraph, mod: ModuleInfo) -> None:
        self.graph = graph
        self.mod = mod
        self.cls_stack: list[ast.ClassDef] = []
        self.fn_stack: list[FunctionInfo] = []
        self.name_stack: list[str] = []
        self.capturing = 0  # depth of `with torch.cuda.graph` blocks

    def visit_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._visit(stmt)

    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_function(node)
            return
        if isinstance(node, ast.ClassDef):
            self._visit_class(node)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)) \
                and self._captures(node):
            for item in node.items:
                self._visit(item)
            self.capturing += 1
            for stmt in node.body:
                self._visit(stmt)
            self.capturing -= 1
            return
        if isinstance(node, ast.Call):
            (self.fn_stack[-1].calls if self.fn_stack
             else self.mod.calls).append(node)
            if self.capturing and self.fn_stack:
                self.fn_stack[-1].captured_calls.append(node)
        elif isinstance(node, ast.Assign) and self.fn_stack:
            self.fn_stack[-1].assigns.append(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _captures(self, node) -> bool:
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call) and self.graph.dotted(
                    self.mod, expr.func) in _CAPTURE_CONTEXTS:
                return True
        return False

    def _visit_function(self, node) -> None:
        scope = ".".join(self.name_stack + [node.name]) if self.name_stack \
            else node.name
        qname = f"{self.mod.name}:{scope}"
        parent = self.fn_stack[-1] if self.fn_stack else None
        fi = FunctionInfo(
            qname=qname, module=self.mod.name, name=node.name,
            ctx=self.mod.ctx, node=node,
            cls=self.cls_stack[-1] if self.cls_stack and not parent else None,
            parent=parent.qname if parent else None)
        self.graph.functions[qname] = fi
        if parent is not None:
            parent.local_defs[node.name] = qname
        elif self.cls_stack:
            for info in self.mod.classes.values():
                if info.node is self.cls_stack[-1]:
                    info.methods[node.name] = qname
        else:
            self.mod.functions[node.name] = qname
        for dec in node.decorator_list:      # decorators evaluate outside
            self._visit(dec)
        self.fn_stack.append(fi)
        self.name_stack.append(node.name)
        capturing, self.capturing = self.capturing, 0  # a def runs later
        for stmt in node.body:
            self._visit(stmt)
        self.capturing = capturing
        self.name_stack.pop()
        self.fn_stack.pop()

    def _visit_class(self, node: ast.ClassDef) -> None:
        if self.fn_stack:                    # class defined inside a function:
            for stmt in node.body:           # treat methods as nested defs
                self._visit(stmt)
            return
        scope = ".".join(self.name_stack + [node.name]) if self.name_stack \
            else node.name
        info = ClassInfo(name=node.name, qname=f"{self.mod.name}:{scope}",
                         node=node, methods={})
        self.mod.classes[node.name] = info
        for dec in node.decorator_list:
            self._visit(dec)
        self.cls_stack.append(node)
        self.name_stack.append(node.name)
        for stmt in node.body:
            self._visit(stmt)
        self.name_stack.pop()
        self.cls_stack.pop()


class Program:
    """One analysis run's whole-program view: every parsed file, the call
    graph, and (on demand) the dataflow fixpoint."""

    def __init__(self, contexts: Iterable[FileContext]) -> None:
        self.files: dict[str, FileContext] = {c.path: c for c in contexts}
        self.graph = CallGraph.build(self.files.values())
        self._dataflow = None

    def dataflow(self):
        if self._dataflow is None:
            from .dataflow import Dataflow
            self._dataflow = Dataflow(self.graph).run()
        return self._dataflow

    def captured_chain(self, qname: str) -> tuple[str, ...]:
        return self.graph.captured.get(qname, ())

    def external_method_refs(self, owner: ast.ClassDef,
                             method: str) -> list[tuple[str, int]]:
        """(path, line) of `X.method` attribute references OUTSIDE the owning
        class — the call-graph query behind FGT006's helper exemption: a
        private method referenced from anywhere else can run without the
        class's own locked callers."""
        out: list[tuple[str, int]] = []
        for ctx in self.files.values():
            for cls, node in _attr_refs(ctx.tree, method):
                if cls is owner:
                    continue
                if isinstance(node.value, ast.Name) \
                        and node.value.id in ("self", "cls") \
                        and cls is not None and _has_method(cls, method):
                    continue  # another class's own method of the same name
                out.append((ctx.path, node.lineno))
        return out


def _attr_refs(tree: ast.Module,
               attr: str) -> Iterator[tuple[ast.ClassDef | None,
                                            ast.Attribute]]:
    """Attribute nodes with the given attr, paired with the enclosing class."""
    def walk(node: ast.AST, cls: ast.ClassDef | None):
        if isinstance(node, ast.ClassDef):
            cls = node
        if isinstance(node, ast.Attribute) and node.attr == attr:
            yield cls, node
        for child in ast.iter_child_nodes(node):
            yield from walk(child, cls)
    yield from walk(tree, None)


def _has_method(cls: ast.ClassDef, name: str) -> bool:
    return any(isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
               and m.name == name for m in cls.body)


def _dotted_parts(node: ast.AST) -> list[str] | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


def _last_component(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""
