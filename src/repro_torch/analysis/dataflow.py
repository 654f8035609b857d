"""figaro-flow dataflow for the port: device-tensor taint to a fixpoint.

Forward abstract interpretation over the functions `callgraph` marked
*captured context* (reachable from a CUDA-graph capture). The lattice per
value:

  * **tainted** — a device tensor: derived from a capture root's tensor
    parameters, or made by a torch factory with an explicit ``device=``.
    At capture such a tensor holds no value yet, and the capture records
    kernels only: reading it on the host (``.item()``, ``.cpu()``,
    ``int(t)``, ``if t:`` ...) syncs the card, which a capture refuses —
    FGT009's sink.
  * **concrete** — a host value fixed for the graph: the root's static
    parameters (keyword-only ones, constant defaults, the engine's ``kind``
    and ``options``), closure variables and module globals, tensor metadata
    (``.shape``, ``.dtype``, ``.device``, ``.numel()``, ``.stride()``,
    ``.data_ptr()``, ``plan.spec``), and results of shape-only calls
    (``len``, ``isinstance``).
  * **host-escaping** — was tainted, then passed through a sync sink; the
    sink itself is the finding, downstream uses are not re-reported.

A value's abstract state is ``AVal(tainted, deps, host)`` where ``deps`` are
the *parameter names* the value inherits taint from — so one local pass per
function yields a reusable summary (params → returns), and `Dataflow`
composes summaries over the call graph: call sites push taint into callee
parameter sets, return taint flows back through ``deps``, repeated to a
(monotone, hence terminating) fixpoint.

Sinks: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``.to("cpu")``; ``int()``/``float()``/``bool()``/``complex()`` and numpy
calls on a tainted value; a tainted value as a condition (``if``,
``while``, ``assert``, a conditional expression, a comprehension filter);
calls whose output shape depends on the data (``nonzero``, ``unique``,
``masked_select`` ...); the ``torch.linalg`` calls that check their
``info`` on the host (``cholesky``, ``inv``, ``solve`` ...; their ``_ex``
forms do not); and, tainted or not, ``torch.cuda.synchronize()`` and a
stream's or event's ``.synchronize()``.

Precision choices are driven by the real tree: tuple targets of
``zip``/``enumerate`` map taint elementwise (``for sp, ix, d in
zip(plan.spec.nodes, plan.index, data)`` keeps ``sp`` concrete), a
subscript-store of a tainted value taints the containing local, an
identity test (``x is None``) is concrete, and unknown calls (``torch.*``)
join their argument taints. A retargeted copy of the JAX package's
``analysis/dataflow.py``.
"""

from __future__ import annotations

import ast
import dataclasses

from .callgraph import CallGraph, FunctionInfo, _last_component

#: Attribute reads that yield host values even on a device tensor: tensor
#: metadata, and the plan convention (`plan.spec` is the plan's static half;
#: its index/data tensors are the device half).
_META_ATTRS = frozenset({
    "shape", "dtype", "ndim", "device", "is_cuda", "layout", "itemsize",
    "requires_grad", "spec",
})

#: Tensor methods that read metadata only — no sync.
_META_METHODS = frozenset({
    "numel", "nelement", "size", "dim", "stride", "element_size",
    "data_ptr", "is_contiguous", "storage_offset", "get_device",
})

#: numpy functions that only touch metadata — not host syncs.
_NP_META = frozenset({
    "shape", "ndim", "size", "dtype", "result_type", "promote_types",
    "can_cast", "issubdtype", "isscalar", "iinfo", "finfo", "index_exp",
})

#: Builtins that return host constants for any argument.
_CONCRETE_BUILTINS = frozenset({
    "len", "range", "isinstance", "issubclass", "type", "repr", "id",
    "callable", "hasattr",
})

#: Builtins that read a device value on the host: a sync.
_SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})

#: Tensor methods that copy a device value to the host.
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: Calls whose output shape depends on the data: the host waits for it.
_SHAPE_SYNCS = frozenset({"nonzero", "argwhere", "unique",
                          "unique_consecutive", "masked_select"})

#: `torch.linalg` (and older `torch`) calls that check their LAPACK-style
#: ``info`` on the host; each has an ``_ex`` form that does not.
_INFO_CHECKS = frozenset({
    "cholesky", "inv", "solve", "lu_factor", "ldl_factor", "inverse",
})

#: Annotations of host values: a parameter (or a return) annotated so is
#: concrete whatever a call site passes.
_HOST_TYPES = frozenset({"int", "float", "bool", "str", "bytes", "None",
                         "dtype", "device", "Size", "slice"})

#: Methods that put their arguments into their receiver.
_CONTAINER_STORES = frozenset({"append", "extend", "insert", "add",
                               "update", "setdefault", "appendleft"})

#: Tensor factories: with ``device=`` they make a device tensor.
_FACTORIES = frozenset({
    "empty", "zeros", "ones", "full", "arange", "linspace", "eye", "rand",
    "randn", "randint", "randperm", "tensor", "as_tensor", "empty_strided",
})


@dataclasses.dataclass(frozen=True)
class AVal:
    tainted: bool = False
    deps: frozenset = frozenset()
    host: bool = False


_CONCRETE = AVal()


def _join(*vals: AVal) -> AVal:
    return AVal(tainted=any(v.tainted for v in vals),
                deps=frozenset().union(*(v.deps for v in vals)),
                host=any(v.host for v in vals))


@dataclasses.dataclass(frozen=True)
class Sink:
    qname: str          # captured-context function containing the sink
    node: ast.AST
    op: str             # ".item()", "int()", "a condition", ...
    expr: str           # offending expression, unparsed (truncated)


@dataclasses.dataclass
class DataflowResult:
    #: function qname -> parameter names proven tainted at some call site.
    param_tainted: dict[str, set[str]]
    #: function qname -> summary of its return value.
    returns: dict[str, AVal]
    #: every host-sync sink found in a captured-context function.
    sinks: list[Sink]


class Dataflow:
    """The fixpoint: local passes over every captured-context function."""

    _MAX_SWEEPS = 20   # taint is monotone; real depth is the call-chain depth

    def __init__(self, graph: CallGraph) -> None:
        self.graph = graph
        self.param_tainted: dict[str, set[str]] = {}
        self.returns: dict[str, AVal] = {}

    def run(self) -> DataflowResult:
        domain = [q for q in self.graph.captured
                  if q in self.graph.functions]
        for q in domain:
            self.param_tainted.setdefault(q, set())
        for q, root in self.graph.roots.items():
            fi = self.graph.functions.get(q)
            if fi is None:
                continue
            params = fi.params()
            if fi.is_method():
                params = params[1:]
            self.param_tainted[q] |= {p for p in params
                                      if p not in root.static}
        sinks: list[Sink] = []
        for _ in range(self._MAX_SWEEPS):
            changed = False
            sinks = []
            for q in domain:
                fn_pass = _FnPass(self, self.graph.functions[q])
                fn_pass.run()
                sinks.extend(fn_pass.sinks)
                changed |= fn_pass.changed
            if not changed:
                break
        return DataflowResult(param_tainted=self.param_tainted,
                              returns=self.returns, sinks=sinks)


class _FnPass:
    """One forward pass over one function body. The body is executed twice so
    loop-carried taint (an accumulator assigned late, read early) converges;
    env updates are joins, so the second iteration is monotone."""

    def __init__(self, df: Dataflow, fi: FunctionInfo) -> None:
        self.df = df
        self.graph = df.graph
        self.fi = fi
        self.mod = df.graph.modules[fi.module]
        self.env: dict[str, AVal] = {}
        self.ret = _CONCRETE
        self.sinks: list[Sink] = []
        self.changed = False

    def run(self) -> None:
        a = self.fi.node.args
        mine = self.df.param_tainted.setdefault(self.fi.qname, set())
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg in ("self", "cls") or _host_annotation(p.annotation):
                self.env[p.arg] = _CONCRETE
            else:
                self.env[p.arg] = AVal(tainted=p.arg in mine,
                                       deps=frozenset({p.arg}))
        for p in (a.vararg, a.kwarg):
            if p is not None:
                self.env[p.arg] = AVal(tainted=p.arg in mine,
                                       deps=frozenset({p.arg}))
        for _ in range(2):
            self.sinks = []
            self.ret = _CONCRETE
            for stmt in self.fi.node.body:
                self._exec(stmt)
        if _host_annotation(self.fi.node.returns):
            self.ret = _CONCRETE
        old = self.df.returns.get(self.fi.qname, _CONCRETE)
        new = _join(old, self.ret)
        if new != old:
            self.df.returns[self.fi.qname] = new
            self.changed = True

    def _is_tainted(self, aval: AVal) -> bool:
        mine = self.df.param_tainted.get(self.fi.qname, set())
        return aval.tainted or any(d in mine for d in aval.deps)

    # -- statements ----------------------------------------------------------

    def _exec(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are their own dataflow functions
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.ret = _join(self.ret, self._ev(stmt.value))
            return
        if isinstance(stmt, ast.Assign):
            val = self._ev(stmt.value)
            for tgt in stmt.targets:
                self._assign(tgt, val, stmt.value)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign(stmt.target, self._ev(stmt.value), stmt.value)
            return
        if isinstance(stmt, ast.AugAssign):
            val = self._ev(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = _join(
                    self.env.get(stmt.target.id, _CONCRETE), val)
            else:
                self._assign(stmt.target, val, stmt.value)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._assign_iter_target(stmt.target, stmt.iter)
            for s in stmt.body + stmt.orelse:
                self._exec(s)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self._ev(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, v, item.context_expr)
            for s in stmt.body:
                self._exec(s)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._condition(stmt.test)
            for s in stmt.body + stmt.orelse:
                self._exec(s)
            return
        if isinstance(stmt, ast.Assert):
            self._condition(stmt.test)
            if stmt.msg is not None:
                self._ev(stmt.msg)
            return
        if isinstance(stmt, ast.Try):
            for s in stmt.body + stmt.orelse + stmt.finalbody:
                self._exec(s)
            for handler in stmt.handlers:
                for s in handler.body:
                    self._exec(s)
            return
        if isinstance(stmt, ast.Expr):
            self._ev(stmt.value)
            return
        # Raise/Assert/Delete/Global/...: evaluate any child expressions so
        # sinks inside them are still seen.
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._ev(child)

    def _assign(self, tgt: ast.AST, val: AVal, src: ast.AST | None) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = val
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            elems = self._elements(src, len(tgt.elts)) if src is not None \
                else None
            for i, elt in enumerate(tgt.elts):
                self._assign(elt, elems[i] if elems else val, None)
        elif isinstance(tgt, (ast.Subscript, ast.Attribute)):
            # Storing a tainted value INTO a container taints the container
            # — `out[i] = torch.cumsum(...)` makes `out` tainted.
            base = tgt.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name):
                self.env[base.id] = _join(
                    self.env.get(base.id, _CONCRETE), val)
        elif isinstance(tgt, ast.Starred):
            self._assign(tgt.value, val, None)

    def _assign_iter_target(self, tgt: ast.AST, it: ast.expr) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            elems = self._elements(it, len(tgt.elts))
            if elems is not None:
                for i, elt in enumerate(tgt.elts):
                    self._assign(elt, elems[i], None)
                return
        self._assign(tgt, self._ev(it), None)

    def _elements(self, src: ast.AST,
                  count: int) -> list[AVal] | None:
        """Elementwise avals for tuple targets of a tuple literal,
        zip()/enumerate(), and a dict's ``.items()`` (keys are hashable host
        values)."""
        if isinstance(src, (ast.Tuple, ast.List)) \
                and len(src.elts) == count \
                and not any(isinstance(e, ast.Starred) for e in src.elts):
            return [self._ev(e) for e in src.elts]
        if isinstance(src, ast.Call) and isinstance(src.func, ast.Attribute) \
                and src.func.attr == "items" and not src.args \
                and count == 2:
            return [_CONCRETE, self._ev(src.func.value)]
        if not isinstance(src, ast.Call) or not isinstance(src.func, ast.Name):
            return None
        if src.func.id == "zip":
            vals = [self._ev(a) for a in src.args]
            if len(vals) < count:
                vals += [_CONCRETE] * (count - len(vals))
            return vals[:count]
        if src.func.id == "enumerate" and src.args:
            inner = self._elements(src.args[0], count - 1)
            if inner is not None:
                return [_CONCRETE] + inner
            return [_CONCRETE] + [self._ev(src.args[0])] * (count - 1)
        return None

    def _condition(self, test: ast.expr) -> None:
        """A test the host branches on: a device value there is a sync."""
        if self._is_tainted(self._ev(test)):
            self._sink(test, "a condition", test)

    # -- expressions ---------------------------------------------------------

    def _ev(self, node: ast.AST) -> AVal:
        if isinstance(node, ast.Name):
            # Unbound names are module globals or closure variables — host
            # values fixed before the capture.
            return self.env.get(node.id, _CONCRETE)
        if isinstance(node, ast.Constant):
            return _CONCRETE
        if isinstance(node, ast.Attribute):
            base = self._ev(node.value)
            if node.attr in _META_ATTRS:
                return _CONCRETE
            return base
        if isinstance(node, ast.Subscript):
            return _join(self._ev(node.value), self._ev(node.slice))
        if isinstance(node, ast.Call):
            return self._ev_call(node)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return _join(_CONCRETE, *[self._ev(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            parts = [self._ev(v) for v in node.values if v is not None]
            parts += [self._ev(k) for k in node.keys if k is not None]
            return _join(_CONCRETE, *parts)
        if isinstance(node, (ast.BinOp,)):
            return _join(self._ev(node.left), self._ev(node.right))
        if isinstance(node, ast.BoolOp):
            return _join(*[self._ev(v) for v in node.values])
        if isinstance(node, ast.UnaryOp):
            return self._ev(node.operand)
        if isinstance(node, ast.Compare):
            val = _join(self._ev(node.left),
                        *[self._ev(c) for c in node.comparators])
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return _CONCRETE  # identity, not a tensor comparison
            return val
        if isinstance(node, ast.IfExp):
            self._condition(node.test)
            return _join(self._ev(node.body), self._ev(node.orelse))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self._assign_iter_target(gen.target, gen.iter)
                for cond in gen.ifs:
                    self._condition(cond)
            if isinstance(node, ast.DictComp):
                return _join(self._ev(node.key), self._ev(node.value))
            return self._ev(node.elt)
        if isinstance(node, ast.Lambda):
            # Inlined into the enclosing captured function: params of a
            # lambda handed to map_result & co. receive tensors.
            for p in node.args.args + node.args.kwonlyargs:
                self.env.setdefault(p.arg, AVal(tainted=True))
            self._ev(node.body)
            return _CONCRETE
        if isinstance(node, ast.Starred):
            return self._ev(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._ev(child)
            return _CONCRETE
        if isinstance(node, ast.NamedExpr):
            val = self._ev(node.value)
            self._assign(node.target, val, node.value)
            return val
        parts = [self._ev(c) for c in ast.iter_child_nodes(node)
                 if isinstance(c, ast.expr)]
        return _join(_CONCRETE, *parts)

    def _ev_call(self, node: ast.Call) -> AVal:
        args = [self._ev(a) for a in node.args]
        kwargs = {kw.arg: self._ev(kw.value) for kw in node.keywords}
        func = node.func
        dotted = self.graph.dotted(self.mod, func) or ""
        last = _last_component(dotted)
        joined = _join(_CONCRETE, *args, *kwargs.values())

        # Syncs whatever they are handed: the whole card, or one stream or
        # event.
        if dotted == "torch.cuda.synchronize" or (
                isinstance(func, ast.Attribute)
                and func.attr == "synchronize"):
            self._sink(node, f"{_callee_text(func)}()", node)
            return _CONCRETE

        if isinstance(func, ast.Attribute):
            recv = self._ev(func.value)
            if func.attr in _META_METHODS:
                return _CONCRETE
            if func.attr in _SYNC_METHODS or (
                    func.attr == "to" and _to_cpu(node)):
                if self._is_tainted(recv):
                    self._sink(node, f".{func.attr}()", func.value)
                    return AVal(host=True)
                return recv
            if func.attr in _SHAPE_SYNCS and self._is_tainted(recv):
                self._sink(node, f".{func.attr}()", func.value)
                return AVal(host=True)

        callee = self.graph.resolve_callable(self.fi, self.mod, func)
        if callee is not None and callee in self.graph.functions:
            return self._ev_program_call(node, callee, args, kwargs)

        head = dotted.split(".", 1)[0]
        if head == "numpy":
            if last in _NP_META:
                return _CONCRETE
            if self._is_tainted(joined):
                self._sink(node, f"np.{last}", node)
                return AVal(host=True)
            return _CONCRETE
        if head == "torch":
            if dotted.startswith("torch.linalg.") and last in _INFO_CHECKS \
                    or dotted in ("torch.inverse", "torch.cholesky"):
                if self._is_tainted(joined):
                    self._sink(node, f"{dotted}", node)
                    return AVal(host=True)
            if last in _SHAPE_SYNCS and self._is_tainted(joined):
                self._sink(node, f"{dotted}", node)
                return AVal(host=True)
            if last in _FACTORIES and "device" in kwargs \
                    and not _is_cpu_literal(_kwarg(node, "device")):
                return AVal(tainted=True)
        if isinstance(func, ast.Name):
            if func.id in _SYNC_BUILTINS and args \
                    and self._is_tainted(args[0]):
                self._sink(node, f"{func.id}()", node.args[0])
                return AVal(host=True)
            if func.id in _CONCRETE_BUILTINS:
                return _CONCRETE
            if func.id == "getattr" and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and node.args[1].value in _META_ATTRS:
                return _CONCRETE
        # Unknown call (torch.*, external libs): taint flows arguments ->
        # result, no sync implied. A method call's receiver is an argument
        # too (`x.sum()` is as tainted as x), and a local container takes
        # what is stored into it (`slabs.append(slab)`).
        if isinstance(func, ast.Attribute):
            if func.attr in _CONTAINER_STORES \
                    and isinstance(func.value, ast.Name):
                name = func.value.id
                self.env[name] = _join(self.env.get(name, _CONCRETE), joined)
            joined = _join(joined, self._ev(func.value))
        return joined

    def _ev_program_call(self, node: ast.Call, callee: str,
                         args: list[AVal],
                         kwargs: dict[str | None, AVal]) -> AVal:
        cf = self.graph.functions[callee]
        params = cf.params()
        if cf.is_method() and isinstance(node.func, ast.Attribute):
            params = params[1:]
        mapped: dict[str, AVal] = {}
        for i, aval in enumerate(args):
            if isinstance(node.args[i], ast.Starred):
                # *data: every remaining positional param sees the splat.
                for p in params[i:]:
                    mapped[p] = _join(mapped.get(p, _CONCRETE), aval)
                break
            if i < len(params):
                mapped[params[i]] = aval
        valid = set(params) | set(cf.kwonly())
        for name, aval in kwargs.items():
            if name in valid:
                mapped[name] = aval
        callee_tainted = self.df.param_tainted.setdefault(callee, set())
        for pname, aval in mapped.items():
            if self._is_tainted(aval) and pname not in callee_tainted:
                callee_tainted.add(pname)
                self.changed = True
        ret = self.df.returns.get(callee, _CONCRETE)
        flows = [mapped[d] for d in ret.deps if d in mapped]
        tainted = ret.tainted or any(self._is_tainted(v) for v in flows)
        return AVal(tainted=tainted,
                    deps=frozenset().union(*(v.deps for v in flows)),
                    host=ret.host)

    def _sink(self, node: ast.AST, op: str, expr: ast.AST) -> None:
        try:
            text = ast.unparse(expr)
        except Exception:   # pragma: no cover - unparse is total on 3.9+
            text = "<expr>"
        if len(text) > 60:
            text = text[:57] + "..."
        self.sinks.append(Sink(qname=self.fi.qname, node=node, op=op,
                               expr=text))


def _kwarg(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu_literal(node: ast.expr | None) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Call) and node.args:
        node = node.args[0]
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _to_cpu(call: ast.Call) -> bool:
    """``t.to("cpu")``, ``t.to(device="cpu")``, ``t.to(torch.device("cpu"))``."""
    target = call.args[0] if call.args else _kwarg(call, "device")
    return _is_cpu_literal(target)


def _callee_text(func: ast.expr) -> str:
    try:
        return ast.unparse(func)
    except Exception:   # pragma: no cover - unparse is total on 3.9+
        return "synchronize"


def _host_annotation(node: ast.expr | None) -> bool:
    """``int``, ``bool | None``, ``torch.dtype``, ``Optional[int]`` ...:
    every alternative a host type."""
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        if node.value is None:
            return True
        if isinstance(node.value, str):  # a string annotation
            try:
                node = ast.parse(node.value, mode="eval").body
            except SyntaxError:
                return False
            return _host_annotation(node)
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _host_annotation(node.left) and _host_annotation(node.right)
    if isinstance(node, ast.Subscript) and _last_component(
            ".".join(_names_of(node.value))) == "Optional":
        return _host_annotation(node.slice)
    names = _names_of(node)
    return bool(names) and names[-1] in _HOST_TYPES


def _names_of(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []
