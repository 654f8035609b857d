"""FGT012 — symbolic slab-layout consistency (a copy of the JAX package's
FIG012, scoped to ``repro_torch/``: the port's ``core/join_tree.py`` and
``core/plan_cache.py`` copy that layout arithmetic).

The R₀ slab layout is pure integer arithmetic spread across three modules:
`build_plan` lays out columns (prefix sums over ``num_data_cols``) and rows
(emission order: per node the ``m`` scaled-tail rows then the ``K``
generalized-tail rows), `plan_cache.bucket_spec` *re-derives* the row layout
after pow2 capacity bucketing, and `PlanSpec.__post_init__` re-derives the
band table. A stale copy of any of these invariants — an ``out_row0`` that
forgets the ``m`` offset, a row bump that drops ``K``, a band built from the
wrong field — produces overlapping or gapped bands that only surface as
numerically wrong R₀ entries, far from the layout code. This rule proves the
invariants by abstract interpretation over the AST shapes:

  * **row partition** — in any loop assigning ``replace(..., tail_row0=...,
    out_row0=...)``: ``tail_row0`` is exactly the running accumulator,
    ``out_row0`` is ``acc + <node>.m``, and the accumulator advances by
    ``<node>.m + <node>.K`` (same node expression) — so consecutive bands
    tile ``[0, r0_rows)`` with no overlap and no gap. ``r0_rows`` passed
    anywhere in the same function must be the final accumulator, and
    ``total_rows`` must be ``sum(<node>.m ...)``.
  * **column prefix** — a loop storing ``col_start[...]`` must store exactly
    the running accumulator (prefix-sum property: ``col0 + width <=
    num_cols`` for every node), and ``num_cols`` must be the final
    accumulator.
  * **pow2 bucketing** — ``next_pow2`` must be the canonical monotone
    ``1 << max(int(x) - 1, 0).bit_length()``; in functions that bucket with
    it, *every* capacity field among ``m``/``K``/``P`` passed to ``replace``
    must go through ``next_pow2`` (a single un-bucketed field breaks the
    cache-hit monotonicity argument).
  * **band contract** — ``SlabBand(kind="tail", ...)`` fields must come from
    ``tail_row0/m/col_start/n`` and ``kind="out"`` from
    ``out_row0/K/subtree_start/subtree_width``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path

#: SlabBand keyword -> required source attribute, per band kind.
_BAND_CONTRACT = {
    "tail": {"row0": "tail_row0", "rows": "m", "col0": "col_start",
             "width": "n"},
    "out": {"row0": "out_row0", "rows": "K", "col0": "subtree_start",
            "width": "subtree_width"},
}

_CAPACITY_FIELDS = ("m", "K", "P")


def _is_replace(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "replace") or \
        (isinstance(f, ast.Name) and f.id == "replace")


def _kw(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _dump(node: ast.AST) -> str:
    return ast.dump(node)


def _is_sum_of_m(node: ast.expr) -> bool:
    """``sum(<x>.m for ...)`` (or listcomp equivalent)."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "sum" and node.args):
        return False
    gen = node.args[0]
    if isinstance(gen, (ast.GeneratorExp, ast.ListComp)):
        return isinstance(gen.elt, ast.Attribute) and gen.elt.attr == "m"
    return False


def _canonical_pow2(param: str) -> str:
    tmpl = ast.parse(f"1 << max(int({param}) - 1, 0).bit_length()",
                     mode="eval")
    return _dump(tmpl.body)


class SlabLayoutRule(Rule):
    rule_id = "FGT012"
    severity = Severity.ERROR
    fix_hint = ("keep the layout arithmetic canonical: tail_row0=acc, "
                "out_row0=acc + node.m, acc += node.m + node.K per node "
                "(r0_rows = final acc, total_rows = sum of node.m); "
                "col_start[x] = acc with num_cols = final acc; bucket every "
                "capacity field through next_pow2")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if port_path(ctx.path) is None:
            return
        yield from self._check_band_calls(ctx)
        yield from self._check_pow2_def(ctx)
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_row_layout(ctx, fn)
                yield from self._check_col_prefix(ctx, fn)
                yield from self._check_pow2_use(ctx, fn)

    # -- band contract --------------------------------------------------

    def _check_band_calls(self, ctx: FileContext) -> Iterator[Finding]:
        for call in ast.walk(ctx.tree):
            if not (isinstance(call, ast.Call)
                    and ((isinstance(call.func, ast.Name)
                          and call.func.id == "SlabBand")
                         or (isinstance(call.func, ast.Attribute)
                             and call.func.attr == "SlabBand"))):
                continue
            kind = _kw(call, "kind")
            if not (isinstance(kind, ast.Constant)
                    and kind.value in _BAND_CONTRACT):
                continue
            contract = _BAND_CONTRACT[kind.value]
            for field, want in contract.items():
                val = _kw(call, field)
                # Only attribute-sourced fields are provable; names/ints are
                # the caller's business (e.g. synthetic bands in tests).
                if isinstance(val, ast.Attribute) and val.attr != want:
                    yield self.finding(
                        ctx, val,
                        f"SlabBand(kind=\"{kind.value}\") takes `{field}` "
                        f"from `.{val.attr}` — the {kind.value}-band "
                        f"contract requires `.{want}` (stale band layout)")

    # -- row partition ---------------------------------------------------

    def _check_row_layout(self, ctx: FileContext, fn) -> Iterator[Finding]:
        found_loop = False
        acc_name = None
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            replace_call = None
            for stmt in ast.walk(loop):
                if isinstance(stmt, ast.Assign) \
                        and isinstance(stmt.value, ast.Call) \
                        and _is_replace(stmt.value) \
                        and _kw(stmt.value, "tail_row0") is not None \
                        and _kw(stmt.value, "out_row0") is not None:
                    replace_call = stmt.value
                    break
            if replace_call is None:
                continue
            found_loop = True
            tail = _kw(replace_call, "tail_row0")
            out = _kw(replace_call, "out_row0")

            if not isinstance(tail, ast.Name):
                yield self.finding(
                    ctx, tail,
                    "`tail_row0` must be the running row accumulator "
                    "(a plain name) — anything else breaks the band "
                    "partition proof")
                continue
            acc_name = tail.id

            # out_row0 == acc + <node>.m
            m_expr = None
            if (isinstance(out, ast.BinOp) and isinstance(out.op, ast.Add)
                    and isinstance(out.left, ast.Name)
                    and out.left.id == acc_name
                    and isinstance(out.right, ast.Attribute)
                    and out.right.attr == "m"):
                m_expr = out.right
            else:
                yield self.finding(
                    ctx, out,
                    f"`out_row0` must be `{acc_name} + <node>.m` (the K "
                    f"rows start right after the m tail rows) — this "
                    f"expression places the out band elsewhere")

            # acc += <node>.m + <node>.K with the SAME node expression
            bump = None
            for stmt in ast.walk(loop):
                if isinstance(stmt, ast.AugAssign) \
                        and isinstance(stmt.op, ast.Add) \
                        and isinstance(stmt.target, ast.Name) \
                        and stmt.target.id == acc_name:
                    bump = stmt
                    break
            if bump is None:
                yield self.finding(
                    ctx, loop,
                    f"row accumulator `{acc_name}` never advances inside "
                    f"the layout loop — every band would start at the same "
                    f"row")
                continue
            v = bump.value
            ok = (isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add)
                  and isinstance(v.left, ast.Attribute) and v.left.attr == "m"
                  and isinstance(v.right, ast.Attribute)
                  and v.right.attr == "K"
                  and _dump(v.left.value) == _dump(v.right.value)
                  and (m_expr is None or _dump(v.left) == _dump(m_expr)))
            if not ok:
                yield self.finding(
                    ctx, bump,
                    f"row accumulator must advance by `<node>.m + <node>.K` "
                    f"per node (same node as `out_row0`) — this bump leaves "
                    f"the bands overlapping or gapped")

        if not found_loop or acc_name is None:
            return

        # r0_rows / total_rows derived from the finished layout.
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            r0 = _kw(call, "r0_rows")
            if r0 is not None and not (isinstance(r0, ast.Name)
                                       and r0.id == acc_name):
                yield self.finding(
                    ctx, r0,
                    f"`r0_rows` must be the final row accumulator "
                    f"`{acc_name}` — any other value desynchronizes the "
                    f"slab height from the band layout")
            tot = _kw(call, "total_rows")
            if tot is not None and not self._is_total_rows(fn, tot):
                yield self.finding(
                    ctx, tot,
                    "`total_rows` must be `sum(<node>.m ...)` over the "
                    "laid-out nodes (directly or via a local alias)")

    def _is_total_rows(self, fn, expr: ast.expr) -> bool:
        if _is_sum_of_m(expr):
            return True
        if isinstance(expr, ast.Name):  # one-level local alias
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.targets[0].id == expr.id:
                    return _is_sum_of_m(stmt.value)
        return False

    # -- column prefix ---------------------------------------------------

    def _check_col_prefix(self, ctx: FileContext, fn) -> Iterator[Finding]:
        acc_name = None
        for loop in ast.walk(fn):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            store = None
            for stmt in ast.walk(loop):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Subscript) \
                        and isinstance(stmt.targets[0].value, ast.Name) \
                        and stmt.targets[0].value.id == "col_start":
                    store = stmt
                    break
            if store is None:
                continue
            bump_names = {
                s.target.id for s in ast.walk(loop)
                if isinstance(s, ast.AugAssign)
                and isinstance(s.target, ast.Name)}
            if not (isinstance(store.value, ast.Name)
                    and store.value.id in bump_names):
                yield self.finding(
                    ctx, store,
                    "`col_start[...]` must store the running column "
                    "accumulator (prefix-sum layout) — otherwise "
                    "`col0 + width <= num_cols` is unprovable")
                continue
            acc_name = store.value.id

        if acc_name is None:
            return
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "num_cols":
                if not (isinstance(stmt.value, ast.Name)
                        and stmt.value.id == acc_name):
                    yield self.finding(
                        ctx, stmt,
                        f"`num_cols` must be the final column accumulator "
                        f"`{acc_name}` — the prefix-sum invariant "
                        f"`col_start[last] + width == num_cols` fails "
                        f"otherwise")

    # -- pow2 bucketing --------------------------------------------------

    def _check_pow2_def(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name == "next_pow2"):
                continue
            body = [s for s in fn.body
                    if not (isinstance(s, ast.Expr)
                            and isinstance(s.value, ast.Constant)
                            and isinstance(s.value.value, str))]
            params = fn.args.args
            ok = (len(body) == 1 and isinstance(body[0], ast.Return)
                  and body[0].value is not None and len(params) == 1
                  and _dump(body[0].value)
                  == _canonical_pow2(params[0].arg))
            if not ok:
                yield self.finding(
                    ctx, fn,
                    "`next_pow2` must be the canonical "
                    "`1 << max(int(x) - 1, 0).bit_length()` — monotone, "
                    "and exact on powers of two; a variant breaks the "
                    "capacity-bucketing cache-hit proof")

    def _check_pow2_use(self, ctx: FileContext, fn) -> Iterator[Finding]:
        calls_pow2 = any(
            isinstance(c, ast.Call) and (
                (isinstance(c.func, ast.Name) and c.func.id == "next_pow2")
                or (isinstance(c.func, ast.Attribute)
                    and c.func.attr == "next_pow2"))
            for c in ast.walk(fn))
        if not calls_pow2:
            return
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call) and _is_replace(call)):
                continue
            for field in _CAPACITY_FIELDS:
                val = _kw(call, field)
                if val is None:
                    continue
                bucketed = isinstance(val, ast.Call) and (
                    (isinstance(val.func, ast.Name)
                     and val.func.id == "next_pow2")
                    or (isinstance(val.func, ast.Attribute)
                        and val.func.attr == "next_pow2"))
                if not bucketed:
                    yield self.finding(
                        ctx, val,
                        f"capacity field `{field}` is set without "
                        f"`next_pow2(...)` in a bucketing function — one "
                        f"un-bucketed field breaks pow2 monotonicity "
                        f"(spec_fits may flap between hits and misses)")
