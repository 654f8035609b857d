"""Plan capacities: bucketed signatures and live-row masks.

A plan's node sizes ``(m, K, P)`` change with every table that is ingested;
this module rounds them up so that near-miss shapes share one plan
signature, the key of the engine's per-signature cache:

  * `bucket_spec(spec)` rounds every node's sizes up to powers of two, so all
    plans whose live sizes fall in the same buckets share one `PlanSpec`.
  * `pad_plan(plan, cap_spec)` embeds an exact plan into such a capacity spec:
    index arrays are padded to capacity shapes and a **live-row mask** rides
    along in the index.

Capacity vs live size (the contract every layer observes):

  * **capacity** is static: `NodeSpec.m/K/P`, the R₀ row layout, `r0_rows` —
    all bucketed, all part of the signature;
  * **live size** is dynamic: the row mask and the zeroed tail of
    ``group_count`` (dead group slots have count 0). `figaro.figaro_r0` uses
    the mask as the Givens weight vector (dead rows rotate with weight 0 and
    emit zero R₀ rows) and `counts.compute_counts` resolves the resulting
    0/0 aggregates to 0, so a capacity plan computes exactly what the
    underlying exact plan computes, padded with zero rows.

Padding layout invariants (relied on by the masked math):

  * dead rows sit at the tail of each node's row range and are appended to
    the **last live group** with continuing ``pos_in_group`` — never a
    segment start, so segmented prefix sums keep positive denominators;
  * dead group slots (``[K_live, K_cap)``) hold zero rows (``group_count
    0``), attach to the last live pgroup with continuing ``pos_in_pgroup``,
    and look up the child's last live P-slot — harmless, because their
    ``theta``/``full`` counts are identically 0;
  * dead pgroup slots hold zero groups, so carried scales ``√Φ↓`` vanish.

`build_capacity_plan(tree)` produces a refreshable plan (it keeps the source
`JoinTree` on the plan object); `refresh_plan(plan, rows)` appends rows,
re-ingests, and re-pads — into the *same* capacities when the new live sizes
still fit (the same signature: the engine replays its captured program), or
grown buckets when they don't (one signature miss, reported by the changed
spec). `PlanHolder` owns one such plan for a `JoinDataset`.
`plan_signature(plan)` digests a plan's structure, so that the ranks of a
mesh can check that they hold the same plan, and `replan_onto` rebuilds a
re-root that another rank decided.

A copy of the JAX package's ``core/plan_cache.py`` with tensors for data.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.sanitizer.locks import san_rlock
from repro_torch.sanitizer.races import shared_state

from .join_tree import FigaroPlan, JoinTree, NodeIndex, PlanSpec, build_plan
from .relation import Database, Relation

__all__ = [
    "next_pow2",
    "bucket_spec",
    "pad_plan",
    "pad_data",
    "build_capacity_plan",
    "refresh_plan",
    "spec_fits",
    "plan_signature",
    "replan_onto",
    "PlanHolder",
]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def bucket_spec(spec: PlanSpec, *, headroom: int = 0) -> PlanSpec:
    """Round every node's ``(m, K, P)`` up to powers of two and recompute the
    R₀ row layout for the bucketed sizes. Column layout is untouched (the
    feature schema is part of the tenant's signature, not its load).

    ``headroom`` rows are added to every node's live row count before
    bucketing, guaranteeing streaming appends of up to that many rows stay
    inside the capacity even when the live size sits exactly on a power of
    two (where ``next_pow2`` alone would leave zero slack)."""
    nodes = [dataclasses.replace(sp, m=next_pow2(sp.m + headroom),
                                 K=next_pow2(sp.K), P=next_pow2(sp.P))
             for sp in spec.nodes]
    row_acc = 0  # emission order: reversed preorder, m tail rows then K
    for i in reversed(spec.preorder):
        nodes[i] = dataclasses.replace(nodes[i], tail_row0=row_acc,
                                       out_row0=row_acc + nodes[i].m)
        row_acc += nodes[i].m + nodes[i].K
    return dataclasses.replace(
        spec, nodes=tuple(nodes),
        total_rows=sum(sp.m for sp in nodes), r0_rows=row_acc)


def spec_fits(live: PlanSpec, cap: PlanSpec) -> bool:
    """True iff an exact plan with spec ``live`` embeds into capacities
    ``cap``: same topology/schema, per-node sizes within capacity."""
    if (live.names != cap.names or live.preorder != cap.preorder
            or live.root != cap.root or live.num_cols != cap.num_cols):
        return False
    for sp, cp in zip(live.nodes, cap.nodes):
        if (sp.name != cp.name or sp.parent != cp.parent
                or sp.children != cp.children or sp.n != cp.n
                or sp.col_start != cp.col_start
                or sp.subtree_start != cp.subtree_start
                or sp.subtree_width != cp.subtree_width
                or sp.child_rel_col0 != cp.child_rel_col0):
            return False
        if sp.m > cp.m or sp.K > cp.K or sp.P > cp.P:
            return False
    return True


def _pad_tail(arr: np.ndarray, size: int, fill) -> np.ndarray:
    """Pad a 1-D int index array up to ``size`` with a constant fill value."""
    arr = np.asarray(arr)
    pad = size - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])


def pad_data(data, spec: PlanSpec):
    """Zero-pad per-node data ([..., m_i, n_i], numpy arrays or tensors) on
    the row axis up to the capacities of ``spec``. Data already at capacity
    pass through."""
    out = []
    for sp, d in zip(spec.nodes, data):
        if not isinstance(d, torch.Tensor):
            d = np.asarray(d)
        if d.shape[-2] > sp.m or d.shape[-1] != sp.n:
            raise ValueError(
                f"{sp.name}: data shape {tuple(d.shape)} does not fit "
                f"capacity ({sp.m}, {sp.n})")
        pad = sp.m - d.shape[-2]
        if pad and isinstance(d, torch.Tensor):
            d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        elif pad:
            widths = [(0, 0)] * (d.ndim - 2) + [(0, pad), (0, 0)]
            d = np.pad(d, widths)
        out.append(d)
    return tuple(out)


def _pad_index(ix: NodeIndex, sp_live, sp_cap,
               child_live_p: Mapping[int, int]) -> NodeIndex:
    """Embed one node's exact index arrays into capacity shapes (see module
    docstring for the layout invariants this establishes)."""
    m, k, p = sp_live.m, sp_live.K, sp_live.P
    mc, kc, pc = sp_cap.m, sp_cap.K, sp_cap.P
    last_group = k - 1
    last_pgroup = p - 1
    # Dead rows join the last live group, continuing its positions.
    row_to_group = _pad_tail(ix.row_to_group, mc, last_group)
    pos_in_group = _pad_tail(ix.pos_in_group, mc, 0)
    if mc > m:
        pos_in_group[m:] = ix.group_count[last_group] + np.arange(
            mc - m, dtype=pos_in_group.dtype)
    row_seg_start = _pad_tail(ix.row_seg_start, mc,
                              ix.group_start[last_group])
    # Dead group slots: zero rows, attached to the last live pgroup.
    group_start = _pad_tail(ix.group_start, kc, m)
    group_count = _pad_tail(ix.group_count, kc, 0)
    group_to_pgroup = _pad_tail(ix.group_to_pgroup, kc, last_pgroup)
    group_seg_start = _pad_tail(ix.group_seg_start, kc,
                                ix.group_seg_start[last_group])
    pos_in_pgroup = _pad_tail(ix.pos_in_pgroup, kc, 0)
    if kc > k:
        pos_in_pgroup[k:] = ix.pgroup_count[last_pgroup] + np.arange(
            kc - k, dtype=pos_in_pgroup.dtype)
    pgroup_count = _pad_tail(ix.pgroup_count, pc, 0)
    child_lookup = {}
    for ch, lookup in ix.child_lookup.items():
        # Dead parent groups point at the child's last LIVE P-slot; their
        # `full` count is 0, so the gather/segment-sum they feed is inert.
        child_lookup[ch] = _pad_tail(lookup, kc, child_live_p[ch] - 1)
    mask = np.zeros(mc, dtype=np.float64)
    mask[:m] = 1.0
    return NodeIndex(
        row_to_group=row_to_group, row_seg_start=row_seg_start,
        pos_in_group=pos_in_group, group_start=group_start,
        group_count=group_count, group_to_pgroup=group_to_pgroup,
        group_seg_start=group_seg_start, pos_in_pgroup=pos_in_pgroup,
        pgroup_count=pgroup_count, child_lookup=child_lookup, row_mask=mask)


def pad_plan(plan: FigaroPlan, cap_spec: PlanSpec | None = None) -> FigaroPlan:
    """Embed an exact plan into a capacity spec (default: its own buckets).

    Returns a masked host `FigaroPlan` whose spec is ``cap_spec`` — every
    plan padded into the same capacities shares one engine signature.
    """
    if plan.device is not None:
        raise ValueError("pad_plan takes a host plan (numpy index arrays)")
    if any(ix.row_mask is not None for ix in plan.index):
        raise ValueError("pad_plan expects an exact plan")
    cap_spec = bucket_spec(plan.spec) if cap_spec is None else cap_spec
    if not spec_fits(plan.spec, cap_spec):
        raise ValueError("plan does not fit the requested capacity spec")
    live_p = {sp.idx: sp.P for sp in plan.spec.nodes}
    index = [
        _pad_index(ix, sp_live, sp_cap, live_p)
        for sp_live, sp_cap, ix in zip(plan.spec.nodes, cap_spec.nodes,
                                       plan.index)
    ]
    data = pad_data(plan.data, cap_spec) if plan.data else ()
    return FigaroPlan(spec=cap_spec, index=tuple(index), data=data)


def build_capacity_plan(tree: JoinTree, *, dtype=np.float64,
                        cap_spec: PlanSpec | None = None,
                        headroom: int = 0) -> FigaroPlan:
    """Ingest + pad in one step, keeping the source tree for refreshes.

    ``headroom`` reserves extra row capacity per node (see `bucket_spec`) so
    a known append rate cannot immediately overflow a bucket. The returned
    plan carries ``plan.source_tree`` (a host-side attribute), which
    `refresh_plan` uses to re-ingest after appends.
    """
    exact = build_plan(tree, dtype=dtype)
    if cap_spec is None:
        cap_spec = bucket_spec(exact.spec, headroom=headroom)
    plan = pad_plan(exact, cap_spec)
    plan.source_tree = tree
    plan.capacity_headroom = headroom
    return plan


def _append_rows(rel: Relation, keys: Mapping[str, np.ndarray],
                 data: np.ndarray) -> Relation:
    data = np.atleast_2d(np.asarray(data, dtype=rel.data.dtype))
    if set(keys) != set(rel.key_attrs):
        raise ValueError(
            f"{rel.name}: appended keys {sorted(keys)} != relation key "
            f"attrs {sorted(rel.key_attrs)}")
    if rel.key_attrs:
        new_keys = np.stack(
            [np.asarray(keys[a], dtype=np.int64) for a in rel.key_attrs],
            axis=1)
    else:
        new_keys = np.zeros((data.shape[0], 0), dtype=np.int64)
    return Relation(rel.name, rel.key_attrs, rel.data_attrs,
                    np.concatenate([rel.keys, new_keys]),
                    np.concatenate([rel.data, data]))


def refresh_plan(
    plan: FigaroPlan,
    new_rows_per_node: Mapping[str, tuple[Mapping[str, np.ndarray],
                                          np.ndarray]],
) -> FigaroPlan:
    """Append-only data refresh: returns a new capacity plan over the grown
    database.

    ``new_rows_per_node`` maps relation name -> ``(key_columns, data_rows)``
    with ``key_columns`` a dict of integer-encoded key arrays (natural-join
    semantics, as at ingest) and ``data_rows`` a [rows, n_i] matrix. Appended
    rows must keep the database fully reduced (dangling keys raise, exactly
    as at `build_plan` time).

    If the refreshed live sizes still fit the plan's capacities, the result
    reuses the **same** `PlanSpec` — the same engine signature, so the next
    dispatch replays its captured program over the new index arrays.
    Otherwise the capacities grow to the new buckets (compare
    ``out.spec == plan.spec`` to detect the one-off signature miss).
    """
    tree = getattr(plan, "source_tree", None)
    if tree is None:
        raise ValueError(
            "refresh_plan needs a plan from build_capacity_plan / a previous "
            "refresh_plan (it keeps the source JoinTree for re-ingest)")
    rels = dict(tree.db.relations)
    for name, (keys, data) in new_rows_per_node.items():
        if name not in rels:
            raise KeyError(f"unknown relation {name!r}; have {sorted(rels)}")
        rels[name] = _append_rows(rels[name], keys, data)
    new_tree = JoinTree(Database(rels), dict(tree.parent))
    exact = build_plan(new_tree, dtype=plan.data[0].dtype if plan.data
                       else np.float64)
    headroom = getattr(plan, "capacity_headroom", 0)
    cap = plan.spec if spec_fits(exact.spec, plan.spec) \
        else bucket_spec(exact.spec, headroom=headroom)
    out = pad_plan(exact, cap)
    out.source_tree = new_tree
    out.capacity_headroom = headroom
    return out


def plan_signature(plan: FigaroPlan) -> str:
    """A digest of what a dispatch on ``plan`` computes over: its spec and
    every index and mask array (the join's structure and live sizes; not
    the data, which requests replace). Plans built from the same tables
    have the same signature in every process. Cached on the plan."""
    cached = plan.__dict__.get("_signature")
    if cached is not None:
        return cached
    digest = hashlib.blake2b(repr(plan.spec).encode(), digest_size=16)
    for ix in plan.index:
        for field in dataclasses.fields(ix):
            value = getattr(ix, field.name)
            for a in ([value[k] for k in sorted(value)]
                      if isinstance(value, dict) else [value]):
                if a is None:
                    digest.update(b"-")
                    continue
                if isinstance(a, torch.Tensor):
                    a = a.cpu().numpy()
                digest.update(np.ascontiguousarray(a, dtype=np.float64
                                                   if field.name == "row_mask"
                                                   else np.int64).data)
    out = plan.__dict__["_signature"] = digest.hexdigest()
    return out


def replan_onto(plan: FigaroPlan, parent: Mapping[str, str | None],
                cap_spec: PlanSpec, headroom: int = 0) -> FigaroPlan:
    """``plan``'s tables on the rooted join tree of ``parent`` (a parent map,
    in the order that fixes the column layout), padded into ``cap_spec``:
    the plan a re-root installs, rebuilt from the decision alone."""
    tree = JoinTree(plan.source_tree.db, dict(parent))
    out = pad_plan(build_plan(tree), cap_spec)
    out.source_tree = tree
    out.capacity_headroom = headroom
    return out


@shared_state({"_plan": "_lock", "_servers": "_lock",
               "_controller": "_lock",
               "appends": "_lock", "regrows": "_lock",
               "reroots": "_lock", "append_volume": "_lock"})
class PlanHolder:
    """Thread-safe owner of ONE current capacity plan.

    A `JoinDataset` and every server attached to it share a single holder,
    so an append through *either* surface is visible to both — there is
    exactly one plan state per join, never a silent fork
    (`repro_torch.train.async_serve` servers `attach` here).

    ``refresh(rows_per_node)`` is the one mutation path: it first **drains**
    every attached server (in-flight and queued requests were validated and
    padded against the old capacities, so they must be answered before the
    plan can change), then applies `refresh_plan` under the holder's lock.
    The ``appends`` / ``regrows`` counters live here for the same reason the
    plan does — any surface that can append must see the same counts.

    ``on_regrow`` is an optional policy hook applied when a refresh
    overflows the current capacities: it receives the (bucket-regrown)
    refreshed plan and returns the plan to install — `repro_torch.api` uses
    it to keep ``bucket=False`` datasets on exact capacities across regrows.

    The holder also records **per-relation append volume**
    (``append_volumes()``) — the raw signal the adaptive re-rooting policy
    (`repro_torch.planner.replan.Replanner`) keys off — and exposes
    ``replace(plan)``, the drain-then-install path a re-root uses.

    While a server over a mesh of several ranks is attached as its
    controller (`attach_controller`), ``refresh`` and ``replace`` drain and
    then hand the change to that server (``route``): on rank 0 its dispatch
    thread applies the change here (`apply_refresh`, `apply_replace`) and
    streams it to every rank at the same point of the stream; on another
    rank ``route`` raises, since changes come from rank 0.
    """

    def __init__(self, plan: FigaroPlan | None = None, *,
                 on_regrow: Callable[[FigaroPlan], FigaroPlan] | None = None):
        # Lock first: the race detector resolves it while __init__ assigns
        # the state it guards.
        self._lock = san_rlock("plan_holder._lock")
        self._on_regrow = on_regrow
        self._plan = plan
        self._servers: weakref.WeakSet = weakref.WeakSet()
        self._controller = None  # a weakref to a mesh server, or None
        self.appends = 0
        self.regrows = 0
        self.reroots = 0
        self.append_volume: dict[str, int] = {}

    @property
    def plan(self) -> FigaroPlan | None:
        with self._lock:
            return self._plan

    def set(self, plan: FigaroPlan) -> None:
        """Install a plan (the lazy first build); use `refresh` for appends."""
        with self._lock:
            self._plan = plan

    def attach(self, server) -> None:
        """Register a server (anything with ``flush()``) to drain before
        plan swaps. Held weakly — dropping the server detaches it."""
        with self._lock:
            self._servers.add(server)

    def attach_controller(self, server) -> None:
        """Route this holder's changes through ``server`` (a server over a
        mesh of several ranks; anything with ``route(op, payload)``). One at
        a time: a second live one raises."""
        with self._lock:
            live = self._controller() if self._controller else None
            if live is not None and live is not server:
                raise ValueError(
                    "this plan already streams through a live server over "
                    "the mesh; close it before serving the plan again")
            self._controller = weakref.ref(server)

    def detach_controller(self, server) -> None:
        with self._lock:
            if self._controller is not None \
                    and self._controller() in (server, None):
                self._controller = None

    def _routed(self):
        with self._lock:
            return self._controller() if self._controller else None

    def drain(self) -> None:
        """Block until every attached server has answered its queue.

        The snapshot is taken under the lock; the flushes run outside it —
        a server flush can dispatch and re-enter holder reads, and holding
        the lock across it would invert the holder/server lock order."""
        with self._lock:
            servers = list(self._servers)
        for server in servers:
            server.flush()

    def note_external_append(self, node: str | None = None,
                             rows: int = 0) -> None:
        """Count an append applied outside `refresh` (the pre-plan ingest
        path, where rows land in the source tables before the lazy first
        plan build)."""
        with self._lock:
            self.appends += 1
            if node is not None:
                self.append_volume[node] = \
                    self.append_volume.get(node, 0) + int(rows)

    def counters(self) -> tuple[int, int]:
        """(appends, regrows) read consistently under the holder lock."""
        with self._lock:
            return self.appends, self.regrows

    def reroot_count(self) -> int:
        with self._lock:
            return self.reroots

    def append_volumes(self) -> dict[str, int]:
        """Rows appended per relation since construction (both refresh and
        pre-plan appends) — the growth signal adaptive re-rooting consumes."""
        with self._lock:
            return dict(self.append_volume)

    def replace(self, plan: FigaroPlan) -> None:
        """Drain attached servers, then install a *structurally different*
        plan (adaptive re-root)."""
        self.drain()
        controller = self._routed()
        if controller is not None:
            controller.route("replace", plan)
            return
        self.apply_replace(plan)

    def apply_replace(self, plan: FigaroPlan) -> None:
        """`replace` without the drain and the routing: the stream's step."""
        with self._lock:
            if self._plan is None:
                raise ValueError("PlanHolder has no plan yet — build one "
                                 "before replacing")
            self._plan = plan
            self.reroots += 1

    def refresh(self, new_rows_per_node) -> bool:
        """Drain attached servers, then append rows via `refresh_plan`.

        Returns True when the refresh stayed within the plan's capacities
        (same signature — the next dispatch replays) and False when the
        capacities grew (one signature miss on the next dispatch).
        """
        self.drain()
        controller = self._routed()
        if controller is not None:
            return controller.route("append", new_rows_per_node)
        return self.apply_refresh(new_rows_per_node)

    def apply_refresh(self, new_rows_per_node) -> bool:
        """`refresh` without the drain and the routing: the stream's step."""
        with self._lock:
            if self._plan is None:
                raise ValueError("PlanHolder has no plan yet — build one "
                                 "before refreshing")
            new_plan = refresh_plan(self._plan, new_rows_per_node)
            in_capacity = new_plan.spec == self._plan.spec
            self.appends += 1
            for name, (_, data) in new_rows_per_node.items():
                rows = int(np.atleast_2d(np.asarray(data)).shape[0])
                self.append_volume[name] = \
                    self.append_volume.get(name, 0) + rows
            if not in_capacity:
                self.regrows += 1
                if self._on_regrow is not None:
                    new_plan = self._on_regrow(new_plan)
            self._plan = new_plan
        return in_capacity
