"""Join trees and the FiGaRo execution plan, split static/dynamic.

A `JoinTree` fixes the evaluation order of the acyclic natural join (paper §2).
`build_plan` compiles the database + tree into a `FigaroPlan`, which is split
into two halves:

  * `PlanSpec` / `NodeSpec` — the **static** half: shapes, tree topology,
    column layout, and the R₀ row layout (where every node's tail block and
    generalized-tail block lands). All Python ints/tuples, hashable; the
    engine keys its per-signature cache on it.
  * `NodeIndex` — the **dynamic** half: per-node segment/group index arrays
    and child lookup tables, built as numpy on the host. `FigaroPlan.to`
    moves them to a device once per (plan, device), as int64 tensors, and
    caches the result on the plan.

`plan.nodes` yields merged per-node `NodePlan` views (spec + index + data).
`import_plan` converts a plan of the JAX package (anything with a ``spec``
and numpy ``index`` / ``data`` fields) into this package's plan without
importing that package.

Terminology matches the paper: for node ``i``, ``X̄_i`` = all join attributes of
``S_i``; ``X̄_p`` = join attributes shared with the parent (empty for the root or
for Cartesian edges); ``X̄_ij`` = attributes shared with child ``j`` (== child's
``X̄_p``).

R₀ row layout: Algorithm 2 emits, per node in reversed preorder, first the
``m_i`` scaled-tail rows (at column ``col_start``) and then the ``K_i``
generalized-tail rows (root: head rows) at column ``subtree_start``. The
offsets are precomputed here (``tail_row0`` / ``out_row0``) so `figaro_r0`
assembles R₀ scatter-free from row slabs in layout order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .relation import Database, Relation

__all__ = [
    "JoinTree",
    "NodeSpec",
    "NodeIndex",
    "PlanSpec",
    "SlabBand",
    "NodePlan",
    "FigaroPlan",
    "build_plan",
    "import_plan",
]


@dataclasses.dataclass
class JoinTree:
    """Rooted join tree over relation names: ``parent[name]`` (root maps to None)."""

    db: Database
    parent: dict[str, str | None]

    def __post_init__(self) -> None:
        roots = [n for n, p in self.parent.items() if p is None]
        if len(roots) != 1:
            raise ValueError(f"join tree needs exactly one root, got {roots}")
        self.root = roots[0]
        self.children: dict[str, list[str]] = {n: [] for n in self.parent}
        for n, p in self.parent.items():
            if p is not None:
                self.children[p].append(n)
        if set(self.parent) != set(self.db.names):
            raise ValueError("join tree nodes != database relations")
        self._validate_join_tree_property()

    @staticmethod
    def from_edges(db: Database, root: str,
                   edges: Sequence[tuple[str, str]]) -> "JoinTree":
        """Build a join tree rooted at ``root``; ``edges`` may be given in any
        orientation (they are re-oriented away from the root), so one edge set
        can be evaluated under every join-tree choice (Table 2).

        Unknown names fail eagerly: a ``root`` or edge endpoint that is not a
        relation of ``db`` raises a `ValueError` naming it and listing the
        ingested relations, instead of a bare `KeyError` (or a misleading
        not-a-tree error) deep inside tree construction."""
        names = set(db.names)
        unknown = sorted({n for e in edges for n in e if n not in names})
        if root not in names and root not in unknown:
            unknown.insert(0, root)
        if unknown:
            noun = "relation" if len(unknown) == 1 else "relations"
            raise ValueError(
                f"unknown {noun} {', '.join(map(repr, unknown))}; "
                f"ingested relations are {sorted(names)}")
        adj: dict[str, list[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        parent: dict[str, str | None] = {root: None}
        stack = [root]
        while stack:
            node = stack.pop()
            for nb in adj.get(node, []):
                if nb not in parent:
                    parent[nb] = node
                    stack.append(nb)
        if adj and len(parent) != len(adj):
            raise ValueError(
                f"edges do not form a tree reaching {set(adj) - set(parent)}")
        return JoinTree(db, parent)

    def preorder(self) -> list[str]:
        out: list[str] = []

        def rec(n: str) -> None:
            out.append(n)
            for c in self.children[n]:
                rec(c)

        rec(self.root)
        return out

    def edges(self) -> list[tuple[str, str]]:
        return [(p, c) for c, p in self.parent.items() if p is not None]

    def shared_attrs(self, a: str, b: str) -> tuple[str, ...]:
        ra, rb = self.db[a], self.db[b]
        return tuple(x for x in ra.key_attrs if x in rb.key_attrs)

    def _validate_join_tree_property(self) -> None:
        """Each attribute must induce a connected subtree (α-acyclicity)."""
        attr_nodes: dict[str, list[str]] = {}
        for rel in self.db:
            for a in rel.key_attrs:
                attr_nodes.setdefault(a, []).append(rel.name)
        for attr, nodes in attr_nodes.items():
            if len(nodes) <= 1:
                continue
            # The nodes containing `attr`, plus tree edges between them, must
            # form a connected subgraph.
            node_set = set(nodes)
            # union-find over tree edges whose both endpoints have the attr
            parent_uf = {n: n for n in nodes}

            def find(x: str) -> str:
                while parent_uf[x] != x:
                    parent_uf[x] = parent_uf[parent_uf[x]]
                    x = parent_uf[x]
                return x

            for p, c in self.edges():
                if p in node_set and c in node_set:
                    parent_uf[find(p)] = find(c)
            roots = {find(n) for n in nodes}
            if len(roots) != 1:
                raise ValueError(
                    f"attribute {attr!r} violates the join-tree property "
                    f"(occurs in disconnected nodes {sorted(nodes)}) — the join "
                    "is not acyclic for this tree; materialize a tree "
                    "decomposition first (paper §2)."
                )


def _group_structure(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """For a sorted code array return (elem_to_group, group_start, group_count)."""
    m = codes.shape[0]
    if m == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z, z
    first = np.ones(m, dtype=bool)
    first[1:] = codes[1:] != codes[:-1]
    elem_to_group = np.cumsum(first).astype(np.int32) - 1
    group_start = np.nonzero(first)[0].astype(np.int32)
    group_count = np.diff(np.append(group_start, m)).astype(np.int32)
    return elem_to_group, group_start, group_count


def _codes(rel: Relation, attrs: Sequence[str], cards: dict[str, int]) -> np.ndarray:
    """Composite int64 codes over `attrs` using *global* attribute cardinalities,
    so codes are comparable across relations."""
    code = np.zeros(rel.num_rows, dtype=np.int64)
    for a in attrs:
        code = code * cards[a] + rel.key_col(a)
    return code


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Static, hashable per-node metadata — part of the plan signature."""

    name: str
    idx: int
    parent: int  # -1 for root
    children: tuple[int, ...]
    # Static sizes.
    m: int  # rows
    n: int  # data columns
    K: int  # distinct full join keys X̄_i
    P: int  # distinct parent-shared keys X̄_p (1 for root / Cartesian edge)
    # Column layout (global, preorder => subtree columns contiguous).
    col_start: int
    subtree_start: int
    subtree_width: int
    # Column offsets of each child's subtree block inside this node's carried
    # Data matrix (aligned with `children`; block 0 = own cols is implicit).
    child_rel_col0: tuple[int, ...]
    # R₀ row layout (emission order: reversed preorder, tails then gen-tails).
    tail_row0: int  # first row of the m scaled-tail rows
    out_row0: int  # first row of the K gen-tail (root: head) rows


@dataclasses.dataclass
class NodeIndex:
    """Dynamic per-node index arrays.

    Built as numpy int32 at ingest on the host; `to` makes the device copy
    (int64 tensors, the index type torch's gathers and ``index_add_`` take).

    Capacity vs live size: for a *capacity-padded* plan (see
    `repro.core.plan_cache`) the static ``NodeSpec`` sizes are bucketed
    **capacities** and the live row/group/pgroup counts are dynamic — encoded
    here as ``row_mask`` (1.0 for live rows, 0.0 for padding) plus zeroed
    ``group_count`` entries for dead group slots. ``row_mask is None`` marks
    an exact (unpadded) plan.
    """

    # Row-level structure (all [m]).
    row_to_group: np.ndarray
    row_seg_start: np.ndarray  # first row index of the row's group
    pos_in_group: np.ndarray
    # Group-level structure.
    group_start: np.ndarray  # [K] first row of group
    group_count: np.ndarray  # [K]
    group_to_pgroup: np.ndarray  # [K]
    group_seg_start: np.ndarray  # [K] first group index of the group's pgroup
    pos_in_pgroup: np.ndarray  # [K]
    pgroup_count: np.ndarray  # [P] (# groups per pgroup)
    # Child lookups: child idx -> [K] index into that child's P-table.
    child_lookup: dict[int, np.ndarray]
    # Live-row mask [m] (float, 1.0 live / 0.0 dead) for capacity-padded
    # plans; None for exact plans.
    row_mask: np.ndarray | None = None

    def to(self, device: torch.device) -> "NodeIndex":
        """Device copy: index arrays as int64 tensors, the mask as float64."""
        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        return NodeIndex(
            row_to_group=idx(self.row_to_group),
            row_seg_start=idx(self.row_seg_start),
            pos_in_group=idx(self.pos_in_group),
            group_start=idx(self.group_start),
            group_count=idx(self.group_count),
            group_to_pgroup=idx(self.group_to_pgroup),
            group_seg_start=idx(self.group_seg_start),
            pos_in_pgroup=idx(self.pos_in_pgroup),
            pgroup_count=idx(self.pgroup_count),
            child_lookup={ch: idx(v) for ch, v in self.child_lookup.items()},
            row_mask=None if self.row_mask is None else torch.as_tensor(
                np.asarray(self.row_mask, dtype=np.float64), device=device))


@dataclasses.dataclass(frozen=True)
class SlabBand:
    """Band metadata of one emitted R₀ slab: rows [row0, row0+rows) hold node
    ``node``'s columns [col0, col0+width) and are zero outside that band —
    what band-wise assembly (`figaro_r0(assembly="band")`) materializes
    instead of padding every slab to the full ``num_cols`` width."""

    node: int
    kind: str  # "tail" (m scaled-tail rows) | "out" (K gen-tail/head rows)
    row0: int
    rows: int
    col0: int
    width: int


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static, hashable whole-plan metadata (the compilation signature)."""

    nodes: tuple[NodeSpec, ...]
    preorder: tuple[int, ...]
    root: int
    num_cols: int  # N = total data columns
    total_rows: int  # M = sum of m_i
    r0_rows: int  # rows of the (padded) almost-upper-triangular R0
    names: tuple[str, ...]
    # R₀ band layout in emission (row) order. Derived from `nodes` — always
    # recomputed in __post_init__, so `dataclasses.replace` (capacity
    # bucketing in plan_cache) can never leave it stale; any passed-in value
    # is overwritten.
    bands: tuple[SlabBand, ...] = ()

    def __post_init__(self) -> None:
        bands: list[SlabBand] = []
        for i in reversed(self.preorder):
            sp = self.nodes[i]
            bands.append(SlabBand(node=i, kind="tail", row0=sp.tail_row0,
                                  rows=sp.m, col0=sp.col_start, width=sp.n))
            bands.append(SlabBand(node=i, kind="out", row0=sp.out_row0,
                                  rows=sp.K, col0=sp.subtree_start,
                                  width=sp.subtree_width))
        object.__setattr__(self, "bands", tuple(bands))


@dataclasses.dataclass
class NodePlan:
    """Merged per-node view (spec + index + data) — the pre-split interface
    that benchmarks/examples/tests keep reading fields off."""

    name: str
    idx: int
    parent: int
    children: list[int]
    m: int
    n: int
    K: int
    P: int
    row_to_group: np.ndarray
    row_seg_start: np.ndarray
    pos_in_group: np.ndarray
    group_start: np.ndarray
    group_count: np.ndarray
    group_to_pgroup: np.ndarray
    group_seg_start: np.ndarray
    pos_in_pgroup: np.ndarray
    pgroup_count: np.ndarray
    child_lookup: dict[int, np.ndarray]
    col_start: int
    subtree_start: int
    subtree_width: int
    data: np.ndarray  # [m, n] float


@dataclasses.dataclass
class FigaroPlan:
    """(static spec, dynamic index, data).

    A plan built by `build_plan` lives on the host: ``device`` is None and
    ``index`` / ``data`` hold numpy arrays. `to` returns its copy on a
    device, whose ``index`` / ``data`` are tensors there; the copy is made
    once per device and cached on the host plan, so repeated dispatches of
    one plan move its index arrays once.
    """

    index: tuple[NodeIndex, ...]
    data: tuple  # per-node [m_i, n_i], preorder-indexed
    spec: PlanSpec
    device: torch.device | None = None  # None: host plan (numpy arrays)

    def to(self, device) -> "FigaroPlan":
        """This plan with index and data tensors on ``device`` (cached)."""
        device = torch.device(device)
        if self.device is not None:
            if self.device != device:
                raise ValueError(f"plan lives on {self.device}; move the "
                                 f"host plan to {device} instead")
            return self
        cache = self.__dict__.setdefault("_device_plans", {})
        moved = cache.get(str(device))
        if moved is None:
            moved = cache[str(device)] = FigaroPlan(
                index=tuple(ix.to(device) for ix in self.index),
                data=tuple(torch.as_tensor(np.asarray(d), device=device)
                           for d in self.data),
                spec=self.spec, device=device)
        return moved

    # -- pre-split compatibility surface ------------------------------------
    @property
    def nodes(self) -> list[NodePlan]:
        return [
            NodePlan(
                name=sp.name, idx=sp.idx, parent=sp.parent,
                children=list(sp.children), m=sp.m, n=sp.n, K=sp.K, P=sp.P,
                row_to_group=ix.row_to_group, row_seg_start=ix.row_seg_start,
                pos_in_group=ix.pos_in_group, group_start=ix.group_start,
                group_count=ix.group_count,
                group_to_pgroup=ix.group_to_pgroup,
                group_seg_start=ix.group_seg_start,
                pos_in_pgroup=ix.pos_in_pgroup, pgroup_count=ix.pgroup_count,
                child_lookup=ix.child_lookup, col_start=sp.col_start,
                subtree_start=sp.subtree_start,
                subtree_width=sp.subtree_width,
                data=d,
            )
            for sp, ix, d in zip(self.spec.nodes, self.index,
                                 self.data if self.data else
                                 (None,) * len(self.spec.nodes))
        ]

    @property
    def preorder(self) -> tuple[int, ...]:
        return self.spec.preorder

    @property
    def root(self) -> int:
        return self.spec.root

    @property
    def num_cols(self) -> int:
        return self.spec.num_cols

    @property
    def total_rows(self) -> int:
        return self.spec.total_rows

    @property
    def r0_rows(self) -> int:
        return self.spec.r0_rows

    @property
    def names(self) -> tuple[str, ...]:
        return self.spec.names

    def node_by_name(self, name: str) -> NodePlan:
        return self.nodes[self.spec.names.index(name)]

    def with_data(self, data) -> "FigaroPlan":
        """Same plan over new per-node data matrices (shapes must match)."""
        data = tuple(data)
        for sp, d in zip(self.spec.nodes, data):
            if tuple(d.shape[-2:]) != (sp.m, sp.n):
                raise ValueError(
                    f"{sp.name}: data shape {d.shape} != plan ({sp.m}, {sp.n})")
        return dataclasses.replace(self, data=data)

    def without_data(self) -> "FigaroPlan":
        """The same plan with no data (the engine passes data on its own)."""
        return dataclasses.replace(self, data=())


def build_plan(tree: JoinTree, dtype=np.float64) -> FigaroPlan:
    """Compile (database, join tree) into a FigaroPlan.

    Sorts every relation with the parent-shared attributes major (paper §5
    assumption), derives segment structure, child lookup tables, the global
    preorder column layout, and the static R₀ row layout.
    """
    db = tree.db
    order = tree.preorder()
    name_to_idx = {n: i for i, n in enumerate(order)}

    # Global attribute cardinalities (for cross-relation composite codes).
    cards: dict[str, int] = {}
    for rel in db:
        for a in rel.key_attrs:
            c = int(rel.key_col(a).max()) + 1 if rel.num_rows else 1
            cards[a] = max(cards.get(a, 1), c)

    # Column layout: preorder, so each subtree occupies a contiguous range.
    col_start: dict[str, int] = {}
    acc = 0
    for nme in order:
        col_start[nme] = acc
        acc += db[nme].num_data_cols
    num_cols = acc

    def subtree_cols(nme: str) -> int:
        return db[nme].num_data_cols + sum(subtree_cols(c) for c in tree.children[nme])

    # First pass: sort relations and build per-node group structure.
    sorted_rels: dict[str, Relation] = {}
    pkey_attrs: dict[str, tuple[str, ...]] = {}
    for nme in order:
        par = tree.parent[nme]
        xp = tree.shared_attrs(nme, par) if par is not None else ()
        rest = tuple(a for a in db[nme].key_attrs if a not in xp)
        sorted_rels[nme] = db[nme].sorted_by(tuple(xp) + rest)
        pkey_attrs[nme] = tuple(xp)

    # Distinct X̄_p tables per node (codes, sorted) — needed for parent lookups.
    pcode_table: dict[str, np.ndarray] = {}
    for nme in order:
        rel = sorted_rels[nme]
        pcodes = _codes(rel, pkey_attrs[nme], cards)
        pcode_table[nme] = np.unique(pcodes)  # sorted

    specs: list[NodeSpec] = [None] * len(order)  # type: ignore
    index: list[NodeIndex] = [None] * len(order)  # type: ignore
    data: list[np.ndarray] = [None] * len(order)  # type: ignore

    for nme in order:
        rel = sorted_rels[nme]
        par = tree.parent[nme]
        xp = pkey_attrs[nme]
        # Rows are sorted xp-major; full-key codes must therefore be mixed
        # xp-major too for sortedness:
        xp_major = tuple(xp) + tuple(a for a in rel.key_attrs if a not in xp)
        full_codes = _codes(rel, xp_major, cards)
        if np.any(np.diff(full_codes) < 0):
            raise AssertionError(f"{nme}: rows not sorted — ingest bug")
        row_to_group, group_start, group_count = _group_structure(full_codes)
        K = group_start.shape[0]
        pos_in_group = np.arange(rel.num_rows, dtype=np.int32) - group_start[row_to_group]
        row_seg_start = group_start[row_to_group]

        # pgroup structure over groups.
        pcodes_rows = _codes(rel, xp, cards)
        pcodes_groups = pcodes_rows[group_start]
        group_to_pgroup, pg_start, pg_count = _group_structure(pcodes_groups)
        P = pg_start.shape[0]
        group_seg_start = pg_start[group_to_pgroup]
        pos_in_pgroup = np.arange(K, dtype=np.int32) - group_seg_start

        # Child lookups: project this node's group keys onto X̄_ij and find the
        # index in the child's distinct X̄_p table. Fully-reduced inputs make
        # every lookup hit (asserted).
        child_lookup: dict[int, np.ndarray] = {}
        for ch in tree.children[nme]:
            xij = pkey_attrs[ch]
            proj = _codes(rel, xij, cards)[group_start]
            table = pcode_table[ch]
            pos = np.searchsorted(table, proj)
            pos = np.clip(pos, 0, table.shape[0] - 1)
            if not np.all(table[pos] == proj):
                raise ValueError(
                    f"dangling key {nme}->{ch}: database is not fully reduced; "
                    "run relation.full_reduce first")
            child_lookup[name_to_idx[ch]] = pos.astype(np.int32)

        # Carried-Data column layout: own cols first, then each child subtree;
        # preorder makes the blocks contiguous — asserted so the engine can
        # assemble by concatenation alone.
        child_idxs = tuple(name_to_idx[c] for c in tree.children[nme])
        rel_col0 = []
        cursor = db[nme].num_data_cols
        for c in tree.children[nme]:
            r0c = col_start[c] - col_start[nme]
            assert r0c == cursor, (nme, c, r0c, cursor)
            rel_col0.append(r0c)
            cursor += subtree_cols(c)
        assert cursor == subtree_cols(nme)

        i = name_to_idx[nme]
        specs[i] = NodeSpec(
            name=nme,
            idx=i,
            parent=-1 if par is None else name_to_idx[par],
            children=child_idxs,
            m=rel.num_rows,
            n=rel.num_data_cols,
            K=K,
            P=int(pcode_table[nme].shape[0]),
            col_start=col_start[nme],
            subtree_start=col_start[nme],
            subtree_width=subtree_cols(nme),
            child_rel_col0=tuple(rel_col0),
            tail_row0=-1,  # filled below once all K/m are known
            out_row0=-1,
        )
        index[i] = NodeIndex(
            row_to_group=row_to_group,
            row_seg_start=row_seg_start.astype(np.int32),
            pos_in_group=pos_in_group,
            group_start=group_start,
            group_count=group_count,
            group_to_pgroup=group_to_pgroup,
            group_seg_start=group_seg_start.astype(np.int32),
            pos_in_pgroup=pos_in_pgroup,
            pgroup_count=pg_count,
            child_lookup=child_lookup,
        )
        data[i] = np.asarray(rel.data, dtype=dtype)

    # Reverse-lookup sanity: child P-table == child's distinct X̄_p codes, and
    # the parent must cover all of them (full reduction the other way).
    for nme in order:
        for ch in tree.children[nme]:
            ci = name_to_idx[ch]
            lookup = index[name_to_idx[nme]].child_lookup[ci]
            covered = np.unique(lookup)
            if covered.shape[0] != specs[ci].P:
                raise ValueError(
                    f"dangling keys in {ch} (not matched by {nme}); run full_reduce")

    # R₀ row layout, in emission order (reversed preorder; per node the m tail
    # rows then the K generalized-tail rows — for the root, K head rows).
    preorder = tuple(name_to_idx[n] for n in order)
    row_acc = 0
    for i in reversed(preorder):
        sp = specs[i]
        specs[i] = dataclasses.replace(sp, tail_row0=row_acc,
                                       out_row0=row_acc + sp.m)
        row_acc += sp.m + sp.K

    total_rows = sum(sp.m for sp in specs)
    spec = PlanSpec(
        nodes=tuple(specs),
        preorder=preorder,
        root=name_to_idx[tree.root],
        num_cols=num_cols,
        total_rows=total_rows,
        r0_rows=row_acc,
        names=tuple(order),
    )
    return FigaroPlan(spec=spec, index=tuple(index), data=tuple(data))


def import_plan(obj, device=None) -> FigaroPlan:
    """This package's host `FigaroPlan` from another package's plan object.

    ``obj`` is duck-typed: a ``spec`` with the `PlanSpec` / `NodeSpec`
    fields, and ``index`` / ``data`` sequences of numpy-convertible arrays
    (the JAX package's `FigaroPlan`, for one). Nothing of that package is
    imported. With ``device``, the plan is also moved there at once (the
    copy is cached on the returned plan).
    """
    src = obj.spec
    nodes = tuple(
        NodeSpec(name=sp.name, idx=int(sp.idx), parent=int(sp.parent),
                 children=tuple(int(c) for c in sp.children),
                 m=int(sp.m), n=int(sp.n), K=int(sp.K), P=int(sp.P),
                 col_start=int(sp.col_start),
                 subtree_start=int(sp.subtree_start),
                 subtree_width=int(sp.subtree_width),
                 child_rel_col0=tuple(int(c) for c in sp.child_rel_col0),
                 tail_row0=int(sp.tail_row0), out_row0=int(sp.out_row0))
        for sp in src.nodes)
    spec = PlanSpec(nodes=nodes, preorder=tuple(int(i) for i in src.preorder),
                    root=int(src.root), num_cols=int(src.num_cols),
                    total_rows=int(src.total_rows), r0_rows=int(src.r0_rows),
                    names=tuple(src.names))
    index = tuple(
        NodeIndex(
            row_to_group=np.asarray(ix.row_to_group),
            row_seg_start=np.asarray(ix.row_seg_start),
            pos_in_group=np.asarray(ix.pos_in_group),
            group_start=np.asarray(ix.group_start),
            group_count=np.asarray(ix.group_count),
            group_to_pgroup=np.asarray(ix.group_to_pgroup),
            group_seg_start=np.asarray(ix.group_seg_start),
            pos_in_pgroup=np.asarray(ix.pos_in_pgroup),
            pgroup_count=np.asarray(ix.pgroup_count),
            child_lookup={int(ch): np.asarray(v)
                          for ch, v in ix.child_lookup.items()},
            row_mask=None if ix.row_mask is None
            else np.asarray(ix.row_mask))
        for ix in obj.index)
    data = tuple(np.asarray(d) for d in obj.data) if obj.data else ()
    plan = FigaroPlan(index=index, data=data, spec=spec)
    if device is not None:
        plan.to(device)
    return plan
