"""One façade for the join-factorization stack: `Session` / `JoinDataset`.

The port's counterpart of the JAX package's `repro.api` (exported as
`repro_torch.figaro`). A `Session` owns the compute configuration (engine,
device, dtype policy, bucketing defaults); a `JoinDataset` owns one join's
**plan lifecycle** (lazy capacity-plan build, online appends, stats) and
exposes the fluent compute methods::

    from repro_torch import figaro

    sess = figaro.Session(use_kernel=True, assembly="band")  # on the card
    ds = sess.ingest(tables).join(edges, root="auto")        # -> JoinDataset
    r = ds.qr()                                # eager: the first dispatch
    r = ds.qr()                                # captures one CUDA graph
    pca = ds.pca(k=3)                          # float64: eager, then replays
    beta, resid = ds.lsq("price", ridge=0.1)   # label by column name
    ds.append("Reviews", {"prod": keys}, rows) # within capacity: no miss
    ds.qr()                                    # launch-only: a replay
    ds.stats(), ds.explain()                   # counters; root ranking

``tables`` is a `Database` or the ``{name: (key_columns, data_matrix,
column_names)}`` mapping of `Database.from_arrays`. The compile-count
contract of the JAX package reads here as a capture-count one: one signature
miss per (pipeline kind, plan signature, static options) and one captured
graph per R signature on the card, captured on its second dispatch
(`core.engine`); an append within capacity replays, and a regrow or re-root
frees the graphs of the spec it supersedes.

``ds.serve(kind=...)`` (and ``Session.serve``) returns an async
micro-batching server over the dataset's plan holder
(`repro_torch.train.serve.make_figaro_server`): ``server.submit(request)``
returns a future, pending requests coalesce into bucketed batches that
replay one captured graph per bucket, and ``server.append`` and
``ds.append`` refresh one shared plan.

Distribution: ``Session(mesh=make_data_mesh())`` splits every batched
dispatch's request axis over the ranks of a data mesh (one process per
rank, `torch.distributed`; ``shard=`` overrides it per call), and
``Session.partitioned_qr`` runs fact-partitioned FiGaRo, partitions spread
over the mesh's ranks and combined by the butterfly TSQR
(`repro_torch.core.distributed`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import FigaroEngine, default_engine, plan_for
from repro_torch.core.join_tree import FigaroPlan, JoinTree, build_plan
from repro_torch.core.plan_cache import (PlanHolder, _append_rows,
                                         bucket_spec, build_capacity_plan,
                                         pad_data, pad_plan, spec_fits)
from repro_torch.core.relation import Database, full_reduce
from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import resolve_shard
from repro_torch.planner import (DatabaseStats, Replanner, choose_root,
                                 explain_text, rank_orientations,
                                 validate_names)
from repro_torch.planner.stats import normalize_edges
from repro_torch.train.async_serve import SERVE_KINDS, validate_serve_kind

__all__ = ["Session", "TableSet", "JoinDataset", "default_session",
           "SERVE_KINDS"]

_UNSET = object()

# Per-kind dtype defaults when the session does not pin one (QR serves in
# float32 by default; the spectral/regression reads default to float64 like
# the paper's evaluation).
_KIND_DTYPES = {
    "r0": torch.float32,
    "qr": torch.float32,
    "svd": torch.float64,
    "pca": torch.float64,
    "least_squares": torch.float64,
}

# Serving kind -> the engine pipeline whose dtype default it takes.
_SERVE_ENGINE_KINDS = {"qr": "qr", "svd": "svd", "pca": "pca",
                       "lsq": "least_squares"}
assert tuple(_SERVE_ENGINE_KINDS) == SERVE_KINDS

class Session:
    """Owns the compute configuration of the join-factorization stack.

    One `Session` = one engine (signature cache, captured graphs, counters),
    one device, one dtype policy and one bucketing default. Datasets made
    from it (`ingest(...).join(...)` / `from_tree(...)`) inherit that
    configuration; per-call keyword overrides always win.

    Parameters
    ----------
    engine:      a `FigaroEngine` to share (default: a fresh one built with
                 ``max_cached``). Sharing one engine shares its cache.
    device:      where the session computes. ``None`` is the card
                 (``cuda``); on a host without CUDA that raises, and the
                 caller passes ``device="cpu"`` to run the kernels' plain
                 PyTorch versions on the CPU.
    dtype:       pin every pipeline to one dtype; ``None`` (default) keeps
                 the per-kind defaults (qr/r0: float32, svd/pca/lsq:
                 float64).
    bucket:      ``True`` (default): datasets build **bucketed** capacity
                 plans (power-of-two node sizes) and ad-hoc plans are padded
                 into their buckets at dispatch, so near-miss shapes share
                 one signature. ``False``: capacities equal the exact live
                 sizes — every append regrows the plan (one miss each).
    headroom:    extra row capacity per node reserved at plan build, so a
                 known append rate cannot immediately overflow a bucket.
    method, leaf_rows, panel, use_kernel, assembly:
                 pipeline defaults forwarded to every dispatch:
                 ``use_kernel=True`` routes each join-tree node through the
                 fused CUDA pass (`repro_torch.kernels.node_fused`) and the
                 TSQR panels through the CUDA `panel_qr` kernel; ``assembly``
                 ("padded" | "band") picks the R₀ materialization.
    donate_data, max_cached:
                 forwarded to the engine constructor; combining either with
                 ``engine=`` raises (configure the engine directly instead).
                 Sessions default to non-donating engines (safe for repeated
                 dispatch of the same buffers); ``max_cached`` bounds the
                 per-kind cache (LRU, evictions counted, evicted graphs
                 freed).
    mesh:        a `launch.mesh.DataMesh` (`make_data_mesh`); batched
                 dispatches split their request axis over
                 ``mesh[shard_axis]`` (one cache entry per (plan
                 signature, mesh signature) on each rank), and
                 `partitioned_qr` spreads its partitions over the ranks.
                 ``device`` must be the mesh's device for this rank.
                 ``None`` = single-device dispatch.

    Capacity vs live size: **capacity** is static — each node's bucketed
    ``(rows, keys, parent-keys)`` and the R₀ row layout are part of the plan
    signature and of its captured graph; **live size** is dynamic — the
    live-row mask and the zeroed dead ``group_count`` slots are index
    tensors copied into the graph's input buffers on every replay. Dead rows
    carry Givens weight 0 and emit exactly-zero R₀ rows, so a capacity plan
    computes exactly what the underlying exact plan computes.
    """

    def __init__(self, *, engine: FigaroEngine | None = None, mesh=None,
                 shard_axis: str = "data", dtype=None, bucket: bool = True,
                 headroom: int = 0, method: str = "tsqr",
                 leaf_rows: int = 256, panel: int = 32,
                 use_kernel: bool = False, assembly: str = "padded",
                 donate_data: bool | None = None,
                 max_cached: int | None = None, device=None):
        if engine is not None and (max_cached is not None
                                   or donate_data is not None):
            raise ValueError("pass max_cached=/donate_data= to the engine's "
                             "constructor when supplying engine=")
        self.device = resolve_device(device)
        if mesh is not None:
            mesh, shard_axis = resolve_shard(mesh, shard_axis)
            mesh.check_device(self.device)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.engine = engine if engine is not None else FigaroEngine(
            donate_data=bool(donate_data), max_cached=max_cached)
        self.dtype = dtype
        self.bucket = bucket
        self.headroom = headroom
        self.method = method
        self.leaf_rows = leaf_rows
        self.panel = panel
        self.use_kernel = use_kernel
        self.assembly = assembly

    # -- dataset construction ------------------------------------------------

    def ingest(self, tables) -> "TableSet":
        """Wrap raw tables for the fluent chain: ``ingest(t).join(edges)``.

        ``tables`` is either a ready `Database` or the
        ``{name: (key_columns, data_matrix, column_names)}`` mapping of
        `Database.from_arrays`.
        """
        if isinstance(tables, Database):
            return TableSet(self, tables)
        if isinstance(tables, dict):
            return TableSet(self, Database.from_arrays(tables))
        raise TypeError(
            f"ingest() expects a Database or a {{name: (keys, data, cols)}} "
            f"dict, got {type(tables).__name__}")

    def from_tree(self, tree: JoinTree) -> "JoinDataset":
        """A `JoinDataset` over an existing `JoinTree`."""
        if not isinstance(tree, JoinTree):
            raise TypeError(f"from_tree() expects a JoinTree, "
                            f"got {type(tree).__name__}")
        return JoinDataset(self, tree)

    # -- option resolution ---------------------------------------------------

    def _dtype_for(self, kind: str, override):
        if override is not None:
            return override
        if self.dtype is not None:
            return self.dtype
        return _KIND_DTYPES[kind]

    def _post_opts(self, kind: str, dtype, method, leaf_rows, panel,
                   use_kernel, assembly) -> dict:
        return dict(
            dtype=self._dtype_for(kind, dtype),
            method=self.method if method is None else method,
            leaf_rows=self.leaf_rows if leaf_rows is None else leaf_rows,
            panel=self.panel if panel is None else panel,
            use_kernel=self.use_kernel if use_kernel is None else use_kernel,
            assembly=self.assembly if assembly is None else assembly)

    @staticmethod
    def _is_batched(data, batched) -> bool:
        """A leading batch axis ([B, m_i, n_i] data) switches to the batched
        dispatch; per-node plan data is always 2-D."""
        if batched is not None:
            return batched
        if data is None:
            return False
        leaves = list(data)
        return bool(leaves) and np.ndim(leaves[0]) == 3

    def _shard_for(self, batched: bool):
        if not batched or self.mesh is None:
            return None
        return (self.mesh, self.shard_axis)

    def _dispatch_opts(self, data, batched, shard, bucket):
        batched = self._is_batched(data, batched)
        return dict(batched=batched,
                    shard=self._shard_for(batched) if shard is _UNSET
                    else shard,
                    bucket=self.bucket if bucket is None else bucket,
                    device=self.device)

    # -- plan-level compute --------------------------------------------------

    def r0(self, tree_or_plan, data=None, *, batched=None, shard=_UNSET,
           bucket=None, dtype=None, use_kernel=None, assembly=None):
        """R₀ of Algorithm 2 under this session's configuration."""
        return self.engine.r0(
            plan_for(tree_or_plan), data,
            dtype=self._dtype_for("r0", dtype),
            use_kernel=self.use_kernel if use_kernel is None else use_kernel,
            assembly=self.assembly if assembly is None else assembly,
            **self._dispatch_opts(data, batched, shard, bucket))

    def qr(self, tree_or_plan, data=None, *, batched=None, shard=_UNSET,
           bucket=None, dtype=None, method=None, leaf_rows=None, panel=None,
           use_kernel=None, assembly=None):
        """Upper-triangular R of the join's QR ([B, N, N] when batched)."""
        return self.engine.qr(
            plan_for(tree_or_plan), data,
            **self._post_opts("qr", dtype, method, leaf_rows, panel,
                              use_kernel, assembly),
            **self._dispatch_opts(data, batched, shard, bucket))

    def svd(self, tree_or_plan, data=None, *, k: int | None = None,
            batched=None, shard=_UNSET, bucket=None, dtype=None, method=None,
            leaf_rows=None, panel=None, use_kernel=None, assembly=None):
        """Singular values + right-singular vectors; ``k`` keeps the top-k."""
        s, vt = self.engine.svd(
            plan_for(tree_or_plan), data,
            **self._post_opts("svd", dtype, method, leaf_rows, panel,
                              use_kernel, assembly),
            **self._dispatch_opts(data, batched, shard, bucket))
        if k is not None:
            s, vt = s[..., :k], vt[..., :k, :]
        return s, vt

    def pca(self, tree_or_plan, data=None, *, k: int | None = None,
            center: bool = True, batched=None, shard=_UNSET, bucket=None,
            dtype=None, method=None, leaf_rows=None, panel=None,
            use_kernel=None, assembly=None):
        """PCA of the join matrix from R (+ factorized means)."""
        return self.engine.pca(
            plan_for(tree_or_plan), data, k=k, center=center,
            **self._post_opts("pca", dtype, method, leaf_rows, panel,
                              use_kernel, assembly),
            **self._dispatch_opts(data, batched, shard, bucket))

    def least_squares(self, tree_or_plan, label_col: int, data=None, *,
                      ridge: float = 0.0, batched=None, shard=_UNSET,
                      bucket=None, dtype=None, method=None, leaf_rows=None,
                      panel=None, use_kernel=None, assembly=None):
        """argmin_β ‖A[:, feats]·β − A[:, label]‖² over the join."""
        return self.engine.least_squares(
            plan_for(tree_or_plan), label_col, data, ridge=ridge,
            **self._post_opts("least_squares", dtype, method, leaf_rows,
                              panel, use_kernel, assembly),
            **self._dispatch_opts(data, batched, shard, bucket))

    def serve(self, tree_or_plan, *, kind: str = "qr", label_col=None,
              k=None, ridge: float = 0.0, dtype=None, method=None,
              leaf_rows=None, use_kernel=None, assembly=None, mesh=_UNSET,
              shard_axis=None, max_batch: int = 32, queue_depth: int = 2):
        """An async pipelined serving endpoint for one join structure (see
        `train.serve.make_figaro_server`): ``submit(request)`` returns a
        `FigaroFuture`, pending requests coalesce up to ``max_batch`` rows,
        and ``queue_depth`` batches pipeline through the engine (depth >= 2
        overlaps the next batch's host-to-device copy with the in-flight
        dispatch). Engine, device, mesh and dtype default to this
        session's configuration. ``tree_or_plan`` may also be a
        `plan_cache.PlanHolder` to share plan state (what
        `JoinDataset.serve` passes). Over a mesh of P > 1 ranks every rank
        calls this with the same tables and options; rank 0's server takes
        the requests and the others follow its stream (`make_figaro_server`).
        """
        from repro_torch.train.serve import make_figaro_server

        validate_serve_kind(kind)
        target = tree_or_plan if isinstance(tree_or_plan, PlanHolder) \
            else plan_for(tree_or_plan)
        return make_figaro_server(
            target, kind=kind, label_col=label_col, k=k,
            ridge=ridge, engine=self.engine, device=self.device,
            dtype=self._dtype_for(_SERVE_ENGINE_KINDS[kind], dtype),
            method=self.method if method is None else method,
            leaf_rows=self.leaf_rows if leaf_rows is None else leaf_rows,
            use_kernel=self.use_kernel if use_kernel is None else use_kernel,
            assembly=self.assembly if assembly is None else assembly,
            mesh=self.mesh if mesh is _UNSET else mesh,
            shard_axis=self.shard_axis if shard_axis is None else shard_axis,
            max_batch=max_batch, queue_depth=queue_depth)

    def partitioned_qr(self, tree: JoinTree, num_parts: int, *, mesh=_UNSET,
                       dtype=None, method=None, use_kernel=None,
                       assembly=None):
        """Fact-partitioned QR (`core.distributed.partitioned_figaro_qr`)
        through this session's engine, device and mesh; float64 unless the
        session or the call pins a dtype."""
        from repro_torch.core.distributed import partitioned_figaro_qr

        return partitioned_figaro_qr(
            tree, num_parts, engine=self.engine,
            mesh=self.mesh if mesh is _UNSET else mesh,
            axis=self.shard_axis, device=self.device,
            dtype=(dtype if dtype is not None else
                   self.dtype if self.dtype is not None else torch.float64),
            method=self.method if method is None else method,
            use_kernel=self.use_kernel if use_kernel is None else use_kernel,
            assembly=self.assembly if assembly is None else assembly)


@dataclasses.dataclass
class TableSet:
    """Ingested tables awaiting a join choice: ``ingest(t).join(edges)``."""

    session: Session
    db: Database

    def join(self, *args, root: str | None = None, edges=None,
             reduce: bool = True, reroot: bool | None = None,
             hysteresis: float = 0.5) -> "JoinDataset":
        """Fix the join tree over ``edges`` (undirected pairs, any
        orientation) and return a `JoinDataset`.

        Accepted call shapes::

            join(edges)                    # root="auto": figaro-plan picks it
            join(edges, root="auto")       # same, explicit
            join(edges, root="Orders")     # hand-rooted
            join("Orders", edges)          # legacy positional order

        With ``root="auto"`` (or omitted) the planner
        (`repro_torch.planner.choose_root`) enumerates every rooted orientation of
        the acyclic join graph and picks the cheapest under the paper's cost
        model; ``ds.explain()`` shows the ranking. The chosen tree is built
        through the same `JoinTree.from_edges` as a hand-rooted join, so when
        the planner picks the root you would have picked, the plan signature
        — and therefore the captured program — is identical: auto costs zero
        extra signature misses.

        ``reroot`` enables adaptive re-rooting (defaults to on iff the root
        was auto-chosen): appends update the planner's exact statistics, and
        when growth makes another orientation cheaper by more than the
        ``hysteresis`` margin the dataset rebuilds on it at the next drain
        point.

        ``reduce`` drops dangling tuples first (`full_reduce`), which the
        FiGaRo pipeline requires of its inputs. Unknown relation names in
        ``root``/``edges`` raise `ValueError` here, eagerly, listing the
        ingested relations.
        """
        if len(args) == 2:  # legacy: join(root, edges)
            pos_root, pos_edges = args
        elif len(args) == 1:
            # join(edges) or join(edges, root=...) — a lone str is a root
            # (legacy partial form join("Orders", edges=...)).
            pos_root, pos_edges = (args[0], None) \
                if isinstance(args[0], str) else (None, args[0])
        elif len(args) == 0:
            pos_root, pos_edges = None, None
        else:
            raise TypeError(f"join() takes at most 2 positional arguments "
                            f"(root, edges), got {len(args)}")
        if pos_root is not None and root is not None:
            raise TypeError("join() got multiple values for 'root'")
        if pos_edges is not None and edges is not None:
            raise TypeError("join() got multiple values for 'edges'")
        root = pos_root if root is None else root
        edges = pos_edges if edges is None else edges
        if edges is None:
            raise TypeError("join() is missing 'edges'")
        edges = [tuple(e) for e in edges]
        auto = root is None or (root == "auto"
                                and "auto" not in self.db.relations)
        validate_names(self.db.names, edges, None if auto else root)
        db = full_reduce(self.db, edges) if reduce else self.db
        if auto:
            root = choose_root(db, edges)
        return JoinDataset(self.session, JoinTree.from_edges(db, root, edges),
                           edges=edges, auto=auto,
                           reroot=auto if reroot is None else reroot,
                           hysteresis=hysteresis)


class JoinDataset:
    """One join's plan lifecycle + fluent compute handle.

    The capacity plan is built lazily on first compute
    (`plan_cache.build_capacity_plan` under the session's
    ``bucket``/``headroom`` policy) and refreshed in place by
    ``append(...)`` (`plan_cache.refresh_plan`): appends that stay within
    the bucketed capacities keep the plan signature, so the next dispatch
    replays the signature's captured program with **zero misses** —
    ``stats()`` surfaces the miss/eviction counters and per-node capacity vs
    live rows so callers can assert that instead of guessing.

    Compute methods (``qr`` / ``svd`` / ``pca`` / ``lsq`` and raw ``r0``)
    read everything off the factorized R. Passing ``data`` overrides the
    ingested tables' values: 2-D per-node leaves dispatch a single pipeline;
    a leading batch axis ([B, rows_i, n_i]) switches to the batched
    dispatch.
    Request leaves sized to the *live* row counts are zero-padded up to
    capacity here; any other row count raises (a stale batch built before an
    ``append`` must be rebuilt, not silently zero-filled).
    """

    def __init__(self, session: Session, tree: JoinTree, *, edges=None,
                 auto: bool = False, reroot: bool = False,
                 hysteresis: float = 0.5):
        self._session = session
        self._tree = tree  # pre-plan only; once built, holder.plan owns it
        # The holder is the ONE plan state for this join (its servers share
        # it, so an append through either surface is visible to both).
        self._holder = PlanHolder(
            on_regrow=None if session.bucket else self._exact_regrow)
        # figaro-plan state: the undirected edge set (so every orientation
        # stays reachable), whether the root was auto-chosen, the adaptive
        # re-rooting policy, and warm capacity plans per alternative root.
        self._edges = normalize_edges(edges if edges is not None
                                      else tree.edges())
        self._auto = auto
        self._reroot_enabled = reroot
        self._hysteresis = hysteresis
        self._replanner: Replanner | None = None
        self._warm_plans: dict[str, FigaroPlan] = {}

    # -- plan lifecycle ------------------------------------------------------

    @property
    def tree(self) -> JoinTree:
        plan = self._holder.plan
        return plan.source_tree if plan is not None else self._tree

    @property
    def plan(self) -> FigaroPlan:
        """The capacity plan (built lazily on first access; owned by a
        `plan_cache.PlanHolder`)."""
        plan = self._holder.plan
        if plan is None:
            if self._auto and self._holder.counters()[0] > 0:
                # Pre-plan appends may have shifted the ranking; nothing is
                # built yet, so re-choosing the root is free.
                best = choose_root(self._tree.db, self._edges)
                if best != self._tree.root:
                    self._tree = JoinTree.from_edges(
                        self._tree.db, best, list(self._edges))
            if self._session.bucket:
                plan = build_capacity_plan(
                    self._tree, headroom=self._session.headroom)
            else:
                plan = self._exact_capacity_plan(self._tree)
            self._holder.set(plan)
            if self._auto and self._session.bucket:
                self._warm_runner_up()
        return plan

    def _warm_runner_up(self) -> None:
        # Keep the second-cheapest orientation's capacity plan warm: pure
        # numpy ingest + bucketing, no capture — if appends later flip the
        # ranking, the re-root re-pads into this spec (when it still fits)
        # instead of re-deriving capacities from scratch.
        tree = self.tree
        ranking = rank_orientations(tree.db, self._edges)
        if len(ranking) < 2:
            return
        runner_up = ranking[1].root
        self._warm_plans[runner_up] = build_capacity_plan(
            JoinTree.from_edges(tree.db, runner_up, list(self._edges)),
            headroom=self._session.headroom)

    def _exact_capacity_plan(self, tree: JoinTree) -> FigaroPlan:
        # Exact capacities: bit-identical numerics to the exact plan, but
        # any append overflows and regrows (one signature miss each).
        exact = build_plan(tree)
        plan = pad_plan(exact, exact.spec)
        plan.source_tree = tree
        plan.capacity_headroom = self._session.headroom
        return plan

    def _exact_regrow(self, new_plan: FigaroPlan) -> FigaroPlan:
        # Keep the session's bucket=False contract on regrow: refresh_plan
        # grows into power-of-two buckets, but this dataset's capacities must
        # stay exact (bit-identical path, one signature miss per append).
        return self._exact_capacity_plan(new_plan.source_tree)

    def append(self, node: str, keys, rows) -> bool:
        """Append rows to one relation; returns True when the refresh stayed
        within the plan's capacities (the next dispatch replays its captured
        program: launch-only).

        ``keys`` maps key-attribute name -> integer array, ``rows`` is a
        [rows, n_i] data matrix — the `plan_cache.refresh_plan` convention.
        Before the first compute the tables are simply grown (the capacity
        plan has not been built yet, so there is nothing to refresh).

        With adaptive re-rooting on (``join(..., root="auto")``), each append
        also updates the planner's exact statistics; when growth makes a
        different orientation cheaper past the hysteresis margin, the dataset
        rebuilds on it right here and returns False (the new orientation's
        first dispatch misses the signature cache and runs eagerly, its
        second captures). A regrow or re-root frees the captured graphs of
        the spec it supersedes (`FigaroEngine.release_graphs`). Column
        layout follows the live tree: re-read ``ds.columns`` after appends
        rather than caching it.
        """
        if self._holder.plan is None:
            rels = dict(self._tree.db.relations)
            if node not in rels:
                raise KeyError(f"unknown relation {node!r}; "
                               f"have {sorted(rels)}")
            rels[node] = _append_rows(rels[node], keys, rows)
            self._tree = JoinTree(Database(rels), dict(self._tree.parent))
            self._holder.note_external_append(
                node, rows=int(np.atleast_2d(np.asarray(rows)).shape[0]))
            return True
        old_spec = self._holder.plan.spec
        in_capacity = self._holder.refresh({node: (keys, rows)})
        if self._reroot_enabled:
            if self._replanner is None:
                # First post-plan append: collect stats now (they already
                # include the rows this refresh just ingested).
                self._replanner = self._make_replanner()
            else:
                self._replanner.note_append(node, self._key_rows(node, keys))
            proposal = self._replanner.proposal()
            if proposal is not None:
                self._reroot_to(proposal)
                in_capacity = False  # new orientation => new signature
        if self._holder.plan.spec != old_spec:
            # The superseded spec's graphs hold their bodies' intermediates
            # on the card and serve no plan of this dataset any more.
            self._session.engine.release_graphs(old_spec)
        return in_capacity

    # -- figaro-plan: explain + adaptive re-rooting --------------------------

    def explain(self) -> str:
        """Human-readable ranking of every join-tree orientation under the
        planner's cost model (`repro_torch.planner`), cheapest first, with the
        winner's per-node breakdown. ``*`` marks the planner's current pick,
        ``=`` the orientation this dataset is actually running — they can
        differ between an append that shifts the estimates and the re-root
        that follows (or permanently, for a hand-rooted join)."""
        rp = self._replanner
        ranking = rp.ranking() if rp is not None else \
            rank_orientations(self.tree.db, self._edges)
        return explain_text(ranking, chosen=ranking[0].root,
                            current=self.tree.root)

    def _key_rows(self, node: str, keys) -> np.ndarray:
        attrs = self.tree.db[node].key_attrs
        cols = [np.atleast_1d(np.asarray(keys[a], dtype=np.int64))
                for a in attrs]
        return np.stack(cols, axis=1) if cols else \
            np.zeros((1, 0), dtype=np.int64)

    def _make_replanner(self) -> Replanner:
        tree = self.tree
        return Replanner(
            stats=DatabaseStats.collect(tree.db, self._edges),
            names=tuple(tree.db.names), edges=self._edges,
            current_root=tree.root, hysteresis=self._hysteresis)

    def _reroot_to(self, root: str) -> None:
        """Rebuild the capacity plan on a new orientation and swap it in at a
        drain point (`PlanHolder.replace`). The displaced orientation's plan
        becomes the new warm alternative."""
        old = self._holder.plan
        tree = JoinTree.from_edges(old.source_tree.db, root,
                                   list(self._edges))
        if self._session.bucket:
            exact = build_plan(tree)
            warm = self._warm_plans.pop(root, None)
            cap = warm.spec if warm is not None \
                and spec_fits(exact.spec, warm.spec) \
                else bucket_spec(exact.spec, headroom=self._session.headroom)
            plan = pad_plan(exact, cap)
            plan.source_tree = tree
            plan.capacity_headroom = self._session.headroom
        else:
            plan = self._exact_capacity_plan(tree)
        self._holder.replace(plan)
        self._warm_plans[old.source_tree.root] = old
        if self._replanner is not None:
            self._replanner.on_reroot(root)

    def stats(self) -> dict:
        """Lifecycle + cache counters: per-node capacity vs live rows,
        appends/regrows, and the session engine's per-kind signature misses
        (``traces``, ``trace_count``), evictions, and cache size
        (``cached_executables``: the engine's cache entries). The keys are
        the JAX package's. A zero-miss append shows up as ``traces`` staying
        flat across dispatches."""
        engine = self._session.engine
        plan = self._holder.plan
        nodes = {}
        if plan is not None:
            for sp, ix in zip(plan.spec.nodes, plan.index):
                live = int(ix.row_mask.sum()) if ix.row_mask is not None \
                    else sp.m
                nodes[sp.name] = {"capacity_rows": sp.m, "live_rows": live}
        else:
            for name in self._tree.preorder():
                nodes[name] = {"capacity_rows": None,
                               "live_rows": self._tree.db[name].num_rows}
        appends, regrows = self._holder.counters()
        return {
            "plan_built": plan is not None,
            "appends": appends,
            "regrows": regrows,
            "root": self.tree.root,
            "auto_root": self._auto,
            "reroots": self._holder.reroot_count(),
            "append_volume": self._holder.append_volumes(),
            "nodes": nodes,
            "traces": self._session.engine.trace_counts(),
            "trace_count": engine.trace_count(),
            "evictions": engine.eviction_count(),
            "cached_executables": engine.cache_size(),
        }

    # -- column naming -------------------------------------------------------

    @property
    def columns(self) -> tuple[str, ...]:
        """Qualified global column names (``"Node.attr"``) in the plan's
        preorder column layout. Follows the *live* tree: an adaptive re-root
        changes the preorder, and with it the column order of R."""
        tree = self.tree
        return tuple(f"{name}.{a}" for name in tree.preorder()
                     for a in tree.db[name].data_attrs)

    def column_index(self, col) -> int:
        """Global column index of ``col``: an int (validated), a bare
        attribute name (must be unique across relations), or a qualified
        ``"Node.attr"``."""
        cols = self.columns
        if isinstance(col, (int, np.integer)):
            if not 0 <= int(col) < len(cols):
                raise IndexError(f"column index {col} out of range "
                                 f"[0, {len(cols)})")
            return int(col)
        if not isinstance(col, str):
            raise TypeError(f"column must be an int or str, "
                            f"got {type(col).__name__}")
        if "." in col:
            if col in cols:
                return cols.index(col)
            raise KeyError(f"unknown column {col!r}; have {list(cols)}")
        hits = [i for i, c in enumerate(cols) if c.split(".", 1)[1] == col]
        if not hits:
            raise KeyError(f"unknown column {col!r}; have {list(cols)}")
        if len(hits) > 1:
            raise KeyError(f"column name {col!r} is ambiguous: "
                           f"{[cols[i] for i in hits]} — qualify it")
        return hits[0]

    # -- compute -------------------------------------------------------------

    def _request_data(self, data):
        """Pad live-sized request leaves up to capacity (see class doc)."""
        if data is None:
            return None
        plan = self.plan
        data = tuple(data)
        if len(data) != len(plan.spec.nodes):
            raise ValueError(
                f"expected one data leaf per relation "
                f"({len(plan.spec.nodes)}: {list(plan.spec.names)}), "
                f"got {len(data)}")
        sizes = [(int(ix.row_mask.sum()) if ix.row_mask is not None
                  else sp.m, sp)
                 for sp, ix in zip(plan.spec.nodes, plan.index)]
        if all(np.shape(d)[-2] == sp.m for d, (_, sp) in zip(data, sizes)):
            return data  # already capacity-shaped: no host round trip
        for d, (live, sp) in zip(data, sizes):
            if np.shape(d)[-2] not in (live, sp.m):
                raise ValueError(
                    f"{sp.name}: request data has {np.shape(d)[-2]} rows; "
                    f"expected the live size ({live}) or the capacity "
                    f"({sp.m}) — rebuild request buffers after append()")
        return pad_data(data, plan.spec)

    def r0(self, data=None, **overrides):
        """R₀ of Algorithm 2 at the plan's capacity layout."""
        return self._session.r0(self.plan, self._request_data(data),
                                **overrides)

    def qr(self, data=None, **overrides):
        """R of the join's QR; ``data`` with a leading batch axis serves the
        whole batch in one dispatch."""
        return self._session.qr(self.plan, self._request_data(data),
                                **overrides)

    def svd(self, data=None, *, k: int | None = None, **overrides):
        """(s, Vᵀ) of the join matrix; ``k`` keeps the top-k."""
        return self._session.svd(self.plan, self._request_data(data), k=k,
                                 **overrides)

    def pca(self, data=None, *, k: int | None = None, center: bool = True,
            **overrides):
        """`PCAResult` (components, explained variance, factorized mean)."""
        return self._session.pca(self.plan, self._request_data(data), k=k,
                                 center=center, **overrides)

    def lsq(self, y, data=None, *, ridge: float = 0.0, **overrides):
        """Closed-form linear regression of label column ``y`` (index, bare
        name, or ``"Node.attr"``) against all other columns."""
        return self._session.least_squares(
            self.plan, self.column_index(y), self._request_data(data),
            ridge=ridge, **overrides)

    def serve(self, kind: str = "qr", *, label_col=None, **kw):
        """An async pipelined serving endpoint over this dataset's capacity
        plan (`train.serve.make_figaro_server`): ``submit(request)`` returns
        a `FigaroFuture`; ``server(batch)`` blocks for its answer.
        ``label_col`` (lsq) is an index, a bare name or ``"Node.attr"``.

        The server shares this dataset's plan *holder*: ``server.append``
        and ``ds.append`` refresh one plan state (draining the server's
        in-flight work first), so ``ds.plan`` / ``ds.stats()`` and the
        served plan can never fork.

        Over a session mesh of P > 1 ranks every rank builds its dataset
        from the same tables and calls ``serve`` alike. Rank 0 submits; its
        ``ds.append`` (and a re-root it decides) reaches every rank's
        dataset through the server's stream, while another rank's
        ``ds.append`` raises until the server is closed.
        """
        validate_serve_kind(kind)
        if label_col is not None:
            label_col = self.column_index(label_col)
        _ = self.plan  # build the capacity plan before sharing the holder
        return self._session.serve(self._holder, kind=kind,
                                   label_col=label_col, **kw)


_DEFAULT_SESSIONS: dict[str, Session] = {}


def default_session(device=None) -> Session:
    """Process-wide `Session` per device behind the module-level entry points
    (`figaro_qr`, `svd_over_join`, ...): shares `default_engine()`'s cache
    and keeps the JAX package's defaults for them (no bucketing, per-kind
    dtypes)."""
    device = resolve_device(device)
    session = _DEFAULT_SESSIONS.get(str(device))
    if session is None:
        session = _DEFAULT_SESSIONS[str(device)] = Session(
            engine=default_engine(), bucket=False, device=device)
    return session
