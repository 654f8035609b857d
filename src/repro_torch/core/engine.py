"""FiGaRo engine: the plan → counts → rotations → post-process pipeline.

`FigaroEngine` fronts the whole pipeline (`qr` / `svd` / `pca` /
`least_squares`, plus raw `r0`), each with a batched variant, on one device:

  * a host plan is moved to the device once and cached there
    (`FigaroPlan.to`); per-node data go to the device in the dispatch's
    dtype;
  * ``batched=True`` takes per-node data with a leading batch axis
    [B, m_i, n_i] and runs the pipeline once over the batch, with the plan
    held fixed — one join structure serving many feature-sets per dispatch;
  * ``bucket=True`` rounds the plan's sizes up to powers of two
    (`repro_torch.core.plan_cache`) before dispatching, so plans that differ
    only within one bucket share one signature. The capacity plan of an
    exact plan is built once and kept on the plan.

One cache entry per dispatch signature — (kind, device, plan spec and mask
layout, data shapes and dtypes, options) — with the JAX package's counters:
`trace_count` counts signature misses per kind, ``max_cached=`` bounds the
entries per kind with LRU eviction (`eviction_count`), and `cache_size`
reports the live entries.

Captured program (the counterpart of the JAX package's one executable per
signature): on the card, the body that produces R — counts, node passes, R₀
assembly, and the TSQR or blocked post-processing (R₀ itself for ``r0``) —
is captured into one CUDA graph per R signature (plan spec and masks, data
shapes, dtype, the options R depends on) and replayed on later calls.
``svd`` / ``pca`` / ``least_squares`` of the same R signature replay the
same graph and run their N×N tail eagerly: `torch.linalg.svd/eigh/solve`
check their ``info`` on the host, which a capture forbids. An R signature
is captured on its second dispatch: the first runs eagerly (it builds the
kernels and creates the library handles a capture needs), so a signature
dispatched once never holds a graph's memory. Each replay first copies the
request's data and the plan's index and mask tensors (when the plan is not
the one last copied) into the graph's input buffers — so an append within
capacity (new index arrays under the same spec) replays without a capture —
and clones R out after it. Graphs share one memory pool per engine, which
is safe because every capture and replay of an engine runs under one lock on
one stream, with inputs copied in and outputs cloned out. A graph holds its
body's intermediates, so it is freed when its last cache entry is evicted,
when the plan spec it serves is superseded (`release_graphs`, which a
dataset calls on a regrow or re-root), and when the engine is dropped.
Launch counts: a capture records its launches
(`_platform.recording_launches`) and every replay adds them, so the counts
read the same as for eager runs. `capture_count` counts captures.

Three things stay eager, by rule, not by fallback: CPU dispatches (no graph
on the host), numerics-sanitizer shadow dispatches, and dispatches inside
`eager_reference` (the reference a replay is checked against) — the last
two are never counted and never captured. Any thread may capture a
signature another thread ran eagerly (a server's dispatch thread does).

Serving (the engine half of `repro_torch.train.async_serve`):

  * ``batch_capacity=`` on every batched kind pads the request batch up to
    the given bucket by repeating the trailing request and slices the pad
    off every output, so live batch sizes inside one bucket share one
    signature and one graph. B=0 keeps its own signature and runs nothing.
  * `stage` starts the host-to-device copy of a request batch on a copy
    stream of the engine's own, from pinned host buffers, and returns the
    staged tensors with the event that ends their copies; the dispatch that
    consumes them makes its stream wait on that event.
  * ``shard=mesh`` (or ``shard=(mesh, axis)``, a `launch.mesh.DataMesh`)
    splits the request axis of a batched dispatch over the ranks of a data
    mesh, one process per rank, each calling the dispatch with the whole
    batch: the batch is padded to a multiple of the axis by repeating the
    trailing request, each rank runs its rows through its own cache entry
    (keyed on the mesh's signature as well) and captured graph, and
    `torch.distributed.all_gather` hands every rank the whole batch's
    answers, outside any graph. A mesh of one rank issues no collective.
    ``stage(shard=)`` copies only this rank's rows ahead of the dispatch.
  * ``donate_data=True`` makes a caller's request tensors the dispatch's
    to consume: the engine drops its references to them as soon as the body
    or the graph's copy-in has read them (PCA's column moments are formed
    before R), and nothing reads them again. ``plan.data`` is never
    donated. Donation is a contract about buffer lifetime: it changes no
    result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref

import torch

from repro_torch.kernels import _platform
from repro_torch.kernels._platform import resolve_device
from repro_torch.launch.mesh import resolve_shard
from repro_torch.sanitizer import _state as _san_state
from repro_torch.sanitizer import retrace as _san_retrace
from repro_torch.sanitizer.locks import san_lock, san_rlock
from repro_torch.sanitizer.races import shared_state

from .counts import compute_counts
from .figaro import ASSEMBLIES, _r0_batch, device_inputs
from .join_tree import FigaroPlan, JoinTree, NodeIndex, build_plan
from .plan_cache import bucket_spec, pad_data, pad_plan
from .postprocess import postprocess_r0

__all__ = ["FigaroEngine", "PCAResult", "Staged", "default_engine",
           "map_result", "plan_for"]

# The options R (or R₀) depends on: the key of a captured graph beside the
# plan and data signature.
_R_OPTIONS = ("dtype", "method", "leaf_rows", "panel", "use_kernel",
              "assembly")


def _bucketize(plan: FigaroPlan, data):
    """Pad an exact plan (and its data) into its power-of-two buckets so
    near-miss shapes share a signature; capacity plans pass through. The
    capacity plan is built once per exact plan and kept on it."""
    if any(ix.row_mask is not None for ix in plan.index):
        return plan, data  # already capacity-padded (its spec IS the bucket)
    if plan.device is not None:
        raise ValueError("bucket=True needs the host plan (the one build_plan "
                         "returned), not its device copy")
    padded = plan.__dict__.get("_capacity_plan")
    if padded is None:
        padded = plan.__dict__["_capacity_plan"] = pad_plan(
            plan, bucket_spec(plan.spec))
    if data is not None:
        data = pad_data(data, padded.spec)
    return padded, data


@dataclasses.dataclass
class PCAResult:
    components: torch.Tensor  # [..., k, N] principal directions (rows)
    explained_variance: torch.Tensor  # [..., k]
    mean: torch.Tensor  # [..., N] column means over the join
    num_rows: torch.Tensor  # [...]: |join|


def _column_moments(plan: FigaroPlan, data, dtype):
    """Factorized column sums [B, N] & row count of the join (no
    materialization), for per-node data [B, m_i, n_i].

    Row r of relation i appears in exactly Φ°_i(key(r)) join rows, so
    Σ_join A[:, Y_i] = Σ_r data_i[r] · Φ°_i(key(r)) — a per-node weighted sum.
    Node columns are preorder-contiguous, so the global vector is a concat.
    """
    counts = compute_counts(plan, dtype=dtype)
    parts = []
    for sp, ix, d in zip(plan.spec.nodes, plan.index, data):
        w = counts[sp.idx]["phi_circ"][ix.row_to_group]
        if ix.row_mask is not None:  # capacity plan: dead rows weigh nothing
            w = w * ix.row_mask.to(dtype)
        parts.append((w @ d.to(dtype)))
    sums = torch.cat(parts, dim=-1)
    total = counts[plan.spec.root]["full"].sum()
    return sums, total


def map_result(fn, out):
    """``fn`` applied to every tensor of a dispatch result: a tensor, a
    tuple of them, or a `PCAResult`."""
    if isinstance(out, tuple):
        return tuple(map_result(fn, o) for o in out)
    if isinstance(out, PCAResult):
        return PCAResult(*(map_result(fn, getattr(out, f.name))
                           for f in dataclasses.fields(out)))
    return fn(out)


def _repeat_pad(data, pad: int) -> list:
    """Pad the leading request-batch axis by repeating the trailing request
    — near-miss batch sizes then share a signature, and the pad rides
    through a well-posed pipeline (an all-zero pad would push singular
    systems through lsq/svd). The pad is sliced off the result."""
    return [torch.cat([d, d[-1:].expand((pad,) + tuple(d.shape[1:]))])
            for d in data]


class Staged(tuple):
    """Request leaves staged by `FigaroEngine.stage` and the event recorded
    on the copy stream after their copies (None on the CPU). ``shard`` is
    None, or (mesh key, live size, padded size) for the rows of one rank
    that ``stage(shard=)`` copied."""

    def __new__(cls, leaves, event, device, shard=None):
        obj = super().__new__(cls, leaves)
        obj.event = event
        obj.device = device
        obj.shard = shard
        return obj

    def consume(self) -> None:
        """Order the current stream after the copies, and keep the staged
        memory from reuse until that stream's work on it is done."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self:
            if t.device == self.device:
                t.record_stream(stream)


def _sharded_size(b: int, batch_capacity: int | None, p: int) -> int:
    """The request axis of a sharded dispatch: ``b`` live requests padded
    to ``batch_capacity``, then to a multiple of the axis size ``p``."""
    if batch_capacity is not None and batch_capacity < b:
        raise ValueError(f"batch_capacity={batch_capacity} smaller than the "
                         f"live request batch ({b})")
    return -(-max(b, batch_capacity or 0) // p) * p


def _rows_of(leaf, lo: int, hi: int, b: int) -> list:
    """Rows [lo, hi) of a leaf of ``b`` requests (an array, or the list of
    its requests' arrays), as a list of parts; rows past ``b`` repeat the
    trailing request (the pad of `_repeat_pad`)."""
    parts = [torch.as_tensor(x) for x in
             (leaf if isinstance(leaf, list) else [leaf])]
    out, at = [], 0
    for x in parts:
        start, stop = max(lo, at), min(hi, at + x.shape[0])
        if start < stop:
            out.append(x[start - at:stop - at])
        at += x.shape[0]
    short = (hi - lo) - sum(x.shape[0] for x in out)
    if short:
        last = next(x for x in reversed(parts) if x.shape[0])[-1:]
        out.append(last.expand((short,) + tuple(last.shape[1:])))
    return out


def _all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis, in rank
    order, on every rank."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def _empty(kind: str, plan: FigaroPlan, options):
    """The result of a batched dispatch over no requests: every output with
    a leading axis of 0, nothing run."""
    n = plan.spec.num_cols
    base = kind.removesuffix("_batched")

    def z(*shape):
        return torch.zeros((0,) + shape, dtype=options["dtype"],
                           device=plan.device)

    if base == "r0":
        return z(plan.spec.r0_rows, n)
    if base == "svd":
        return z(n), z(n, n)
    if base == "pca":
        k = options["k"]
        return PCAResult(z(k, n), z(k), z(n), z())
    if base == "least_squares":
        return z(n - 1), z()
    return z(n, n)


def _pca_tail(r, sums, total, *, k, center):
    mean = sums / total
    gram = r.mT @ r
    if center:
        gram = gram - total * (mean[..., :, None] * mean[..., None, :])
    cov = gram / torch.clamp(total - 1.0, min=1.0)
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    # The centered-Gram subtraction can leave tiny negative eigenvalues
    # (a variance); clamp before the top-k select so near-constant
    # columns report 0, not -1e-17.
    evals = torch.clamp(evals, min=0.0)
    order = torch.argsort(-evals, dim=-1)[..., :k]
    comps = torch.gather(evecs, -1, order[..., None, :].expand(
        evecs.shape[:-1] + (k,)))
    return PCAResult(components=comps.mT,
                     explained_variance=torch.gather(evals, -1, order),
                     mean=mean, num_rows=total.expand(mean.shape[:-1]))


def _least_squares_tail(r, *, label_col, ridge):
    n = r.shape[-1]
    # Permute label last, re-triangularize the permuted R (cheap: N×N).
    perm = [j for j in range(n) if j != label_col] + [label_col]
    rp = r[..., perm]
    rr = torch.linalg.qr(rp, mode="r").R[..., :n, :]
    r_ff = rr[..., : n - 1, : n - 1]
    r_fl = rr[..., : n - 1, n - 1]
    if ridge:
        g = r_ff.mT @ r_ff + ridge * torch.eye(n - 1, dtype=r.dtype,
                                               device=r.device)
        beta = torch.linalg.solve(g, (r_ff.mT @ r_fl[..., None]))[..., 0]
        # The ridge solution does not zero the projected residual, so
        # ‖Aβ − y‖ keeps both terms: ‖r_ff·β − r_fl‖² + rr[n−1,n−1]².
        fit = (r_ff @ beta[..., None])[..., 0] - r_fl
        resid = torch.sqrt(torch.sum(fit * fit, dim=-1)
                           + rr[..., n - 1, n - 1] ** 2)
    else:
        beta = torch.linalg.solve_triangular(
            r_ff, r_fl[..., None], upper=True)[..., 0]
        resid = torch.abs(rr[..., n - 1, n - 1])
    return beta, resid


def _index_tensors(plan: FigaroPlan) -> list:
    """Every index and mask tensor of a device plan, in a fixed order."""
    out = []
    for ix in plan.index:
        for field in dataclasses.fields(ix):
            value = getattr(ix, field.name)
            if isinstance(value, dict):
                out.extend(value[k] for k in sorted(value))
            elif value is not None:
                out.append(value)
    return out


def _static_plan(plan: FigaroPlan) -> FigaroPlan:
    """A copy of a device plan whose index and mask tensors are the graph's
    own input buffers."""
    def own(value):
        if isinstance(value, dict):
            return {k: v.clone() for k, v in value.items()}
        return None if value is None else value.clone()

    index = tuple(NodeIndex(**{f.name: own(getattr(ix, f.name))
                               for f in dataclasses.fields(ix)})
                  for ix in plan.index)
    return FigaroPlan(index=index, data=(), spec=plan.spec,
                      device=plan.device)


class _Graph:
    """One captured R body: the CUDA graph, its input buffers (the plan's
    index and mask tensors, then the data), its output, and the launches its
    capture recorded."""

    def __init__(self, graph, plan, data, out, launches):
        self.graph = graph
        self.index = _index_tensors(plan)
        self.data = data
        self.out = out
        self.launches = launches
        self._loaded = None  # weakref to the device plan last copied in

    def replay(self, plan: FigaroPlan, data) -> torch.Tensor:
        """Copy the inputs in, replay, clone R out (on the current stream).

        The plan's index and mask tensors are copied only when another
        device plan comes (an append, another dataset of the same spec): a
        host plan moves to the device once, and its device copy is never
        written, so the buffers still hold it. At the yelp scale that copy
        is about 1 ms of a 58 ms ``qr``."""
        if self._loaded is None or self._loaded() is not plan:
            for dst, src in zip(self.index, _index_tensors(plan),
                                strict=True):
                dst.copy_(src)
            self._loaded = weakref.ref(plan)
        for dst, src in zip(self.data, data, strict=True):
            dst.copy_(src)
        self.graph.replay()
        return self.out.clone()


@shared_state({"_cache": "_cache_lock", "_graphs": "_cache_lock",
               "_warm": "_cache_lock", "_trace_counts": "_count_lock",
               "_evictions": "_count_lock", "_captures": "_count_lock",
               "_copy_streams": "_stage_lock"})
class FigaroEngine:
    """Signature cache + dispatch for the FiGaRo pipeline.

    ``donate_data=True`` (default) lets each dispatch consume the request
    tensors a caller passes (serving: request buffers belong to the dispatch
    that answers them; see the module docstring). Tensors of ``plan.data``
    are never donated. Pass ``donate_data=False`` when callers re-dispatch
    the same buffers.

    ``max_cached=`` caps the number of cached signatures **per pipeline
    kind** (``qr``, ``qr_batched``, ...). The cache is LRU: dispatching a new
    signature past the cap evicts the least-recently-used entry of that kind
    (and frees its captured graph once no other entry replays it);
    re-dispatching an evicted signature is a miss again (visible in
    `trace_count`). The default (``None``) keeps every entry.
    """

    _STATIC = {
        "r0": ("dtype", "use_kernel", "assembly"),
        "r0_batched": ("dtype", "use_kernel", "assembly"),
        "qr": _R_OPTIONS,
        "qr_batched": _R_OPTIONS,
        "svd": _R_OPTIONS,
        "svd_batched": _R_OPTIONS,
        "pca": ("k", "center") + _R_OPTIONS,
        "pca_batched": ("k", "center") + _R_OPTIONS,
        "least_squares": ("label_col", "ridge") + _R_OPTIONS,
        "least_squares_batched": ("label_col", "ridge") + _R_OPTIONS,
    }

    def __init__(self, *, donate_data: bool = True,
                 max_cached: int | None = None):
        if max_cached is not None and max_cached < 1:
            raise ValueError(f"max_cached must be >= 1 or None, "
                             f"got {max_cached}")
        self.donate_data = bool(donate_data)
        self.max_cached = max_cached
        # Locks are created before the state they guard so the race
        # detector can resolve them mid-__init__. The cache lock guards the
        # entries and the graphs, the count lock the counters, and the graph
        # lock serializes every capture and replay (their graphs share one
        # memory pool).
        self._cache_lock = san_rlock("engine._cache_lock")
        self._count_lock = san_lock("engine._count_lock")
        self._graph_lock = san_lock("engine._graph_lock")
        self._stage_lock = san_lock("engine._stage_lock")
        self._trace_counts: collections.Counter = collections.Counter()
        self._evictions: collections.Counter = collections.Counter()
        self._captures: collections.Counter = collections.Counter()
        # signature -> the key of the R graph it replays (None: eager)
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._graphs: dict = {}  # R key -> _Graph
        self._warm: set = set()  # R keys run once eagerly, not captured yet
        self._local = threading.local()  # eager_reference, per thread
        self._copy_streams: dict = {}  # device -> `stage`'s copy stream
        # Under the graph lock: the graphs' shared memory pool and the
        # stream every capture and replay runs on.
        self._pool = None
        self._stream = None

    # -- cache plumbing ------------------------------------------------------

    def trace_count(self, kind: str | None = None) -> int:
        """Signature misses since construction; cache-hit tests assert this
        stays flat across same-signature dispatches."""
        with self._count_lock:
            if kind is None:
                return sum(self._trace_counts.values())
            return self._trace_counts[kind]

    def trace_counts(self) -> dict[str, int]:
        """Per-kind signature misses as a plain dict (for stats surfaces)."""
        with self._count_lock:
            return {k: int(v) for k, v in sorted(self._trace_counts.items())}

    def eviction_count(self, kind: str | None = None) -> int:
        """Entries evicted by the ``max_cached`` LRU policy, per kind."""
        with self._count_lock:
            if kind is None:
                return sum(self._evictions.values())
            return self._evictions[kind]

    def capture_count(self, kind: str | None = None) -> int:
        """CUDA graphs captured, by the kind whose dispatch captured them."""
        with self._count_lock:
            if kind is None:
                return sum(self._captures.values())
            return self._captures[kind]

    def cache_size(self, kind: str | None = None) -> int:
        """Number of live cache entries (per kind, or total)."""
        with self._cache_lock:
            if kind is None:
                return len(self._cache)
            return sum(1 for k in self._cache if k[0] == kind)

    def graph_count(self) -> int:
        """Number of live captured graphs."""
        with self._cache_lock:
            return len(self._graphs)

    @staticmethod
    def _signature(kind: str, plan: FigaroPlan, data, options,
                   mesh_key=None) -> tuple:
        """The cache key: kind, device, plan spec and masks, data shapes,
        static options, and the mesh of a sharded dispatch (its signature
        and axis; None unsharded), whose data are this rank's rows."""
        masks = tuple(ix.row_mask is None for ix in plan.index)
        shapes = tuple((tuple(d.shape), str(d.dtype)) for d in data)
        return (kind, str(plan.device), plan.spec, masks, shapes,
                tuple(sorted(options.items())), mesh_key)

    @staticmethod
    def _r_key(kind: str, key: tuple, options) -> tuple | None:
        """The R graph a signature replays: its plan and data signature, the
        R options, and whether it stops at R₀; None for a CPU dispatch. A
        rank's sharded dispatch replays the graph of its local rows."""
        _, device, spec, masks, shapes, _, _ = key
        if not device.startswith("cuda"):
            return None
        return (kind.startswith("r0"), device, spec, masks, shapes,
                tuple((k, options[k]) for k in _R_OPTIONS if k in options))

    def _lookup(self, kind: str, key: tuple, options):
        """The R key of ``key``'s entry; a miss adds the entry, counts it
        (and notes it for the retrace sanitizer) and evicts past the cap."""
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)  # LRU: most-recent at the tail
                return self._cache[key]
            with self._count_lock:
                self._trace_counts[kind] += 1
            if _san_state.STATE.enabled and _san_state.STATE.retrace:
                _san_retrace.note_trace(kind, key)
            r_key = self._cache[key] = self._r_key(kind, key, options)
            if self.max_cached is not None:
                while sum(1 for k in self._cache
                          if k[0] == kind) > self.max_cached:
                    oldest = next(k for k in self._cache if k[0] == kind)
                    self._drop_graph_of(self._cache.pop(oldest))
                    with self._count_lock:
                        self._evictions[kind] += 1
            return r_key

    def _drop_graph_of(self, r_key) -> None:
        """Free the graph of ``r_key`` once no entry replays it."""
        if r_key is not None and r_key not in self._cache.values():
            self._graphs.pop(r_key, None)
            self._warm.discard(r_key)

    def release_graphs(self, spec) -> int:
        """Free the captured graphs of the plan spec ``spec`` (one that a
        regrow or re-root superseded) and return how many went. The cache
        entries stay, so the counters do not move; a later dispatch of one
        runs eagerly once more and is captured on the next. The memory goes
        back to the card with the last graph of the pool (on
        `torch.cuda.empty_cache`, or when the allocator next runs short)."""
        with self._cache_lock:
            gone = [k for k in self._graphs if k[2] == spec]
            for k in gone:
                del self._graphs[k]
            self._warm = {k for k in self._warm if k[2] != spec}
        return len(gone)

    @contextlib.contextmanager
    def eager_reference(self):
        """Run this thread's dispatches inside the block eagerly and outside
        the cache — the same input preparation as any dispatch, then the
        body and tail, with no signature, count or graph: the reference a
        replay is checked against (``chip_smoke.py``, the GPU tests)."""
        before = getattr(self._local, "eager", False)
        self._local.eager = True
        try:
            yield
        finally:
            self._local.eager = before

    def _host_inputs(self, plan: FigaroPlan, data, options, device,
                     bucket: bool):
        """(plan, data, device) of a dispatch after validation and
        bucketing, still as the caller gave them."""
        if not isinstance(plan, FigaroPlan):
            raise TypeError(_plan_arg_error("plan", plan))
        if options.get("assembly", "padded") not in ASSEMBLIES:
            raise ValueError(f"unknown assembly {options['assembly']!r}; "
                             f"expected {ASSEMBLIES}")
        if plan.device is None:
            device = resolve_device(device)  # raise before any host work
        if bucket:
            plan, data = _bucketize(plan, data)
        return plan, data, device

    def _dispatch(self, kind: str, plan: FigaroPlan, data, *, device=None,
                  bucket: bool = False, batch_capacity: int | None = None,
                  shard=None, mesh_key=None, **options):
        batched = kind.endswith("_batched")
        if batch_capacity is not None and not batched:
            raise ValueError(f"batch_capacity= requires a batched dispatch, "
                             f"got kind={kind!r}")
        if shard is not None:
            return self._sharded(kind, plan, data, shard, device=device,
                                 bucket=bucket,
                                 batch_capacity=batch_capacity, **options)
        if isinstance(data, Staged):
            if data.shard is not None and mesh_key is None:
                raise ValueError("a batch staged with shard= holds one "
                                 "rank's rows: dispatch it with the same "
                                 "shard=")
            data.consume()  # before anything reads the staged tensors
        owner = plan
        plan, data, device = self._host_inputs(plan, data, options, device,
                                               bucket)
        # Never donate what the plan owns: later dispatches read it again.
        donate = self.donate_data and data is not None and not any(
            d is p for d in data for p in owner.data)
        eager = getattr(self._local, "eager", False)
        shadow = None
        if not eager and _san_state.STATE.enabled \
                and _san_state.STATE.numerics:
            from repro_torch.sanitizer import numerics as _san_numerics

            # The request as given: the float64 shadow casts the same
            # values, not the primary dtype's rounding of them.
            shadow = _san_numerics.prepare_shadow(self, kind, plan, data,
                                                  options, device)
        # Every pipeline body takes data with a batch axis; a single
        # dispatch is a batch of one.
        plan, data = device_inputs(plan, data, options["dtype"], device,
                                   batched)
        b_live = int(data[0].shape[0]) if batched else 1
        if batch_capacity is not None and b_live:
            if batch_capacity < b_live:
                raise ValueError(
                    f"batch_capacity={batch_capacity} smaller than the live "
                    f"request batch ({b_live})")
            if batch_capacity > b_live:
                data = _repeat_pad(data, batch_capacity - b_live)
        padded = batched and int(data[0].shape[0]) > b_live
        with (torch.cuda.device(plan.device) if plan.device.type == "cuda"
              else contextlib.nullcontext()):
            out = self._run(kind, plan, data, options,
                            eager or _san_state.STATE.shadow_active(),
                            donate, mesh_key)
        if padded:
            out = map_result(lambda x: x[:b_live], out)  # drop the pad's
        if shadow is not None:
            _san_numerics.after_dispatch(self, shadow, out)
        return out

    def _run(self, kind, plan, data, options, eager: bool, donate: bool,
             mesh_key=None):
        """The signature's lookup, R (eager, or through its graph on the
        card) and the tail, for device inputs [B, m_i, n_i]."""
        r_key = None
        if not eager:
            key = self._signature(kind, plan, data, {
                k: options[k] for k in self._STATIC[kind]}, mesh_key)
            r_key = self._lookup(kind, key, options)
        if kind.endswith("_batched") and data[0].shape[0] == 0:
            return _empty(kind, plan, options)
        moments = None
        if kind.removesuffix("_batched") == "pca":
            moments = _column_moments(plan, data, options["dtype"])
        if r_key is None:
            r = self._body(kind, plan, data, options)
        else:
            r = self._graph_r(kind, r_key, plan, data, options)
        if donate:
            data.clear()  # consumed: nothing reads the request again
        return self._tail(kind, r, moments, options)

    def _sharded(self, kind, plan, data, shard, *, device, bucket,
                 batch_capacity, **options):
        """A batched dispatch split over a data mesh: the request axis padded
        to a multiple of the axis by repeating the trailing request, this
        rank's rows through its own cached (and, on the card, captured)
        dispatch, every rank's answers gathered to every rank outside any
        graph, and the pad cut off. One rank issues no collective.

        On more ranks, every rank's local step (its rows, its dispatch) is
        agreed on the mesh's control group before the gather
        (`DataMesh.agree`): if one rank raised, every rank raises the same
        `RankDispatchError` naming it, and none enters the gather."""
        mesh, axis = resolve_shard(shard)
        if not kind.endswith("_batched"):
            raise ValueError(
                f"shard= requires a batched dispatch, got kind={kind!r}")
        if data is None:
            # plan.data is per-node [m_i, n_i]: no request axis to split.
            raise ValueError(
                "shard= needs an explicit [B, m_i, n_i] data batch")
        p = mesh.size
        mesh.check_control()
        mesh_key = (mesh.signature, axis)
        tag = data.shard if isinstance(data, Staged) else None
        if tag is not None:
            b = tag[1]
        else:
            b = len(data[0])
            if b == 0:
                # Nothing to split: the unsharded batched dispatch answers
                # with empty results of the right shapes.
                return self._dispatch(kind, plan, data,
                                      device=mesh.check_device(device),
                                      bucket=bucket,
                                      batch_capacity=batch_capacity,
                                      **options)
        error = None
        try:
            out = self._local_rows(kind, plan, data, mesh, mesh_key, tag,
                                   device=device, bucket=bucket,
                                   batch_capacity=batch_capacity, **options)
        except Exception as e:  # agreed below: no rank gathers alone
            if p == 1:
                raise
            error = e
        if p > 1:
            mesh.agree(error)
            out = map_result(lambda x: _all_gather(mesh, x), out)
        return map_result(lambda x: x[:b], out)

    def _local_rows(self, kind, plan, data, mesh, mesh_key, tag, *, device,
                    bucket, batch_capacity, **options):
        """This rank's part of a sharded dispatch: its rows of the padded
        batch (or the rows ``stage(shard=)`` tagged) through its own
        dispatch."""
        device = mesh.check_device(device)
        if plan.device is not None and plan.device != device:
            raise ValueError(f"the plan lives on {plan.device}, not on the "
                             f"mesh's device {device} for this rank")
        p, rank = mesh.size, mesh.local_rank()
        if isinstance(data, Staged):
            data.consume()  # before anything reads the staged tensors
        if tag is not None:
            key, b, padded = tag
            want = _sharded_size(b, batch_capacity, p)
            if (key, padded) != (mesh_key, want):
                raise ValueError(
                    f"batch staged for mesh {key} at {padded} requests, "
                    f"dispatched on mesh {mesh_key} at {want}")
            local = list(data)
        else:
            b = len(data[0])
            q = _sharded_size(b, batch_capacity, p) // p
            local = []
            for d in data:
                parts = _rows_of(d, rank * q, (rank + 1) * q, b)
                local.append(parts[0] if len(parts) == 1
                             else torch.cat(parts))
        return self._dispatch(kind, plan, local, device=device, bucket=bucket,
                              mesh_key=mesh_key, **options)

    # -- the captured program ------------------------------------------------

    def _graph_r(self, kind, r_key, plan, data, options) -> torch.Tensor:
        """R of one card dispatch: on the signature's first call an eager
        run, on the second the capture and its replay, then replays.

        The graphs live in one pool, opened anew when none is live; the
        references to the live ones held here keep them (and so the pool)
        alive through a capture even if an eviction drops them meanwhile."""
        from repro_torch.kernels import _seg_scan

        with self._graph_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(plan.device)
            stream = self._stream
            current = torch.cuda.current_stream(plan.device)
            stream.wait_stream(current)
            with self._cache_lock:
                graph = self._graphs.get(r_key)
                warm = r_key in self._warm
                live = list(self._graphs.values())
            with torch.cuda.stream(stream):
                if graph is None and not warm:
                    r = self._body(kind, plan, data, options)
                    with self._cache_lock:
                        if r_key in self._cache.values():  # not evicted
                            self._warm.add(r_key)
                else:
                    if graph is None:
                        if not live:
                            self._pool = torch.cuda.graph_pool_handle()
                        graph = self._capture(kind, r_key, plan, data,
                                              options, stream, self._pool)
                    r = graph.replay(plan, data)
            del live
            current.wait_stream(stream)
            r.record_stream(current)
            if graph is not None:
                _platform.add_launches(graph.launches)
        # The scan kernels report a look-back timeout through a pinned word
        # they write on replay as well: read it, as an eager launch does.
        _seg_scan.raise_if_timed_out()
        return r

    def _capture(self, kind, r_key, plan, data, options, stream,
                 pool) -> _Graph:
        """Capture the R body of ``r_key`` into a graph in ``pool``, with
        input buffers of its own (under the graph lock, after the eager
        run of the signature's first call)."""
        static_plan = _static_plan(plan)
        static_data = [d.clone() for d in data]
        cuda_graph = torch.cuda.CUDAGraph()
        with _platform.recording_launches() as launches:
            with torch.cuda.graph(cuda_graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self._body(kind, static_plan, static_data, options)
        graph = _Graph(cuda_graph, static_plan, static_data, out,
                       dict(launches))
        with self._count_lock:
            self._captures[kind] += 1
        with self._cache_lock:
            self._warm.discard(r_key)
            if r_key in self._cache.values():  # not evicted meanwhile
                self._graphs[r_key] = graph
        return graph

    # -- pipeline bodies (data batched over a leading axis) ------------------

    def _body(self, kind, plan, data, options) -> torch.Tensor:
        """The captured part: R₀ for ``r0`` kinds, R otherwise, [B, ...]."""
        r0 = _r0_batch(plan, data, use_kernel=options["use_kernel"],
                       assembly=options["assembly"])
        if kind.startswith("r0"):
            return r0
        return postprocess_r0(r0, method=options["method"],
                              leaf_rows=options["leaf_rows"],
                              panel=options["panel"],
                              use_kernel=options["use_kernel"])

    def _tail(self, kind, r, moments, options):
        """The eager N×N part after R, and the batch of one unwrapped."""
        base = kind.removesuffix("_batched")
        if base == "svd":
            _, s, vt = torch.linalg.svd(r)
            out = (s, vt)
        elif base == "pca":
            out = _pca_tail(r, *moments, k=options["k"],
                            center=options["center"])
        elif base == "least_squares":
            out = _least_squares_tail(r, label_col=options["label_col"],
                                      ridge=options["ridge"])
        else:  # r0, qr
            out = r
        return out if kind.endswith("_batched") else map_result(
            lambda x: x[0], out)

    def stage(self, data, *, shard=None, device=None,
              batch_capacity: int | None = None,
              live: int | None = None) -> tuple:
        """Start the host-to-device copy of request leaves ahead of their
        dispatch.

        Each leaf not already on the card is copied into a pinned host
        buffer (a copy from pageable memory would not overlap anything) and
        from there, asynchronously, on a copy stream of the engine's own; an
        event recorded after the copies travels with the returned `Staged`
        tuple, and the dispatch that consumes it makes its stream wait on
        that event. So a serving queue of depth 2 stages the next batch
        while the current one runs. A leaf given as a list of arrays (the
        requests of a coalesced batch) is concatenated along the batch axis
        as it is copied into the pinned buffer. Leaves already on the card
        pass through unchanged; on the CPU nothing is staged.

        With ``shard=mesh`` (or ``(mesh, axis)``) the batch is padded as a
        sharded dispatch pads it (to ``batch_capacity``, then to a multiple
        of the axis, repeating the trailing request) and only this rank's
        rows are copied, to the mesh's device for this rank (on the CPU
        too). The `Staged` carries the mesh, the live size and the padded
        size: a dispatch with the same ``shard=`` and ``batch_capacity=``
        takes it as its local rows as they are, and raises if its mesh or
        padded size differs. With ``live=b`` the leaves already hold only
        this rank's rows of such a padded batch of ``b`` live requests (what
        a serving controller sends each rank): they are staged as they are.
        """
        shard_tag = None
        if shard is not None:
            mesh, axis = resolve_shard(shard)
            device = mesh.check_device(device)
            first = data[0] if data else []
            b = sum(map(len, first)) if isinstance(first, list) \
                else len(first)
            if live is not None:
                b = live
            if b:
                padded = _sharded_size(b, batch_capacity, mesh.size)
                q = padded // mesh.size
                if live is None:
                    lo = mesh.local_rank() * q
                    data = [_rows_of(d, lo, lo + q, b) for d in data]
                else:
                    data = [d if isinstance(d, list) else [d] for d in data]
                    rows = {sum(map(len, d)) for d in data}
                    if rows != {q}:
                        raise ValueError(
                            f"live={b} at {padded} requests over "
                            f"{mesh.size} ranks gives each rank {q} rows; "
                            f"the leaves hold {sorted(rows)}")
                shard_tag = ((mesh.signature, axis), b, padded)
        elif live is not None:
            raise ValueError("live= needs shard=")
        device = resolve_device(device)
        if device.type != "cuda":
            if shard_tag is None:
                return tuple(data)
            return Staged([parts[0] if len(parts) == 1 else torch.cat(parts)
                           for parts in data], None, device, shard_tag)
        with self._stage_lock:
            stream = self._copy_streams.get(device)
            if stream is None:
                stream = self._copy_streams[device] = torch.cuda.Stream(
                    device)
        leaves = []
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for d in data:
                parts = [torch.as_tensor(p) for p in
                         (d if isinstance(d, list) else [d])]
                if all(p.device == device for p in parts):
                    leaves.append(parts[0] if len(parts) == 1
                                  else torch.cat(parts))
                    continue
                pinned = torch.empty(
                    (sum(p.shape[0] for p in parts),) + parts[0].shape[1:],
                    dtype=parts[0].dtype, pin_memory=True)
                at = 0
                for p in parts:
                    pinned[at:at + p.shape[0]].copy_(p)
                    at += p.shape[0]
                leaves.append(pinned.to(device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return Staged(leaves, event, device, shard_tag)

    # -- public API ----------------------------------------------------------

    def r0(self, plan: FigaroPlan, data=None, *, batched: bool = False,
           shard=None, bucket: bool = False,
           batch_capacity: int | None = None,
           dtype=torch.float32, use_kernel: bool = False,
           assembly: str = "padded", device=None) -> torch.Tensor:
        """R₀ of Algorithm 2; ``batched`` expects [B, m_i, n_i] data.

        ``bucket=True`` pads the plan (and data rows) to its power-of-two
        capacities first; R₀ then carries extra all-zero rows at the
        capacity layout. ``batch_capacity`` (requires ``batched=True``) pads
        a partial request batch up to the given bucket (repeating the
        trailing request; the pad is sliced off the result), so the cache
        and the captured graphs track batch *buckets*, not every live batch
        size — the serving queue (`train.async_serve`) picks its buckets
        this way. ``shard`` (a `launch.mesh.DataMesh` or ``(mesh, axis)``;
        requires ``batched=True``) splits the request batch over the mesh:
        each rank answers its rows and every rank returns the whole batch's
        answers. ``use_kernel`` routes each node through the fused CUDA
        pass (`kernels/node_fused`); ``assembly`` ("padded" | "band") picks
        the R₀ materialization (see `core.figaro`).
        """
        return self._dispatch("r0_batched" if batched else "r0", plan, data,
                              shard=shard, bucket=bucket,
                              batch_capacity=batch_capacity,
                              device=device, dtype=dtype,
                              use_kernel=use_kernel, assembly=assembly)

    def qr(self, plan: FigaroPlan, data=None, *, batched: bool = False,
           shard=None, bucket: bool = False,
           batch_capacity: int | None = None,
           dtype=torch.float32, method: str = "tsqr", leaf_rows: int = 256,
           panel: int = 32, use_kernel: bool = False,
           assembly: str = "padded", device=None) -> torch.Tensor:
        """Upper-triangular R of the join's QR ([B, N, N] when batched)."""
        return self._dispatch(
            "qr_batched" if batched else "qr", plan, data, shard=shard,
            bucket=bucket,
            batch_capacity=batch_capacity, device=device, dtype=dtype,
            method=method, leaf_rows=leaf_rows, panel=panel,
            use_kernel=use_kernel, assembly=assembly)

    def svd(self, plan: FigaroPlan, data=None, *, batched: bool = False,
            shard=None, bucket: bool = False,
            batch_capacity: int | None = None,
            dtype=torch.float64, method: str = "tsqr", leaf_rows: int = 256,
            panel: int = 32, use_kernel: bool = False,
            assembly: str = "padded", device=None):
        """Singular values + right-singular vectors of the join matrix."""
        return self._dispatch(
            "svd_batched" if batched else "svd", plan, data, shard=shard,
            bucket=bucket,
            batch_capacity=batch_capacity, device=device, dtype=dtype,
            method=method, leaf_rows=leaf_rows, panel=panel,
            use_kernel=use_kernel, assembly=assembly)

    def pca(self, plan: FigaroPlan, data=None, *, batched: bool = False,
            shard=None, bucket: bool = False,
            batch_capacity: int | None = None,
            k: int | None = None, center: bool = True,
            dtype=torch.float64, method: str = "tsqr", leaf_rows: int = 256,
            panel: int = 32, use_kernel: bool = False,
            assembly: str = "padded", device=None) -> PCAResult:
        """PCA of the join matrix from R (+ factorized means when centering)."""
        n = plan.spec.num_cols
        k = n if k is None else min(k, n)
        return self._dispatch(
            "pca_batched" if batched else "pca", plan, data, shard=shard,
            bucket=bucket,
            batch_capacity=batch_capacity, device=device, k=k, center=center,
            dtype=dtype, method=method, leaf_rows=leaf_rows, panel=panel,
            use_kernel=use_kernel, assembly=assembly)

    def least_squares(self, plan: FigaroPlan, label_col: int, data=None, *,
                      batched: bool = False, shard=None,
                      bucket: bool = False,
                      batch_capacity: int | None = None, ridge: float = 0.0,
                      dtype=torch.float64, method: str = "tsqr",
                      leaf_rows: int = 256, panel: int = 32,
                      use_kernel: bool = False, assembly: str = "padded",
                      device=None):
        """argmin_β ‖A[:, feats]·β − A[:, label]‖² over the unmaterialized join."""
        return self._dispatch(
            "least_squares_batched" if batched else "least_squares", plan,
            data, shard=shard, bucket=bucket, batch_capacity=batch_capacity,
            device=device, label_col=label_col, ridge=float(ridge),
            dtype=dtype, method=method, leaf_rows=leaf_rows, panel=panel,
            use_kernel=use_kernel, assembly=assembly)


def _plan_arg_error(arg_name: str, value) -> str:
    """A clear TypeError message for a non-plan handed to a plan argument."""
    from .relation import Database

    got = type(value).__name__
    if isinstance(value, Database):
        hint = ("a Database is not executable yet — pick a join tree first: "
                "JoinTree.from_edges(db, root, edges)")
    else:
        hint = ("build one with join_tree.build_plan(tree) or "
                "plan_cache.build_capacity_plan(tree)")
    return (f"argument {arg_name!r} must be a JoinTree or FigaroPlan, "
            f"got {got}: {hint}")


_DEFAULT_ENGINE: FigaroEngine | None = None


def default_engine() -> FigaroEngine:
    """Process-wide shared engine (non-donating, safe for repeated dispatch of
    the same buffers) — the cross-call signature cache behind the
    module-level `figaro_qr` / `svd_over_join` convenience APIs."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = FigaroEngine(donate_data=False)
    return _DEFAULT_ENGINE


def plan_for(tree_or_plan: JoinTree | FigaroPlan) -> FigaroPlan:
    """Accept either a `JoinTree` (compiled here) or a ready `FigaroPlan`."""
    if isinstance(tree_or_plan, FigaroPlan):
        return tree_or_plan
    if isinstance(tree_or_plan, JoinTree):
        return build_plan(tree_or_plan)
    raise TypeError(_plan_arg_error("tree_or_plan", tree_or_plan))
