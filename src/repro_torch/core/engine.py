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

PyTorch runs eagerly, so there is no executable to compile. The engine still
keeps one cache entry per dispatch signature — (kind, device, plan spec and
mask layout, data shapes and dtypes, options) — holding the bound pipeline
for it, with the JAX package's counters: `trace_count` counts signature
misses per kind, ``max_cached=`` bounds the entries per kind with LRU
eviction (`eviction_count`), and `cache_size` reports the live entries.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import torch

from repro_torch.kernels._platform import resolve_device

from .counts import compute_counts
from .figaro import ASSEMBLIES, _r0_batch, device_inputs
from .join_tree import FigaroPlan, JoinTree, build_plan
from .plan_cache import bucket_spec, pad_data, pad_plan
from .postprocess import postprocess_r0

__all__ = ["FigaroEngine", "PCAResult", "default_engine", "plan_for"]


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


def _first(out):
    """The one result of a batch of one."""
    if isinstance(out, tuple):
        return tuple(o[0] for o in out)
    if isinstance(out, PCAResult):
        return PCAResult(out.components[0], out.explained_variance[0],
                         out.mean[0], out.num_rows[0])
    return out[0]


class FigaroEngine:
    """Signature cache + dispatch for the FiGaRo pipeline.

    ``max_cached=`` caps the number of cached signatures **per pipeline
    kind** (``qr``, ``qr_batched``, ...). The cache is LRU: dispatching a new
    signature past the cap evicts the least-recently-used entry of that kind;
    re-dispatching an evicted signature is a miss again (visible in
    `trace_count`). The default (``None``) keeps every entry.
    """

    _STATIC = {
        "r0": ("dtype", "use_kernel", "assembly"),
        "r0_batched": ("dtype", "use_kernel", "assembly"),
        "qr": ("dtype", "method", "leaf_rows", "panel", "use_kernel",
               "assembly"),
        "qr_batched": ("dtype", "method", "leaf_rows", "panel", "use_kernel",
                       "assembly"),
        "svd": ("dtype", "method", "leaf_rows", "panel", "use_kernel",
                "assembly"),
        "svd_batched": ("dtype", "method", "leaf_rows", "panel", "use_kernel",
                        "assembly"),
        "pca": ("dtype", "k", "center", "method", "leaf_rows", "panel",
                "use_kernel", "assembly"),
        "pca_batched": ("dtype", "k", "center", "method", "leaf_rows",
                        "panel", "use_kernel", "assembly"),
        "least_squares": ("dtype", "label_col", "ridge", "method",
                          "leaf_rows", "panel", "use_kernel", "assembly"),
        "least_squares_batched": ("dtype", "label_col", "ridge", "method",
                                  "leaf_rows", "panel", "use_kernel",
                                  "assembly"),
    }

    def __init__(self, *, max_cached: int | None = None):
        if max_cached is not None and max_cached < 1:
            raise ValueError(f"max_cached must be >= 1 or None, "
                             f"got {max_cached}")
        self.max_cached = max_cached
        # One lock for the cache and the counters: a dispatch may come from
        # any thread.
        self._lock = threading.Lock()
        self._trace_counts: collections.Counter = collections.Counter()
        self._evictions: collections.Counter = collections.Counter()
        self._cache: collections.OrderedDict = collections.OrderedDict()

    # -- cache plumbing ------------------------------------------------------

    def trace_count(self, kind: str | None = None) -> int:
        """Signature misses since construction; cache-hit tests assert this
        stays flat across same-signature dispatches."""
        with self._lock:
            if kind is None:
                return sum(self._trace_counts.values())
            return self._trace_counts[kind]

    def eviction_count(self, kind: str | None = None) -> int:
        """Entries evicted by the ``max_cached`` LRU policy, per kind."""
        with self._lock:
            if kind is None:
                return sum(self._evictions.values())
            return self._evictions[kind]

    def cache_size(self, kind: str | None = None) -> int:
        """Number of live cache entries (per kind, or total)."""
        with self._lock:
            if kind is None:
                return len(self._cache)
            return sum(1 for k in self._cache if k[0] == kind)

    @staticmethod
    def _signature(kind: str, plan: FigaroPlan, data, options) -> tuple:
        masks = tuple(ix.row_mask is None for ix in plan.index)
        shapes = tuple((tuple(d.shape), str(d.dtype)) for d in data)
        return (kind, str(plan.device), plan.spec, masks, shapes,
                tuple(sorted(options.items())))

    def _lookup(self, kind: str, key: tuple):
        """The bound pipeline for ``key``; a miss binds it, counts it and
        evicts past the cap."""
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self._cache.move_to_end(key)  # LRU: most-recent at the tail
                return fn
            self._trace_counts[kind] += 1
            fn = self._cache[key] = getattr(self, f"_{kind}_impl")
            if self.max_cached is not None:
                while sum(1 for k in self._cache
                          if k[0] == kind) > self.max_cached:
                    oldest = next(k for k in self._cache if k[0] == kind)
                    del self._cache[oldest]
                    self._evictions[kind] += 1
            return fn

    def _dispatch(self, kind: str, plan: FigaroPlan, data, *, device=None,
                  bucket: bool = False, **options):
        if not isinstance(plan, FigaroPlan):
            raise TypeError(_plan_arg_error("plan", plan))
        if options.get("assembly", "padded") not in ASSEMBLIES:
            raise ValueError(f"unknown assembly {options['assembly']!r}; "
                             f"expected {ASSEMBLIES}")
        if plan.device is None:
            device = resolve_device(device)  # raise before any host work
        if bucket:
            plan, data = _bucketize(plan, data)
        # Every pipeline body takes data with a batch axis; a single
        # dispatch is a batch of one.
        plan, data = device_inputs(plan, data, options["dtype"], device,
                                   kind.endswith("_batched"))
        key = self._signature(kind, plan, data, {
            k: options[k] for k in self._STATIC[kind]})
        return self._lookup(kind, key)(plan, data, **options)

    # -- pipeline bodies (data batched over a leading axis) ------------------

    def _qr_batch(self, plan, data, *, dtype, method, leaf_rows, panel,
                  use_kernel, assembly):
        r0 = _r0_batch(plan, data, use_kernel=use_kernel, assembly=assembly)
        return postprocess_r0(r0, method=method, leaf_rows=leaf_rows,
                              panel=panel, use_kernel=use_kernel)

    def _svd_batch(self, plan, data, **qr_opts):
        r = self._qr_batch(plan, data, **qr_opts)
        _, s, vt = torch.linalg.svd(r)
        return s, vt

    def _pca_batch(self, plan, data, *, k, center, dtype, **qr_opts):
        r = self._qr_batch(plan, data, dtype=dtype, **qr_opts)
        sums, total = _column_moments(plan, data, dtype)
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
                         mean=mean,
                         num_rows=total.expand(mean.shape[:-1]))

    def _least_squares_batch(self, plan, data, *, label_col, ridge, dtype,
                             **qr_opts):
        r = self._qr_batch(plan, data, dtype=dtype, **qr_opts)
        n = plan.spec.num_cols
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

    def _r0_impl(self, plan, data, *, dtype, use_kernel, assembly):
        return _r0_batch(plan, data, use_kernel=use_kernel,
                         assembly=assembly)[0]

    def _r0_batched_impl(self, plan, data, *, dtype, use_kernel, assembly):
        return _r0_batch(plan, data, use_kernel=use_kernel, assembly=assembly)

    def _qr_impl(self, plan, data, *, dtype, method, leaf_rows, panel,
                 use_kernel, assembly):
        return self._qr_batch(plan, data, dtype=dtype, method=method,
                              leaf_rows=leaf_rows, panel=panel,
                              use_kernel=use_kernel, assembly=assembly)[0]

    def _qr_batched_impl(self, plan, data, *, dtype, method, leaf_rows, panel,
                         use_kernel, assembly):
        return self._qr_batch(plan, data, dtype=dtype, method=method,
                              leaf_rows=leaf_rows, panel=panel,
                              use_kernel=use_kernel, assembly=assembly)

    def _svd_impl(self, plan, data, *, dtype, method, leaf_rows, panel,
                  use_kernel, assembly):
        return _first(self._svd_batch(
            plan, data, dtype=dtype, method=method, leaf_rows=leaf_rows,
            panel=panel, use_kernel=use_kernel, assembly=assembly))

    def _svd_batched_impl(self, plan, data, *, dtype, method, leaf_rows,
                          panel, use_kernel, assembly):
        return self._svd_batch(plan, data, dtype=dtype, method=method,
                               leaf_rows=leaf_rows, panel=panel,
                               use_kernel=use_kernel, assembly=assembly)

    def _pca_impl(self, plan, data, *, k, center, dtype, method, leaf_rows,
                  panel, use_kernel, assembly):
        return _first(self._pca_batch(
            plan, data, k=k, center=center, dtype=dtype, method=method,
            leaf_rows=leaf_rows, panel=panel, use_kernel=use_kernel,
            assembly=assembly))

    def _pca_batched_impl(self, plan, data, *, k, center, dtype, method,
                          leaf_rows, panel, use_kernel, assembly):
        return self._pca_batch(plan, data, k=k, center=center, dtype=dtype,
                               method=method, leaf_rows=leaf_rows,
                               panel=panel, use_kernel=use_kernel,
                               assembly=assembly)

    def _least_squares_impl(self, plan, data, *, label_col, ridge, dtype,
                            method, leaf_rows, panel, use_kernel, assembly):
        return _first(self._least_squares_batch(
            plan, data, label_col=label_col, ridge=ridge, dtype=dtype,
            method=method, leaf_rows=leaf_rows, panel=panel,
            use_kernel=use_kernel, assembly=assembly))

    def _least_squares_batched_impl(self, plan, data, *, label_col, ridge,
                                    dtype, method, leaf_rows, panel,
                                    use_kernel, assembly):
        return self._least_squares_batch(
            plan, data, label_col=label_col, ridge=ridge, dtype=dtype,
            method=method, leaf_rows=leaf_rows, panel=panel,
            use_kernel=use_kernel, assembly=assembly)

    # -- public API ----------------------------------------------------------

    def r0(self, plan: FigaroPlan, data=None, *, batched: bool = False,
           bucket: bool = False, dtype=torch.float32,
           use_kernel: bool = False, assembly: str = "padded",
           device=None) -> torch.Tensor:
        """R₀ of Algorithm 2; ``batched`` expects [B, m_i, n_i] data.

        ``bucket=True`` pads the plan (and data rows) to its power-of-two
        capacities first; R₀ then carries extra all-zero rows at the
        capacity layout. ``use_kernel`` routes each node through the fused
        CUDA pass (`kernels/node_fused`); ``assembly`` ("padded" | "band")
        picks the R₀ materialization (see `core.figaro`).
        """
        return self._dispatch("r0_batched" if batched else "r0", plan, data,
                              bucket=bucket, device=device, dtype=dtype,
                              use_kernel=use_kernel, assembly=assembly)

    def qr(self, plan: FigaroPlan, data=None, *, batched: bool = False,
           bucket: bool = False, dtype=torch.float32, method: str = "tsqr",
           leaf_rows: int = 256, panel: int = 32, use_kernel: bool = False,
           assembly: str = "padded", device=None) -> torch.Tensor:
        """Upper-triangular R of the join's QR ([B, N, N] when batched)."""
        return self._dispatch(
            "qr_batched" if batched else "qr", plan, data, bucket=bucket,
            device=device, dtype=dtype, method=method, leaf_rows=leaf_rows,
            panel=panel, use_kernel=use_kernel, assembly=assembly)

    def svd(self, plan: FigaroPlan, data=None, *, batched: bool = False,
            bucket: bool = False, dtype=torch.float64, method: str = "tsqr",
            leaf_rows: int = 256, panel: int = 32, use_kernel: bool = False,
            assembly: str = "padded", device=None):
        """Singular values + right-singular vectors of the join matrix."""
        return self._dispatch(
            "svd_batched" if batched else "svd", plan, data, bucket=bucket,
            device=device, dtype=dtype, method=method, leaf_rows=leaf_rows,
            panel=panel, use_kernel=use_kernel, assembly=assembly)

    def pca(self, plan: FigaroPlan, data=None, *, batched: bool = False,
            bucket: bool = False, k: int | None = None, center: bool = True,
            dtype=torch.float64, method: str = "tsqr", leaf_rows: int = 256,
            panel: int = 32, use_kernel: bool = False,
            assembly: str = "padded", device=None) -> PCAResult:
        """PCA of the join matrix from R (+ factorized means when centering)."""
        n = plan.spec.num_cols
        k = n if k is None else min(k, n)
        return self._dispatch(
            "pca_batched" if batched else "pca", plan, data, bucket=bucket,
            device=device, k=k, center=center, dtype=dtype, method=method,
            leaf_rows=leaf_rows, panel=panel, use_kernel=use_kernel,
            assembly=assembly)

    def least_squares(self, plan: FigaroPlan, label_col: int, data=None, *,
                      batched: bool = False, bucket: bool = False,
                      ridge: float = 0.0, dtype=torch.float64,
                      method: str = "tsqr", leaf_rows: int = 256,
                      panel: int = 32, use_kernel: bool = False,
                      assembly: str = "padded", device=None):
        """argmin_β ‖A[:, feats]·β − A[:, label]‖² over the unmaterialized join."""
        return self._dispatch(
            "least_squares_batched" if batched else "least_squares", plan,
            data, bucket=bucket, device=device, label_col=label_col,
            ridge=float(ridge), dtype=dtype, method=method,
            leaf_rows=leaf_rows, panel=panel, use_kernel=use_kernel,
            assembly=assembly)


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
    """Process-wide shared engine — the cross-call signature cache behind the
    module-level `figaro_qr` / `svd_over_join` convenience APIs."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = FigaroEngine()
    return _DEFAULT_ENGINE


def plan_for(tree_or_plan: JoinTree | FigaroPlan) -> FigaroPlan:
    """Accept either a `JoinTree` (compiled here) or a ready `FigaroPlan`."""
    if isinstance(tree_or_plan, FigaroPlan):
        return tree_or_plan
    if isinstance(tree_or_plan, JoinTree):
        return build_plan(tree_or_plan)
    raise TypeError(_plan_arg_error("tree_or_plan", tree_or_plan))
