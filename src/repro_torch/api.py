"""The port's compute façade: `Session` and `default_session`.

A `Session` owns the compute configuration of the join-factorization stack
— one engine (signature cache + counters), one device, one dtype policy, one
bucketing default and the pipeline options — and exposes the plan-level
compute methods::

    from repro_torch import figaro
    from repro_torch.data.relational import yelp_like

    sess = figaro.Session(use_kernel=True, assembly="band")  # on the card
    r = sess.qr(yelp_like(scale=1000))                        # f32 R [N, N]
    s, vt = sess.svd(tree)                                    # f64
    pca = sess.pca(tree, k=3)
    beta, resid = sess.least_squares(tree, label_col=0)

This is the first part of the JAX package's `repro.api` to be ported: the
dataset surface (``ingest``, ``from_tree``, ``TableSet``, ``JoinDataset``),
``serve`` and ``partitioned_qr`` are still to come.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import FigaroEngine, default_engine, plan_for
from repro_torch.kernels._platform import resolve_device

__all__ = ["Session", "default_session"]

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


class Session:
    """Owns the compute configuration of the join-factorization stack.

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
    bucket:      ``True`` (default): plans are padded into their power-of-two
                 capacity buckets at dispatch (with live-row masks), so
                 near-miss shapes share one signature. ``False``: exact
                 sizes.
    headroom:    extra row capacity per node reserved when a capacity plan
                 is built for a dataset (kept for the dataset surface still
                 to be ported; plan-level calls do not read it).
    method, leaf_rows, panel, use_kernel, assembly:
                 pipeline defaults forwarded to every dispatch:
                 ``use_kernel=True`` routes each join-tree node through the
                 fused CUDA pass (`repro_torch.kernels.node_fused`) and the
                 TSQR panels through the CUDA `panel_qr` kernel; ``assembly``
                 ("padded" | "band") picks the R₀ materialization.
    max_cached:  forwarded to the engine constructor; combining it with
                 ``engine=`` raises.
    """

    def __init__(self, *, engine: FigaroEngine | None = None, dtype=None,
                 bucket: bool = True, headroom: int = 0, method: str = "tsqr",
                 leaf_rows: int = 256, panel: int = 32,
                 use_kernel: bool = False, assembly: str = "padded",
                 max_cached: int | None = None, device=None):
        if engine is not None and max_cached is not None:
            raise ValueError("pass max_cached= to the engine's constructor "
                             "when supplying engine=")
        self.device = resolve_device(device)
        self.engine = engine if engine is not None else FigaroEngine(
            max_cached=max_cached)
        self.dtype = dtype
        self.bucket = bucket
        self.headroom = headroom
        self.method = method
        self.leaf_rows = leaf_rows
        self.panel = panel
        self.use_kernel = use_kernel
        self.assembly = assembly

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
        return bool(leaves) and leaves[0].ndim == 3

    def _dispatch_opts(self, data, batched, bucket):
        return dict(batched=self._is_batched(data, batched),
                    bucket=self.bucket if bucket is None else bucket,
                    device=self.device)

    # -- plan-level compute --------------------------------------------------

    def r0(self, tree_or_plan, data=None, *, batched=None, bucket=None,
           dtype=None, use_kernel=None, assembly=None):
        """R₀ of Algorithm 2 under this session's configuration."""
        return self.engine.r0(
            plan_for(tree_or_plan), data,
            dtype=self._dtype_for("r0", dtype),
            use_kernel=self.use_kernel if use_kernel is None else use_kernel,
            assembly=self.assembly if assembly is None else assembly,
            **self._dispatch_opts(data, batched, bucket))

    def qr(self, tree_or_plan, data=None, *, batched=None, bucket=None,
           dtype=None, method=None, leaf_rows=None, panel=None,
           use_kernel=None, assembly=None):
        """Upper-triangular R of the join's QR ([B, N, N] when batched)."""
        return self.engine.qr(
            plan_for(tree_or_plan), data,
            **self._post_opts("qr", dtype, method, leaf_rows, panel,
                              use_kernel, assembly),
            **self._dispatch_opts(data, batched, bucket))

    def svd(self, tree_or_plan, data=None, *, k: int | None = None,
            batched=None, bucket=None, dtype=None, method=None,
            leaf_rows=None, panel=None, use_kernel=None, assembly=None):
        """Singular values + right-singular vectors; ``k`` keeps the top-k."""
        s, vt = self.engine.svd(
            plan_for(tree_or_plan), data,
            **self._post_opts("svd", dtype, method, leaf_rows, panel,
                              use_kernel, assembly),
            **self._dispatch_opts(data, batched, bucket))
        if k is not None:
            s, vt = s[..., :k], vt[..., :k, :]
        return s, vt

    def pca(self, tree_or_plan, data=None, *, k: int | None = None,
            center: bool = True, batched=None, bucket=None, dtype=None,
            method=None, leaf_rows=None, panel=None, use_kernel=None,
            assembly=None):
        """PCA of the join matrix from R (+ factorized means)."""
        return self.engine.pca(
            plan_for(tree_or_plan), data, k=k, center=center,
            **self._post_opts("pca", dtype, method, leaf_rows, panel,
                              use_kernel, assembly),
            **self._dispatch_opts(data, batched, bucket))

    def least_squares(self, tree_or_plan, label_col: int, data=None, *,
                      ridge: float = 0.0, batched=None, bucket=None,
                      dtype=None, method=None, leaf_rows=None, panel=None,
                      use_kernel=None, assembly=None):
        """argmin_β ‖A[:, feats]·β − A[:, label]‖² over the join."""
        return self.engine.least_squares(
            plan_for(tree_or_plan), label_col, data, ridge=ridge,
            **self._post_opts("least_squares", dtype, method, leaf_rows,
                              panel, use_kernel, assembly),
            **self._dispatch_opts(data, batched, bucket))


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
