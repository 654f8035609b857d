"""SVD, PCA and least squares over joins — all read off R (paper §1).

A = Q·R  ⇒  singular values of A == singular values of R; right-singular
vectors of A == those of R; RᵀR is the Cholesky factorization of AᵀA; the
least-squares solution against a label column is back-substitution on the R of
the label-extended matrix. None of it touches the join output.

The factorizations delegate to `repro_torch.api.default_session(device)`;
``batched=True`` serves a leading batch axis of feature-sets per dispatch.
`join_column_moments` runs the engine's factorized column sums directly.
"""

from __future__ import annotations

import torch

from .engine import PCAResult, _column_moments
from .figaro import device_inputs


def _session(device):
    # Lazy: repro_torch.api imports repro_torch.core.engine.
    from repro_torch.api import default_session

    return default_session(device)


__all__ = [
    "svd_over_join",
    "pca_over_join",
    "least_squares_over_join",
    "join_column_moments",
    "PCAResult",
]


def svd_over_join(tree_or_plan, data=None, *, batched: bool = False,
                  dtype=torch.float64, device=None, **qr_kwargs):
    """Singular values and right-singular vectors of the join matrix.

    Returns (s [N], Vt [N, N]); the implicit U is A·V·diag(1/s) (never built).
    With ``batched=True`` and [B, m_i, n_i] data: (s [B, N], Vt [B, N, N]).
    """
    return _session(device).svd(tree_or_plan, data, batched=batched,
                                dtype=dtype, **qr_kwargs)


def join_column_moments(plan, data=None, *, dtype=torch.float64,
                        device=None):
    """Factorized column sums [N] & row count of the join (no
    materialization).

    Row r of relation i appears in exactly Φ°_i(key(r)) join rows, so
    Σ_join A[:, Y_i] = Σ_r data_i[r] · Φ°_i(key(r)) — a per-node weighted sum.
    A host plan runs on ``device`` (default: the card).
    """
    plan, data = device_inputs(plan, data, dtype, device, batched=False)
    sums, total = _column_moments(plan, data, dtype)
    return sums[0], total


def pca_over_join(tree_or_plan, k: int | None = None, *, data=None,
                  center: bool = True, dtype=torch.float64, device=None,
                  **qr_kwargs) -> PCAResult:
    """PCA of the join matrix from R (+ factorized means when centering).

    cov = (AᵀA − J·μμᵀ)/(J−1) = (RᵀR − J·μμᵀ)/(J−1); eigendecomposition of an
    N×N matrix — independent of the join size.
    """
    return _session(device).pca(tree_or_plan, data, k=k, center=center,
                                dtype=dtype, **qr_kwargs)


def least_squares_over_join(tree_or_plan, label_col: int, *, data=None,
                            ridge: float = 0.0, dtype=torch.float64,
                            device=None, **qr_kwargs):
    """argmin_β ‖A[:, feats]·β − A[:, label]‖² over the (unmaterialized) join.

    Uses the R of the full matrix: with column order (feats…, label),
    β = R_ff⁻¹ · r_fl. `label_col` indexes the plan's global column layout.

    Returns (beta [N-1], residual_norm).
    """
    return _session(device).least_squares(tree_or_plan, label_col, data,
                                          ridge=ridge, dtype=dtype,
                                          **qr_kwargs)
