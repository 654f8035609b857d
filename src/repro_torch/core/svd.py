"""SVD, PCA and least squares over joins — all read off R (paper §1).

A = Q·R  ⇒  singular values of A == singular values of R; right-singular
vectors of A == those of R; RᵀR is the Cholesky factorization of AᵀA; the
least-squares solution against a label column is back-substitution on the R of
the label-extended matrix. None of it touches the join output.

All entry points delegate to `repro_torch.api.default_session(device)`;
``batched=True`` serves a leading batch axis of feature-sets per dispatch.
"""

from __future__ import annotations

import torch

from .engine import PCAResult


def _session(device):
    # Lazy: repro_torch.api imports repro_torch.core.engine.
    from repro_torch.api import default_session

    return default_session(device)


__all__ = [
    "svd_over_join",
    "pca_over_join",
    "least_squares_over_join",
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
