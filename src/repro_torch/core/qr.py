"""Public QR APIs: FiGaRo end-to-end and materialized-join baselines.

`figaro_qr` is the paper's pipeline: plan → counts → Algorithm 2 → post-process.
`figaro_qr_batched` is the serving form — one dispatch factorizes B
feature-sets over the same join structure. Both delegate to
`repro_torch.api.default_session(device)`, so repeat calls with
same-signature plans hit its engine's cache. `figaro_qr_fn` is the
plan-closed form wall-clock benchmarks time: a closure ``data -> R`` that
replays one CUDA graph. `materialized_qr` / `givens_qr_r` are the baselines
the paper benchmarks against (library QR on the join output / textbook
Givens rotations); `implicit_q_gram_check` checks R without forming Q.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._platform import resolve_device

from .join_tree import FigaroPlan, JoinTree
from .materialize import materialize_join
from .postprocess import householder_qr_r, normalize_sign

__all__ = [
    "figaro_qr",
    "figaro_qr_batched",
    "figaro_qr_fn",
    "materialized_qr",
    "givens_qr_r",
    "implicit_q_gram_check",
]


def _session(device):
    # Lazy: repro_torch.api imports repro_torch.core.engine.
    from repro_torch.api import default_session

    return default_session(device)


def figaro_qr(
    tree_or_plan: JoinTree | FigaroPlan,
    data=None,
    *,
    dtype=torch.float32,
    method: str = "tsqr",
    leaf_rows: int = 256,
    use_kernel: bool = False,
    device=None,
) -> torch.Tensor:
    """Upper-triangular R of the QR decomposition of the (unmaterialized) join."""
    return _session(device).qr(tree_or_plan, data, batched=False, dtype=dtype,
                               method=method, leaf_rows=leaf_rows,
                               use_kernel=use_kernel)


def figaro_qr_batched(
    tree_or_plan: JoinTree | FigaroPlan,
    data_batch,
    *,
    dtype=torch.float32,
    method: str = "tsqr",
    leaf_rows: int = 256,
    use_kernel: bool = False,
    device=None,
) -> torch.Tensor:
    """R for a batch of feature-sets over one join structure: ``data_batch[i]``
    is [B, m_i, n_i]; returns [B, N, N] from a single dispatch."""
    return _session(device).qr(tree_or_plan, data_batch, batched=True,
                               dtype=dtype, method=method,
                               leaf_rows=leaf_rows, use_kernel=use_kernel)


def figaro_qr_fn(plan: FigaroPlan, *, dtype=torch.float32,
                 method: str = "tsqr", leaf_rows: int = 256,
                 use_kernel: bool = False, device=None):
    """A closure ``data -> R`` for a fixed plan.

    Counts, Algorithm 2 and post-processing on the plan *closed over*: a
    host plan moves to ``device`` (default: the card) once, here, and each
    call dispatches on the data alone — on the card by replaying one CUDA
    graph per data signature, captured on its second call (see
    `core.engine._PlanClosure`). ``data`` is per-node [m_i, n_i] (default:
    the plan's own). R₀ is assembled in place (``assembly="band"``, which
    gives the padded layout's R₀ bit for bit without its copies). The
    minimum-overhead form wall-clock benchmarks time; for plan-generic
    dispatch (one graph shared across same-signature plans, batching,
    donation) use `FigaroEngine` / `figaro_qr` instead.
    """
    from .engine import _PlanClosure

    return _PlanClosure(plan, dtype=dtype, method=method,
                        leaf_rows=leaf_rows, use_kernel=use_kernel,
                        assembly="band", device=device)


def materialized_qr(tree: JoinTree, *, dtype=torch.float64,
                    method: str = "lapack", device=None) -> torch.Tensor:
    """Baseline: materialize the join, then classical QR (paper's MKL role)."""
    a = torch.as_tensor(materialize_join(tree), dtype=dtype,
                        device=resolve_device(device))
    if method == "lapack":
        r = torch.linalg.qr(a, mode="r").R[: a.shape[1]]
    elif method == "householder":
        r = householder_qr_r(a)
    elif method == "givens":
        r = givens_qr_r(a)
    else:
        raise ValueError(method)
    return normalize_sign(r)


def givens_qr_r(a: torch.Tensor) -> torch.Tensor:
    """Textbook Givens-rotation QR (one rotation per zeroed entry) -> R.

    The O(mn) rotations × O(n) work each that FiGaRo's block transforms replace.
    Kept for op-count comparisons and accuracy experiments on small inputs.
    """
    m, n = a.shape
    a = a.clone()
    # Rotation schedule: for each column k, bubble zeros up from the bottom.
    for k in range(n):
        for i in range(m - 1, k, -1):  # zero a[i, k] against a[i-1, k]
            xi = a[i - 1, k]
            xj = a[i, k]
            r = torch.hypot(xi, xj)
            safe = r > 0
            one = torch.ones_like(r)
            c = torch.where(safe, xi / torch.where(safe, r, one), one)
            s = torch.where(safe, -xj / torch.where(safe, r, one),
                            torch.zeros_like(r))
            row_i = a[i - 1].clone()
            row_j = a[i].clone()
            a[i - 1] = c * row_i - s * row_j
            a[i] = s * row_i + c * row_j
    return torch.triu(a[:n])


def implicit_q_gram_check(r: torch.Tensor, gram) -> torch.Tensor:
    """‖RᵀR − AᵀA‖_F / ‖AᵀA‖_F — orthogonality proxy without materializing Q.

    (The paper computes Q lazily as A·R⁻¹; since Q never needs materializing,
    accuracy is checked on the Gram identity instead.) Computed in R's dtype
    on R's device.
    """
    gram = torch.as_tensor(gram, dtype=r.dtype, device=r.device)
    return torch.linalg.norm(r.T @ r - gram) / torch.linalg.norm(gram)
