"""Post-processing (paper §7): triangularize R₀ (M×N) → R (N×N).

The paper's THIN scheme — each thread Givens-reduces its share of rows, then a
parallel combine — is, in block form, exactly TSQR (tall-skinny QR with a
binary combine tree). Here:

  * `householder_qr_r`   — column-at-a-time Householder in plain PyTorch.
  * `blocked_qr_r`       — panel/WY blocked variant; with ``use_kernel`` the
                           panel factorization is the CUDA `panel_qr` kernel.
  * `tsqr_r`             — row-blocked leaf QRs + log₂ pairwise combine.
  * `postprocess_r0`     — R₀ → upper-triangular R with non-negative diagonal.

Every function takes any number of leading batch dimensions ([..., m, n]):
TSQR's leaves and each of its combine levels go to the leaf factorization as
one batch, and a batch of requests rides along in front. All functions return
only R (the paper never materializes Q either).

The Householder loops update only the rows and columns at and after the
current step: the rows above are untouched by a reflector that is zero
there, and the columns before it hold only below-diagonal dust that the
final ``triu`` drops, so R is the same as the full update's.
"""

from __future__ import annotations

import torch

__all__ = [
    "householder_qr_r",
    "householder_panel",
    "blocked_qr_r",
    "tsqr_r",
    "postprocess_r0",
    "normalize_sign",
]


def normalize_sign(r: torch.Tensor) -> torch.Tensor:
    """Flip row signs so diag(R) >= 0 (QR uniqueness normalization)."""
    s = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return r * s[..., :, None]


def _reflector(x: torch.Tensor):
    """Householder vector for the columns ``x`` [B, rows] (pivot at row 0):
    returns (v with v[0] = xk − α, the pivot value vk)."""
    sigma = torch.linalg.vector_norm(x, dim=-1)
    xk = x[:, 0]
    sgn = torch.where(xk >= 0, torch.ones_like(xk), -torch.ones_like(xk))
    alpha = -sgn * sigma
    v = x.clone()
    v[:, 0] = xk - alpha
    return v, v[:, 0].clone()


def _beta(v: torch.Tensor) -> torch.Tensor:
    """2 / vᵀv, and 0 for a reflector whose vᵀv is zero or subnormal: XLA
    flushes subnormals to zero, and 2 / vᵀv would overflow to inf there
    (then inf · 0 = NaN in the update) — the dust of a rank-deficient
    float32 column reaches it."""
    vv = (v * v).sum(dim=-1)
    ok = vv >= torch.finfo(vv.dtype).tiny
    return torch.where(ok, 2.0 / torch.where(ok, vv, torch.ones_like(vv)),
                       torch.zeros_like(vv))


def _rank1_update(sub: torch.Tensor, v: torch.Tensor, beta: torch.Tensor):
    """sub ← sub − β·v·(vᵀ·sub), in place on the view ``sub`` [B, r, c]."""
    w = (v.unsqueeze(-2) @ sub).squeeze(-2)  # [B, c]
    sub.sub_((beta[:, None] * v).unsqueeze(-1) * w.unsqueeze(-2))


def householder_qr_r(a: torch.Tensor) -> torch.Tensor:
    """R factor via Householder reflections; [..., m, n] -> [..., n, n]."""
    m, n = a.shape[-2:]
    lead = a.shape[:-2]
    a = a.reshape(-1, m, n).clone()  # updated in place below
    for k in range(min(m - 1, n)):
        v, _ = _reflector(a[:, k:, k])
        _rank1_update(a[:, k:, k:], v, _beta(v))
    if m >= n:
        r = torch.triu(a[:, :n])
    else:  # degenerate tall requirement; pad for a consistent [n, n]
        r = a.new_zeros((a.shape[0], n, n))
        r[:, :m] = torch.triu(a)
    return r.reshape(lead + (n, n))


def householder_panel(a: torch.Tensor):
    """Factor panels [..., m, nb]: returns (V unit-lower reflectors
    [..., m, nb], beta [..., nb], R_panel [..., m, nb]).

    Plain PyTorch; `repro_torch.kernels.panel_qr` implements the same contract
    as a CUDA kernel (held against this in the tests and on the card).
    """
    m, nb = a.shape[-2:]
    lead = a.shape[:-2]
    a = a.reshape(-1, m, nb).clone()
    vs = torch.zeros_like(a)
    betas = a.new_zeros((a.shape[0], nb))
    for k in range(min(m, nb)):
        v, vk = _reflector(a[:, k:, k])
        safe = vk.abs() > 0
        v = torch.where(safe[:, None],
                        v / torch.where(safe, vk, torch.ones_like(vk))[:, None],
                        v)  # unit diagonal
        beta = _beta(v)
        _rank1_update(a[:, k:, k:], v, beta)
        vs[:, k:, k] = v
        betas[:, k] = beta
    return (vs.reshape(lead + (m, nb)), betas.reshape(lead + (nb,)),
            a.reshape(lead + (m, nb)))


def _panel_to_wy(v: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Compact-WY T [B, nb, nb] from unit reflectors V [B, m, nb] and betas
    [B, nb]: the forward recurrence."""
    nb = v.shape[-1]
    gram = v.mT @ v  # column j is Vᵀ·v_j
    t = v.new_zeros((v.shape[0], nb, nb))
    for j in range(nb):
        col = -beta[:, j, None] * (t @ gram[:, :, j:j + 1]).squeeze(-1)
        col[:, j:] = 0
        t[:, :, j] = col
        t[:, j, j] = beta[:, j]
    return t


def _apply_wy(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Trailing update A ← Hₙ…H₁·A = (I − V·Tᵀ·Vᵀ)·A (compact WY).

    With Q = H₁…Hₙ = I − V·T·Vᵀ (LAPACK forward convention), the QR trailing
    update applies Qᵀ, i.e. Tᵀ.
    """
    return a - v @ (t.mT @ (v.mT @ a))


def blocked_qr_r(a: torch.Tensor, panel: int = 32, *,
                 use_kernel: bool = False) -> torch.Tensor:
    """Blocked Householder QR (panel + compact-WY trailing update) ->
    R [..., n, n]. With ``use_kernel`` the panels go to the `panel_qr`
    kernel's in-place form (the plain version for CPU tensors), which
    factors the strided column block where it lies and returns T with V.
    T is formed only where a trailing update follows."""
    m, n = a.shape[-2:]
    lead = a.shape[:-2]
    a = a.reshape(-1, m, n)
    if m < n:
        a = torch.cat([a, a.new_zeros((a.shape[0], n - m, n))], dim=1)
        m = n
    else:
        a = a.clone()  # updated in place below
    if use_kernel:
        from repro_torch.kernels.panel_qr import ops as pq_ops
    pos = 0
    while pos < n:
        nb = min(panel, n - pos)
        trailing = pos + nb < n
        if use_kernel:
            v, beta, t = pq_ops.panel_qr_wy(a[:, pos:, pos:pos + nb])
        else:
            v, beta, rp = householder_panel(a[:, pos:, pos:pos + nb])
            a[:, pos:, pos:pos + nb] = rp
            t = _panel_to_wy(v, beta) if trailing else None
        if trailing:
            a[:, pos:, pos + nb:] = _apply_wy(a[:, pos:, pos + nb:], v, t)
        pos += nb
    return torch.triu(a[:, :n]).reshape(lead + (n, n))


def tsqr_r(a: torch.Tensor, leaf_rows: int = 256,
           leaf_qr=householder_qr_r) -> torch.Tensor:
    """TSQR: row-block leaf QRs, then pairwise combines — THIN (§7) in block form.

    [..., m, n] -> R [..., n, n]. Rows are zero-padded to a full grid; zero
    rows do not change R. Every level is one batched call of ``leaf_qr``.
    """
    m, n = a.shape[-2:]
    lead = a.shape[:-2]
    a = a.reshape(-1, m, n)
    nreq = a.shape[0]
    leaf_rows = max(leaf_rows, n)
    blocks = max(1, -(-m // leaf_rows))
    pad = blocks * leaf_rows - m
    if pad:
        a = torch.cat([a, a.new_zeros((nreq, pad, n))], dim=1)
    rs = leaf_qr(a.reshape(nreq * blocks, leaf_rows, n)).reshape(
        nreq, blocks, n, n)
    while rs.shape[1] > 1:
        b = rs.shape[1]
        if b % 2:
            rs = torch.cat([rs, rs.new_zeros((nreq, 1, n, n))], dim=1)
            b += 1
        stacked = rs.reshape(nreq * (b // 2), 2 * n, n)
        rs = leaf_qr(stacked).reshape(nreq, b // 2, n, n)
    return rs[:, 0].reshape(lead + (n, n))


def postprocess_r0(r0: torch.Tensor, *, method: str = "tsqr",
                   leaf_rows: int = 256, panel: int = 32,
                   use_kernel: bool = False) -> torch.Tensor:
    """R₀ ([..., M, N], almost upper-triangular) → R ([..., N, N], diag ≥ 0)."""
    if method == "tsqr":
        if use_kernel:
            def leaf(x):
                return blocked_qr_r(x, panel=panel, use_kernel=True)
        else:
            leaf = householder_qr_r
        r = tsqr_r(r0, leaf_rows=leaf_rows, leaf_qr=leaf)
    elif method == "householder":
        r = householder_qr_r(r0)
    elif method == "blocked":
        r = blocked_qr_r(r0, panel=panel, use_kernel=use_kernel)
    elif method == "lapack":  # the library QR (cuSOLVER / LAPACK)
        r = torch.linalg.qr(r0, mode="r").R
        n = r0.shape[-1]
        r = r[..., :n, :]
    else:
        raise ValueError(f"unknown postprocess method {method!r}")
    return normalize_sign(r)
