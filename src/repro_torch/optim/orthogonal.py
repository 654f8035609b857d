"""QR-orthogonalized optimizer updates — a beyond-paper use of FiGaRo's TSQR.

The port of the JAX package's ``optim/orthogonal.py``: Muon-style
orthogonalization of 2-D updates through the R factor of the paper's
post-processing, ``orth(G) = G·R⁻¹`` where ``G = QR``. R comes from
`repro_torch.core.postprocess.tsqr_r` (the THIN/TSQR path of R₀'s
post-processing, with its default Householder leaves, as in JAX), the
solve from ``torch.linalg.solve_triangular``.

Which gradients are orthogonalized follows JAX's leaves, whose super-block
parameters are stacked over the super-blocks: a 2-D leaf is orthogonalized
as one matrix, a 3-D one block by block (JAX's ``vmap``), anything else is
left as it is. For a `Transformer`'s gradients (``model=``) that is decided
on the stacked leaf: the MLP weights block by block, the attention weights
(4-D stacked) not at all, the block norm scales (``[n_blocks, d]``) as one
matrix across the blocks when ``n_blocks >= 2``, ``embed`` and ``lm_head``
as matrices, ``final_norm`` not at all. Opt-in (off by default).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.postprocess import tsqr_r
from repro_torch.models.weights import block_index, jax_path

__all__ = ["orthogonalize", "orthogonalized_update"]


def orthogonalize(g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Q of the thin QR of ``g`` [..., m, n] (tall orientation) via TSQR,
    scaled to unit RMS; leading dimensions are independent matrices."""
    m, n = g.shape[-2:]
    transpose = m < n
    a = g.mT if transpose else g
    a32 = a.float()
    r = tsqr_r(a32, leaf_rows=max(256, a.shape[-1]))
    # Solve a = q r  =>  q = a r^-1 (triangular solve, regularized).
    rr = r + eps * torch.eye(r.shape[-1], dtype=r.dtype, device=r.device)
    q = torch.linalg.solve_triangular(rr, a32, upper=True, left=False)
    q = q * math.sqrt(q.shape[-1])  # RMS-norm scale
    out = q.mT if transpose else q
    return out.to(g.dtype)


def _one(g: torch.Tensor, min_dim: int) -> torch.Tensor:
    """JAX's rule on one (stacked) leaf; a 3-D one is scan-stacked
    [n_blocks, a, b], each matrix orthogonalized."""
    if (g.ndim == 2 and min(g.shape) >= min_dim) or g.ndim == 3:
        return orthogonalize(g)
    return g


def orthogonalized_update(grads: dict, *, min_dim: int = 2,
                          model=None) -> dict:
    """TSQR-orthogonalize every 2-D leaf (3-D: each matrix of the stack);
    others unchanged. ``grads`` maps names to gradients. With ``model`` (a
    `Transformer`), they are its parameters' gradients and are judged as
    JAX's stacked leaves; without it each tensor is a leaf of its own.
    Returns a new dict."""
    if model is None:
        return {name: _one(g, min_dim) for name, g in grads.items()}
    out = {}
    stacks: dict = {}
    for name, g in grads.items():
        i = block_index(name)
        if i is not None:
            stacks.setdefault(jax_path(name), []).append((i, name))
        else:
            out[name] = _one(g, min_dim)
    for members in stacks.values():
        members.sort()
        stacked = _one(torch.stack([grads[n] for _, n in members]), min_dim)
        for (_, name), g in zip(members, stacked.unbind(0)):
            out[name] = g
    return {name: out[name] for name in grads}
