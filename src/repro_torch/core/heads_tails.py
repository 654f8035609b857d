"""Heads and tails (paper §3): block effects of Givens-rotation sequences.

``head(A, v)`` / ``tail(A, v)`` implement Definition 3.4 (the unweighted
Definition 3.2 is the ``v = 1`` special case). Together they form a *weighted
Helmert transform*: the orthogonal matrix ``G = R_m … R_2`` of Lemma 3.5, so

    G @ [S⊗v | A]  ==  [ ‖v‖₂·S  head(A,v) ]
                       [   0     tail(A,v) ]

`segmented_head_tail` applies the transform independently per contiguous
segment of rows (one segment per join key) — the vectorized form FiGaRo needs.
`givens_sequence` builds the explicit rotation sequence (test oracle: applying
it row-by-row must reproduce head/tail).

Numerics note (paper observation (3)): head/tail never squares *data* values —
only the weights are squared — which is where FiGaRo's accuracy edge over
Householder-on-the-join comes from.

Batching: the segmented functions take data with any leading batch
dimensions and their rows on dimension ``-2`` ([..., m, n]); the per-row
vectors (weights, segment ids, positions) are [m] and shared by the batch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "head",
    "tail",
    "head_tail",
    "segmented_head_tail",
    "segmented_cumsum",
    "givens_rotation",
    "givens_sequence",
]


def head(a: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
    """Generalized head ``H(A, v) = (1/‖v‖₂) Σᵢ vᵢ A[i,:]`` — one row."""
    if v is None:
        return a.sum(dim=0) / float(np.sqrt(a.shape[0]))
    # Cast the weights to the data dtype (as `tail` does): a float64 weight
    # vector must not silently upcast low-precision data.
    v = v.to(a.dtype)
    return (v @ a) / torch.linalg.vector_norm(v)


def tail(a: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
    """Generalized tail ``T(A, v)`` — (m-1) rows (Definition 3.4).

    Row ``j`` (1-based, j∈[m-1]) is
      ( ‖v₁..ⱼ‖·A[j+1,:] − vⱼ₊₁·(Σᵢ≤ⱼ vᵢA[i,:])/‖v₁..ⱼ‖ ) / ‖v₁..ⱼ₊₁‖.
    """
    m = a.shape[0]
    if v is None:
        v = torch.ones(m, dtype=a.dtype, device=a.device)
    v = v.to(a.dtype)
    w2 = v * v
    c_incl = torch.cumsum(w2, dim=0)  # ‖v₁..ⱼ‖² at j (inclusive)
    s_incl = torch.cumsum(v[:, None] * a, dim=0)
    c_excl = c_incl - w2
    s_excl = s_incl - v[:, None] * a
    c_excl_safe = torch.where(c_excl > 0, c_excl, torch.ones_like(c_excl))
    t = (torch.sqrt(c_excl_safe)[:, None] * a
         - v[:, None] * s_excl / torch.sqrt(c_excl_safe)[:, None])
    t = t / torch.sqrt(c_incl)[:, None]
    return t[1:]


def head_tail(a: torch.Tensor, v: torch.Tensor | None = None):
    return head(a, v), tail(a, v)


# ---------------------------------------------------------------------------
# Segmented (per-join-key) version — FiGaRo's workhorse.
# ---------------------------------------------------------------------------


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """Elements of ``even`` at 0, 2, 4, … and of ``odd`` at 1, 3, 5, …"""
    k = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, k), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > k:  # odd length: one even element left over
        out = torch.cat([out, even.narrow(dim, k, 1)], dim=dim)
    return out


def _combine(a, b):
    """Segmented-sum operator: (f_a, x_a) ⊕ (f_b, x_b) = (f_a|f_b, x_b + (f_b ? 0 : x_a))."""
    fa, xa = a
    fb, xb = b
    return fa | fb, xb + torch.where(fb, torch.zeros_like(xa), xa)


def _sl(x: torch.Tensor, dim: int, start: int, stop: int | None,
        step: int = 1) -> torch.Tensor:
    index = [slice(None)] * x.ndim
    index[dim] = slice(start, stop, step)
    return x[tuple(index)]


def _assoc_scan(elems, dim: int):
    """Inclusive associative scan of ``(flags, values)`` along ``dim``.

    The same odd/even recursion as `jax.lax.associative_scan`, so the sums
    associate in the same order as the JAX package's `segmented_cumsum`.
    """
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = _combine([_sl(e, dim, 0, -1, 2) for e in elems],
                       [_sl(e, dim, 1, None, 2) for e in elems])
    odd = _assoc_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([_sl(e, dim, 0, -1) for e in odd],
                        [_sl(e, dim, 2, None, 2) for e in elems])
    else:
        even = _combine(list(odd), [_sl(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_sl(e, dim, 0, 1), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def segmented_cumsum(x: torch.Tensor, first_flag: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over rows that restarts wherever ``first_flag`` is True.

    ``x`` is [m] or [..., m, n] (rows on dimension -2); ``first_flag`` is [m].
    Implemented with an associative scan (no subtract-the-base trick), so long
    arrays do not suffer cross-segment cancellation.
    """
    if x.ndim == 1:
        dim, flags = 0, first_flag
    else:
        dim, flags = x.ndim - 2, first_flag[:, None]
    flags = torch.broadcast_to(flags, x.shape)
    _, out = _assoc_scan([flags, x], dim)
    return out


def segmented_head_tail(
    data: torch.Tensor,
    weights: torch.Tensor,
    seg_id: torch.Tensor,
    pos_in_seg: torch.Tensor,
    num_segments: int,
):
    """Per-segment generalized head & tail over contiguous row segments.

    Args:
      data: [..., m, n]; rows of all segments, concatenated (segment-sorted).
      weights: [m] strictly positive weights ``v`` (0 on dead rows).
      seg_id: [m] int64 — segment of each row (non-decreasing).
      pos_in_seg: [m] int — 0 for the first row of a segment.
      num_segments: segment count K.

    Returns:
      heads: [..., K, n] — H(seg, v_seg)
      tails: [..., m, n] — row r holds T(seg, v_seg)[pos-1] for pos>0, else 0
      norms: [K]         — ‖v_seg‖₂ (the scaling Lemma 3.5 applies to the S part)
    """
    dtype = data.dtype
    weights = weights.to(dtype)
    first = pos_in_seg == 0
    w2 = weights * weights
    wa = data * weights[:, None]

    c_incl = segmented_cumsum(w2, first)
    s_incl = segmented_cumsum(wa, first)
    c_excl = c_incl - w2
    s_excl = s_incl - wa
    c_excl_safe = torch.where(pos_in_seg > 0, c_excl, torch.ones_like(c_excl))
    tails = (torch.sqrt(c_excl_safe)[:, None] * data
             - weights[:, None] * s_excl / torch.sqrt(c_excl_safe)[:, None])
    tails = tails / torch.sqrt(c_incl)[:, None]
    tails = torch.where((pos_in_seg > 0)[:, None], tails,
                        torch.zeros_like(tails))

    c_tot = w2.new_zeros(num_segments).index_add_(0, seg_id, w2)
    s_tot = wa.new_zeros(wa.shape[:-2] + (num_segments, wa.shape[-1]))
    s_tot.index_add_(wa.ndim - 2, seg_id, wa)
    norms = torch.sqrt(c_tot)
    heads = s_tot / torch.where(norms > 0, norms, torch.ones_like(norms))[:, None]
    return heads, tails, norms


# ---------------------------------------------------------------------------
# Explicit Givens rotations — the oracle the closed forms must agree with.
# ---------------------------------------------------------------------------


def givens_rotation(m: int, i: int, j: int, s: float, c: float) -> np.ndarray:
    """``Giv_m(i, j, sinθ, cosθ)`` (Definition 3.1), 0-based indices."""
    g = np.eye(m)
    g[i, i] = c
    g[j, j] = c
    g[i, j] = -s
    g[j, i] = s
    return g


def givens_sequence(v: np.ndarray) -> np.ndarray:
    """The orthogonal ``G = R_m … R_2`` of Lemma 3.5 for weight vector ``v``.

    Applying G to ``[S⊗v | T]`` zeroes all but the first (scaled) copy of S and
    produces [head; tail] — the oracle used by tests.
    """
    v = np.asarray(v, dtype=np.float64)
    m = v.shape[0]
    g = np.eye(m)
    for i in range(1, m):  # paper's i = 2..m (1-based)
        norm_i = np.linalg.norm(v[: i + 1])
        norm_im1 = np.linalg.norm(v[:i])
        r = givens_rotation(m, 0, i, -v[i] / norm_i, norm_im1 / norm_i)
        g = r @ g
    return g
