"""The reference computed one precision down: the control where the port's
own lower precision does not reach the cell's path (float32 on a join of at
most 32 columns makes no matmul that TF32 could take).

TF32 is emulated exactly as the tensor cores compute it: each float32 input
rounded to 10 bits of mantissa (round to nearest), products summed in
float32. The answers are then worked out in float32 from that Gram matrix,
as the reference works them out in float64 from its own.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tf32", "answer_from_gram"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, nearest first."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def answer_from_gram(kind: str, gram, sums, rows, *, k=None, label_col=None):
    """An answer of ``kind`` in float32, in the Gram matrix's column order,
    in the shape `figbench.reference.checks.check_answer` takes."""
    g = np.asarray(gram, dtype=np.float32)
    if kind == "qr":
        return np.linalg.cholesky(g).T
    if kind == "svd":
        vals, vecs = np.linalg.eigh(g)
        return np.sqrt(np.clip(vals[::-1], 0, None)), vecs[:, ::-1].T
    if kind == "pca":
        mu = (np.asarray(sums, dtype=np.float32) / np.float32(rows))
        cov = (g - np.float32(rows) * np.outer(mu, mu)) / np.float32(rows - 1)
        vals, vecs = np.linalg.eigh(cov)
        return vecs[:, ::-1][:, :k].T, vals[::-1][:k], mu
    if kind == "lsq":
        feats = [j for j in range(g.shape[0]) if j != label_col]
        return np.linalg.solve(g[np.ix_(feats, feats)], g[feats, label_col])
    raise ValueError(f"unknown answer kind {kind!r}")
