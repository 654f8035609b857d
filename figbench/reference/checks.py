"""The numbers a run's answers are compared on, against the reference's
Gram matrix G = AᵀA, column sums and row count of the same join (float64).

An answer names its columns by the port's ``JoinDataset.columns``; each is
mapped onto the reference's column order by name, so the port may lay its
columns out as it likes. Every number is a worst case over the entries it
covers, relative to a scale that makes it independent of the data's size:

- ``r_gram``: RᵀR against G, max |(RᵀR − G)_ij| / (‖A_i‖ ‖A_j‖), with
  ‖A_j‖ the norm of column j of the join's matrix; an entry below R's
  diagonal, or a negative one on it, counts as its size over ‖A_j‖. An
  upper triangular R with a non-negative diagonal and RᵀR = G is G's
  Cholesky factor, so this covers all of R, and it holds where the join's
  matrix is short of full rank as well.
- ``svd_s``: max |Δs_i| / s_1; ``svd_vt``: the largest distance between a
  right singular vector and the reference's, whichever sign is nearer.
- ``pca_var``: max |Δλ_i| / λ_1 of the explained variances; ``pca_comp``: as
  ``svd_vt`` for the components; ``pca_mean``: max |Δμ_j| / σ_j, the column
  means against the column standard deviations over the join.
- ``lsq_coef``: max |Δβ_j| / max |β_j| of the least-squares coefficients of
  the label column against all others.
"""

from __future__ import annotations

import numpy as np

__all__ = ["perm", "check_answer", "KIND_NUMBERS"]

KIND_NUMBERS = {
    "qr": ("r_gram",),
    "svd": ("svd_s", "svd_vt"),
    "pca": ("pca_var", "pca_comp", "pca_mean"),
    "lsq": ("lsq_coef",),
}


def perm(names, ref_names) -> np.ndarray:
    """For each reference column, the index of the same column in
    ``names``."""
    at = {n: i for i, n in enumerate(names)}
    missing = [n for n in ref_names if n not in at]
    if missing or len(names) != len(ref_names):
        raise ValueError(f"columns {list(names)} do not match the "
                         f"reference's {list(ref_names)}")
    return np.asarray([at[n] for n in ref_names])


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _vectors(got, want) -> float:
    """Largest distance between the rows of ``got`` and the columns of
    ``want``, each taken with the sign that brings it nearer."""
    out = 0.0
    for i in range(want.shape[1]):
        g, w = got[i], want[:, i]
        out = max(out, min(np.linalg.norm(g - w), np.linalg.norm(g + w)))
    return float(out)


def _eig_desc(m):
    vals, vecs = np.linalg.eigh(m)
    return vals[::-1], vecs[:, ::-1]


def _r_gram(r, p, gram) -> float:
    r = _f64(r)
    norm = np.sqrt(np.diag(gram))
    got = (r.T @ r)[np.ix_(p, p)]
    off = np.abs(np.tril(r, -1)) + np.diag(np.clip(-np.diag(r), 0, None))
    return float(max(np.max(np.abs(got - gram) / np.outer(norm, norm)),
                     np.max(off / norm[np.argsort(p)][None, :])))


def _svd(answer, p, gram) -> dict:
    s, vt = (_f64(x) for x in answer)
    vals, vecs = _eig_desc(gram)
    want = np.sqrt(np.clip(vals, 0.0, None))
    return {"svd_s": float(np.max(np.abs(s - want)) / want[0]),
            "svd_vt": _vectors(vt[:, p], vecs)}


def _pca(answer, p, gram, sums, rows, k) -> dict:
    comps, var, mean = (_f64(x) for x in answer)
    mu = sums / rows
    cov = (gram - rows * np.outer(mu, mu)) / max(rows - 1.0, 1.0)
    vals, vecs = _eig_desc(cov)
    sigma = np.sqrt(np.clip(np.diag(cov), 1e-300, None))
    return {"pca_var": float(np.max(np.abs(var - vals[:k])) / vals[0]),
            "pca_comp": _vectors(comps[:, p], vecs[:, :k]),
            "pca_mean": float(np.max(np.abs(mean[p] - mu) / sigma))}


def _lsq(answer, names, ref_names, gram, label) -> dict:
    beta = _f64(answer)
    li = list(ref_names).index(label)
    feats = [j for j in range(len(ref_names)) if j != li]
    want = np.linalg.solve(gram[np.ix_(feats, feats)], gram[feats, li])
    got_names = [n for n in names if n != label]
    q = perm(got_names, [ref_names[j] for j in feats])
    return {"lsq_coef": float(np.max(np.abs(beta[q] - want))
                              / np.max(np.abs(want)))}


def check_answer(kind: str, answer, names, ref_names, ref, *, k=None,
                 label=None) -> dict:
    """The numbers of one answer of ``kind`` ("qr", "svd", "pca" or "lsq"),
    given as numpy arrays with its columns named by ``names``, against
    ``ref = (G, sums, rows)`` whose columns are ``ref_names``."""
    gram, sums, rows = ref
    p = perm(names, ref_names)
    if kind == "qr":
        return {"r_gram": _r_gram(answer, p, gram)}
    if kind == "svd":
        return _svd(answer, p, gram)
    if kind == "pca":
        return _pca(answer, p, gram, sums, rows, k)
    if kind == "lsq":
        return _lsq(answer, names, ref_names, gram, label)
    raise ValueError(f"unknown answer kind {kind!r}")
