"""Join materialization oracle (numpy) — for tests/baselines only.

FiGaRo's whole point is to *avoid* this. Tests and the `*-on-materialized-join`
baselines use it to (a) cross-check `R₀ᵀR₀ == AᵀA`, (b) feed the classical
Givens/Householder algorithms, (c) brute-force the count aggregates.

Column order of the produced matrix matches the plan's preorder layout, so
``figaro_r0(plan)`` and ``qr(materialize(tree))`` decompose the same matrix.
"""

from __future__ import annotations

import numpy as np

from .join_tree import JoinTree

__all__ = ["materialize_join", "join_output_rows"]


def _mix(keys: dict[str, np.ndarray], attrs: tuple[str, ...],
         cards: dict[str, int], n: int) -> np.ndarray:
    code = np.zeros(n, dtype=np.int64)
    for a in attrs:
        code = code * cards[a] + keys[a]
    return code


def _inner_join(lk, ld, rk, rd, attrs, cards):
    n_l = ld.shape[0]
    n_r = rd.shape[0]
    lcode = _mix(lk, attrs, cards, n_l)
    rcode = _mix(rk, attrs, cards, n_r)
    order = np.argsort(rcode, kind="stable")
    rcode_s = rcode[order]
    starts = np.searchsorted(rcode_s, lcode, side="left")
    ends = np.searchsorted(rcode_s, lcode, side="right")
    counts = ends - starts
    total = int(counts.sum())
    l_idx = np.repeat(np.arange(n_l), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    r_idx = order[np.repeat(starts, counts) + offs]
    keys = {a: lk[a][l_idx] for a in lk}
    for a in rk:
        if a not in keys:
            keys[a] = rk[a][r_idx]
    data = np.concatenate([ld[l_idx], rd[r_idx]], axis=1)
    return keys, data


def materialize_join(tree: JoinTree) -> np.ndarray:
    """The data matrix ``A[:, Ȳ]`` of the natural join (preorder column layout)."""
    db = tree.db
    cards: dict[str, int] = {}
    for rel in db:
        for a in rel.key_attrs:
            c = int(rel.key_col(a).max()) + 1 if rel.num_rows else 1
            cards[a] = max(cards.get(a, 1), c)

    def rec(name: str):
        rel = db[name]
        keys = {a: rel.key_col(a) for a in rel.key_attrs}
        data = np.asarray(rel.data, dtype=np.float64)
        for ch in tree.children[name]:
            ck, cd = rec(ch)
            shared = tree.shared_attrs(name, ch)
            keys, data = _inner_join(keys, data, ck, cd, shared, cards)
        return keys, data

    _, data = rec(tree.root)
    return data


def join_output_rows(tree: JoinTree) -> int:
    return materialize_join(tree).shape[0]
