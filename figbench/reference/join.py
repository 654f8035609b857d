"""The join's Gram matrix AᵀA, its column sums and its row count, by
materializing the join of an acyclic schema block by block (plain PyTorch).

The join tree is the configuration's root and edges. Every subtree below the
root is joined whole, as row indices into its relations, and sorted by its
key toward its parent. The root's rows are then taken in blocks whose joins
hold at most ``block_rows`` rows; each block's join is expanded into row
indices, its matrix gathered from the values given, and its Gram and column
sums are added up in float64. Columns are in the reference's own order:
`Join.columns`, the relations in preorder, each relation's data columns in
order, named ``"Relation.column"``.
"""

from __future__ import annotations

import numpy as np
import torch

from figbench.data.tables import codes, orient, shared

__all__ = ["Join"]


class Join:
    def __init__(self, tables: dict, root: str, edges, device="cpu"):
        self.device = torch.device(device)
        _, self.children, self.preorder = orient(root, edges)
        self.root = root
        self.columns = tuple(f"{n}.{c}" for n in self.preorder
                             for c in tables[n].columns)
        # per child: the codes of its parent's rows and of its own rows over
        # the key attributes the two share (all 0 on a Cartesian edge)
        self._up, self._down = {}, {}
        for p in self.preorder:
            for c in self.children[p]:
                attrs = shared(tables[p], tables[c])
                if attrs:
                    cp, cc = codes(tables, attrs, p, c)
                else:
                    cp = np.zeros(tables[p].rows, dtype=np.int64)
                    cc = np.zeros(tables[c].rows, dtype=np.int64)
                self._up[c] = torch.as_tensor(cp, device=self.device)
                self._down[c] = torch.as_tensor(cc, device=self.device)
        self._sub = {}
        for node in reversed(self.preorder):
            if node == root:
                continue
            cols = self._expand(node, torch.arange(
                tables[node].rows, device=self.device))
            key = self._down[node][cols[node]]
            order = torch.argsort(key, stable=True)
            self._sub[node] = (key[order],
                               {n: v[order] for n, v in cols.items()})
        count = torch.ones(tables[root].rows, dtype=torch.int64,
                           device=self.device)
        for c in self.children[root]:
            lo, hi = self._range(c, self._up[c])
            count *= hi - lo
        self._count = count.cpu().numpy()
        self.rows = int(self._count.sum())

    def _range(self, child: str, code: torch.Tensor):
        keys = self._sub[child][0]
        return (torch.searchsorted(keys, code),
                torch.searchsorted(keys, code, right=True))

    def _expand(self, node: str, rows: torch.Tensor) -> dict:
        """Row indices of every relation in ``node``'s subtree, one entry a
        row of the join of that subtree restricted to ``rows`` of node."""
        cols = {node: rows}
        for c in self.children[node]:
            lo, hi = self._range(c, self._up[c][cols[node]])
            cnt = hi - lo
            total = int(cnt.sum())
            start = torch.cumsum(cnt, 0) - cnt
            cols = {n: torch.repeat_interleave(v, cnt, output_size=total)
                    for n, v in cols.items()}
            pos = torch.repeat_interleave(lo - start, cnt, output_size=total) \
                + torch.arange(total, device=self.device)
            for n, v in self._sub[c][1].items():
                cols[n] = v[pos]
        return cols

    def blocks(self, block_rows: int) -> list:
        """[lo, hi) ranges of root rows whose joins hold at most
        ``block_rows`` rows each (a root row with more stands alone)."""
        csum = np.cumsum(self._count)
        out, lo, m = [], 0, len(csum)
        while lo < m:
            base = csum[lo - 1] if lo else 0
            hi = max(int(np.searchsorted(csum, base + block_rows,
                                         side="right")), lo + 1)
            out.append((lo, min(hi, m)))
            lo = hi
        return out

    def gram(self, value_sets, *, block_rows: int = 1 << 23,
             dtype=torch.float64, inputs=None) -> list:
        """For each feature set (a mapping relation -> [rows, width] values),
        ``(G, sums, rows)``: AᵀA [N, N] and the column sums [N] of the join's
        matrix as float64 numpy arrays, and its row count. ``dtype`` is the
        precision the sums are made in; ``inputs``, where given, rounds each
        block of the matrix before its products (`lower.tf32`)."""
        sets = [{n: torch.as_tensor(np.asarray(vs[n]), device=self.device)
                 .to(dtype) for n in self.preorder} for vs in value_sets]
        n_cols = len(self.columns)
        grams = [torch.zeros((n_cols, n_cols), dtype=dtype,
                             device=self.device) for _ in sets]
        sums = [torch.zeros(n_cols, dtype=dtype, device=self.device)
                for _ in sets]
        for lo, hi in self.blocks(block_rows):
            cols = self._expand(self.root, torch.arange(
                lo, hi, device=self.device))
            for vals, g, s in zip(sets, grams, sums):
                x = torch.cat([vals[n][cols[n]] for n in self.preorder], 1)
                if inputs is not None:
                    x = inputs(x)
                g += x.mT @ x
                s += x.sum(0)
            del cols
        return [(g.cpu().numpy().astype(np.float64),
                 s.cpu().numpy().astype(np.float64), self.rows)
                for g, s in zip(grams, sums)]
