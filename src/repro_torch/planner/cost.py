"""The paper's complexity model, specialized to the repo's Algorithm 2 engine.

Per node ``i`` the engine (`repro_torch.core.figaro.figaro_r0`) does:

  1. a head/tail rotation pass over the relation's own ``[m_i, n_i]`` block
     (first-pass Givens work — every scan pass touches the data a small
     constant number of times, `ROTATION_PASSES`);
  2. a gather of the children's carried heads into the ``[K_i, w_i]`` Data
     matrix, where ``K_i`` is the distinct-full-key count and ``w_i`` the
     node's *subtree data-column width* (own columns + all descendants');
  3. **non-root only**: a second, generalized head/tail pass over that
     ``[K_i, w_i]`` matrix to project away the parent-shared key.

Step 3 is the orientation lever: the root skips it, so rooting the tree at
the relation whose subtree-weighted ``K_i * w_i`` mass is largest removes the
single biggest projection pass. A naive "sum over all nodes of rows x width"
misranks real schemas (it charges the root for a pass it never runs); the
root exclusion below is what makes predicted cost track measured runtime in
the JAX package's ``benchmarks/join_tree_effect.py``.

Pure numpy-free arithmetic on host ints.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from .stats import DatabaseStats

__all__ = ["ROTATION_PASSES", "NodeCost", "OrientationCost",
           "orientation_cost", "plan_cost", "subtree_widths"]

# Each head/tail scan pass reads+rotates+writes its block: ~3 touches per
# element. A constant factor — it cannot change a ranking, but it keeps the
# absolute numbers within sight of element-touch counts for `explain()`.
ROTATION_PASSES = 3


@dataclasses.dataclass(frozen=True)
class NodeCost:
    """Per-node cost breakdown under one orientation."""

    name: str
    m: int  # rows
    n: int  # own data columns
    K: int  # distinct full join keys (gen-head/tail rows)
    width: int  # subtree data-column width w_i
    is_root: bool
    first_pass: float  # ROT * m * n
    gather: float  # K * (w - n): assembling children heads into Data
    project: float  # ROT * K * w for non-root, 0 for the root

    @property
    def total(self) -> float:
        return self.first_pass + self.gather + self.project


@dataclasses.dataclass(frozen=True)
class OrientationCost:
    """Estimated cost of one rooted orientation, with per-node breakdown."""

    root: str
    parent: Mapping[str, str | None]
    nodes: tuple[NodeCost, ...]
    total: float


def subtree_widths(parent: Mapping[str, str | None],
                   ncols: Mapping[str, int]) -> dict[str, int]:
    """w_i per node: own data columns + all descendants' (pure topology)."""
    widths = dict(ncols)
    # Children accumulate into ancestors; iterate leaves-up by repeatedly
    # folding nodes whose children are all folded.
    children: dict[str, list[str]] = {n: [] for n in parent}
    for n, p in parent.items():
        if p is not None:
            children[p].append(n)

    def width(n: str) -> int:
        return ncols[n] + sum(width(c) for c in children[n])

    return {n: width(n) for n in parent}


def orientation_cost(stats: DatabaseStats,
                     parent: Mapping[str, str | None]) -> OrientationCost:
    """Score one rooted orientation (``parent`` maps root -> None)."""
    roots = [n for n, p in parent.items() if p is None]
    if len(roots) != 1:
        raise ValueError(f"orientation needs exactly one root, got {roots}")
    root = roots[0]
    ncols = {n: st.num_data_cols for n, st in stats.relations.items()}
    widths = subtree_widths(parent, ncols)
    nodes = []
    for name in parent:
        st = stats.relations[name]
        m, n, K, w = st.num_rows, st.num_data_cols, st.distinct_keys, widths[name]
        is_root = name == root
        nodes.append(NodeCost(
            name=name, m=m, n=n, K=K, width=w, is_root=is_root,
            first_pass=float(ROTATION_PASSES * m * n),
            gather=float(K * (w - n)),
            project=0.0 if is_root else float(ROTATION_PASSES * K * w),
        ))
    nodes = tuple(sorted(nodes, key=lambda c: c.name))
    return OrientationCost(root=root, parent=dict(parent), nodes=nodes,
                           total=sum(c.total for c in nodes))


def plan_cost(tree) -> float:
    """Estimated cost of an existing `JoinTree`-like object (duck-typed:
    needs ``tree.db`` and ``tree.parent``)."""
    from .stats import stats_for

    edges = [(p, c) for c, p in tree.parent.items() if p is not None]
    stats = stats_for(tree.db, edges)
    return orientation_cost(stats, tree.parent).total
