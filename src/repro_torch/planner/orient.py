"""Orientation enumeration and root choice over the acyclic join graph.

An undirected edge set over ``r`` relations has exactly ``r`` rooted
orientations (one per root — re-orienting edges away from it), so exhaustive
enumeration is O(r^2) in the tree size and always affordable at ingest time.
Eager name validation lives here too: the facade calls `validate_names` so an
unknown root or edge endpoint raises a `ValueError` naming the offender and
listing the ingested relations, instead of a bare `KeyError` deep inside tree
construction.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .cost import OrientationCost, orientation_cost
from .stats import DatabaseStats, normalize_edges, stats_for

__all__ = ["validate_names", "orient_edges", "enumerate_roots",
           "rank_orientations", "choose_root"]


def validate_names(names: Iterable[str], edges: Sequence[tuple[str, str]],
                   root: str | None = None) -> None:
    """Raise ValueError if ``root`` or any edge endpoint is not in ``names``."""
    have = sorted(names)
    have_set = set(have)
    unknown = sorted({n for e in edges for n in e if n not in have_set})
    if root is not None and root not in have_set and root not in unknown:
        unknown.insert(0, root)
    if unknown:
        noun = "relation" if len(unknown) == 1 else "relations"
        raise ValueError(
            f"unknown {noun} {', '.join(map(repr, unknown))}; "
            f"ingested relations are {have}")


def orient_edges(names: Iterable[str], edges: Sequence[tuple[str, str]],
                 root: str) -> dict[str, str | None]:
    """Orient undirected ``edges`` away from ``root``: a parent map covering
    every name (root -> None). Raises ValueError on unknown names, on edges
    that do not form a spanning tree, and on disconnected relations."""
    names = list(names)
    validate_names(names, edges, root)
    adj: dict[str, list[str]] = {n: [] for n in names}
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    parent: dict[str, str | None] = {root: None}
    stack = [root]
    while stack:
        node = stack.pop()
        for nb in adj[node]:
            if nb not in parent:
                parent[nb] = node
                stack.append(nb)
    missing = sorted(set(names) - set(parent))
    if missing:
        raise ValueError(
            f"edges do not connect {missing} to root {root!r}; "
            "every ingested relation must be reachable through the join edges")
    return parent


def enumerate_roots(names: Iterable[str],
                    edges: Sequence[tuple[str, str]]) -> list[tuple[str, dict[str, str | None]]]:
    """All rooted orientations as ``(root, parent_map)``, one per relation."""
    names = list(names)
    return [(r, orient_edges(names, edges, r)) for r in names]


def rank_orientations(db, edges: Sequence[tuple[str, str]],
                      stats: DatabaseStats | None = None) -> list[OrientationCost]:
    """Every orientation scored and sorted cheapest-first (ties: root name,
    so the ranking — and therefore `choose_root` — is deterministic)."""
    if stats is None:
        stats = stats_for(db, normalize_edges(edges))
    ranked = [orientation_cost(stats, parent)
              for _, parent in enumerate_roots(db.names, edges)]
    ranked.sort(key=lambda oc: (oc.total, oc.root))
    return ranked


def choose_root(db, edges: Sequence[tuple[str, str]],
                stats: DatabaseStats | None = None) -> str:
    """The cheapest orientation's root under the cost model."""
    return rank_orientations(db, edges, stats)[0].root
