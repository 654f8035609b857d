"""Exact join statistics, collected at ingest and maintained incrementally.

The cost model (`repro_torch.planner.cost`) needs, per relation: row count ``m``,
data-column count ``n``, the distinct full-join-key count ``K`` (the number of
generalized-head/tail rows the relation emits — orientation-independent), and
per-edge distinct counts / fan-outs for diagnostics. All of these are *exact*,
not sampled: we keep the sorted unique key rows of every tracked projection,
so an append merges ``r`` new rows in O((U + r) log r) without rescanning the
relation, and incremental stats equal a from-scratch recollection bit for bit.

Pure numpy + stdlib by design: statistics run at ingest time on the host. The module is
duck-typed against `repro_torch.core.relation` (``rel.keys`` / ``rel.key_attrs`` /
``rel.num_rows`` / ``rel.num_data_cols``; ``db.relations``) rather than
importing it, which also keeps `repro_torch.data.relational` free to import the
planner without a cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

__all__ = ["RelationStats", "DatabaseStats", "stats_for", "normalize_edges"]

# Attribute hung on a Database instance to cache stats per edge set.
_CACHE_ATTR = "_figaro_plan_stats"


def _unique_rows(rows: np.ndarray) -> np.ndarray:
    """Sorted unique rows of a [r, k] int array (k may be 0)."""
    if rows.shape[0] == 0 or rows.shape[1] == 0:
        return rows[: min(rows.shape[0], 1)].copy()
    return np.unique(rows, axis=0)


def normalize_edges(edges: Iterable[tuple[str, str]]) -> tuple[tuple[str, str], ...]:
    """Canonical undirected edge set: endpoints sorted, edges sorted, deduped."""
    return tuple(sorted({tuple(sorted((a, b))) for a, b in edges}))


@dataclasses.dataclass
class RelationStats:
    """Exact statistics of one relation over a set of tracked key projections."""

    name: str
    key_attrs: tuple[str, ...]
    num_data_cols: int
    num_rows: int
    # Tracked projection -> sorted unique key rows [U, len(attrs)].
    uniques: dict[tuple[str, ...], np.ndarray]

    @property
    def distinct_keys(self) -> int:
        """K_i: distinct full join keys (gen-head/tail row count of the node)."""
        return int(self.uniques[self.key_attrs].shape[0])

    def distinct(self, attrs: Sequence[str]) -> int:
        return int(self.uniques[tuple(attrs)].shape[0])

    def fan_out(self, attrs: Sequence[str]) -> float:
        """Average rows per distinct value of ``attrs`` — the downward fan-out
        when ``attrs`` are the attributes shared with the parent."""
        d = self.distinct(attrs)
        return self.num_rows / d if d else float(self.num_rows)

    def update(self, keys: np.ndarray) -> None:
        """Merge appended key rows (``[r, len(key_attrs)]``, key-attr order)."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.ndim == 1:
            keys = keys[None, :]
        if keys.shape[1] != len(self.key_attrs):
            raise ValueError(
                f"{self.name}: appended keys have {keys.shape[1]} columns, "
                f"expected {len(self.key_attrs)}")
        self.num_rows += int(keys.shape[0])
        pos = {a: i for i, a in enumerate(self.key_attrs)}
        for attrs, table in self.uniques.items():
            proj = keys[:, [pos[a] for a in attrs]]
            self.uniques[attrs] = _unique_rows(
                np.concatenate([table, proj], axis=0))

    @staticmethod
    def collect(rel, track: Iterable[tuple[str, ...]]) -> "RelationStats":
        """Collect from a `Relation`-like object; always tracks the full key."""
        key_attrs = tuple(rel.key_attrs)
        keys = np.asarray(rel.keys, dtype=np.int64)
        pos = {a: i for i, a in enumerate(key_attrs)}
        uniques: dict[tuple[str, ...], np.ndarray] = {}
        for attrs in {key_attrs} | {tuple(t) for t in track}:
            uniques[attrs] = _unique_rows(keys[:, [pos[a] for a in attrs]])
        return RelationStats(
            name=rel.name,
            key_attrs=key_attrs,
            num_data_cols=int(rel.num_data_cols),
            num_rows=int(rel.num_rows),
            uniques=uniques,
        )


@dataclasses.dataclass
class DatabaseStats:
    """Per-relation stats plus the undirected join-edge structure they track.

    Orientation-independent on purpose: ``m``, ``n``, ``K`` and per-edge
    distinct counts do not change when the tree is re-rooted, so one stats
    object scores *every* orientation and survives adaptive re-rooting.
    """

    relations: dict[str, RelationStats]
    edges: tuple[tuple[str, str], ...]  # normalized undirected
    shared: dict[tuple[str, str], tuple[str, ...]]  # per normalized edge

    @staticmethod
    def collect(db, edges: Iterable[tuple[str, str]]) -> "DatabaseStats":
        edges = normalize_edges(edges)
        rels: Mapping[str, object] = db.relations
        shared: dict[tuple[str, str], tuple[str, ...]] = {}
        track: dict[str, list[tuple[str, ...]]] = {n: [] for n in rels}
        for a, b in edges:
            ra, rb = rels[a], rels[b]
            attrs = tuple(x for x in ra.key_attrs if x in rb.key_attrs)
            shared[(a, b)] = attrs
            if attrs:
                track[a].append(attrs)
                track[b].append(tuple(x for x in rb.key_attrs if x in attrs))
        stats = {n: RelationStats.collect(rels[n], track[n]) for n in rels}
        return DatabaseStats(relations=stats, edges=edges, shared=shared)

    def shared_attrs(self, a: str, b: str) -> tuple[str, ...]:
        """Join attributes of undirected edge {a, b}, in a's attr order."""
        key = tuple(sorted((a, b)))
        attrs = self.shared[key]
        return tuple(x for x in self.relations[a].key_attrs if x in attrs)

    def edge_fan_out(self, child: str, parent: str) -> float:
        """Downward fan-out of ``child`` under ``parent``: average child rows
        per distinct parent-shared key (1.0 means key-preserving)."""
        return self.relations[child].fan_out(self.shared_attrs(child, parent))

    def update(self, name: str, keys: np.ndarray) -> None:
        """Fold an append's key rows into ``name``'s stats, incrementally."""
        if name not in self.relations:
            raise ValueError(
                f"unknown relation {name!r}; have {sorted(self.relations)}")
        self.relations[name].update(keys)


def stats_for(db, edges: Iterable[tuple[str, str]]) -> DatabaseStats:
    """Stats for (db, edges), cached on the Database per normalized edge set.

    The cache rides on the instance (plain attribute), so repeated planning
    calls — rank, explain, re-root checks — reuse one collection pass. Callers
    that append rows must route the new keys through `DatabaseStats.update` to
    keep the cached object exact.
    """
    key = normalize_edges(edges)
    cache = getattr(db, _CACHE_ATTR, None)
    if cache is None:
        cache = {}
        try:
            setattr(db, _CACHE_ATTR, cache)
        except (AttributeError, TypeError):  # frozen/slotted db: skip caching
            return DatabaseStats.collect(db, key)
    if key not in cache:
        cache[key] = DatabaseStats.collect(db, key)
    return cache[key]
