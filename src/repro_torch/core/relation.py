"""Relations, databases and ingest-time preprocessing for FiGaRo.

The paper's setting: a database of relations ``S_1..S_r``, each with *join* (key)
attributes ``X_i`` (any hashable type) and *data* attributes ``Y_i`` (reals). The
matrix ``A`` is defined by the natural join of the relations, projected onto the
data columns.

Design split: everything *structural* — dictionary encoding of keys, sorting,
grouping, full reduction — happens here at ingest time in numpy ("query
compilation", mirrors the paper's assumption that inputs are pre-sorted).
Everything *numeric* runs as PyTorch on the device downstream (`counts.py`,
`figaro.py`). This module is a numpy copy of the JAX package's
`core/relation.py`, so the port never imports that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "Relation",
    "Database",
    "encode_database",
    "full_reduce",
]


@dataclasses.dataclass
class Relation:
    """One relation: integer-encoded key columns + float data columns.

    ``keys[:, a]`` is the dictionary-encoded value of key attribute
    ``key_attrs[a]`` for each row; encodings are shared across relations per
    attribute name so natural-join equality == integer equality.
    """

    name: str
    key_attrs: tuple[str, ...]
    data_attrs: tuple[str, ...]
    keys: np.ndarray  # [m, len(key_attrs)] int64
    data: np.ndarray  # [m, len(data_attrs)] float

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys, dtype=np.int64)
        self.data = np.asarray(self.data)
        if self.keys.ndim != 2 or self.data.ndim != 2:
            raise ValueError(f"{self.name}: keys/data must be 2-D")
        if self.keys.shape[0] != self.data.shape[0]:
            raise ValueError(f"{self.name}: keys and data row counts differ")
        if self.keys.shape[1] != len(self.key_attrs):
            raise ValueError(f"{self.name}: keys width != len(key_attrs)")
        if self.data.shape[1] != len(self.data_attrs):
            raise ValueError(f"{self.name}: data width != len(data_attrs)")

    @property
    def num_rows(self) -> int:
        return self.keys.shape[0]

    @property
    def num_data_cols(self) -> int:
        return self.data.shape[1]

    def key_col(self, attr: str) -> np.ndarray:
        return self.keys[:, self.key_attrs.index(attr)]

    def sorted_by(self, attr_order: Sequence[str]) -> "Relation":
        """Stable sort rows lexicographically by the given key attributes."""
        cols = [self.key_col(a) for a in attr_order]
        # np.lexsort sorts by the *last* key first.
        order = np.lexsort(tuple(reversed(cols))) if cols else np.arange(self.num_rows)
        return Relation(
            self.name, self.key_attrs, self.data_attrs,
            self.keys[order], self.data[order],
        )

    def select_rows(self, mask: np.ndarray) -> "Relation":
        return Relation(self.name, self.key_attrs, self.data_attrs,
                        self.keys[mask], self.data[mask])


@dataclasses.dataclass
class Database:
    relations: dict[str, Relation]

    def __getitem__(self, name: str) -> Relation:
        return self.relations[name]

    def __iter__(self):
        return iter(self.relations.values())

    @property
    def names(self) -> list[str]:
        return list(self.relations.keys())

    @property
    def total_rows(self) -> int:
        return sum(r.num_rows for r in self)

    @property
    def total_data_cols(self) -> int:
        return sum(r.num_data_cols for r in self)

    @staticmethod
    def from_tables(
        tables: Mapping[str, tuple[Mapping[str, Iterable[Any]], Mapping[str, Iterable[float]]]],
    ) -> "Database":
        """Build a database from ``{name: (key_columns, data_columns)}``.

        Key column values may be any hashable type; they are dictionary-encoded
        per attribute name, shared across relations (so equal values in two
        relations map to the same code — natural-join semantics).
        """
        # Build per-attribute dictionaries across all relations.
        dictionaries: dict[str, dict[Any, int]] = {}
        for _, (key_cols, _) in tables.items():
            for attr, values in key_cols.items():
                d = dictionaries.setdefault(attr, {})
                for v in values:
                    if v not in d:
                        d[v] = len(d)
        relations = {}
        for name, (key_cols, data_cols) in tables.items():
            key_attrs = tuple(key_cols.keys())
            data_attrs = tuple(data_cols.keys())
            if key_attrs:
                keys = np.stack(
                    [np.array([dictionaries[a][v] for v in key_cols[a]], dtype=np.int64)
                     for a in key_attrs], axis=1)
            else:
                nrows = len(next(iter(data_cols.values())))
                keys = np.zeros((nrows, 0), dtype=np.int64)
            data = np.stack([np.asarray(list(data_cols[a]), dtype=np.float64)
                             for a in data_attrs], axis=1) if data_attrs else \
                np.zeros((keys.shape[0], 0))
            relations[name] = Relation(name, key_attrs, data_attrs, keys, data)
        return Database(relations)

    @staticmethod
    def from_arrays(
        tables: Mapping[str, tuple[Mapping[str, np.ndarray], np.ndarray, Sequence[str]]],
    ) -> "Database":
        """Fast path: ``{name: (key_arrays_int, data_matrix, data_attr_names)}``.

        Key arrays must already be non-negative integers with natural-join
        semantics (equal ints join).
        """
        relations = {}
        for name, (key_cols, data, data_attrs) in tables.items():
            key_attrs = tuple(key_cols.keys())
            keys = (np.stack([np.asarray(key_cols[a], dtype=np.int64) for a in key_attrs], axis=1)
                    if key_attrs else np.zeros((data.shape[0], 0), dtype=np.int64))
            relations[name] = Relation(name, key_attrs, tuple(data_attrs), keys,
                                       np.asarray(data))
        return Database(relations)


def encode_database(db: Database) -> Database:
    """Re-encode each key attribute to a dense ``0..card-1`` range (shared per attr)."""
    # Collect the union of values per attribute.
    values: dict[str, np.ndarray] = {}
    for rel in db:
        for a in rel.key_attrs:
            col = rel.key_col(a)
            values[a] = col if a not in values else np.concatenate([values[a], col])
    lut = {a: np.unique(v) for a, v in values.items()}
    relations = {}
    for rel in db:
        cols = [np.searchsorted(lut[a], rel.key_col(a)) for a in rel.key_attrs]
        keys = (np.stack(cols, axis=1) if cols
                else np.zeros((rel.num_rows, 0), dtype=np.int64))
        relations[rel.name] = Relation(rel.name, rel.key_attrs, rel.data_attrs,
                                       keys, rel.data)
    return Database(relations)


def _composite_codes(rel: Relation, attrs: Sequence[str],
                     cards: Mapping[str, int] | None = None) -> np.ndarray:
    """Row-wise composite key over ``attrs`` as a single int64 code (row-major mix).

    ``cards`` must be shared across every relation whose codes are compared
    (otherwise the mixing bases disagree); defaults to this relation's own
    maxima — only safe for single-relation grouping.
    """
    if not attrs:
        return np.zeros(rel.num_rows, dtype=np.int64)
    cols = [rel.key_col(a) for a in attrs]
    if cards is None:
        card_list = [int(c.max()) + 1 if c.size else 1 for c in cols]
    else:
        card_list = [int(cards[a]) for a in attrs]
    total = 1.0
    for c in card_list:
        total *= c
    if total > 2**62:
        raise ValueError("composite key space too large for int64 mixing")
    code = np.zeros(rel.num_rows, dtype=np.int64)
    for col, card in zip(cols, card_list):
        code = code * card + col
    return code


def full_reduce(db: Database, edges: Sequence[tuple[str, str]]) -> Database:
    """Semi-join reduce the database so no dangling tuples remain (Yannakakis).

    ``edges`` are (parent, child) pairs of a join tree. Two sweeps: leaves→root
    then root→leaves, filtering rows whose shared-attr key has no partner.
    """
    rels = dict(db.relations)

    def shared(a: str, b: str) -> tuple[str, ...]:
        return tuple(x for x in rels[a].key_attrs if x in rels[b].key_attrs)

    def semijoin(target: str, source: str) -> None:
        attrs = shared(target, source)
        if not attrs:
            return  # Cartesian edge: no filtering possible/needed.
        t, s = rels[target], rels[source]
        # Shared mixing bases: per-attribute cardinality over BOTH relations.
        cards = {a: max(int(t.key_col(a).max(initial=-1)),
                        int(s.key_col(a).max(initial=-1))) + 1 for a in attrs}
        t_code = _composite_codes(t, attrs, cards)
        s_code = np.unique(_composite_codes(s, attrs, cards))
        mask = np.isin(t_code, s_code)
        rels[target] = t.select_rows(mask)

    # children → parents (bottom-up), then parents → children (top-down).
    for parent, child in reversed(list(edges)):
        semijoin(parent, child)
    for parent, child in edges:
        semijoin(child, parent)
    out = Database(rels)
    for rel in out:
        if rel.num_rows == 0:
            raise ValueError(f"relation {rel.name} is empty after reduction")
    return out
