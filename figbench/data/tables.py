"""Tables of a configuration, made from a seed (numpy only).

A configuration lists its relations in order. Each has a row count, key
columns and data columns. A key column is drawn as

- ``arange``: 0, 1, ..., rows - 1 (a primary key);
- ``uniform``: integers drawn uniformly from [0, card) (a foreign key);
- ``repeat``: 0 .. card - 1, each repeated ``times`` times;
- ``tile``: the run 0 .. card - 1, repeated ``times`` times.

Data columns are drawn from U[low, high) (the paper's U[-3, 3)). The draws
follow the relations' order, each relation's key columns in order and then
its data, from one ``numpy.random.default_rng(seed)``: given the sizes and
the seed of the port's ``yelp_like`` or ``favorita_like``, the tables that
come out are theirs. This module is the benchmark's frozen copy of those
generators.

The port ingests the tables as drawn: its join reduces them and its plan
sorts them. `reduce` does the first by itself: it drops every row that
joins with nothing (a full semijoin reduction). `prepare` also sorts each
reduced table, stably, by the key attributes it shares with its parent in
the join tree and then by its other key attributes, the order in which a
FiGaRo plan holds its rows. The reference reads the prepared tables, and a
request's data leaves are given in their order, row i of a leaf being row i
of its prepared table; a leaf's shape is that of the reduced table.

A size in a configuration is a whole number, the name of a top-level entry
that holds one, or a list of those, multiplied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Table", "resolve", "orient", "draw_tables", "reduce", "prepare",
           "make_tables", "tree_stats", "feature_sets"]


@dataclasses.dataclass
class Table:
    name: str
    keys: dict  # attribute -> int64 [rows]
    data: np.ndarray  # float64 [rows, width]
    columns: tuple  # data column names

    @property
    def rows(self) -> int:
        return int(self.data.shape[0])

    def take(self, idx) -> "Table":
        return Table(self.name, {a: k[idx] for a, k in self.keys.items()},
                     self.data[idx], self.columns)


def resolve(config: dict, value) -> int:
    """A size of the configuration as a whole number."""
    if isinstance(value, bool):
        raise TypeError(f"not a size: {value!r}")
    if isinstance(value, int):
        return value
    if isinstance(value, str):
        return resolve(config, config[value])
    if isinstance(value, list):
        out = 1
        for v in value:
            out *= resolve(config, v)
        return out
    raise TypeError(f"not a size: {value!r}")


def _columns(config: dict, rel: dict) -> tuple:
    if "columns" in rel:
        return tuple(rel["columns"])
    width = resolve(config, rel["width"])
    return tuple(f"{rel['prefix']}{i}" for i in range(width))


def _draw_key(config: dict, spec: dict, rows: int, rng) -> np.ndarray:
    how = spec["draw"]
    if how == "arange":
        return np.arange(rows)
    if how == "uniform":
        return rng.integers(0, resolve(config, spec["card"]), rows)
    card, times = resolve(config, spec["card"]), resolve(config, spec["times"])
    if card * times != rows:
        raise ValueError(f"{how} key of {card} x {times} for {rows} rows")
    if how == "repeat":
        return np.repeat(np.arange(card), times)
    if how == "tile":
        return np.tile(np.arange(card), times)
    raise ValueError(f"unknown key draw {how!r}")


def draw_tables(config: dict, seed: int) -> dict:
    """The configuration's tables as drawn, before reduction."""
    rng = np.random.default_rng(seed)
    low, high = config["values"]["low"], config["values"]["high"]
    out = {}
    for rel in config["relations"]:
        rows = resolve(config, rel["rows"])
        keys = {attr: _draw_key(config, spec, rows, rng)
                for attr, spec in rel["keys"].items()}
        cols = _columns(config, rel)
        data = rng.uniform(low, high, size=(rows, len(cols)))
        out[rel["name"]] = Table(rel["name"], keys, data, cols)
    return out


def orient(root: str, edges) -> tuple[dict, dict, list]:
    """(parent, children, preorder) of the join tree over ``edges`` rooted
    at ``root``; children in the order their edges are listed."""
    adj: dict = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    parent = {root: None}
    children: dict = {root: []}
    order = [root]
    for node in order:
        for nb in adj.get(node, []):
            if nb not in parent:
                parent[nb] = node
                children[node].append(nb)
                children[nb] = []
                order.append(nb)
    if adj and len(parent) != len(adj):
        raise ValueError(f"edges do not form a tree from {root!r}")
    preorder: list = []

    def visit(node):
        preorder.append(node)
        for c in children[node]:
            visit(c)

    visit(root)
    return parent, children, preorder


def shared(a: Table, b: Table) -> tuple:
    return tuple(k for k in a.keys if k in b.keys)


def codes(tables, attrs, *names) -> list:
    """One int64 code per row of each named table over ``attrs``, with
    mixing bases common to all of them (equal keys, equal codes)."""
    cards = {a: 1 + max(int(tables[n].keys[a].max(initial=-1)) for n in names)
             for a in attrs}
    total = 1.0
    for a in attrs:
        total *= cards[a]
    if total > 2 ** 62:
        raise ValueError("composite key space too large for int64")
    out = []
    for n in names:
        code = np.zeros(tables[n].rows, dtype=np.int64)
        for a in attrs:
            code = code * cards[a] + tables[n].keys[a]
        out.append(code)
    return out


def _semijoin(tables, target: str, source: str) -> None:
    attrs = shared(tables[target], tables[source])
    if not attrs:
        return
    t, s = codes(tables, attrs, target, source)
    keep = np.isin(t, np.unique(s))
    if not keep.all():
        tables[target] = tables[target].take(keep)


def reduce(config: dict, drawn: dict) -> dict:
    """The drawn tables fully reduced, rows in the order drawn; ``drawn``
    is left as it is."""
    tables = dict(drawn)
    _, children, preorder = orient(config["root"], config["edges"])
    for node in reversed(preorder):  # leaves to root
        for c in children[node]:
            _semijoin(tables, node, c)
    for node in preorder:  # root to leaves
        for c in children[node]:
            _semijoin(tables, c, node)
    return tables


def prepare(config: dict, drawn: dict) -> dict:
    """The drawn tables fully reduced and each sorted as a FiGaRo plan holds
    it (see the module's doc); ``drawn`` is left as it is."""
    tables = reduce(config, drawn)
    parent, _, preorder = orient(config["root"], config["edges"])
    for node in preorder:
        t = tables[node]
        if t.rows == 0:
            raise ValueError(f"relation {node} is empty after reduction")
        up = shared(t, tables[parent[node]]) if parent[node] else ()
        attrs = up + tuple(a for a in t.keys if a not in up)
        if attrs:
            tables[node] = t.take(np.lexsort(
                tuple(t.keys[a] for a in reversed(attrs))))
    return tables


def make_tables(config: dict, seed: int) -> dict:
    """The configuration's tables from ``seed``, prepared."""
    return prepare(config, draw_tables(config, seed))


def tree_stats(tables: dict, root: str, edges) -> dict:
    """Per relation: its rows ``m``, data width ``n``, distinct full keys
    ``K`` and the data width of its subtree ``w``; the join's width ``N``."""
    parent, children, preorder = orient(root, edges)
    width = {}
    for node in reversed(preorder):
        width[node] = tables[node].data.shape[1] + sum(
            width[c] for c in children[node])
    out = {}
    for node in preorder:
        t = tables[node]
        attrs = tuple(t.keys)
        k = int(np.unique(codes(tables, attrs, node)[0]).size) if attrs \
            else min(t.rows, 1)
        out[node] = {"m": t.rows, "n": int(t.data.shape[1]), "K": k,
                     "w": width[node]}
    return {"nodes": out, "N": width[root]}


def feature_sets(tables: dict, order, count: int, seed: int, low: float,
                 high: float, dtype=np.float32) -> list:
    """``count`` sets of new data values, one [rows, width] leaf a relation
    in ``order``, drawn from U[low, high) by a stream of ``seed`` apart from
    the tables' own."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for _ in range(count):
        leaves = []
        for name in order:
            shape = tables[name].data.shape
            leaves.append((rng.random(shape, dtype=dtype) * (high - low)
                           + low).astype(dtype, copy=False))
        out.append(tuple(leaves))
    return out
