"""The benchmark's tables: shapes, cardinalities, seeding, and the frozen
copies of the port's ``yelp_like`` (the many-to-many test fixture) and
``favorita_like``."""

import copy
import json
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from figbench.data import feature_sets, make_tables, orient, resolve, tree_stats  # noqa: E402
from figbench.data.tables import shared  # noqa: E402
from figbench.manifest import Manifest  # noqa: E402

MANIFEST = Manifest()
#: The many-to-many schema of the port's ``yelp_like``, a test fixture (not a
#: configuration of the benchmark).
MANY = json.loads((pathlib.Path(__file__).with_name("many_to_many.json"))
                  .read_text())


def _config(name):
    return copy.deepcopy(MANY if name == "many_to_many"
                         else MANIFEST.config(name))


def _sorted_like(tables, root, edges, db):
    """The port's reduced relations, sorted as `make_tables` sorts."""
    parent, _, _ = orient(root, edges)
    out = {}
    for name, rel in db.relations.items():
        keys = {a: rel.keys[:, i] for i, a in enumerate(rel.key_attrs)}
        up = tuple(a for a in keys if parent[name] and
                   a in tables[parent[name]].keys)
        attrs = up + tuple(a for a in keys if a not in up)
        order = np.lexsort(tuple(keys[a] for a in reversed(attrs)))
        out[name] = ({a: k[order] for a, k in keys.items()}, rel.data[order])
    return out


def _assert_same(tables, theirs):
    assert sorted(tables) == sorted(theirs)
    for name, (keys, data) in theirs.items():
        np.testing.assert_array_equal(tables[name].data, data)
        for a, k in keys.items():
            np.testing.assert_array_equal(tables[name].keys[a], k)


def test_many_to_many_is_the_ports_yelp_like():
    from repro_torch.data.relational import yelp_like

    cfg = dict(_config("many_to_many"), review_rows=600, users=30,
               businesses=20, width=3)
    tables = make_tables(cfg, 2)
    tree = yelp_like(scale=300, cols=3, seed=2)
    _assert_same(tables, _sorted_like(tables, cfg["root"], cfg["edges"],
                                      tree.db))


def test_favorita_schema_is_the_ports_favorita_like():
    from repro_torch.data.relational import favorita_like

    cfg = copy.deepcopy(MANIFEST.config("favorita"))
    cfg.update(sales_rows=4000, stores=25, items=50, days=100)
    widths = {"Sales": 1, "Stores": 3, "Items": 3, "Transactions": 1,
              "Oil": 1, "Holidays": 1}
    for rel in cfg["relations"]:
        rel["columns"] = rel["columns"][:widths[rel["name"]]]
    tables = make_tables(cfg, 1)
    tree = favorita_like(scale=1000, cols=3, seed=1)
    _assert_same(tables, _sorted_like(tables, cfg["root"], cfg["edges"],
                                      tree.db))


def test_sizes_of_the_configurations():
    many, fav = _config("many_to_many"), MANIFEST.config("favorita")
    assert resolve(many, ["businesses", "categories_per_business"]) \
        == 1_333_330
    assert fav["sales_rows"] * 16 == fav["sales_rows_published"]
    assert resolve(fav, ["stores", "days"]) == 90_936
    widths = {r["name"]: len(r["columns"]) for r in fav["relations"]}
    assert widths == {"Sales": 2, "Stores": 4, "Items": 3,
                      "Transactions": 1, "Oil": 1, "Holidays": 5}
    assert sum(widths.values()) == 16


@pytest.mark.parametrize("name", ["many_to_many", "favorita"])
def test_reduced_sorted_and_seeded(name):
    cfg = _config(name)
    cfg.update({"many_to_many": dict(review_rows=2000, users=100, businesses=60,
                             width=4),
                "favorita": dict(sales_rows=3000, stores=5, items=40,
                                 days=30)}[name])
    a, b, c = (make_tables(cfg, s) for s in (11, 11, 12))
    parent, children, _ = orient(cfg["root"], cfg["edges"])
    for p, cs in children.items():  # every row joins its neighbours
        for ch in cs:
            for x, y in ((p, ch), (ch, p)):
                attrs = shared(a[x], a[y])
                xs = set(zip(*(a[x].keys[k] for k in attrs)))
                ys = set(zip(*(a[y].keys[k] for k in attrs)))
                assert xs <= ys
    for n in a:
        np.testing.assert_array_equal(a[n].data, b[n].data)
        assert a[n].data.min() >= -3.0 and a[n].data.max() < 3.0
        up = [k for k in a[n].keys if parent[n] and k in a[parent[n]].keys]
        if up:
            assert np.all(np.diff(a[n].keys[up[0]]) >= 0)
    assert any(not np.array_equal(a[n].data, c[n].data) for n in a)
    stats = tree_stats(a, cfg["root"], cfg["edges"])
    assert stats["N"] == sum(t.data.shape[1] for t in a.values())
    if name == "favorita":  # key to foreign key: one Transactions row a
        assert stats["nodes"]["Transactions"]["m"] == 5 * 30  # (store, day)
        assert stats["nodes"]["Oil"]["K"] == 30


def test_feature_sets_are_seeded_and_distinct():
    cfg = dict(_config("many_to_many"), review_rows=200, users=10,
               businesses=8, width=2)
    tables = make_tables(cfg, 3)
    order = list(tables)
    one = feature_sets(tables, order, 3, 5, -3.0, 3.0)
    two = feature_sets(tables, order, 3, 5, -3.0, 3.0)
    assert len(one) == 3
    for s1, s2 in zip(one, two):
        for x, y, n in zip(s1, s2, order):
            assert x.dtype == np.float32 and x.shape == tables[n].data.shape
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(one[0][0], one[1][0])
    assert not np.array_equal(one[0][0], tables[order[0]].data)


@pytest.mark.parametrize("name", ["many_to_many", "favorita"])
def test_the_port_holds_the_drawn_tables_in_the_prepared_order(name):
    """A request's leaves go by the prepared tables' row order: the port,
    given the tables as drawn, reduces and sorts them into that order."""
    import torch

    from figbench.data import draw_tables, prepare
    from repro_torch import figaro

    cfg = _config(name)
    cfg.update({"many_to_many": dict(review_rows=900, users=40, businesses=25,
                             width=3),
                "favorita": dict(sales_rows=900, stores=5, items=30,
                                 days=20)}[name])
    drawn = draw_tables(cfg, 7)
    tables = prepare(cfg, drawn)
    ds = figaro.Session(device="cpu", **cfg["session"]).ingest(
        {n: (t.keys, t.data, list(t.columns)) for n, t in drawn.items()}
    ).join([tuple(e) for e in cfg["edges"]], root=cfg["root"])
    order = list(dict.fromkeys(c.split(".")[0] for c in ds.columns))
    for n, leaf in zip(order, ds.plan.data):
        leaf = torch.as_tensor(leaf).numpy()
        np.testing.assert_array_equal(leaf[:tables[n].rows], tables[n].data)
        assert not leaf[tables[n].rows:].any()
