"""The port's planner (`repro_torch.planner`) against the JAX package's.

On the retailer, favorita, yelp and cartesian schemas (the same tables from
both packages' generators): `stats_for` field by field, `orientation_cost`
for every root, `choose_root`, `explain_text` as a string, and the façade's
``join(..., root="auto")`` root and ``explain()``. Adaptive re-rooting: the
same appends through both packages' datasets give the same sequence of
`Replanner` decisions (tests/test_planner.py:287 and :325), and the
re-rooted port dataset's R equals the JAX dataset's at float64 1e-9. The
port runs on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import figaro as jfig
from repro import planner as jplanner
from repro.core.relation import Database as JDatabase
from repro.core.relation import full_reduce as jfull_reduce
from repro.data import relational as jrel
from repro.planner import stats as jstats
from repro_torch import figaro
from repro_torch import planner as tplanner
from repro_torch.core.relation import Database, full_reduce
from repro_torch.data import relational as trel
from repro_torch.planner import stats as tstats

ATOL = 1e-9
SCHEMAS = {
    "retailer": lambda m: m.retailer_like(scale=60, cols=2),
    "favorita": lambda m: m.favorita_like(scale=40, cols=2),
    "yelp": lambda m: m.yelp_like(scale=40, cols=2),
    "cartesian": lambda m: m.cartesian(7, 5),
}


def _trees(name):
    return SCHEMAS[name](trel), SCHEMAS[name](jrel)


def _same_stats(st_t, st_j):
    assert st_t.edges == st_j.edges and st_t.shared == st_j.shared
    assert sorted(st_t.relations) == sorted(st_j.relations)
    for name, rt in st_t.relations.items():
        rj = st_j.relations[name]
        for f in ("name", "key_attrs", "num_data_cols", "num_rows"):
            assert getattr(rt, f) == getattr(rj, f), (name, f)
        assert sorted(rt.uniques) == sorted(rj.uniques)
        for attrs, u in rt.uniques.items():
            np.testing.assert_array_equal(u, rj.uniques[attrs])
        assert rt.distinct_keys == rj.distinct_keys


def _same_cost(ct, cj):
    assert ct.root == cj.root and dict(ct.parent) == dict(cj.parent)
    assert ct.total == cj.total
    assert [dataclasses.astuple(n) for n in ct.nodes] == \
        [dataclasses.astuple(n) for n in cj.nodes]


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_stats_equal_field_by_field(name):
    t, j = _trees(name)
    st_t = tstats.stats_for(t.db, t.edges())
    st_j = jstats.stats_for(j.db, j.edges())
    _same_stats(st_t, st_j)
    for rel in st_t.relations.values():
        for attrs in rel.uniques:
            assert rel.fan_out(attrs) == \
                st_j.relations[rel.name].fan_out(attrs)


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_orientation_cost_equal_for_every_root(name):
    t, j = _trees(name)
    st_t = tstats.stats_for(t.db, t.edges())
    st_j = jstats.stats_for(j.db, j.edges())
    roots_t = tplanner.enumerate_roots(t.db.names, t.edges())
    roots_j = jplanner.enumerate_roots(j.db.names, j.edges())
    assert [r for r, _ in roots_t] == [r for r, _ in roots_j]
    for (root, pt), (_, pj) in zip(roots_t, roots_j):
        assert pt == pj, root
        _same_cost(tplanner.orientation_cost(st_t, pt),
                   jplanner.orientation_cost(st_j, pj))
    assert tplanner.plan_cost(t) == jplanner.plan_cost(j)


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_choose_root_and_explain_text_identical(name):
    t, j = _trees(name)
    rank_t = tplanner.rank_orientations(t.db, t.edges())
    rank_j = jplanner.rank_orientations(j.db, j.edges())
    for ct, cj in zip(rank_t, rank_j, strict=True):
        _same_cost(ct, cj)
    assert tplanner.choose_root(t.db, t.edges()) == \
        jplanner.choose_root(j.db, j.edges())
    for chosen, current in ((rank_t[0].root, t.root), (None, None),
                            (rank_t[-1].root, rank_t[0].root)):
        assert tplanner.explain_text(rank_t, chosen, current) == \
            jplanner.explain_text(rank_j, chosen, current)
    assert tplanner.explain_text([]) == jplanner.explain_text([])


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_facade_auto_root_and_explain_match(name):
    t, j = _trees(name)
    ds_t = figaro.Session(device="cpu").ingest(t.db).join(t.edges(),
                                                          root="auto")
    ds_j = jfig.Session().ingest(j.db).join(j.edges(), root="auto")
    assert ds_t.tree.root == ds_j.tree.root
    assert ds_t.explain() == ds_j.explain()


def test_validate_names_and_orient_edges_match():
    names = ["A", "B", "C"]
    edges = [("A", "B"), ("B", "C")]
    assert tplanner.orient_edges(names, edges, "B") == \
        jplanner.orient_edges(names, edges, "B")
    for bad_root, bad_edges in (("Z", edges), ("A", [("A", "Q")]),
                                ("A", [("A", "B")])):
        with pytest.raises(ValueError) as et:
            tplanner.orient_edges(names, bad_edges, bad_root)
        with pytest.raises(ValueError) as ej:
            jplanner.orient_edges(names, bad_edges, bad_root)
        assert str(et.value) == str(ej.value)


def test_incremental_stats_update_matches_jax():
    t, j = _trees("yelp")
    st_t = tstats.DatabaseStats.collect(t.db, t.edges())
    st_j = jstats.DatabaseStats.collect(j.db, j.edges())
    keys = np.array([[0, 1], [3, 2], [0, 1]])
    st_t.update("Review", keys)
    st_j.update("Review", keys)
    _same_stats(st_t, st_j)


# -- adaptive re-rooting: the same decisions on the same appends --------------


def _flip_tables(rng, *, f2_cols: int = 8):
    """tests/test_planner.py's chain F1(x,u) - D(x,y) - F2(y,v)."""
    nx, ny, m_d, m_f1, m_f2 = 20, 15, 40, 200, 10
    dx = rng.integers(0, nx, m_d)
    dy = rng.integers(0, ny, m_d)
    return {
        "F1": ({"x": rng.choice(np.unique(dx), m_f1), "u": np.arange(m_f1)},
               rng.normal(size=(m_f1, 4)), [f"f{i}" for i in range(4)]),
        "D": ({"x": dx, "y": dy}, rng.normal(size=(m_d, 1)), ["d0"]),
        "F2": ({"y": rng.choice(np.unique(dy), m_f2), "v": np.arange(m_f2)},
               rng.normal(size=(m_f2, f2_cols)),
               [f"g{i}" for i in range(f2_cols)]),
    }


_FLIP_EDGES = [("F1", "D"), ("D", "F2")]


def _appends(db, f2_cols: int, steps: int):
    """A fixed sequence of (relation, keys, rows) appends on the reduced
    flip chain ``db``: F2 rows with existing y and fresh v, F1 rows with
    existing x and fresh u, alternating (tests/test_planner.py:325)."""
    grow = np.random.default_rng(2)
    out, next_v, next_u = [], 10, 200
    for _ in range(steps):
        ys = np.unique(db["F2"].key_col("y"))
        out.append(("F2", {"y": grow.choice(ys, 40),
                           "v": np.arange(next_v, next_v + 40)},
                    grow.normal(size=(40, f2_cols))))
        next_v += 40
        xs = np.unique(db["F1"].key_col("x"))
        out.append(("F1", {"x": grow.choice(xs, 40),
                           "u": np.arange(next_u, next_u + 40)},
                    grow.normal(size=(40, 4))))
        next_u += 40
    return out


@pytest.mark.parametrize("f2_cols,hysteresis", [(8, 0.4), (4, 0.5),
                                                (8, 0.0)])
def test_replanner_decisions_match_over_the_same_appends(f2_cols,
                                                         hysteresis):
    """Both packages' datasets take the same appends after their first
    plan build: every append's return value, root and re-root count agree
    (with F1 and F2 equally wide, neither flaps)."""
    tables = _flip_tables(np.random.default_rng(1), f2_cols=f2_cols)
    ds_t = figaro.Session(device="cpu", headroom=4).ingest(tables).join(
        _FLIP_EDGES, hysteresis=hysteresis)
    ds_j = jfig.Session(headroom=4).ingest(tables).join(
        _FLIP_EDGES, hysteresis=hysteresis)
    _ = ds_t.plan, ds_j.plan
    seq_t, seq_j = [], []
    for name, keys, rows in _appends(ds_t.tree.db, f2_cols, steps=3):
        seq_t.append((ds_t.append(name, keys, rows), ds_t.tree.root,
                      ds_t.stats()["reroots"]))
        seq_j.append((ds_j.append(name, keys, rows), ds_j.tree.root,
                      ds_j.stats()["reroots"]))
    assert seq_t == seq_j
    if f2_cols == 4:
        assert seq_t[-1][2] == 0, "alternating appends flapped the root"
    assert ds_t.explain() == ds_j.explain()
    assert ds_t.columns == ds_j.columns


def test_hysteresis_gated_reroot_matches_jax():
    """tests/test_planner.py:287 on both packages: 400 F2 rows flip the
    root from F1 to F2 past a 0.4 margin; the port's re-rooted R equals the
    JAX dataset's."""
    rng = np.random.default_rng(0)
    tables = _flip_tables(rng)
    ds_t = figaro.Session(device="cpu", headroom=4).ingest(tables).join(
        _FLIP_EDGES, hysteresis=0.4)
    ds_j = jfig.Session(headroom=4).ingest(tables).join(
        _FLIP_EDGES, hysteresis=0.4)
    ys = np.unique(ds_t.tree.db["F2"].key_col("y"))
    grow = np.random.default_rng(7)
    keys = {"y": grow.choice(ys, 400), "v": np.arange(10, 410)}
    rows = grow.normal(size=(400, 8))
    assert ds_t.tree.root == ds_j.tree.root == "F1"
    ds_t.qr(dtype=torch.float64)
    ds_j.qr(dtype=jnp.float64)
    assert ds_t.append("F2", keys, rows) is False
    assert ds_j.append("F2", keys, rows) is False
    st = ds_t.stats()
    assert st["root"] == "F2" and st["reroots"] == 1
    assert st["append_volume"] == {"F2": 400}
    assert ds_t.columns[0].startswith("F2.")
    r_t = ds_t.qr(dtype=torch.float64).numpy()
    r_j = np.asarray(ds_j.qr(dtype=jnp.float64))
    np.testing.assert_allclose(r_t, r_j, atol=ATOL)


def test_reroot_releases_the_superseded_specs_graphs(monkeypatch):
    """The re-root of test_hysteresis_gated_reroot_matches_jax hands the
    displaced orientation's spec to `FigaroEngine.release_graphs` once."""
    tables = _flip_tables(np.random.default_rng(0))
    sess = figaro.Session(device="cpu", headroom=4)
    ds = sess.ingest(tables).join(_FLIP_EDGES, hysteresis=0.4)
    released = []
    monkeypatch.setattr(sess.engine, "release_graphs", released.append)
    ds.qr(dtype=torch.float64)
    spec = ds.plan.spec
    ys = np.unique(ds.tree.db["F2"].key_col("y"))
    grow = np.random.default_rng(7)
    keys = {"y": grow.choice(ys, 400), "v": np.arange(10, 410)}
    assert ds.append("F2", keys, grow.normal(size=(400, 8))) is False
    assert ds.stats()["reroots"] == 1 and ds.tree.root == "F2"
    assert released == [spec]


def test_direct_replanner_policy_matches_jax():
    """tests/test_planner.py:325's direct check on both Replanners: a
    challenger inside the margin never wins, one outside it does."""
    rng = np.random.default_rng(0)
    tables = _flip_tables(rng)
    db_t = full_reduce(Database.from_arrays(tables), _FLIP_EDGES)
    db_j = jfull_reduce(JDatabase.from_arrays(tables), _FLIP_EDGES)
    ranking = tplanner.rank_orientations(db_t, _FLIP_EDGES)
    best, second = ranking[0], ranking[1]
    margin = second.total / best.total - 1.0
    for hyst, want in ((margin + 0.05, None), (max(margin - 0.05, 0.0),
                                               best.root)):
        got = []
        for pl, st, db in ((tplanner, tstats, db_t), (jplanner, jstats, db_j)):
            rp = pl.Replanner(stats=st.stats_for(db, _FLIP_EDGES),
                              names=tuple(db.names),
                              edges=st.normalize_edges(_FLIP_EDGES),
                              current_root=second.root, hysteresis=hyst)
            got.append(rp.proposal())
        assert got == [want, want]
