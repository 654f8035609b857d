"""The port's plan lifecycle (`refresh_plan`, `PlanHolder`) against the JAX
package's.

The same appends go through both packages' `refresh_plan` on star, chain
and yelp shapes, starting from the same capacity plan: the refreshed
`PlanSpec`, every index array and the row masks are equal (`np.array_equal`
through `assert_same_plan`), an append within capacity keeps the spec, one
past it regrows to the JAX package's grown spec, and a dangling append
raises in both. `PlanHolder` keeps the JAX holder's counters and append
volumes over the same refreshes. R off a refreshed plan (port, CPU, both of
its corners) equals the JAX package's at float64 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import join_tree as jt
from repro.core import plan_cache as jpc
from repro.core.engine import FigaroEngine as JaxEngine
from repro.core.relation import Database as JDatabase
from repro.core.relation import full_reduce as jfull_reduce
from repro.data import relational as jrel
from repro_torch.core import join_tree as tjt
from repro_torch.core import plan_cache as tpc
from repro_torch.core.engine import FigaroEngine
from repro_torch.core.relation import Database, full_reduce
from repro_torch.data import relational as trel

ATOL = 1e-9
INDEX_FIELDS = ("row_to_group", "row_seg_start", "pos_in_group",
                "group_start", "group_count", "group_to_pgroup",
                "group_seg_start", "pos_in_pgroup", "pgroup_count",
                "row_mask")
SPEC_FIELDS = ("name", "idx", "parent", "children", "m", "n", "K", "P",
               "col_start", "subtree_start", "subtree_width",
               "child_rel_col0", "tail_row0", "out_row0")
PORT_CORNERS = [(False, "padded"), (True, "band")]


def _spec_tuple(spec):
    return (spec.preorder, spec.root, spec.num_cols, spec.r0_rows,
            spec.total_rows, spec.names,
            tuple(tuple(getattr(n, f) for f in SPEC_FIELDS)
                  for n in spec.nodes))


def assert_same_plan(p_t, p_j):
    """Equal specs, and every index array, mask and data matrix equal."""
    assert _spec_tuple(p_t.spec) == _spec_tuple(p_j.spec)
    for it, ij in zip(p_t.index, p_j.index, strict=True):
        for f in INDEX_FIELDS:
            a, b = getattr(it, f), getattr(ij, f)
            assert (a is None) == (b is None), f
            if b is not None:
                assert np.array_equal(np.asarray(a), np.asarray(b)), f
        assert sorted(it.child_lookup) == sorted(ij.child_lookup)
        for ch in ij.child_lookup:
            assert np.array_equal(it.child_lookup[ch],
                                  np.asarray(ij.child_lookup[ch]))
    for dt, dj in zip(p_t.data, p_j.data, strict=True):
        assert np.array_equal(np.asarray(dt), np.asarray(dj))


def _star_tables(m_fact: int = 20):
    rng = np.random.default_rng(m_fact)
    return {
        "Orders": ({"cust": np.arange(m_fact) % 8,
                    "prod": np.arange(m_fact) % 4},
                   rng.normal(size=(m_fact, 2)), ["amount", "qty"]),
        "Customers": ({"cust": np.arange(8)},
                      rng.normal(size=(8, 2)), ["age", "income"]),
        "Products": ({"prod": np.arange(4)},
                     rng.normal(size=(4, 1)), ["price"]),
    }


def _chain_tables():
    rng = np.random.default_rng(5)
    return {
        "A": ({"x": np.array([0, 0, 1, 2, 2, 3])}, rng.normal(size=(6, 2)),
              ["a0", "a1"]),
        "B": ({"x": np.array([0, 1, 2, 3, 3]), "y": np.array([0, 1, 1, 2, 0])},
              rng.normal(size=(5, 1)), ["b0"]),
        "C": ({"y": np.array([0, 1, 2, 2])}, rng.normal(size=(4, 2)),
              ["c0", "c1"]),
    }


SHAPES = {
    "star": (_star_tables, [("Orders", "Customers"), ("Orders", "Products")],
             "Orders"),
    "chain": (_chain_tables, [("A", "B"), ("B", "C")], "A"),
}


def _trees(shape):
    """(port JoinTree, JAX JoinTree) over the same reduced tables."""
    if shape == "yelp":
        return (trel.yelp_like(scale=40, cols=2),
                jrel.yelp_like(scale=40, cols=2))
    tables, edges, root = SHAPES[shape]
    tt = tjt.JoinTree.from_edges(
        full_reduce(Database.from_arrays(tables()), edges), root, edges)
    tj = jt.JoinTree.from_edges(
        jfull_reduce(JDatabase.from_arrays(tables()), edges), root, edges)
    return tt, tj


def _appends(tree, node: str, rows: int, seed: int):
    """(keys, data) appending ``rows`` rows to ``node`` with keys drawn from
    its existing rows (the database stays fully reduced)."""
    rng = np.random.default_rng(seed)
    rel = tree.db[node]
    pick = rng.integers(0, rel.num_rows, rows)
    keys = {a: rel.key_col(a)[pick].copy() for a in rel.key_attrs}
    return keys, rng.normal(size=(rows, rel.num_data_cols))


CASES = [("star", "Orders"), ("star", "Customers"), ("chain", "B"),
         ("chain", "C"), ("yelp", "Review"), ("yelp", "CheckIn")]


@pytest.mark.parametrize("shape,node", CASES)
def test_refresh_within_capacity_keeps_spec_and_matches_jax(shape, node):
    tt, tj = _trees(shape)
    cap_t = tpc.build_capacity_plan(tt, headroom=4)
    cap_j = jpc.build_capacity_plan(tj, headroom=4)
    assert_same_plan(cap_t, cap_j)
    for step in range(2):
        rows = {node: _appends(tt, node, 2, seed=step)}
        cap_t, old_spec = tpc.refresh_plan(cap_t, rows), cap_t.spec
        cap_j = jpc.refresh_plan(cap_j, rows)
        assert cap_t.spec == old_spec, "an append within capacity regrew"
        assert_same_plan(cap_t, cap_j)


@pytest.mark.parametrize("shape,node", CASES)
def test_refresh_past_capacity_regrows_to_the_jax_spec(shape, node):
    tt, tj = _trees(shape)
    cap_t = tpc.build_capacity_plan(tt)
    cap_j = jpc.build_capacity_plan(tj)
    m_cap = cap_t.spec.nodes[cap_t.spec.names.index(node)].m
    live = tt.db[node].num_rows
    rows = {node: _appends(tt, node, m_cap - live + 1, seed=3)}
    grown_t = tpc.refresh_plan(cap_t, rows)
    grown_j = jpc.refresh_plan(cap_j, rows)
    assert grown_t.spec != cap_t.spec
    assert grown_t.spec.nodes[grown_t.spec.names.index(node)].m == 2 * m_cap
    assert_same_plan(grown_t, grown_j)
    assert grown_t.source_tree.db[node].num_rows == m_cap + 1


@pytest.mark.parametrize("shape,node,key", [("star", "Orders", "cust"),
                                            ("chain", "C", "y"),
                                            ("yelp", "CheckIn", "biz")])
def test_dangling_append_raises_in_both(shape, node, key):
    tt, tj = _trees(shape)
    rel = tt.db[node]
    keys = {a: rel.key_col(a)[:1].copy() for a in rel.key_attrs}
    keys[key] = np.array([10_000])
    rows = {node: (keys, np.zeros((1, rel.num_data_cols)))}
    with pytest.raises(ValueError, match="reduce"):
        tpc.refresh_plan(tpc.build_capacity_plan(tt), rows)
    with pytest.raises(ValueError, match="reduce"):
        jpc.refresh_plan(jpc.build_capacity_plan(tj), rows)


def test_refresh_errors_match_jax():
    tt, tj = _trees("star")
    with pytest.raises(ValueError, match="build_capacity_plan"):
        tpc.refresh_plan(tjt.build_plan(tt), {})
    cap_t = tpc.build_capacity_plan(tt)
    with pytest.raises(KeyError, match="unknown relation"):
        tpc.refresh_plan(cap_t, {"Nope": ({}, np.zeros((1, 1)))})
    with pytest.raises(ValueError, match="key attrs") as et:
        tpc.refresh_plan(cap_t, {"Products": ({"cust": np.array([0])},
                                              np.zeros((1, 1)))})
    with pytest.raises(ValueError, match="key attrs") as ej:
        jpc.refresh_plan(jpc.build_capacity_plan(tj), {
            "Products": ({"cust": np.array([0])}, np.zeros((1, 1)))})
    assert str(et.value) == str(ej.value)


def test_plan_holder_counters_and_volumes_match_jax():
    tt, tj = _trees("star")
    h_t = tpc.PlanHolder(tpc.build_capacity_plan(tt, headroom=2))
    h_j = jpc.PlanHolder(jpc.build_capacity_plan(tj, headroom=2))
    steps = [("Orders", 1), ("Customers", 1), ("Orders", 12), ("Orders", 3)]
    for i, (node, rows) in enumerate(steps):
        app = {node: _appends(h_t.plan.source_tree, node, rows, seed=i)}
        assert h_t.refresh(app) == h_j.refresh(app)
        assert_same_plan(h_t.plan, h_j.plan)
    h_t.note_external_append("Products", 2)
    h_j.note_external_append("Products", 2)
    assert h_t.counters() == h_j.counters() == (5, 1)
    assert h_t.append_volumes() == h_j.append_volumes() == {
        "Orders": 16, "Customers": 1, "Products": 2}
    assert h_t.reroot_count() == h_j.reroot_count() == 0
    h_t.replace(tpc.build_capacity_plan(tt))
    assert h_t.reroot_count() == 1
    with pytest.raises(ValueError, match="no plan yet"):
        tpc.PlanHolder().refresh({})


def test_plan_holder_drains_attached_servers_and_regrow_hook():
    """`attach` / `drain` keep the JAX contract (a server is anything with
    ``flush()``), and ``on_regrow`` replaces a regrown plan."""
    tt, _ = _trees("star")
    seen = []
    holder = tpc.PlanHolder(tpc.build_capacity_plan(tt),
                            on_regrow=lambda p: seen.append(p) or p)

    class Server:
        flushes = 0

        def flush(self):
            Server.flushes += 1

    server = Server()
    holder.attach(server)
    cap_m = holder.plan.spec.nodes[0].m
    holder.refresh({"Orders": _appends(tt, "Orders", cap_m, seed=0)})
    assert Server.flushes == 1 and len(seen) == 1
    assert holder.counters() == (1, 1)


@pytest.mark.parametrize("use_kernel,assembly", PORT_CORNERS)
@pytest.mark.parametrize("shape,node", [("star", "Orders"),
                                        ("yelp", "Review")])
def test_refreshed_plan_r_matches_jax(shape, node, use_kernel, assembly):
    tt, tj = _trees(shape)
    rows = {node: _appends(tt, node, 3, seed=1)}
    cap_t = tpc.refresh_plan(tpc.build_capacity_plan(tt, headroom=4), rows)
    cap_j = jpc.refresh_plan(jpc.build_capacity_plan(tj, headroom=4), rows)
    r_t = FigaroEngine().qr(cap_t, dtype=torch.float64, device="cpu",
                            use_kernel=use_kernel, assembly=assembly)
    r_j = JaxEngine(donate_data=False).qr(cap_j, dtype=jnp.float64)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=ATOL)
