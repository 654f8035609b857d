"""Port plan layer vs the JAX package: identical plans, buckets and imports.

`repro_torch.core.join_tree.build_plan` and the bucketing half of
`repro_torch.core.plan_cache` are numpy copies of the reference's; on the same
database they must give bit-identical index arrays, `PlanSpec.bands`,
`r0_rows` and `num_cols`. `import_plan` turns a JAX plan into the port's by
duck typing; R₀ from the imported plan equals R₀ from the port's own plan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TOPOLOGIES, random_acyclic_db
from repro.core import join_tree as jt
from repro.core import plan_cache as jpc
from repro.core.engine import FigaroEngine
from repro.data import relational as jrel
from repro_torch.core import join_tree as tjt
from repro_torch.core import plan_cache as tpc
from repro_torch.core.figaro import figaro_r0
from repro_torch.core.relation import Database, Relation
from repro_torch.data import relational as trel

GENERATORS = {
    "retailer": lambda m: m.retailer_like(scale=60, cols=2),
    "retailer_bad": lambda m: m.retailer_like(scale=60, cols=2, root="bad"),
    "favorita": lambda m: m.favorita_like(scale=40, cols=2),
    "yelp": lambda m: m.yelp_like(scale=40, cols=2),
    "cartesian": lambda m: m.cartesian(7, 5),
}

INDEX_FIELDS = ("row_to_group", "row_seg_start", "pos_in_group",
                "group_start", "group_count", "group_to_pgroup",
                "group_seg_start", "pos_in_pgroup", "pgroup_count",
                "row_mask")


def port_tree(tree):
    """The port's JoinTree over the same relations as a JAX JoinTree."""
    rels = {r.name: Relation(r.name, r.key_attrs, r.data_attrs, r.keys,
                             r.data) for r in tree.db}
    return tjt.JoinTree(Database(rels), dict(tree.parent))


def assert_same_plan(p_t, p_j):
    """Spec fields, bands and every index array identical."""
    st, sj = p_t.spec, p_j.spec
    assert st.preorder == sj.preorder and st.root == sj.root
    assert st.num_cols == sj.num_cols and st.r0_rows == sj.r0_rows
    assert st.total_rows == sj.total_rows and st.names == sj.names
    for a, b in zip(st.nodes, sj.nodes):
        for f in ("name", "idx", "parent", "children", "m", "n", "K", "P",
                  "col_start", "subtree_start", "subtree_width",
                  "child_rel_col0", "tail_row0", "out_row0"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
    assert [tuple(vars(b).values()) for b in st.bands] == \
        [tuple(vars(b).values()) for b in sj.bands]
    for it, ij in zip(p_t.index, p_j.index):
        for f in INDEX_FIELDS:
            a, b = getattr(it, f), getattr(ij, f)
            if b is None:
                assert a is None, f
                continue
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f)
        assert set(it.child_lookup) == set(ij.child_lookup)
        for ch in ij.child_lookup:
            np.testing.assert_array_equal(it.child_lookup[ch],
                                          np.asarray(ij.child_lookup[ch]))
    for dt, dj in zip(p_t.data, p_j.data):
        np.testing.assert_array_equal(np.asarray(dt), np.asarray(dj))


@pytest.mark.parametrize("name", list(GENERATORS))
def test_build_plan_identical_on_generators(name):
    p_t = tjt.build_plan(GENERATORS[name](trel))
    p_j = jt.build_plan(GENERATORS[name](jrel))
    assert_same_plan(p_t, p_j)


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_build_plan_identical_on_random_dbs(topology, seed):
    _, tree, p_j = random_acyclic_db(topology, np.random.default_rng(seed))
    assert_same_plan(tjt.build_plan(port_tree(tree)), p_j)


@pytest.mark.parametrize("name", ["retailer", "yelp", "cartesian"])
@pytest.mark.parametrize("headroom", [0, 5])
def test_bucket_and_pad_identical(name, headroom):
    p_t = tjt.build_plan(GENERATORS[name](trel))
    p_j = jt.build_plan(GENERATORS[name](jrel))
    cap_t = tpc.bucket_spec(p_t.spec, headroom=headroom)
    cap_j = jpc.bucket_spec(p_j.spec, headroom=headroom)
    for a, b in zip(cap_t.nodes, cap_j.nodes):
        assert (a.m, a.K, a.P, a.tail_row0, a.out_row0) == \
            (b.m, b.K, b.P, b.tail_row0, b.out_row0)
    assert cap_t.r0_rows == cap_j.r0_rows
    assert tpc.spec_fits(p_t.spec, cap_t) and jpc.spec_fits(p_j.spec, cap_j)
    assert_same_plan(tpc.pad_plan(p_t, cap_t), jpc.pad_plan(p_j, cap_j))
    assert_same_plan(
        tpc.build_capacity_plan(GENERATORS[name](trel), headroom=headroom),
        jpc.build_capacity_plan(GENERATORS[name](jrel), headroom=headroom))


def test_next_pow2_matches():
    for x in [0, 1, 2, 3, 4, 5, 7, 8, 9, 1000, 1024, 1025, 2**23 - 7]:
        assert tpc.next_pow2(x) == jpc.next_pow2(x)


def test_pad_data_torch_and_numpy():
    p_t = tjt.build_plan(GENERATORS["yelp"](trel))
    cap = tpc.bucket_spec(p_t.spec)
    padded_np = tpc.pad_data(p_t.data, cap)
    padded_t = tpc.pad_data([torch.as_tensor(d) for d in p_t.data], cap)
    for a, b, sp in zip(padded_np, padded_t, cap.nodes):
        assert a.shape == (sp.m, sp.n)
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(ValueError, match="does not fit"):
        tpc.pad_data([np.zeros((10**6, 1))] + list(p_t.data[1:]), cap)


@pytest.mark.parametrize("name", ["retailer", "yelp"])
@pytest.mark.parametrize("capacity", [False, True])
def test_import_plan_round_trip(name, capacity):
    """A JAX plan imported by duck typing equals the port's own plan, and
    both routes give the JAX package's R₀."""
    if capacity:
        p_j = jpc.build_capacity_plan(GENERATORS[name](jrel))
        p_t = tpc.build_capacity_plan(GENERATORS[name](trel))
    else:
        p_j = jt.build_plan(GENERATORS[name](jrel))
        p_t = tjt.build_plan(GENERATORS[name](trel))
    imported = tjt.import_plan(p_j, device="cpu")
    assert imported.device is None
    assert_same_plan(imported, p_j)
    r0_j = np.asarray(FigaroEngine(donate_data=False).r0(
        p_j, dtype=jnp.float64))
    r0_imp = figaro_r0(imported, dtype=torch.float64, device="cpu").numpy()
    r0_own = figaro_r0(p_t, dtype=torch.float64, device="cpu").numpy()
    np.testing.assert_array_equal(r0_imp, r0_own)
    np.testing.assert_allclose(r0_imp, r0_j, atol=1e-9)


def test_plan_to_device_is_cached_and_int64():
    p_t = tjt.build_plan(GENERATORS["retailer"](trel))
    moved = p_t.to("cpu")
    assert moved is p_t.to("cpu") and moved.to("cpu") is moved
    assert moved.device == torch.device("cpu") and p_t.device is None
    for ix in moved.index:
        assert ix.row_to_group.dtype == torch.int64
        assert all(v.dtype == torch.int64 for v in ix.child_lookup.values())
    np.testing.assert_array_equal(moved.data[0].numpy(), p_t.data[0])
