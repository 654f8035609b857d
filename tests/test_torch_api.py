"""The port's dataset surface (`repro_torch.figaro`: `Session.ingest`,
`from_tree`, `TableSet.join`, `JoinDataset`) against the JAX package's.

Mirrors the non-serving cases of tests/test_api.py (:51-230, :301-425) and
tests/test_kernel_path.py (:45, :54, :82, :177), port against JAX: the same
tables through both façades give the same R, singular values and vectors,
principal components, regression coefficients and residuals, in both of the
port's corners (plain/padded and kernel/band), at float64 1e-9 absolute
(tests/test_kernel_path.py:30); singular vectors and components up to
sign, R after `normalize_sign`. The lifecycle cases hold the port's
signature-miss counters to the JAX package's trace counters (the lazy
capacity plan, appends before and after it, regrows, ``bucket=False``),
``stats()`` to JAX's dict (same keys, same values apart from the counters'
engine-specific ones), ``serve`` (Session and dataset) to the dataset's own
answers and the JAX package's server, ``donate_data`` validation, and the
mesh arguments (``mesh=``, ``shard=``) to their validation, a one-rank
mesh's answers and ``partitioned_qr`` to the JAX session's. The port runs
on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import figaro as jfig
from repro.core.engine import FigaroEngine as JaxEngine
from repro.core.plan_cache import build_capacity_plan as jbuild_capacity_plan
from repro.data import relational as jrel
from repro_torch import figaro
from repro_torch.core.engine import FigaroEngine, plan_for
from repro_torch.core.figaro import figaro_r0
from repro_torch.core.join_tree import JoinTree, build_plan
from repro_torch.core.plan_cache import build_capacity_plan
from repro_torch.core.postprocess import normalize_sign
from repro_torch.core.relation import Database
from repro_torch.data import relational as trel
from repro_torch.launch.mesh import make_data_mesh

ATOL = 1e-9
PORT_CORNERS = [(False, "padded"), (True, "band")]
CORNER_IDS = ["plain-padded", "kernel-band"]
TREES = {
    "retailer": lambda m: m.retailer_like(scale=60, cols=2),
    "yelp": lambda m: m.yelp_like(scale=40, cols=2),  # many-to-many
    "cartesian": lambda m: m.cartesian(7, 5, n1=2, n2=2),
}
_STAR_EDGES = [("Orders", "Customers"), ("Orders", "Products")]


def _star_tables(m_fact: int = 20):
    """tests/test_api.py's star: exactly 8 distinct fact keys."""
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


# One JAX engine for the cases that compare answers only, so a signature
# both port corners dispatch compiles once; the cases that compare the
# counters take a private one.
_JAX_ENGINE = JaxEngine(donate_data=False)


def _sessions(corner=(False, "padded"), private=False, **kw):
    """(port Session on the CPU, JAX Session); the port's engine is always
    private, the JAX one when ``private``."""
    use_kernel, assembly = corner
    return (figaro.Session(device="cpu", use_kernel=use_kernel,
                           assembly=assembly, **kw),
            jfig.Session(engine=JaxEngine(donate_data=False) if private
                         else _JAX_ENGINE, **kw))


def _star_pair(corner=(False, "padded"), m_fact=20, private=False, **kw):
    st, sj = _sessions(corner, private, **kw)
    return (st, st.ingest(_star_tables(m_fact)).join("Orders", _STAR_EDGES),
            sj, sj.ingest(_star_tables(m_fact)).join("Orders", _STAR_EDGES))


def _close(got, want, signs=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if signs:  # rows of Vᵀ / principal components: each up to its sign
        flip = np.sign(np.sum(got * want, axis=-1, keepdims=True))
        got = got * np.where(flip == 0, 1.0, flip)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _r(r):
    return normalize_sign(torch.as_tensor(np.array(r)))


# -- façade parity: qr / svd / pca / lsq --------------------------------------


@pytest.mark.parametrize("corner", PORT_CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("name", list(TREES))
def test_dataset_qr_matches_jax(name, corner):
    """The default (bucketed) dataset; ``bucket=False`` against JAX:
    `test_bucket_false_regrow_keeps_exact_capacities`."""
    st, sj = _sessions(corner)
    r_t = st.from_tree(TREES[name](trel)).qr(dtype=torch.float64)
    r_j = sj.from_tree(TREES[name](jrel)).qr(dtype=jnp.float64)
    _close(_r(r_t), _r(r_j))


@functools.lru_cache(maxsize=None)
def _jax_reads(name):
    """The JAX dataset's svd, pca(k=2) and ridge lsq answers (lsq without
    ridge: `test_lsq_by_column_name_matches_index_and_jax`)."""
    dj = jfig.Session(engine=_JAX_ENGINE).from_tree(TREES[name](jrel))
    return dj.svd(), dj.pca(k=2), dj.lsq(dj.plan.num_cols - 1, ridge=0.3)


@pytest.mark.parametrize("corner", PORT_CORNERS, ids=CORNER_IDS)
@pytest.mark.parametrize("name", list(TREES))
def test_dataset_svd_pca_lsq_match_jax(name, corner):
    st, _ = _sessions(corner)
    dt = st.from_tree(TREES[name](trel))
    (s_j, vt_j), p_j, (b_j, res_j) = _jax_reads(name)
    s_t, vt_t = dt.svd()
    _close(s_t, s_j)
    _close(vt_t, vt_j, signs=True)
    p_t = dt.pca(k=2)
    _close(p_t.explained_variance, p_j.explained_variance)
    _close(p_t.components, p_j.components, signs=True)
    _close(p_t.mean, p_j.mean)
    assert float(p_t.num_rows) == float(p_j.num_rows)
    b_t, res_t = dt.lsq(dt.plan.num_cols - 1, ridge=0.3)
    _close(b_t, b_j)
    _close(res_t, res_j)


@pytest.mark.parametrize("corner", PORT_CORNERS, ids=CORNER_IDS)
def test_engine_path_dataset_and_bucketed_agree(corner):
    """Direct engine dispatch == ds.qr bit for bit; the bucketed (capacity)
    dataset agrees with the exact path and with JAX's bucketed one."""
    tree = TREES["retailer"](trel)
    use_kernel, assembly = corner
    r_engine = FigaroEngine().qr(build_plan(tree), dtype=torch.float64,
                                 device="cpu", use_kernel=use_kernel,
                                 assembly=assembly)
    st, _ = _sessions(corner, bucket=False)
    assert torch.equal(st.from_tree(tree).qr(dtype=torch.float64), r_engine)
    st, sj = _sessions(corner, bucket=True, headroom=8)
    r_cap = st.from_tree(tree).qr(dtype=torch.float64)
    _close(r_cap, r_engine)
    _close(r_cap, sj.from_tree(TREES["retailer"](jrel)).qr(
        dtype=jnp.float64))


def test_batched_auto_detect_matches_per_sample_and_jax():
    st, dt, sj, dj = _star_pair()
    rng = np.random.default_rng(1)
    batch = tuple(np.stack([rng.normal(size=np.shape(d)) for _ in range(3)])
                  for d in dt.plan.data)
    rb = dt.qr(batch, dtype=torch.float64)
    assert rb.shape == (3, dt.plan.num_cols, dt.plan.num_cols)
    assert st.engine.trace_count("qr_batched") == 1
    _close(rb, dj.qr(batch, dtype=jnp.float64))
    for i in range(3):
        _close(rb[i], dt.qr([d[i] for d in batch], dtype=torch.float64))


# -- root choice, names, legacy argument orders --------------------------------


@pytest.mark.parametrize("name", ["retailer", "yelp", "favorita"])
def test_join_root_auto_matches_jax(name):
    make = {"favorita": lambda m: m.favorita_like(scale=40, cols=2),
            **TREES}[name]
    t, j = make(trel), make(jrel)
    st, sj = _sessions()
    for args, kw in (((t.edges(),), {"root": "auto"}), ((t.edges(),), {}),
                     ((), {"edges": t.edges()})):
        dt = st.ingest(t.db).join(*args, **kw)
        dj = sj.ingest(j.db).join(*args, **kw)
        assert dt.tree.root == dj.tree.root
        assert dt.stats()["auto_root"] is True
        assert dt.explain() == dj.explain()
    if name == "yelp":  # R itself: once is enough
        _close(_r(dt.qr(dtype=torch.float64)),
               _r(dj.qr(dtype=jnp.float64)))


def test_retailer_like_root_auto_picks_the_jax_root():
    t = trel.retailer_like(scale=60, cols=2, root="auto")
    j = jrel.retailer_like(scale=60, cols=2, root="auto")
    assert t.root == j.root == "Inventory"
    assert t.parent == j.parent


def test_join_argument_orders_and_eager_name_validation():
    st, sj = _sessions()
    tables = _star_tables()
    hand = st.ingest(tables).join("Orders", _STAR_EDGES)  # legacy order
    for ds in (st.ingest(tables).join(_STAR_EDGES, root="Orders"),
               st.ingest(tables).join("Orders", edges=_STAR_EDGES)):
        assert ds.tree.root == "Orders" and ds.stats()["auto_root"] is False
        assert torch.equal(ds.qr(dtype=torch.float64),
                           hand.qr(dtype=torch.float64))
    for bad in ((("Nope", _STAR_EDGES), {}),
                ((_STAR_EDGES + [("Orders", "Ghost")],), {}),
                ((_STAR_EDGES,), {"root": "Ghost"})):
        with pytest.raises(ValueError) as et:
            st.ingest(tables).join(*bad[0], **bad[1])
        with pytest.raises(ValueError) as ej:
            sj.ingest(tables).join(*bad[0], **bad[1])
        assert str(et.value) == str(ej.value)
        assert "ingested relations are" in str(et.value)
    for bad_args, bad_kw in (((), {}), (("Orders",), {"root": "Orders",
                                                      "edges": _STAR_EDGES}),
                             (("Orders", _STAR_EDGES), {"edges": []}),
                             (("a", "b", "c"), {})):
        with pytest.raises(TypeError):
            st.ingest(tables).join(*bad_args, **bad_kw)


# -- bucketed sessions: near-miss shapes share one signature ------------------


def test_bucket_true_shares_signature_across_near_miss_shapes():
    st, _ = _sessions(bucket=True)
    ds_a = st.ingest(_star_tables(20)).join("Orders", _STAR_EDGES)
    ds_b = st.ingest(_star_tables(24)).join("Orders", _STAR_EDGES)
    ds_a.qr(dtype=torch.float64)
    ds_b.qr(dtype=torch.float64)
    assert st.engine.trace_count("qr") == 1
    assert ds_a.plan.spec == ds_b.plan.spec


def test_bucket_false_distinct_shapes_miss_separately():
    st, _ = _sessions(bucket=False)
    for m in (20, 24):
        st.ingest(_star_tables(m)).join("Orders", _STAR_EDGES).qr(
            dtype=torch.float64)
    assert st.engine.trace_count("qr") == 2


# -- plan lifecycle: lazy build, appends, regrows, stats ----------------------


def _same_stats(st_t, st_j, counters=True):
    """``stats()`` equal to JAX's: same keys; the counters compared only
    where ``counters`` (the port counts its own engine's misses)."""
    assert set(st_t) == set(st_j)
    engine_keys = {"traces", "trace_count", "evictions",
                   "cached_executables"}
    for k in st_t:
        if k not in engine_keys or counters:
            assert st_t[k] == st_j[k], k


def test_plan_is_lazy_and_append_before_compute_grows_tables():
    _, dt, _, dj = _star_pair(headroom=8, private=True)
    _same_stats(dt.stats(), dj.stats())
    assert dt.stats()["plan_built"] is False
    app = ({"cust": np.array([0, 1]), "prod": np.array([0, 1])},
           np.ones((2, 2)))
    assert dt.append("Orders", *app) and dj.append("Orders", *app)
    assert dt.stats()["plan_built"] is False
    assert dt.stats()["nodes"]["Orders"]["live_rows"] == 22
    _same_stats(dt.stats(), dj.stats())
    r_t, r_j = dt.qr(dtype=torch.float64), dj.qr(dtype=jnp.float64)
    assert r_t.shape == (5, 5)
    _close(r_t, r_j)
    _same_stats(dt.stats(), dj.stats())
    assert dt.stats()["nodes"]["Orders"]["capacity_rows"] >= 22 + 8


@pytest.mark.parametrize("corner", PORT_CORNERS, ids=CORNER_IDS)
def test_append_within_capacity_is_zero_miss(corner):
    st, dt, _, dj = _star_pair(corner, headroom=16, private=True)
    dt.qr(dtype=torch.float64)
    dj.qr(dtype=jnp.float64)
    misses = st.engine.trace_count("qr")
    app = ({"cust": np.array([2, 3]), "prod": np.array([2, 3])},
           np.ones((2, 2)) * 0.5)
    assert dt.append("Orders", *app) is True
    assert dj.append("Orders", *app) is True
    r_t = dt.qr(dtype=torch.float64)
    stats = dt.stats()
    assert stats["traces"]["qr"] == misses, "an append within capacity missed"
    assert stats["appends"] == 1 and stats["regrows"] == 0
    assert st.engine.capture_count() == 0  # no graphs on the CPU
    _close(r_t, dj.qr(dtype=jnp.float64))
    _same_stats(stats, dj.stats())
    # the appended rows are really in the answer
    r_ref = FigaroEngine().qr(build_plan(dt.tree), dtype=torch.float64,
                              device="cpu")
    _close(r_t, r_ref)


def test_bucket_false_regrow_keeps_exact_capacities():
    st, dt, _, dj = _star_pair(bucket=False, private=True)
    dt.qr(dtype=torch.float64)
    dj.qr(dtype=jnp.float64)
    app = ({"cust": np.array([0]), "prod": np.array([0])}, np.ones((1, 2)))
    for step in range(2):  # every append overflows: one miss each
        assert dt.append("Orders", *app) is False
        assert dj.append("Orders", *app) is False
        r_t, r_j = dt.qr(dtype=torch.float64), dj.qr(dtype=jnp.float64)
        stats = dt.stats()
        orders = stats["nodes"]["Orders"]
        assert orders["capacity_rows"] == orders["live_rows"] == 21 + step
        assert stats["regrows"] == step + 1
        assert stats["traces"]["qr"] == 2 + step
        _same_stats(stats, dj.stats())
    assert torch.equal(r_t, FigaroEngine().qr(
        build_plan(dt.tree), dtype=torch.float64, device="cpu"))
    _close(r_t, r_j)


def test_append_past_capacity_regrows_once():
    st, dt, _, dj = _star_pair(m_fact=32, headroom=0, private=True)
    dt.qr(dtype=torch.float64)
    dj.qr(dtype=jnp.float64)
    misses = st.engine.trace_count("qr")
    app = ({"cust": np.array([0]), "prod": np.array([0])}, np.ones((1, 2)))
    assert dt.append("Orders", *app) is False
    assert dj.append("Orders", *app) is False
    r_t, r_j = dt.qr(dtype=torch.float64), dj.qr(dtype=jnp.float64)
    stats = dt.stats()
    assert stats["traces"]["qr"] == misses + 1 and stats["regrows"] == 1
    _same_stats(stats, dj.stats())
    _close(r_t, r_j)


def test_live_sized_requests_padded_stale_rejected():
    _, dt, _, dj = _star_pair(headroom=16)
    rng = np.random.default_rng(2)
    live = tuple(rng.normal(size=(dt.tree.db[n].num_rows,
                                  dt.tree.db[n].num_data_cols))
                 for n in dt.tree.preorder())
    r_live = dt.qr(live, dtype=torch.float64)  # padded up inside
    cap = tuple(np.zeros(np.shape(d)) for d in dt.plan.data)
    for c, l in zip(cap, live):
        c[: l.shape[0]] = l
    assert torch.equal(r_live, dt.qr(cap, dtype=torch.float64))
    _close(r_live, dj.qr(live, dtype=jnp.float64))
    tensors = tuple(torch.as_tensor(d) for d in live)  # tensors pad too
    assert torch.equal(r_live, dt.qr(tensors, dtype=torch.float64))
    dt.append("Orders", {"cust": np.array([0]), "prod": np.array([0])},
              np.ones((1, 2)))
    with pytest.raises(ValueError, match="rebuild request buffers"):
        dt.qr(live, dtype=torch.float64)  # stale: built before the append
    with pytest.raises(ValueError, match="one data leaf per relation"):
        dt.qr(live[:-1], dtype=torch.float64)
    with pytest.raises(ValueError, match="one data leaf per relation"):
        dt.qr(live + (np.zeros((2, 2)),), dtype=torch.float64)


def test_stats_keys_and_values_match_jax():
    st, dt, sj, dj = _star_pair(headroom=4)
    for ds in (dt, dj):
        ds.qr()
        ds.lsq("price")
    _same_stats(dt.stats(), dj.stats(), counters=False)
    stats = dt.stats()
    assert stats["traces"] == {"least_squares": 1, "qr": 1}
    assert stats["trace_count"] == 2 and stats["evictions"] == 0
    assert stats["cached_executables"] == st.engine.cache_size() == 2
    assert "captures" not in stats


# -- column naming -------------------------------------------------------------


def test_lsq_by_column_name_matches_index_and_jax():
    _, dt, _, dj = _star_pair()
    assert dt.columns == dj.columns == (
        "Orders.amount", "Orders.qty", "Customers.age", "Customers.income",
        "Products.price")
    b_idx, r_idx = dt.lsq(4)
    for col in ("price", "Products.price", np.int64(4)):
        b, r = dt.lsq(col)
        assert torch.equal(b, b_idx) and torch.equal(r, r_idx)
    b_j, r_j = dj.lsq("price")
    _close(b_idx, b_j)
    _close(r_idx, r_j)


def test_column_index_errors():
    _, dt, _, _ = _star_pair()
    with pytest.raises(KeyError, match="unknown column"):
        dt.column_index("nope")
    with pytest.raises(KeyError, match="unknown column"):
        dt.column_index("Orders.nope")
    with pytest.raises(IndexError):
        dt.column_index(99)
    with pytest.raises(TypeError):
        dt.column_index(1.5)
    amb = figaro.Session(device="cpu").ingest({
        "A": ({"k": np.arange(3)}, np.ones((3, 1)), ["x"]),
        "B": ({"k": np.arange(3)}, np.ones((3, 1)), ["x"]),
    }).join("A", [("A", "B")])
    with pytest.raises(KeyError, match="ambiguous"):
        amb.column_index("x")
    assert amb.column_index("B.x") == 1


# -- capacity plans through the kernel corner (tests/test_kernel_path.py) -----


@pytest.mark.parametrize("name", list(TREES))
def test_capacity_plan_dead_rows_exactly_zero(name):
    cap = build_capacity_plan(TREES[name](trel), headroom=3)
    eng = FigaroEngine()
    r0_x = eng.r0(cap, dtype=torch.float64, device="cpu")
    r0_k = eng.r0(cap, dtype=torch.float64, device="cpu", use_kernel=True,
                  assembly="band")
    _close(r0_k, r0_x)
    dead = ~torch.any(r0_x != 0, dim=1)
    assert bool(dead.any()), "capacity plan with headroom has dead rows"
    assert not bool(torch.any(r0_k[dead] != 0)), "kernel path leaked"
    r_k = eng.qr(cap, dtype=torch.float64, device="cpu", use_kernel=True,
                 assembly="band")
    r_j = JaxEngine(donate_data=False).qr(
        jbuild_capacity_plan(TREES[name](jrel), headroom=3),
        dtype=jnp.float64)
    _close(r_k, r_j)


@pytest.mark.parametrize("name", list(TREES))
def test_band_assembly_bit_identical_through_the_dataset(name):
    """tests/test_kernel_path.py:177 on the port: band and padded R₀ are
    the same bits; the kernel corner's band R₀ of the dataset's capacity
    plan matches the plain padded one at 1e-9."""
    plan = build_plan(TREES[name](trel))
    r_pad = figaro_r0(plan, dtype=torch.float64, assembly="padded",
                      device="cpu")
    r_band = figaro_r0(plan, dtype=torch.float64, assembly="band",
                       device="cpu")
    assert torch.equal(r_pad, r_band)
    (st_k, _), (st_x, _) = _sessions((True, "band")), _sessions()
    _close(st_k.from_tree(TREES[name](trel)).r0(dtype=torch.float64),
           st_x.from_tree(TREES[name](trel)).r0(dtype=torch.float64))


# -- engine LRU bounds ----------------------------------------------------------


def test_engine_lru_eviction_bounds_cache():
    engine = FigaroEngine(max_cached=1)
    plan_a = build_plan(trel.cartesian(6, 5))
    plan_b = build_plan(trel.cartesian(9, 7))

    def qr(plan):
        engine.qr(plan, dtype=torch.float64, device="cpu")

    qr(plan_a)
    qr(plan_b)  # evicts A's entry
    assert engine.trace_count("qr") == 2 and engine.eviction_count("qr") == 1
    assert engine.cache_size("qr") == 1
    qr(plan_b)  # LRU hit
    assert engine.trace_count("qr") == 2
    qr(plan_a)  # evicted: a miss again
    assert engine.trace_count("qr") == 3 and engine.eviction_count("qr") == 2
    assert engine.trace_counts() == {"qr": 3}
    assert engine.graph_count() == 0 and engine.capture_count() == 0


@pytest.mark.parametrize("bucket", [False, True])
def test_eager_reference_is_uncounted_and_gives_the_dispatch_answer(bucket):
    """`FigaroEngine.eager_reference`: the same dispatch (bucketing
    included) run outside the cache — no miss, no entry — with the answer
    the counted dispatch gives."""
    engine = FigaroEngine()
    plan = build_plan(trel.yelp_like(scale=40, cols=2))

    def qr():
        return engine.qr(plan, dtype=torch.float64, device="cpu",
                         bucket=bucket)

    with engine.eager_reference():
        ref = qr()
    assert engine.trace_count() == 0 and engine.cache_size() == 0
    got = qr()
    assert engine.trace_count("qr") == 1 and torch.equal(got, ref)
    with engine.eager_reference():
        assert torch.equal(qr(), ref)
    assert engine.trace_count() == 1 and engine.cache_size() == 1


@pytest.mark.parametrize("bucket,overflow", [(True, False), (True, True),
                                             (False, False)])
def test_regrow_releases_the_superseded_specs_graphs(bucket, overflow,
                                                     monkeypatch):
    """An append that changes the plan spec (a regrow; with bucket=False
    every append) hands the old spec to `FigaroEngine.release_graphs`; one
    within capacity keeps the spec and releases nothing."""
    st = figaro.Session(device="cpu", bucket=bucket, headroom=4)
    ds = st.ingest(_star_tables()).join("Orders", _STAR_EDGES)
    released = []
    monkeypatch.setattr(st.engine, "release_graphs", released.append)
    ds.qr(dtype=torch.float64)
    spec = ds.plan.spec
    node = ds.stats()["nodes"]["Orders"]
    rows = node["capacity_rows"] - node["live_rows"] + 1 if overflow else 2
    keys = {"cust": np.arange(rows) % 8, "prod": np.arange(rows) % 4}
    in_capacity = ds.append("Orders", keys, np.ones((rows, 2)))
    regrew = overflow or not bucket
    assert in_capacity is not regrew
    assert ds.plan.spec != spec if regrew else ds.plan.spec == spec
    assert released == ([spec] if regrew else [])


def test_engine_lru_cap_two_keeps_both_alternating():
    engine = FigaroEngine(max_cached=2)
    plans = [build_plan(trel.cartesian(6, 5)), build_plan(trel.cartesian(9, 7))]
    for _ in range(3):
        for plan in plans:
            engine.qr(plan, dtype=torch.float64, device="cpu")
    assert engine.trace_count("qr") == 2 and engine.eviction_count() == 0


def test_engine_unbounded_by_default_and_validation():
    engine = FigaroEngine()
    assert engine.max_cached is None
    with pytest.raises(ValueError, match="max_cached"):
        FigaroEngine(max_cached=0)
    with pytest.raises(ValueError, match="max_cached"):
        figaro.Session(device="cpu", engine=engine, max_cached=2)
    assert figaro.Session(device="cpu", max_cached=3).engine.max_cached == 3


# -- clear errors --------------------------------------------------------------


def test_plan_for_and_dispatch_reject_non_plans():
    db = Database.from_arrays({"S": ({}, np.ones((3, 2)), ["a", "b"])})
    with pytest.raises(TypeError, match="tree_or_plan.*Database"):
        plan_for(db)
    with pytest.raises(TypeError, match="'plan'.*Database"):
        FigaroEngine().svd(db, device="cpu")
    assert plan_for(JoinTree.from_edges(db, "S", [])).num_cols == 2


def test_ingest_and_from_tree_type_errors():
    sess = figaro.Session(device="cpu")
    with pytest.raises(TypeError, match="ingest"):
        sess.ingest(np.ones((3, 2)))
    with pytest.raises(TypeError, match="from_tree"):
        sess.from_tree({"root": None})


# -- meshes (A12) on the façade; serving kinds validated first -----------------


def test_meshes_on_the_facade_validate_and_match_jax():
    """``mesh=``/``shard=`` take a `DataMesh` (anything else is a
    `TypeError`); ``partitioned_qr`` gives the JAX session's R; a dataset
    serves and dispatches over a one-rank mesh with the unsharded answers."""
    sess = figaro.Session(device="cpu")
    _, dt, sj, dj = _star_pair()
    with pytest.raises(TypeError, match="DataMesh"):
        figaro.Session(device="cpu", mesh=object())
    with pytest.raises(TypeError, match="DataMesh"):
        dt.qr(shard=object())
    with pytest.raises(TypeError, match="DataMesh"):
        sess.qr(dt.plan, shard=(object(), "data"))
    with pytest.raises(TypeError, match="DataMesh"):
        dt.serve(kind="qr", mesh=object())
    with pytest.raises(TypeError, match="DataMesh"):
        sess.serve(dt.plan, kind="lsq", label_col=0, mesh=object())
    r = sess.partitioned_qr(dt.tree, 2)
    assert r.dtype == torch.float64
    _close(normalize_sign(r), sj.partitioned_qr(dj.tree, 2))
    mesh = make_data_mesh(device="cpu")
    batch = tuple(np.stack([d, 2.0 * d]) for d in dt.plan.data)
    server = dt.serve(kind="qr", mesh=mesh, dtype=torch.float64)
    try:
        served = server(batch)
    finally:
        server.close()
    _close(served, dt.qr(batch, dtype=torch.float64))
    _close(dt.qr(batch, dtype=torch.float64, shard=mesh), served)
    # the kind is validated first, with the list of kinds
    with pytest.raises(ValueError, match=r"supported kinds: qr, svd, pca"):
        dt.serve(kind="nope")
    with pytest.raises(ValueError, match="supported kinds"):
        sess.serve(dt.plan, kind="cholesky")
    assert figaro.SERVE_KINDS == jfig.SERVE_KINDS == ("qr", "svd", "pca",
                                                      "lsq")
    assert dt.qr(shard=None).shape == (5, 5)  # shard=None is no mesh


# -- serving through the façade (Session.serve, JoinDataset.serve) --------------


@pytest.mark.parametrize("corner", PORT_CORNERS, ids=CORNER_IDS)
def test_dataset_and_session_serve_round_trips(corner):
    """``ds.serve`` and ``sess.serve`` answer like the dataset's own
    compute methods and the JAX package's ``ds.serve`` (float64, 1e-9);
    ``label_col`` resolves by column name; the session's dtype policy
    applies (qr float32 unless pinned)."""
    ts, dt, tj, dj = _star_pair(corner)
    data = tuple(np.asarray(d) for d in dt.plan.data)
    jdata = tuple(np.asarray(d) for d in dj.plan.data)
    s_lsq = dt.serve(kind="lsq", label_col="price", dtype=torch.float64)
    j_lsq = dj.serve(kind="lsq", label_col="price", dtype=jnp.float64)
    got, want = s_lsq(data), j_lsq(jdata)
    assert np.allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
    assert np.allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL)
    beta, _ = dt.lsq("price", dtype=torch.float64)
    assert np.allclose(got[0].numpy(), beta.numpy(), atol=ATOL)
    s_qr = ts.serve(dt.plan, kind="qr")
    r32 = s_qr(data)
    assert r32.dtype == torch.float32
    s_pca = dt.serve(kind="pca", k=2)
    pca = s_pca(data)
    want = dt.pca(k=2)
    assert np.allclose(pca.explained_variance.numpy(),
                       want.explained_variance.numpy(), atol=ATOL)
    for server in (s_lsq, j_lsq, s_qr, s_pca):
        server.close()


def test_session_donate_data_forwarded_and_validated():
    engine = FigaroEngine()
    with pytest.raises(ValueError, match="donate_data"):
        figaro.Session(device="cpu", engine=engine, donate_data=True)
    with pytest.raises(ValueError, match="donate_data"):
        figaro.Session(device="cpu", engine=engine, donate_data=False)
    assert figaro.Session(device="cpu",
                          donate_data=True).engine.donate_data is True
    assert figaro.Session(device="cpu").engine.donate_data is False
    assert jfig.Session(donate_data=True).engine.donate_data is True


def test_figaro_module_exports():
    from repro_torch import api
    from repro_torch.core.plan_cache import PlanHolder

    assert figaro.Session is api.Session
    assert figaro.JoinDataset is api.JoinDataset
    assert figaro.TableSet is api.TableSet
    assert figaro.PlanHolder is PlanHolder
    assert figaro.FigaroEngine is FigaroEngine
    assert set(figaro.__all__) == set(jfig.__all__)
    assert set(figaro.__all__) >= {"Session", "TableSet", "JoinDataset",
                                   "PlanHolder", "AsyncFigaroServer",
                                   "FigaroFuture", "SERVE_KINDS"}
