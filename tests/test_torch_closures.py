"""The port's plan-closed closures and join helpers against the JAX package.

`figaro_qr_fn` / `figaro_r0_fn` (the closures ``data -> R`` / ``data -> R₀``
that wall-clock benchmarks time), `join_column_moments` and
`implicit_q_gram_check`, on random acyclic databases and a retailer tree,
with data drawn from a seed and handed to both packages. The port runs on
the CPU (plain versions of its kernels, no graph); JAX's closures run
jitted, their kernel path in Pallas interpret mode. One jit per input and
kernel path computes what JAX's closures compute: its band R₀, both
methods' R from it (JAX's `figaro_qr_fn` runs the same `postprocess_r0` on
its padded R₀, which is bit-identical to band's), and the moments; JAX's
`figaro_qr_fn` itself answers the fresh-values case. Tolerances: float64 at
1e-9 relative (tests/test_kernel_path.py:30); float32 RᵀR within 1e-4 of
float64's; the moments at 1e-10 of the materialized join's, the Gram check
at 1e-12 relative of JAX's on R perturbed away from exact. Band and padded
R₀ of the port are both held to JAX's band R₀.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_acyclic_db
from repro.core import figaro as jfigaro
from repro.core import join_tree as jjt
from repro.core import postprocess as jpost
from repro.core import qr as jqr
from repro.core import svd as jsvd
from repro.data import relational as jrel
from repro_torch.core import join_tree as tjt
from repro_torch.core.figaro import figaro_r0_fn
from repro_torch.core.materialize import materialize_join
from repro_torch.core.qr import figaro_qr_fn, implicit_q_gram_check
from repro_torch.core.relation import Database, Relation
from repro_torch.core.svd import join_column_moments
from repro_torch.data import relational as trel

INPUTS = ("chain3", "star3", "snowflake4", "retailer")
METHODS = ("tsqr", "blocked")
RTOL64 = 1e-9


def _port_tree(tree):
    rels = {r.name: Relation(r.name, r.key_attrs, r.data_attrs, r.keys,
                             r.data) for r in tree.db}
    return tjt.JoinTree(Database(rels), dict(tree.parent))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port tree, port plan, JAX plan, seeded data [m_i, n_i])."""
    if name == "retailer":
        t_tree = trel.retailer_like(60)
        p_j = jjt.build_plan(jrel.retailer_like(60))
    else:
        _, j_tree, p_j = random_acyclic_db(name, np.random.default_rng(7))
        t_tree = _port_tree(j_tree)
    p_t = tjt.build_plan(t_tree)
    rng = np.random.default_rng(11)
    data = tuple(rng.normal(size=np.shape(d)) for d in p_t.data)
    return t_tree, p_t, p_j, data


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_refs(name, use_kernel):
    """JAX's R₀, R per method and (kernels off) moments, in one jit."""
    plan = _case(name)[2]

    def refs(data):
        r0 = jfigaro.figaro_r0(plan, data, dtype=jnp.float64,
                               use_kernel=use_kernel, assembly="band")
        out = {"r0": r0}
        for method in METHODS:
            out[method] = jpost.postprocess_r0(r0, method=method,
                                               use_kernel=use_kernel)
        if not use_kernel:
            out["moments"] = jsvd.join_column_moments(plan, data)
        return out

    got = jax.jit(refs)([jnp.asarray(d) for d in _case(name)[3]])
    return jax.tree.map(np.asarray, got)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", INPUTS)
def test_qr_closure_matches_jax(name, use_kernel, method):
    _, p_t, _, data = _case(name)
    fn = figaro_qr_fn(p_t, dtype=torch.float64, method=method,
                      use_kernel=use_kernel, device="cpu")
    r = fn(data)
    assert r.dtype == torch.float64 and r.shape == (p_t.spec.num_cols,) * 2
    assert _rel(r, _jax_refs(name, use_kernel)[method]) <= RTOL64


@pytest.mark.parametrize("assembly", ["padded", "band"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", INPUTS)
def test_r0_closure_matches_jax(name, use_kernel, assembly):
    _, p_t, _, data = _case(name)
    fn = figaro_r0_fn(p_t, dtype=torch.float64, use_kernel=use_kernel,
                      assembly=assembly, device="cpu")
    assert _rel(fn(data), _jax_refs(name, use_kernel)["r0"]) <= RTOL64


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", INPUTS)
def test_qr_closure_float32_gram_within_float32_accuracy(name, use_kernel):
    _, p_t, _, data = _case(name)
    r32 = figaro_qr_fn(p_t, use_kernel=use_kernel, device="cpu")(data)
    assert r32.dtype == torch.float32
    r32 = r32.double().numpy()
    r64 = _jax_refs(name, use_kernel)["tsqr"]
    assert _rel(r32.T @ r32, r64.T @ r64) <= 1e-4


def test_closure_answers_fresh_values_and_checks_shapes():
    """A second call with new values gives the new answer (JAX's closure
    on the same values); data of another dtype is cast to the closure's;
    data of other row counts raise, as JAX's trace does, and a closure over
    a plan of other row counts answers its own join."""
    _, p_t, p_j, data = _case("snowflake4")
    fn = figaro_qr_fn(p_t, dtype=torch.float64, device="cpu")
    first = fn(data)
    fresh = [2.0 * d + 1.0 for d in data]
    second = fn(fresh)
    want = jqr.figaro_qr_fn(p_j, dtype=jnp.float64)(
        [jnp.asarray(d) for d in fresh])
    assert _rel(second, want) <= RTOL64
    assert not torch.equal(first, second)
    f32 = [d.astype(np.float32) for d in fresh]
    assert torch.equal(fn(f32), fn([d.astype(np.float64) for d in f32]))
    bad = list(data)
    bad[0] = np.zeros((bad[0].shape[0] + 1, bad[0].shape[1]))
    with pytest.raises(ValueError, match="does not match the plan"):
        fn(bad)
    with pytest.raises(ValueError, match="data matrices"):
        fn(data[:-1])
    _, j_tree, _ = random_acyclic_db("snowflake4", np.random.default_rng(8),
                                     max_rows=12)
    tree = _port_tree(j_tree)
    plan = tjt.build_plan(tree)
    assert [sp.m for sp in plan.spec.nodes] != \
        [sp.m for sp in p_t.spec.nodes]
    other = figaro_qr_fn(plan, dtype=torch.float64, device="cpu")().numpy()
    a = materialize_join(tree)
    assert _rel(other.T @ other, a.T @ a) <= RTOL64


@pytest.mark.parametrize("name", INPUTS)
def test_join_column_moments_match_jax_and_the_materialized_join(name):
    t_tree, p_t, _, data = _case(name)
    sums, total = join_column_moments(p_t, data, device="cpu")
    j_sums, j_total = _jax_refs(name, False)["moments"]
    assert sums.dtype == torch.float64 and sums.shape == (
        p_t.spec.num_cols,)
    assert _rel(sums, j_sums) <= 1e-10 and float(total) == float(j_total)
    a = materialize_join(t_tree)
    own, rows = join_column_moments(p_t, device="cpu")
    assert int(rows) == a.shape[0]
    assert _rel(own / rows, a.mean(axis=0)) <= 1e-10


@pytest.mark.parametrize("name", ["star3", "retailer"])
def test_implicit_q_gram_check_matches_jax(name):
    """Under 1e-10 on the exact R; held to JAX's at 1e-12 relative on R
    scaled entrywise by 1 + 1e-3 · noise, where the check reads about
    1e-3, far from a check that returns 0."""
    t_tree, p_t, _, _ = _case(name)
    a = materialize_join(t_tree)
    gram = a.T @ a
    r = figaro_qr_fn(p_t, dtype=torch.float64, device="cpu")()
    exact = implicit_q_gram_check(r, gram)
    assert exact.dtype == torch.float64 and float(exact) < 1e-10
    assert float(implicit_q_gram_check(r.float(), gram)) < 1e-4
    noise = np.random.default_rng(13).normal(size=tuple(r.shape))
    off = r * (1.0 + 1e-3 * torch.as_tensor(noise))
    got = float(implicit_q_gram_check(off, gram))
    want = float(jqr.implicit_q_gram_check(jnp.asarray(off.numpy()),
                                           jnp.asarray(gram)))
    assert 1e-5 < want < 1e-1
    assert abs(got - want) <= 1e-12 * want


def test_entry_points_default_to_the_card():
    _, p_t, _, _ = _case("chain3")
    for make in (figaro_qr_fn, figaro_r0_fn, join_column_moments):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(p_t)
