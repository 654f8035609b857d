"""Port Algorithm 1/2 and post-processing vs the JAX package.

Counts, R₀ (all four use_kernel × assembly corners, exact and capacity
plans) and the post-processing factorizations, on the same generator tables
and random acyclic databases. The port runs on the CPU (plain versions of its
kernels); the JAX side runs jitted, its kernel path in Pallas interpret mode.
Tolerance: float64, 1e-9 absolute — the reference's own kernel-vs-XLA bound
(tests/test_kernel_path.py:30). Band and padded assembly must agree bit for
bit, and R₀ᵀR₀ must equal AᵀA of the materialized join.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TOPOLOGIES, random_acyclic_db
from repro.core import counts as jcounts
from repro.core import postprocess as jpp
from repro.core.engine import FigaroEngine as JaxEngine
from repro.core import join_tree as jt
from repro.core import plan_cache as jpc
from repro.data import relational as jrel
from repro_torch.core import counts as tcounts
from repro_torch.core import join_tree as tjt
from repro_torch.core import plan_cache as tpc
from repro_torch.core import postprocess as tpp
from repro_torch.core.figaro import (assembly_traffic, figaro_r0,
                                     figaro_r0_batched)
from repro_torch.core.materialize import materialize_join
from repro_torch.core.relation import Database, Relation
from repro_torch.data import relational as trel

ATOL = 1e-9
TREES = {
    "retailer": lambda m: m.retailer_like(scale=60, cols=2),
    "yelp": lambda m: m.yelp_like(scale=40, cols=2),  # many-to-many
    "cartesian": lambda m: m.cartesian(7, 5),
}
CORNERS = [(False, "padded"), (False, "band"), (True, "padded"),
           (True, "band")]


def port_tree(tree):
    rels = {r.name: Relation(r.name, r.key_attrs, r.data_attrs, r.keys,
                             r.data) for r in tree.db}
    return tjt.JoinTree(Database(rels), dict(tree.parent))


def _plans(name, capacity):
    build_t = tpc.build_capacity_plan if capacity else tjt.build_plan
    build_j = jpc.build_capacity_plan if capacity else jt.build_plan
    return build_t(TREES[name](trel)), build_j(TREES[name](jrel))


@functools.lru_cache(maxsize=None)
def _jax_r0(name, capacity, use_kernel):
    _, p_j = _plans(name, capacity)
    return np.asarray(JaxEngine(donate_data=False).r0(
        p_j, dtype=jnp.float64, use_kernel=use_kernel,
        assembly="band" if use_kernel else "padded"))


# -- Algorithm 1 --------------------------------------------------------------


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("capacity", [False, True])
def test_compute_counts_matches_jax(name, capacity):
    p_t, p_j = _plans(name, capacity)
    got = tcounts.compute_counts(p_t, device="cpu")
    want = jax.jit(lambda p: [dict(c) for c in jcounts.compute_counts(p)])(
        p_j)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == torch.float64
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    if not capacity:
        exact = tcounts.compute_counts_reference(p_t)
        for g, e in zip(got, exact):
            for key in e:
                np.testing.assert_array_equal(g[key].numpy(), e[key])


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_compute_counts_random_dbs(topology):
    _, tree, p_j = random_acyclic_db(topology, np.random.default_rng(4))
    p_t = tjt.build_plan(port_tree(tree))
    got = tcounts.compute_counts(p_t, device="cpu")
    for g, e in zip(got, jcounts.compute_counts_reference(p_j)):
        for key in e:
            np.testing.assert_array_equal(g[key].numpy(), e[key])


# -- Algorithm 2 --------------------------------------------------------------


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("capacity", [False, True])
def test_figaro_r0_corners_match_jax(name, capacity):
    """All four use_kernel × assembly corners equal the JAX package's R₀
    (XLA path and fused-kernel path), and band == padded bit for bit."""
    p_t, _ = _plans(name, capacity)
    outs = {c: figaro_r0(p_t, dtype=torch.float64, use_kernel=c[0],
                         assembly=c[1], device="cpu").numpy() for c in CORNERS}
    for uk in (False, True):
        np.testing.assert_array_equal(outs[(uk, "band")], outs[(uk, "padded")])
        for c in CORNERS:
            np.testing.assert_allclose(outs[c], _jax_r0(name, capacity, uk),
                                       atol=ATOL)


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
@pytest.mark.parametrize("use_kernel", [False, True])
def test_r0_gram_equals_join_gram(topology, use_kernel):
    """Theorem 6.1: R₀ᵀR₀ == AᵀA of the materialized join, on exact and
    capacity plans."""
    _, tree, _ = random_acyclic_db(topology, np.random.default_rng(2))
    tree = port_tree(tree)
    a = materialize_join(tree)
    for plan in (tjt.build_plan(tree), tpc.build_capacity_plan(tree)):
        r0 = figaro_r0(plan, dtype=torch.float64, use_kernel=use_kernel,
                       assembly="band", device="cpu").numpy()
        np.testing.assert_allclose(r0.T @ r0, a.T @ a, atol=1e-9)


def test_figaro_r0_batched_equals_single():
    p_t, _ = _plans("yelp", True)
    rng = np.random.default_rng(1)
    batch = [rng.normal(size=(3,) + np.shape(d)) for d in p_t.data]
    for uk in (False, True):
        got = figaro_r0_batched(p_t, batch, dtype=torch.float64,
                                use_kernel=uk, assembly="band", device="cpu")
        for i in range(3):
            one = figaro_r0(p_t, [d[i] for d in batch], dtype=torch.float64,
                            use_kernel=uk, assembly="band", device="cpu")
            np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=1e-12)


def test_f32_kernel_path_matches_jax():
    p_t, p_j = _plans("retailer", True)
    got = figaro_r0(p_t, dtype=torch.float32, use_kernel=True,
                    assembly="band", device="cpu")
    want = np.asarray(JaxEngine(donate_data=False).r0(
        p_j, dtype=jnp.float32, use_kernel=True, assembly="band"))
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)


def test_assembly_traffic_matches_jax():
    from repro.core.figaro import assembly_traffic as jax_traffic

    p_t, p_j = _plans("retailer", True)
    for asm in ("padded", "band"):
        assert assembly_traffic(p_t.spec, assembly=asm) == \
            jax_traffic(p_j.spec, assembly=asm)
    with pytest.raises(ValueError, match="unknown assembly"):
        figaro_r0(p_t, assembly="scatter", device="cpu")


# -- post-processing ------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(40, 6), (300, 9), (5, 8)])
def test_postprocess_methods_match_jax(m, n):
    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, n))
    want = {meth: np.asarray(jax.jit(functools.partial(
        jpp.postprocess_r0, method=meth, leaf_rows=16, panel=4,
        use_kernel=False))(jnp.asarray(a)))
        for meth in ("tsqr", "householder", "blocked")}
    for meth in ("tsqr", "householder", "blocked", "lapack"):
        for uk in (False, True):
            got = tpp.postprocess_r0(torch.as_tensor(a), method=meth,
                                     leaf_rows=16, panel=4,
                                     use_kernel=uk).numpy()
            ref = want.get(meth, want["householder"])
            if m >= n:
                np.testing.assert_allclose(got, ref, atol=ATOL)
            else:  # rank-deficient: only the Gram identity is unique
                np.testing.assert_allclose(got.T @ got, a.T @ a, atol=ATOL)


def test_postprocess_batched_equals_single():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(3, 100, 7)))
    for uk in (False, True):
        got = tpp.postprocess_r0(a, leaf_rows=16, panel=4, use_kernel=uk)
        for i in range(3):
            one = tpp.postprocess_r0(a[i], leaf_rows=16, panel=4,
                                     use_kernel=uk)
            np.testing.assert_allclose(got[i].numpy(), one.numpy(),
                                       atol=1e-12)
    with pytest.raises(ValueError, match="unknown postprocess"):
        tpp.postprocess_r0(a, method="cholesky")


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-4)])
def test_blocked_qr_r_kernel_path_matches_jax(dtype, tol):
    """``blocked_qr_r(use_kernel=True)`` on a batch of TSQR-like leaves with
    N = 35 (two panels, 32 + 3, each a strided column block factored in
    place) against JAX's ``blocked_qr_r(use_kernel=True)``, its Pallas
    kernel in interpret mode; and against the port's plain path."""
    rng = np.random.default_rng(35)
    a = rng.normal(size=(2, 64, 35)).astype(dtype)
    got = tpp.blocked_qr_r(torch.as_tensor(a), use_kernel=True)
    plain = tpp.blocked_qr_r(torch.as_tensor(a))
    assert got.dtype == torch.as_tensor(a).dtype
    for i in range(a.shape[0]):
        want = np.asarray(jax.jit(functools.partial(
            jpp.blocked_qr_r, use_kernel=True))(jnp.asarray(a[i])))
        np.testing.assert_allclose(got[i].numpy(), want, atol=tol)
        np.testing.assert_allclose(plain[i].numpy(), want, atol=tol)


def test_blocked_qr_r_tall_panels_match_jax():
    """``blocked_qr_r(use_kernel=True)`` on one R₀-like [4500, 35] float64
    matrix — the tall path's two panels (32 + 3 columns), each taller than
    4,096 rows, the height at which the card takes panel_qr's grid variant
    — against JAX's ``blocked_qr_r(use_kernel=True)``, its Pallas kernel in
    interpret mode: 1e-9 relative after ``normalize_sign``."""
    rng = np.random.default_rng(4500)
    a = rng.normal(size=(4500, 35)) * rng.uniform(0.5, 2.0, size=35)
    got = tpp.normalize_sign(tpp.blocked_qr_r(torch.as_tensor(a),
                                              use_kernel=True))
    want = np.asarray(jpp.normalize_sign(jax.jit(functools.partial(
        jpp.blocked_qr_r, use_kernel=True))(jnp.asarray(a))))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-9


@pytest.mark.parametrize("n,panel,formed", [(35, 32, 1), (12, 4, 2),
                                            (8, 8, 0)])
def test_blocked_qr_r_forms_t_only_before_a_trailing_update(monkeypatch, n,
                                                           panel, formed):
    """The plain path forms a panel's T only when a trailing update follows
    it: never for the last panel."""
    calls = []
    real = tpp._panel_to_wy

    def counting(v, beta):
        calls.append(v.shape)
        return real(v, beta)

    monkeypatch.setattr(tpp, "_panel_to_wy", counting)
    a = torch.as_tensor(np.random.default_rng(n).normal(size=(40, n)))
    r = tpp.blocked_qr_r(a, panel=panel)
    assert len(calls) == formed
    np.testing.assert_allclose(r.numpy().T @ r.numpy(), a.numpy().T @ a.numpy(),
                               atol=1e-9)
