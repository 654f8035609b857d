"""Port `Session` vs the JAX package's `figaro.Session`, end to end.

qr / svd / pca / least_squares / r0 through both façades with the same
options, single and batched, bucketing on and off, on the many-to-many yelp
schema. The port runs on the CPU with both of its kernel-path corners
(plain/padded and kernel/band); the JAX side runs its XLA path, which its
own suite holds to its kernel path at 1e-9 (tests/test_kernel_path.py).
Tolerance: float64, 1e-9 absolute (tests/test_kernel_path.py:30); singular
vectors and principal components are compared up to the sign of each.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import figaro as jfig
from repro.core.engine import FigaroEngine as JaxEngine
from repro.core import join_tree as jt
from repro.data import relational as jrel
from repro_torch import figaro
from repro_torch.core import join_tree as tjt
from repro_torch.core import qr as tqr
from repro_torch.core import svd as tsvd
from repro_torch.core.counts import compute_counts
from repro_torch.core.engine import FigaroEngine
from repro_torch.core.figaro import figaro_r0
from repro_torch.core.materialize import materialize_join
from repro_torch.data import relational as trel

ATOL = 1e-9
BATCH = 2
PORT_CORNERS = [(False, "padded"), (True, "band")]


def _plans():
    return (tjt.build_plan(trel.yelp_like(scale=40, cols=2)),
            jt.build_plan(jrel.yelp_like(scale=40, cols=2)))


def _batch(plan):
    rng = np.random.default_rng(8)
    return [rng.normal(size=(BATCH,) + np.shape(d)) for d in plan.data]


@functools.lru_cache(maxsize=None)
def _jax(kind, bucket, batched):
    """The JAX façade's answer (XLA path), as numpy."""
    _, p_j = _plans()
    sess = jfig.Session(engine=JaxEngine(donate_data=False), bucket=bucket)
    data = _batch(p_j) if batched else None
    if kind == "qr":
        out = sess.qr(p_j, data, dtype=jnp.float64)
    elif kind == "svd":
        out = sess.svd(p_j, data)
    elif kind == "pca":
        p = sess.pca(p_j, data, k=2)
        out = (p.components, p.explained_variance, p.mean, p.num_rows)
    elif kind == "lsq":
        out = sess.least_squares(p_j, 0, data)
    else:
        out = sess.r0(p_j, data, dtype=jnp.float64)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port(kind, bucket, batched, use_kernel, assembly):
    p_t, _ = _plans()
    sess = figaro.Session(device="cpu", bucket=bucket, use_kernel=use_kernel,
                          assembly=assembly)
    data = _batch(p_t) if batched else None
    if kind == "qr":
        return sess.qr(p_t, data, dtype=torch.float64)
    if kind == "svd":
        return sess.svd(p_t, data)
    if kind == "pca":
        p = sess.pca(p_t, data, k=2)
        return (p.components, p.explained_variance, p.mean, p.num_rows)
    if kind == "lsq":
        return sess.least_squares(p_t, 0, data)
    return sess.r0(p_t, data, dtype=torch.float64)


def _sign_align(got, want):
    """Flip each row (last two axes: [.., k, N]) of ``got`` to ``want``'s sign."""
    s = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    return got * np.where(s == 0, 1.0, s)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("use_kernel,assembly", PORT_CORNERS)
def test_qr_and_r0_match_jax(bucket, batched, use_kernel, assembly):
    r = _port("qr", bucket, batched, use_kernel, assembly)
    assert r.dtype == torch.float64
    n = _plans()[0].spec.num_cols
    assert r.shape == ((BATCH,) if batched else ()) + (n, n)
    np.testing.assert_allclose(r.numpy(), _jax("qr", bucket, batched),
                               atol=ATOL)
    if bucket and not batched:
        r0 = _port("r0", bucket, batched, use_kernel, assembly)
        np.testing.assert_allclose(r0.numpy(), _jax("r0", bucket, batched),
                                   atol=ATOL)


@pytest.mark.parametrize("bucket,batched", [(True, False), (True, True),
                                            (False, False)])
@pytest.mark.parametrize("use_kernel,assembly", PORT_CORNERS)
def test_svd_pca_lsq_match_jax(bucket, batched, use_kernel, assembly):
    s, vt = _port("svd", bucket, batched, use_kernel, assembly)
    s_j, vt_j = _jax("svd", bucket, batched)
    assert s.dtype == torch.float64  # the f64 default of the spectral reads
    np.testing.assert_allclose(s.numpy(), s_j, atol=ATOL)
    np.testing.assert_allclose(_sign_align(vt.numpy(), vt_j), vt_j,
                               atol=ATOL)

    comps, var, mean, rows = _port("pca", bucket, batched, use_kernel,
                                   assembly)
    comps_j, var_j, mean_j, rows_j = _jax("pca", bucket, batched)
    np.testing.assert_allclose(_sign_align(comps.numpy(), comps_j), comps_j,
                               atol=ATOL)
    np.testing.assert_allclose(var.numpy(), var_j, atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), mean_j, atol=ATOL)
    np.testing.assert_allclose(rows.numpy(), rows_j, atol=ATOL)

    beta, resid = _port("lsq", bucket, batched, use_kernel, assembly)
    beta_j, resid_j = _jax("lsq", bucket, batched)
    np.testing.assert_allclose(beta.numpy(), beta_j, atol=ATOL)
    np.testing.assert_allclose(resid.numpy(), resid_j, atol=ATOL)


def test_default_qr_dtype_is_float32():
    p_t, p_j = _plans()
    r = figaro.Session(device="cpu", use_kernel=True, assembly="band").qr(p_t)
    assert r.dtype == torch.float32
    r_j = np.asarray(jfig.Session(engine=JaxEngine(donate_data=False)).qr(p_j))
    # float32 end to end: roundoff of ~1e-7 per operation over the join's
    # sums; 1e-5 of R's largest entry.
    np.testing.assert_allclose(r.numpy(), r_j, atol=1e-5 * np.abs(r_j).max())


def test_entry_points_default_to_the_card():
    """Without ``device=`` every entry point targets CUDA, and on a host
    without it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default is usable")
    tree = trel.cartesian(3, 2)
    plan = tjt.build_plan(tree)
    for call in (lambda: figaro.Session(),
                 lambda: figaro.default_session(),
                 lambda: tqr.figaro_qr(tree),
                 lambda: tsvd.svd_over_join(tree),
                 lambda: figaro_r0(plan),
                 lambda: compute_counts(plan),
                 lambda: FigaroEngine().qr(plan)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_module_level_wrappers_delegate_to_default_session():
    p_t, _ = _plans()
    sess = figaro.Session(device="cpu", bucket=False)
    np.testing.assert_array_equal(
        tqr.figaro_qr(p_t, device="cpu").numpy(), sess.qr(p_t).numpy())
    batch = _batch(p_t)
    np.testing.assert_array_equal(
        tqr.figaro_qr_batched(p_t, batch, device="cpu").numpy(),
        sess.qr(p_t, batch).numpy())
    s, vt = tsvd.svd_over_join(p_t, device="cpu")
    np.testing.assert_array_equal(s.numpy(), sess.svd(p_t)[0].numpy())
    p = tsvd.pca_over_join(p_t, 2, device="cpu")
    np.testing.assert_array_equal(p.explained_variance.numpy(),
                                  sess.pca(p_t, k=2).explained_variance.numpy())
    beta, _ = tsvd.least_squares_over_join(p_t, 1, device="cpu", ridge=0.5)
    np.testing.assert_array_equal(
        beta.numpy(), sess.least_squares(p_t, 1, ridge=0.5)[0].numpy())
    a = materialize_join(trel.yelp_like(scale=40, cols=2))
    np.testing.assert_allclose(p.mean.numpy(), a.mean(axis=0), atol=1e-9)
    assert float(p.num_rows) == a.shape[0]
    assert figaro.default_session("cpu") is figaro.default_session("cpu")


def test_baselines_match_figaro():
    tree = trel.retailer_like(scale=10, cols=1)
    r = figaro.Session(device="cpu").qr(tree, dtype=torch.float64).numpy()
    for method in ("lapack", "householder", "givens"):
        np.testing.assert_allclose(
            tqr.materialized_qr(tree, method=method, device="cpu").numpy(), r,
            atol=1e-9)


def test_engine_signature_cache_and_lru():
    p_t, _ = _plans()
    eng = FigaroEngine(max_cached=1)
    sess = figaro.Session(engine=eng, device="cpu")
    sess.qr(p_t)
    sess.qr(p_t)
    assert eng.trace_count("qr") == 1 and eng.cache_size("qr") == 1
    sess.qr(p_t, dtype=torch.float64)  # new signature: evicts the first
    assert eng.trace_count("qr") == 2 and eng.eviction_count("qr") == 1
    assert eng.cache_size() == 1 and eng.trace_count() == 2
    with pytest.raises(ValueError, match="max_cached"):
        FigaroEngine(max_cached=0)
    with pytest.raises(TypeError, match="JoinTree or FigaroPlan"):
        sess.qr(p_t.spec)
