"""Port kernels' plain versions vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode (as its own suite does on
the CPU) and its XLA ``ref.py``. Tolerances:

  * float64: 1e-9 absolute, the reference's own kernel-vs-XLA bound
    (tests/test_kernel_path.py:30);
  * node_fused in float32: 1e-5 (the recorded Pallas-vs-ref gap is 9.5e-7);
  * panel_qr in float32: 1e-4 (the recorded gap is 2.5e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.node_fused import kernel as jnf_kernel
from repro.kernels.node_fused import ops as jnf_ops
from repro.kernels.node_fused import ref as jnf_ref
from repro.kernels.panel_qr import kernel as jpq_kernel
from repro.kernels.panel_qr import ref as jpq_ref
from repro.core import heads_tails as jht
from repro_torch.core import heads_tails as tht
from repro_torch.kernels import _platform
from repro_torch.kernels.node_fused import ops as nf_ops
from repro_torch.kernels.node_fused import ref as nf_ref
from repro_torch.kernels.panel_qr import ops as pq_ops

TOL = {np.float32: {"nf": 1e-5, "pq": 1e-4}, np.float64: {"nf": 1e-9,
                                                          "pq": 1e-9}}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


def _segments(rng, m, p_start=0.08, p_dead=0.1):
    """Segment starts (row 0 always), and dead rows that are never starts."""
    first = rng.random(m) < p_start
    first[0] = True
    dead = (rng.random(m) < p_dead) & ~first
    return first, dead


def _row_vectors(rng, m, dtype, first, dead):
    w = rng.uniform(0.5, 2.0, m)
    w[dead] = 0.0
    ds = np.where(dead, 0.0, 1.0)
    ca, cb, es = (rng.uniform(-1.0, 1.0, m) for _ in range(3))
    cb = -w * cb  # as the wrapper's coef_b = −v/…: zero on dead rows
    return [v.astype(dtype) for v in (ds, w)], \
        [v.astype(dtype) for v in (ca, cb, es)]


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


# -- node_fused: the kernel itself -------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,block_rows", [(40, 1, 8), (300, 3, 16),
                                            (129, 5, 32)])
def test_node_fused_plain_vs_pallas(dtype, m, n, block_rows):
    """Segments straddle the Pallas kernel's row blocks (short blocks, many
    segments); dead rows come out exactly zero."""
    rng = np.random.default_rng(m + n)
    first, dead = _segments(rng, m)
    (ds, w), (ca, cb, es) = _row_vectors(rng, m, dtype, first, dead)
    data = rng.uniform(-1.0, 1.0, (m, n)).astype(dtype)
    col = lambda v: jnp.asarray(v)[:, None]
    e_j, s_j = jnf_kernel.node_fused_kernel(
        jnp.asarray(data), col(ds), col(w), col(first.astype(dtype)),
        col(ca), col(cb), col(es), block_rows=block_rows, block_cols=128,
        interpret=True)
    e_t, s_t = nf_ops.node_fused(_t(data), _t(ds), _t(w), _t(first), _t(ca),
                                 _t(cb), _t(es))
    assert e_t.dtype == DTYPES[dtype]
    tol = TOL[dtype]["nf"]
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=tol)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=tol)
    assert np.all(e_t.numpy()[dead] == 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_node_fused_batched_columns(dtype):
    """A [B, m, n] batch shares the row vectors: each batch element equals
    its own single call."""
    rng = np.random.default_rng(7)
    m, n, b = 90, 4, 3
    first, dead = _segments(rng, m)
    (ds, w), (ca, cb, es) = _row_vectors(rng, m, dtype, first, dead)
    data = rng.uniform(-1.0, 1.0, (b, m, n)).astype(dtype)
    rows = [_t(v) for v in (ds, w, first, ca, cb, es)]
    e_b, s_b = nf_ops.node_fused(_t(data), *rows)
    for i in range(b):
        e_i, s_i = nf_ops.node_fused(_t(data[i]), *rows)
        np.testing.assert_array_equal(e_b[i].numpy(), e_i.numpy())
        np.testing.assert_array_equal(s_b[i].numpy(), s_i.numpy())


def test_node_fused_cpu_runs_plain_version_without_counting():
    _platform.reset_launch_counts()
    m = 16
    z = torch.zeros(m, dtype=torch.float64)
    first = torch.zeros(m, dtype=torch.bool)
    first[0] = True
    nf_ops.node_fused(torch.ones(m, 2, dtype=torch.float64), z + 1, z + 1,
                      first, z, z, z)
    assert _platform.launch_counts().get("node_fused", 0) == 0


# -- node_fused: the whole pass (coefficients + head gather) -----------------


def _pass_inputs(rng, m, n, dtype, masked):
    first, dead = _segments(rng, m, p_dead=0.15 if masked else 0.0)
    seg = np.cumsum(first) - 1
    k = int(seg[-1]) + 1
    starts = np.flatnonzero(first)
    pos = np.arange(m) - starts[seg]
    last = np.append(starts[1:], m) - 1
    w = rng.uniform(0.5, 2.0, m)
    w[dead] = 0.0
    mask = np.where(dead, 0.0, 1.0) if masked else None
    live = np.ones(k, dtype=bool)
    live[-1] = not masked  # a dead trailing slot when masked
    es = rng.uniform(0.5, 3.0, m)
    data = rng.uniform(-1.0, 1.0, (m, n))
    cast = lambda v: None if v is None else v.astype(dtype)
    return (cast(data), cast(w), pos, cast(es), last, live, cast(mask))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_node_pass_vs_jax(dtype, masked):
    rng = np.random.default_rng(3)
    data, w, pos, es, last, live, mask = _pass_inputs(rng, 200, 3, dtype,
                                                      masked)
    j_args = [jnp.asarray(v) for v in (data, w, pos, es, last, live)]
    j_mask = None if mask is None else jnp.asarray(mask)
    slab_j, heads_j, norms_j = jax.jit(functools.partial(
        jnf_ops.fused_node_pass, block_rows=16, interpret=True))(
        *j_args, data_scale=j_mask)
    slab_r, heads_r, norms_r = jax.jit(jnf_ref.fused_node_pass_ref)(
        *j_args, data_scale=j_mask)
    t_args = [_t(v) for v in (data, w, pos, es, last, live)]
    t_mask = None if mask is None else _t(mask)
    slab_t, heads_t, norms_t = nf_ops.fused_node_pass(*t_args,
                                                      data_scale=t_mask)
    slab_p, heads_p, norms_p = nf_ref.fused_node_pass_ref(*t_args,
                                                          data_scale=t_mask)
    tol = TOL[dtype]["nf"]
    for got in ((slab_t, heads_t, norms_t), (slab_p, heads_p, norms_p)):
        for g, jk, jr in zip(got, (slab_j, heads_j, norms_j),
                             (slab_r, heads_r, norms_r)):
            np.testing.assert_allclose(g.numpy(), np.asarray(jk), atol=tol)
            np.testing.assert_allclose(g.numpy(), np.asarray(jr), atol=tol)
    if masked:
        assert np.all(slab_t.numpy()[mask == 0] == 0.0)
        assert np.all(heads_t.numpy()[~live] == 0.0)


# -- segmented scan and head/tail building blocks -----------------------------


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (64,), (333, 3)])
def test_segmented_cumsum_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    x = rng.normal(size=shape)
    first = rng.random(shape[0]) < 0.2
    first[0] = True
    got = tht.segmented_cumsum(_t(x), _t(first)).numpy()
    want = np.asarray(jax.jit(jht.segmented_cumsum)(jnp.asarray(x),
                                                    jnp.asarray(first)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_head_tail_match_jax_and_givens_oracle():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(9, 4))
    v = rng.uniform(0.5, 2.0, 9)
    h_t, t_t = tht.head_tail(_t(a), _t(v))
    h_j, t_j = jht.head_tail(jnp.asarray(a), jnp.asarray(v))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-12)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-12)
    g = tht.givens_sequence(v)
    np.testing.assert_allclose(g, jht.givens_sequence(v), atol=1e-14)
    ga = g @ a
    np.testing.assert_allclose(ga[0], h_t.numpy(), atol=1e-12)
    np.testing.assert_allclose(ga[1:], t_t.numpy(), atol=1e-12)
    h_u, _ = tht.head_tail(_t(a))
    np.testing.assert_allclose(h_u.numpy(), np.asarray(jht.head(
        jnp.asarray(a))), atol=1e-12)


def test_segmented_head_tail_matches_jax():
    rng = np.random.default_rng(5)
    m, n = 50, 3
    first = rng.random(m) < 0.2
    first[0] = True
    seg = np.cumsum(first) - 1
    pos = np.arange(m) - np.flatnonzero(first)[seg]
    data = rng.normal(size=(m, n))
    w = rng.uniform(0.5, 2.0, m)
    k = int(seg[-1]) + 1
    got = tht.segmented_head_tail(_t(data), _t(w), _t(seg), _t(pos), k)
    want = jax.jit(functools.partial(jht.segmented_head_tail,
                                     num_segments=k))(
        jnp.asarray(data), jnp.asarray(w), jnp.asarray(seg), jnp.asarray(pos))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-12)


# -- panel_qr -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,nb", [(8, 8), (37, 9), (70, 32), (256, 32),
                                  (256, 3), (5, 8)])
def test_panel_qr_plain_vs_pallas(dtype, m, nb):
    rng = np.random.default_rng(m * nb)
    a = rng.normal(size=(m, nb)).astype(dtype)
    v_j, b_j, r_j = jpq_kernel.panel_qr_kernel(jnp.asarray(a), interpret=True)
    v_r, b_r, r_r = jpq_ref.panel_qr_ref(jnp.asarray(a))
    v_t, b_t, r_t = pq_ops.panel_qr(_t(a))
    assert v_t.dtype == DTYPES[dtype]
    tol = TOL[dtype]["pq"]
    for g, jk, jr in zip((v_t, b_t, r_t), (v_j, b_j, r_j), (v_r, b_r, r_r)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jk), atol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(jr), atol=tol)
    assert np.all(np.tril(r_t.numpy(), -1) == 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_panel_qr_batched(dtype):
    """A [B, m, nb] batch (a TSQR level) equals the panels one by one."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=(4, 40, 16)).astype(dtype)
    v_b, b_b, r_b = pq_ops.panel_qr(_t(a))
    tol = TOL[dtype]["pq"]
    for i in range(a.shape[0]):
        v_j, b_j, r_j = jpq_kernel.panel_qr_kernel(jnp.asarray(a[i]),
                                                   interpret=True)
        np.testing.assert_allclose(v_b[i].numpy(), np.asarray(v_j), atol=tol)
        np.testing.assert_allclose(b_b[i].numpy(), np.asarray(b_j), atol=tol)
        np.testing.assert_allclose(r_b[i].numpy(), np.asarray(r_j), atol=tol)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        pq_ops.panel_qr(torch.zeros(4, 4, device="meta"))
