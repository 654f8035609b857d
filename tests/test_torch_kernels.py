"""Port kernels' plain versions vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode (as its own suite does on
the CPU) and its XLA ``ref.py``. Tolerances:

  * float64: 1e-9 absolute, the reference's own kernel-vs-XLA bound
    (tests/test_kernel_path.py:30);
  * node_fused and segmented_tail in float32: 1e-5 (the recorded
    node_fused Pallas-vs-ref gap is 9.5e-7; segmented_tail is its subset);
  * panel_qr in float32: 1e-4 (the recorded gap is 2.5e-5).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.head_tail import kernel as jht_kernel
from repro.kernels.head_tail import ref as jht_ref
from repro.kernels.node_fused import kernel as jnf_kernel
from repro.kernels.node_fused import ops as jnf_ops
from repro.kernels.node_fused import ref as jnf_ref
from repro.kernels.panel_qr import kernel as jpq_kernel
from repro.kernels.panel_qr import ref as jpq_ref
from repro.core import heads_tails as jht
from repro.core import postprocess as jpp
from repro_torch.core import heads_tails as tht
from repro_torch.core import postprocess as tpp
from repro_torch.kernels import _platform
from repro_torch.kernels.head_tail import ops as ht_ops
from repro_torch.kernels.head_tail import ref as ht_ref
from repro_torch.kernels.node_fused import ops as nf_ops
from repro_torch.kernels.node_fused import ref as nf_ref
from repro_torch.kernels.panel_qr import kernel as pq_kernel
from repro_torch.kernels.panel_qr import ops as pq_ops
from repro_torch.kernels.panel_qr import ref as pq_ref

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


# -- segmented_tail (head_tail kernel) ----------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,block_rows", [(40, 1, 8), (129, 5, 32)])
def test_segmented_tail_plain_vs_pallas(dtype, m, n, block_rows):
    """Segments straddle the Pallas kernel's row blocks (short blocks, many
    segments)."""
    rng = np.random.default_rng(m * n)
    first, _ = _segments(rng, m, p_dead=0.0)
    data = rng.uniform(-1.0, 1.0, (m, n)).astype(dtype)
    w = rng.uniform(0.5, 2.0, m).astype(dtype)
    wa = (data * w[:, None]).astype(dtype)
    ca, cb = (rng.uniform(-1.0, 1.0, m).astype(dtype) for _ in range(2))
    col = lambda v: jnp.asarray(v)[:, None]
    args_j = (jnp.asarray(data), jnp.asarray(wa), col(first.astype(dtype)),
              col(ca), col(cb))
    out_j = jht_kernel.segmented_tail_kernel(
        *args_j, block_rows=block_rows, block_cols=128, interpret=True)
    out_r = jht_ref.segmented_tail_ref(*args_j)
    out_t = ht_ops.segmented_tail(_t(data), _t(wa), _t(first), _t(ca),
                                  _t(cb))
    assert out_t.dtype == DTYPES[dtype]
    tol = TOL[dtype]["nf"]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=tol)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_r), atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segmented_tail_batched_columns(dtype):
    """A [B, m, n] batch shares the row vectors: each batch element equals
    its own single call."""
    rng = np.random.default_rng(17)
    m, n, b = 70, 3, 2
    first, _ = _segments(rng, m, p_dead=0.0)
    data = rng.normal(size=(b, m, n)).astype(dtype)
    wa = rng.normal(size=(b, m, n)).astype(dtype)
    rows = [_t(first)] + [_t(rng.normal(size=m).astype(dtype))
                          for _ in range(2)]
    out_b = ht_ops.segmented_tail(_t(data), _t(wa), *rows)
    for i in range(b):
        out_i = ht_ref.segmented_tail_ref(_t(data[i]), _t(wa[i]), *rows)
        np.testing.assert_array_equal(out_b[i].numpy(), out_i.numpy())


def _segment_layout(rng, m):
    first = rng.random(m) < 0.2
    first[0] = True
    seg = np.cumsum(first) - 1
    pos = np.arange(m) - np.flatnonzero(first)[seg]
    return seg, pos, int(seg[-1]) + 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segmented_head_tail_kernel_path_matches_jax(dtype):
    """``use_kernel=True`` against JAX's ``use_kernel=True`` (its Pallas
    kernel in interpret mode) and against the port's own unfused path."""
    rng = np.random.default_rng(23)
    m, n = 300, 3
    seg, pos, k = _segment_layout(rng, m)
    data = rng.normal(size=(m, n)).astype(dtype)
    w = rng.uniform(0.5, 2.0, m).astype(dtype)
    t_args = (_t(data), _t(w), _t(seg), _t(pos), k)
    _platform.reset_launch_counts()
    got = tht.segmented_head_tail(*t_args, use_kernel=True)
    assert _platform.launch_counts().get("segmented_tail", 0) == 0  # CPU
    unfused = tht.segmented_head_tail(*t_args)
    want = jax.jit(functools.partial(jht.segmented_head_tail, num_segments=k,
                                     use_kernel=True))(
        jnp.asarray(data), jnp.asarray(w), jnp.asarray(seg), jnp.asarray(pos))
    tol = TOL[dtype]["nf"]
    for g, u, wnt in zip(got, unfused, want):
        assert g.dtype == DTYPES[dtype]
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=tol)
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=tol)


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


def _kernel_order_panel(a: torch.Tensor):
    """The CUDA kernel's arithmetic order on one [m, nb] panel, in the I/O
    type: the panel in LAPACK's compact storage (R on and above the
    diagonal, the earlier reflectors below it), so one product u = vᵀP per
    step gives z = V[:, :k]ᵀv (u[:k]) for T's column and w = vᵀA (u[k:]) for
    the update; v'v reduced beside it; R[k, k] by the update; T[:k, k] =
    −β·T[:k, :k]·z. Returns (V, beta, R, T)."""
    p = a.clone()
    m, nb = p.shape
    steps = min(m, nb)
    rows = torch.arange(m)
    zero = torch.zeros((), dtype=a.dtype)
    t = torch.zeros((nb, nb), dtype=a.dtype)
    betas = torch.zeros(nb, dtype=a.dtype)
    diag = torch.zeros(nb, dtype=a.dtype)
    for k in range(steps):
        x = p[:, k].clone()
        below = torch.where(rows >= k, x, zero)
        sigma = torch.sqrt((below * below).sum())
        xk = x[k]
        sgn = 1.0 if bool(xk >= 0) else -1.0
        vk = xk - (-sgn * sigma)
        v = torch.where(rows > k, x, torch.where(rows == k, vk, zero))
        safe = bool(vk.abs() > 0)
        if safe:
            v = v / vk
        u = v @ p
        vv = (v * v).sum()
        beta = 2.0 / vv if bool(vv > 0) else zero
        t[:k, k] = -beta * (t[:k, :k] @ u[:k])
        t[k, k] = beta
        betas[k] = beta
        diag[k] = 1.0 if safe else 0.0
        c = beta * v
        p[:, k + 1:] -= c[:, None] * u[None, k + 1:]
        p[k, k] -= c[k] * u[k]
        p[k + 1:, k] = v[k + 1:]
    v_out = torch.tril(p, -1)
    v_out[:, steps:] = 0
    v_out[:steps, :steps] += torch.diag(diag[:steps])
    return v_out, betas, torch.triu(p), t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,nb", [(256, 32), (224, 3), (70, 32), (38, 3),
                                  (5, 8)])
def test_panel_qr_kernel_order_matches_pallas(dtype, m, nb):
    """The kernel's order of arithmetic (T built from z, v'v reduced with w,
    R's diagonal by the update), emulated on the CPU, against the Pallas
    kernel (V, beta, R) and the plain T, at the panel tolerance."""
    rng = np.random.default_rng(m + nb)
    a = rng.normal(size=(m, nb)).astype(dtype)
    v_j, b_j, r_j = jpq_kernel.panel_qr_kernel(jnp.asarray(a), interpret=True)
    v_e, b_e, r_e, t_e = _kernel_order_panel(_t(a))
    a_p = _t(a).clone()
    _, _, t_p = pq_ops.panel_qr_wy(a_p)
    tol = TOL[dtype]["pq"]
    for g, want in zip((v_e, b_e, r_e), (v_j, b_j, r_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=tol)
    np.testing.assert_allclose(t_e.numpy(), t_p.numpy(), atol=tol)


def _grid_order_panel(a: torch.Tensor, per: int, inner: int = 8):
    """The grid variant's arithmetic on one [m, nb] panel (m ≥ nb) spread
    over ``per`` CTAs of contiguous row ranges, in the I/O type. Columns go
    in inner blocks of ``inner``. Step k's tail sums h[j] = Σ_{i > k} x_i·P[i, j]
    over the block's columns and its pivot row are summed over the CTAs in
    order; α, v_p, v'v = h[k]/v_p² + 1 and u = h/v_p + P[k, :] come from them,
    and the step updates the block's columns ≥ k only, column k keeping v
    below the diagonal. A block's end sums V_bᵀ[V A] (V up to the block's
    end, A right of it) over the CTAs: the block's rows of the Gram VᵀV and
    V_bᵀA. It forms T_b and applies the block to the columns right of it,
    A −= V_b·T_bᵀ·V_bᵀA. The last block's rows of VᵀV come from the last
    step, and T from VᵀV. Returns (V, beta, R, T)."""
    p = a.clone()
    m, nb = p.shape
    rows_per = -(-m // per)
    ranges = [(min(m, r * rows_per), min(m, (r + 1) * rows_per))
              for r in range(per)]
    rows = torch.arange(m)
    zero = torch.zeros((), dtype=a.dtype)

    def over_ctas(f):
        total = f(*ranges[0])
        for lo, hi in ranges[1:]:
            total = total + f(lo, hi)
        return total

    def sums(k, hi):
        tail = torch.where(rows > k, p[:, k], zero)
        h = torch.zeros(nb, dtype=a.dtype)
        h[k:hi] = over_ctas(lambda lo, up: tail[lo:up] @ p[lo:up, k:hi])
        return h, p[k].clone()

    def t_of(gram, betas):
        t = torch.zeros_like(gram)
        for k in range(len(betas)):
            t[:k, k] = -betas[k] * (t[:k, :k] @ gram[:k, k])
            t[k, k] = betas[k]
        return t

    betas = torch.zeros(nb, dtype=a.dtype)
    diag = torch.zeros(nb, dtype=a.dtype)
    gram = torch.zeros((nb, nb), dtype=a.dtype)
    blocks = [(j0, min(j0 + inner, nb)) for j0 in range(0, nb, inner)]
    h, piv = sums(0, blocks[0][1])
    for j0, hi in blocks:
        for k in range(j0, hi):
            xp, hk = piv[k], h[k]
            sigma = torch.sqrt(hk + xp * xp)
            sgn = 1.0 if bool(xp >= 0) else -1.0
            vk = xp - (-sgn * sigma)
            safe = bool(vk.abs() > 0)
            inv = 1.0 / vk if safe else torch.ones((), dtype=a.dtype)
            vv = hk * inv * inv + 1.0 if safe else hk + vk * vk
            u = h * inv + piv if safe else h + vk * piv
            betas[k] = 2.0 / vv if bool(vv > 0) else zero
            diag[k] = 1.0 if safe else vk
            vi = torch.where(rows > k, p[:, k] * inv,
                             torch.where(rows == k, diag[k], zero))
            bu = betas[k] * u
            p[k:, k + 1:hi] -= vi[k:, None] * bu[None, k + 1:hi]
            p[k, k] -= vi[k] * bu[k]
            p[k + 1:, k] = vi[k + 1:]
            if k + 1 < hi:
                h, piv = sums(k + 1, hi)
        v_left = torch.tril(p[:, :hi], -1)
        v_left[:hi] += torch.diag(diag[:hi])
        vb = v_left[:, j0:]
        s = over_ctas(lambda lo, up: vb[lo:up].T @ torch.cat(
            [v_left[lo:up], p[lo:up, hi:]], dim=1))
        gram[j0:hi] = s[:, :nb]
        if hi < nb:
            t_b = t_of(s[:, j0:hi], betas[j0:hi])
            p[j0:, hi:] -= vb[j0:] @ (t_b.T @ s[:, hi:])
            h, piv = sums(hi, min(hi + inner, nb))
    v_out = torch.tril(p, -1)
    v_out[:nb] += torch.diag(diag)
    return v_out, betas, torch.triu(p), t_of(gram.T, betas)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,nb,per", [(300, 32, 5), (131, 3, 4), (90, 16, 7),
                                      (9, 9, 4)])
def test_panel_qr_grid_order_matches_pallas(dtype, m, nb, per):
    """The grid variant's order of arithmetic (look-ahead tail sums and
    pivot row per CTA, added in order; u and v'v from them; inner blocks of
    8 columns applied to the columns right of them in compact-WY form; T
    from VᵀV, a block's rows at a time), emulated on the CPU, against the Pallas kernel (V, beta, R)
    and the plain T, at the panel tolerance. (9, 9, 4) has a one-column
    last block and a CTA without rows."""
    rng = np.random.default_rng(m * per + nb)
    a = rng.normal(size=(m, nb)).astype(dtype)
    v_j, b_j, r_j = jpq_kernel.panel_qr_kernel(jnp.asarray(a), interpret=True)
    v_e, b_e, r_e, t_e = _grid_order_panel(_t(a), per)
    _, _, t_p = pq_ops.panel_qr_wy(_t(a).clone())
    tol = TOL[dtype]["pq"]
    for g, want in zip((v_e, b_e, r_e), (v_j, b_j, r_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=tol)
    np.testing.assert_allclose(t_e.numpy(), t_p.numpy(), atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,nb,lda", [(70, 32, 35), (38, 3, 3), (40, 16, 20),
                                      (5, 8, 8)])
def test_panel_qr_wy_ref_writes_r_and_forms_t(dtype, m, nb, lda):
    """`panel_qr_wy_ref` on a strided column block: V and beta as
    `panel_qr_ref`, R left in the block (the rest of the matrix untouched),
    and T = `_panel_to_wy` (V, beta), which equals the JAX package's T of
    its Pallas kernel's reflectors."""
    rng = np.random.default_rng(m * lda)
    full = _t(rng.normal(size=(2, m, lda)).astype(dtype))
    orig = full.clone()
    block = full[:, :, :nb]
    v_w, b_w, t_w = pq_ops.panel_qr_wy(block)
    v_r, b_r, r_r = pq_ref.panel_qr_ref(orig[:, :, :nb])
    np.testing.assert_array_equal(v_w.numpy(), v_r.numpy())
    np.testing.assert_array_equal(b_w.numpy(), b_r.numpy())
    np.testing.assert_array_equal(full[:, :, :nb].numpy(), r_r.numpy())
    np.testing.assert_array_equal(full[:, :, nb:].numpy(),
                                  orig[:, :, nb:].numpy())
    np.testing.assert_array_equal(
        t_w.numpy(), tpp._panel_to_wy(v_r, b_r).numpy())
    tol = TOL[dtype]["pq"]
    for i in range(2):
        v_j, b_j, _ = jpq_kernel.panel_qr_kernel(
            jnp.asarray(orig[i, :, :nb].numpy()), interpret=True)
        np.testing.assert_allclose(t_w[i].numpy(), np.asarray(
            jpp._panel_to_wy(v_j, b_j)), atol=tol)


@pytest.mark.parametrize("m,want", [
    (38, "reg"),        # TSQR combine remainder panels
    (256, "reg"),       # TSQR leaves: one block, one row per thread
    (257, "cluster"),
    (1024, "cluster"),  # the TSQR combine at N = 512: four CTAs
    (4096, "cluster"),  # sixteen CTAs, the largest cluster
    (4097, "grid"),
    (24_117_248, "grid"),  # a whole R0 (method="blocked")
])
def test_panel_qr_variant_by_size(m, want):
    """The wrapper's choice between its kernels, from the panel's height
    alone: one block up to 256 rows, a cluster of up to 16 blocks up to
    4,096, a cooperative grid above."""
    assert pq_kernel.variant(m) == want
    cs = pq_kernel.cluster_size(m)
    assert (cs == 1) == (want == "reg")
    assert (cs <= pq_kernel.MAX_CLUSTER) == (want != "grid")
    assert pq_kernel.kernel_name(want) == f"panel_qr_{want}"


def test_panel_qr_size_function_mirrors_the_cuda_source():
    """`variant`, `CTA_ROWS`, `MAX_CLUSTER` and `MAX_NB` are the CUDA
    source's ``pq_variant_of``, ``kCtaRows``, ``kMaxCluster`` and
    ``kMaxNb``, `VARIANTS` is in the order of its ``Variant`` enum, and
    `cluster_size` is its launch's CTA count, so the choice made here is
    the one the library makes."""
    src = (pathlib.Path(pq_kernel.__file__).resolve().parents[2] / "csrc"
           / "panel_qr.cu").read_text()
    assert f"kCtaRows = {pq_kernel.CTA_ROWS};" in src
    assert f"kMaxCluster = {pq_kernel.MAX_CLUSTER};" in src
    assert f"kMaxNb = {pq_kernel.MAX_NB};" in src
    assert "if (m <= kCtaRows) return kReg;" in src
    assert ("if (m <= (int64_t)kCtaRows * kMaxCluster) return kCluster;"
            in src)
    assert "  return kGrid;\n}" in src
    assert pq_kernel.VARIANTS == ("reg", "cluster", "grid")
    assert "enum Variant { kReg = 0, kCluster = 1, kGrid = 2 };" in src
    assert "const int cs = (m + kCtaRows - 1) / kCtaRows;" in src
    assert f"constexpr int kNoClusterFits = {pq_kernel.NO_CLUSTER_FITS};" \
        in src
    assert pq_kernel.cluster_size(1024) == 4


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        pq_ops.panel_qr(torch.zeros(4, 4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        pq_ops.panel_qr_wy(torch.zeros(4, 4, device="meta"))
    z = torch.zeros(4, 2, device="meta")
    v = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ht_ops.segmented_tail(z, z, v.bool(), v, v)
    with pytest.raises(ValueError, match="no kernel"):
        ht_ops.segmented_cumsum(v, v.bool())
    with pytest.raises(ValueError, match="no kernel"):
        nf_ops.fused_node_pass(z, v, v.long(), v, v.long(), v.bool())
