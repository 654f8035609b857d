"""The single-pass segmented scan's arithmetic, and the node pass on real
plans, against the JAX package — on the CPU.

``src/repro_torch/csrc/seg_scan.cuh`` runs only on the card, so
``tests/_scan_order.py`` emulates its order of arithmetic (tile shape from
`repro_torch.kernels._seg_scan.geometry`, serial rows per thread, the
Hillis-Steele scan over a tile's chunks, the chained tile prefixes); the
GPU tests hold the kernel to that emulation bit for bit. Here the emulation
is held to the Pallas kernels in interpret mode (``node_fused_kernel``,
``segmented_tail_kernel``, the whole ``fused_node_pass``) and to
``segmented_cumsum``, on segments that straddle tiles, one segment over more
than 64 tiles, every row a segment start, and dead rows and slots.
Tolerances, relative to max(1, max |want|): float32 1e-5, float64 1e-9 (the
bounds of tests/test_torch_kernels.py).

Then the port's `fused_node_pass` (its plain version here) against JAX's on
every pass of padded retailer, yelp and favorita plans, and the kernel
path's band assembly — each pass writing its slab straight into its band of
R₀ — against the padded assembly, bit for bit, at B = 1 and B = 3.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _scan_order as so
from repro.kernels.head_tail import kernel as jht_kernel
from repro.kernels.node_fused import kernel as jnf_kernel
from repro.kernels.node_fused import ops as jnf_ops
from repro_torch.core import join_tree as tjt
from repro_torch.core import plan_cache as tpc
from repro_torch.core.figaro import figaro_r0, figaro_r0_batched
from repro_torch.core.heads_tails import segmented_cumsum
from repro_torch.data import relational as trel
from repro_torch.kernels import _seg_scan
from repro_torch.kernels.node_fused import ops as nf_ops

TOL = {np.float32: 1e-5, np.float64: 1e-9}
SEG_SCAN = (pathlib.Path(__file__).resolve().parent.parent / "src"
            / "repro_torch" / "csrc" / "seg_scan.cuh")


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (err, scale)


def _long_rows(n, dtype):
    """Rows of 70 tiles of the widest mode's geometry at n columns."""
    item = np.dtype(dtype).itemsize
    return 70 * max(_seg_scan.geometry(n, item, mode).tile_rows
                    for mode in ("pass", "contract", "tail", "cumsum"))


KINDS = ["straddle", "long", "all_starts", "dead"]


def _case(kind, dtype):
    """(data [m, n], first, dead rows, m, n) for one scan case."""
    rng = np.random.default_rng(KINDS.index(kind) + 10 * (dtype == np.float64))
    if kind == "straddle":      # short segments across tile edges
        m, n, p_start, p_dead = 3_001, 1, 0.05, 0.0
    elif kind == "long":        # one segment over more than 64 tiles
        n = 40
        m, p_start, p_dead = _long_rows(n, dtype), 0.0, 0.0
    elif kind == "all_starts":  # K = m
        m, n, p_start, p_dead = 2_000, 3, 1.0, 0.0
    else:                       # dead rows, 18 columns
        m, n, p_start, p_dead = 1_500, 18, 0.05, 0.15
    first = rng.random(m) < p_start
    first[0] = True
    dead = (rng.random(m) < p_dead) & ~first
    data = rng.uniform(-1.0, 1.0, (m, n)).astype(dtype)
    return data, first, dead, m, n, rng


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_scan_order_matches_pallas_and_segmented_cumsum(dtype, kind):
    """The contract, tail and cumsum modes' order of arithmetic against the
    Pallas node_fused and segmented_tail kernels and segmented_cumsum."""
    data, first, dead, m, n, rng = _case(kind, dtype)
    w = rng.uniform(0.5, 2.0, m)
    w[dead] = 0.0
    ds = np.where(dead, 0.0, 1.0)
    ca, cb, es = (rng.uniform(-1.0, 1.0, m) for _ in range(3))
    cb = -w * cb
    ds, w, ca, cb, es = (v.astype(dtype) for v in (ds, w, ca, cb, es))
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v))
    col = lambda v: jnp.asarray(v)[:, None]
    tol = TOL[dtype]

    emitted, s_incl = so.contract_order(t(data), t(ds), t(w), t(first),
                                        t(ca), t(cb), t(es))
    e_j, s_j = jnf_kernel.node_fused_kernel(
        jnp.asarray(data), col(ds), col(w), col(first.astype(dtype)),
        col(ca), col(cb), col(es), block_rows=64, block_cols=128,
        interpret=True)
    _close(emitted, e_j, tol)
    _close(s_incl, s_j, tol)
    wa = (data * ds[:, None]) * w[:, None]
    _close(s_incl, segmented_cumsum(t(wa).double(), t(first)), tol)
    assert np.all(emitted.numpy()[dead] == 0.0)

    tails = so.tail_order(t(data), t(wa), t(first), t(ca), t(cb))
    tails_j = jht_kernel.segmented_tail_kernel(
        jnp.asarray(data), jnp.asarray(wa), col(first.astype(dtype)),
        col(ca), col(cb), block_rows=64, block_cols=128, interpret=True)
    _close(tails, tails_j, tol)

    for x in (t(data), t(w)):
        _close(so.cumsum_order(x, t(first)),
               segmented_cumsum(x.double(), t(first)), tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_node_pass_order_matches_jax_fused_node_pass(dtype, kind):
    """The node-pass mode's order of arithmetic (coefficients from the
    squared-weight lane, heads at each segment's last row) against JAX's
    fused_node_pass with its Pallas kernel; dead rows and three dead slots
    (pointing at row 0, the last row and past the end) exactly zero."""
    data, first, dead, m, n, rng = _case(kind, dtype)
    seg = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    pos = np.arange(m) - starts[seg]
    last = np.append(np.append(starts[1:], m) - 1, [0, m - 1, m + 5])
    live = np.ones(last.shape[0], dtype=bool)
    live[-3:] = False
    w = rng.uniform(0.5, 2.0, m)
    w[dead] = 0.0
    mask = np.where(dead, 0.0, 1.0).astype(dtype)
    es = rng.uniform(0.5, 3.0, m).astype(dtype)
    w = w.astype(dtype)
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v))
    got = so.node_pass_order(t(data), t(w), t(pos), t(es), t(last), t(live),
                             data_scale=t(mask))
    want = jax.jit(functools.partial(jnf_ops.fused_node_pass, block_rows=64,
                                     interpret=True))(
        *(jnp.asarray(v) for v in (data, w, pos, es, last, live)),
        data_scale=jnp.asarray(mask))
    for g, wnt in zip(got, want):
        _close(g, wnt, TOL[dtype])
    slab, heads, norms = got
    assert np.all(slab.numpy()[dead] == 0.0)
    assert np.all(heads.numpy()[~live] == 0.0)
    assert np.all(norms.numpy()[~live] == 0.0)


TREES = {
    "retailer": lambda mod: mod.retailer_like(scale=60, cols=2),
    "yelp": lambda mod: mod.yelp_like(scale=40, cols=2),
    "favorita": lambda mod: mod.favorita_like(scale=60, cols=2),
}


def _padded_plan(name):
    return tpc.pad_plan(tjt.build_plan(TREES[name](trel)))


def _captured_passes(plan, dtype):
    """The arguments of every fused_node_pass call of one kernel-path R₀."""
    calls = []
    real = nf_ops.fused_node_pass

    def hook(*args, **kwargs):
        calls.append(([a.clone() for a in args],
                      {k: v for k, v in kwargs.items()
                       if k not in ("out", "out_col")}))
        return real(*args, **kwargs)

    nf_ops.fused_node_pass = hook
    try:
        figaro_r0(plan, dtype=dtype, use_kernel=True, assembly="band",
                  device="cpu")
    finally:
        nf_ops.fused_node_pass = real
    return calls


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(TREES))
def test_fused_node_pass_matches_jax_on_plan_passes(dtype, name):
    """Every pass of a padded plan's kernel path: the port's fused_node_pass
    (plain version) and the kernel's order of arithmetic against JAX's
    fused_node_pass with its Pallas kernel."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    plan = _padded_plan(name)
    calls = _captured_passes(plan, tdt)
    assert len(calls) == 2 * len(plan.spec.nodes) - 1
    tol = TOL[dtype]
    for args, kw in calls:
        data = args[0][0]  # batch of one
        ds = kw.get("data_scale")
        rest = [a.numpy() for a in args[1:]]
        want = jax.jit(functools.partial(jnf_ops.fused_node_pass,
                                         block_rows=16, interpret=True))(
            jnp.asarray(data.numpy()), *(jnp.asarray(v) for v in rest),
            data_scale=None if ds is None else jnp.asarray(ds.numpy()))
        port = nf_ops.fused_node_pass(*args, **kw)
        order = so.node_pass_order(*args, **kw)
        for got in (port, order):
            slab, heads, norms = got
            _close(slab[0], want[0], tol)
            _close(heads[0], want[1], tol)
            _close(norms, want[2], tol)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", ["retailer", "yelp"])
def test_band_write_r0_equals_padded(name, batch):
    """With assembly="band" the kernel path writes each pass's slab straight
    into R₀ as whole rows (its band's columns, zeros in the rest) and never
    zero-fills R₀, since the bands tile its rows; R₀ equals the padded
    assembly's bit for bit."""
    plan = _padded_plan(name)
    spans = sorted((b.row0, b.rows) for b in plan.spec.bands)
    assert [r0 for r0, _ in spans] == list(np.cumsum([0] + [r for _, r in
                                                           spans])[:-1])
    assert sum(r for _, r in spans) == plan.spec.r0_rows
    if batch == 1:
        band = figaro_r0(plan, dtype=torch.float64, use_kernel=True,
                         assembly="band", device="cpu")
        padded = figaro_r0(plan, dtype=torch.float64, use_kernel=True,
                           assembly="padded", device="cpu")
    else:
        rng = np.random.default_rng(batch)
        data = [rng.normal(size=(batch,) + np.asarray(d).shape)
                for d in plan.data]
        band = figaro_r0_batched(plan, data, dtype=torch.float64,
                                 use_kernel=True, assembly="band",
                                 device="cpu")
        padded = figaro_r0_batched(plan, data, dtype=torch.float64,
                                   use_kernel=True, assembly="padded",
                                   device="cpu")
    assert torch.equal(band, padded)
    assert bool(band.abs().sum() > 0)


def test_seg_scan_geometry_mirrors_the_cuda_source():
    """`_seg_scan.geometry` and `MODES` against the text of seg_scan.cuh (the
    GPU tests hold them against the build)."""
    src = SEG_SCAN.read_text()
    assert f"constexpr int kThreads = {_seg_scan.THREADS};" in src
    assert "constexpr int kSmemBudget = 48 * 1024;" in src
    assert _seg_scan.SMEM_BUDGET == 48 * 1024
    assert ("g.tpc = n == 0 ? kThreads : (n <= kThreads ? kThreads / (int)n "
            ": 1);") in src
    assert "g.pitch = (int)(n | 1);" in src
    assert "if (rpt % 2 == 0) rpt -= 1;" in src
    assert "g.rw = (g.tile_rows + kThreads - 1) / kThreads;" in src
    assert re.search(r"mats_of\(mode\) \* g\.pitch \* item \+\s+\(int64_t\)"
                     r"row_t_of\(mode, item\) \* item \+ 4 \* row_i_of\(mode\)"
                     r" \+\s+8 \* row_l_of\(mode\) \+ 1;", src)
    assert ("return mode == kPass ? (item == 4 ? 4 : 5) : mode == kContract "
            "? 5 : mode == kTail ? 2 : 0;") in src
    assert "return mode == kContract || mode == kTail ? 2 : 1;" in src
    assert "row_i_of(int mode) { return mode == kPass ? 1 : 0; }" in src
    assert "row_l_of(int mode) { return mode == kPass ? 1 : 0; }" in src
    assert "enum Mode { kPass = 0, kContract = 1, kTail = 2, kCumsum = 3 };" \
        in src
    assert [v[0] for v in _seg_scan.MODES.values()] == [0, 1, 2, 3]
    g = _seg_scan.geometry(1, 4, "pass")
    assert (g.tpc, g.rpt % 2, g.tile_rows) == (256, 1, 256 * g.rpt)
