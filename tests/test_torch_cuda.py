"""CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc; without them each test skips (the
decision is taken inside the test, never at import). On the machine with the
card, run them without the suite's conftest (which imports JAX)::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, relative to max(1, |plain|): float64 1e-9 and float32 1e-5
(node_fused, segmented_tail) / 1e-4 (panel_qr, its T held to `_panel_to_wy`
of the kernel's own V and beta) — the bounds the CPU suite holds the plain
versions to against the JAX package. The node pass and every mode of the
single-pass scan are also held to `tests/_scan_order.py`, the CPU emulation
of their order of arithmetic, bit for bit. The panel_qr tests assert through the
launch counts which variant (``panel_qr_reg``, ``_cluster``, ``_grid``) ran. The
engine's captured program: a replay equals the eager body bit for bit, an
append within capacity replays (no capture), a regrow captures once, replays
add the capture's launch counts, an evicted graph frees its memory, and two
threads share one signature's graph. Serving: a thread captures a signature
another thread ran eagerly, a served batch equals its synchronous batched
dispatch bit for bit, `stage` copies on the engine's copy stream, a served
stream over a one-rank NCCL mesh (appends included) equals the same stream
without a mesh bit for bit and issues no collective, and a batched node
pass past 2³¹ elements keeps its offsets. The LM's decode step (qwen3
smoke, and the mixtral, arctic, rwkv6 and jamba smoke configs through
their MoE, mamba and rwkv layers): a `DecodeGraph` replay equals the eager
step bit for bit, logits and cache, and `sample_loop` on the card gives the CPU loop's tokens, its
logits within 1e-4. The LM's train step (qwen3 smoke, float32, remat):
one step on the card against the CPU's, with the orthogonal update off
and on, metrics within 1e-5 and parameters and moments within rtol 2e-4
and atol 2e-6 plus the gradient's tolerance carried through Adam
(`tests/_adam_hold.py`); the flash branch under autograd raises on the card and
launches nothing. flash_attention,
elementwise: 2e-5 absolute in float32 and 1e-12 in float64 (the JAX
package's own kernel-vs-oracle bound, tests/test_flash_kernel.py, and
float64 rounding); in bfloat16 one bfloat16 step, |got − want| ≤
2⁻⁷·|want| + 1e-3·rms(want), since the kernel and the plain version both
round one float32 result.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import _scan_order
from repro_torch import figaro
from repro_torch.core import heads_tails, postprocess
from repro_torch.data.relational import yelp_like
from repro_torch.kernels import _platform, _seg_scan
from repro_torch.kernels.flash_attn import kernel as fk, ref as fr
from repro_torch.kernels.head_tail import kernel as hk, ref as hr
from repro_torch.kernels.node_fused import kernel as nk, ref as nr
from repro_torch.kernels.panel_qr import kernel as pk, ref as pr

TOL = {torch.float32: {"nf": 1e-5, "pq": 1e-4},
       torch.float64: {"nf": 1e-9, "pq": 1e-9}}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")


def _rel(got, want):
    scale = max(1.0, float(want.double().abs().max()))
    return float((got.double() - want.double()).abs().max()) / scale


def _flash_excess(got, want, tol):
    """The largest |got − want| over the allowance a·|want| + r·rms(want)
    + c, with (a, r, c) = ``tol``: at most 1 passes."""
    a, r, c = tol
    want = want.double()
    diff = (got.double() - want).abs()
    rms = float(want.square().mean().sqrt())
    return float((diff / (a * want.abs() + (r * rms + c))).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,n", [(1, 10_001, 1), (2, 4_099, 3),
                                   (1, 777, 40)])
def test_node_fused_kernel_matches_plain(dtype, b, m, n):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m)
    first = torch.rand(m, generator=g, device="cuda") < 0.05
    first[0] = True
    dead = (torch.rand(m, generator=g, device="cuda") < 0.1) & ~first
    w = torch.rand(m, generator=g, device="cuda", dtype=dtype) + 0.5
    w[dead] = 0
    ds = (~dead).to(dtype)
    ca = torch.rand(m, generator=g, device="cuda", dtype=dtype)
    cb = -w * torch.rand(m, generator=g, device="cuda", dtype=dtype)
    es = torch.rand(m, generator=g, device="cuda", dtype=dtype)
    data = torch.randn(b, m, n, generator=g, device="cuda", dtype=dtype)
    args = (data, ds, w, first, ca, cb, es)
    _platform.reset_launch_counts()
    e_k, s_k = nk.node_fused(*args)
    assert _platform.launch_counts() == {nk.CONTRACT_NAME: 1}
    e_r, s_r = nr.node_fused_ref(*args)
    _seg_scan.check()
    assert _rel(e_k, e_r) <= TOL[dtype]["nf"]
    assert _rel(s_k, s_r) <= TOL[dtype]["nf"]
    assert bool((e_k[:, dead] == 0).all())


def _pass_case(b, m, n, dtype, p_start, seed):
    """fused_node_pass inputs on the card: random segments (p_start 1.0: every
    row starts one, K = m; 0.0: one segment over all rows), 10 % dead rows
    (never starts; weight and data_scale 0), the live slots' last rows, and
    three dead slots pointing at row 0, the last row and past the end.
    Returns (args, kwargs, dead rows, dead slots)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    first = torch.rand(m, generator=g, device=dev) < p_start
    first[0] = True
    dead = (torch.rand(m, generator=g, device=dev) < 0.1) & ~first
    seg = torch.cumsum(first.long(), 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    pos = torch.arange(m, device=dev) - starts[seg]
    last = torch.cat([starts[1:], torch.tensor([m], device=dev)]) - 1
    last = torch.cat([last, torch.tensor([0, m - 1, m + 5], device=dev)])
    live = torch.ones(last.shape[0], dtype=torch.bool, device=dev)
    live[-3:] = False
    w = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    w[dead] = 0
    ds = (~dead).to(dtype)
    es = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    data = torch.randn(b, m, n, generator=g, device=dev, dtype=dtype)
    return (data, w, pos, es, last, live), {"data_scale": ds}, dead, ~live


PASS_CASES = [(1, 10_001, 1, 0.05), (2, 4_099, 3, 0.05), (1, 777, 40, 0.05),
              (1, 50_000, 1, 1.0),       # K = m
              (1, 200_000, 1, 0.0),      # one segment over > 64 tiles
              (1, 40_000, 18, 0.0),      # the same, 18 columns
              (2, 3_001, 300, 0.02)]     # wider than a block's threads


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,n,p_start", PASS_CASES)
def test_fused_node_pass_kernel_matches_plain(dtype, b, m, n, p_start):
    """The node pass's kernel against `ref.fused_node_pass_ref` (slab, heads,
    norms); dead rows and dead slots exactly zero; one launch counted."""
    _need_card()
    args, kw, dead, dead_slots = _pass_case(b, m, n, dtype, p_start, m + n)
    _platform.reset_launch_counts()
    got = nk.fused_node_pass(*args, **kw)
    assert _platform.launch_counts() == {nk.NAME: 1}
    want = nr.fused_node_pass_ref(*args, **kw)
    _seg_scan.check()
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == dtype
        assert _rel(x, y) <= TOL[dtype]["nf"]
    slab, heads, norms = got
    assert bool((slab[:, dead] == 0).all())
    assert bool((heads[:, dead_slots] == 0).all())
    assert bool((norms[dead_slots] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,n,p_start", PASS_CASES[:3] + PASS_CASES[5:6])
def test_seg_scan_kernels_match_their_cpu_emulation(dtype, b, m, n, p_start):
    """Every mode of the single-pass scan equals `tests/_scan_order.py`, the
    CPU emulation of its order of arithmetic, bit for bit."""
    _need_card()
    args, kw, _, _ = _pass_case(b, m, n, dtype, p_start, m * n)
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t
    got = nk.fused_node_pass(*args, **kw)
    want = _scan_order.node_pass_order(*map(cpu, args),
                                       data_scale=cpu(kw["data_scale"]))
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    data, w, pos, es = args[:4]
    first = pos == 0
    ds = kw["data_scale"]
    ca = torch.rand_like(w)
    cb = -w * torch.rand_like(w)
    contract = (data, ds, w, first, ca, cb, es)
    for x, y in zip(nk.node_fused(*contract),
                    _scan_order.contract_order(*map(cpu, contract))):
        assert torch.equal(x.cpu(), y)
    wa = data * w[:, None]
    tail = (data, wa, first, ca, cb)
    assert torch.equal(hk.segmented_tail(*tail).cpu(),
                       _scan_order.tail_order(*map(cpu, tail)))
    for x in (w * w, data):
        assert torch.equal(hk.segmented_cumsum(x, first).cpu(),
                           _scan_order.cumsum_order(x.cpu(), first.cpu()))
    _seg_scan.check()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("whole_rows", [False, True])
@pytest.mark.parametrize("m,n,row0,col0", [(5_000, 1, 17, 3), (3_000, 16, 0, 19),
                                          (2_000, 35, 100, 0)])
def test_fused_node_pass_writes_into_a_strided_band(dtype, whole_rows, m, n,
                                                    row0, col0):
    """The slab straight into a band of a [2, rows, 35] buffer (row stride 35,
    batch stride rows·35), as R₀'s band assembly gives it — either the band
    itself, or its whole rows with ``out_col`` (then the rest of those rows
    is zeroed): the band equals the plain slab, everything else is
    untouched."""
    _need_card()
    args, kw, _, _ = _pass_case(2, m, n, dtype, 0.05, row0 + n)
    buf = torch.randn(2, row0 + m + 50, 35, device="cuda", dtype=dtype)
    keep = buf.clone()
    band = buf[:, row0:row0 + m, col0:col0 + n]
    if whole_rows:
        slab, heads, norms = nk.fused_node_pass(
            *args, **kw, out=buf[:, row0:row0 + m], out_col=col0)
    else:
        slab, heads, norms = nk.fused_node_pass(*args, **kw, out=band)
    assert slab.data_ptr() == band.data_ptr()
    want = nr.fused_node_pass_ref(*args, **kw)
    _seg_scan.check()
    assert _rel(band, want[0]) <= TOL[dtype]["nf"]
    assert _rel(heads, want[1]) <= TOL[dtype]["nf"]
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[:, row0:row0 + m, col0:col0 + n] = False
    if whole_rows:
        rest = outside.clone()
        rest[:, :row0] = False
        rest[:, row0 + m:] = False
        assert bool((buf[rest] == 0).all())
        outside[:, row0:row0 + m] = False
    assert torch.equal(buf[outside], keep[outside])


def test_fused_node_pass_issues_few_torch_ops():
    """On the card the wrapper adds no [m]-sized torch op: at most 12 torch
    ops besides its kernel launches (a dispatch-mode count)."""
    _need_card()
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    args, kw, _, _ = _pass_case(1, 100_000, 3, torch.float32, 0.05, 1)
    nk.fused_node_pass(*args, **kw)  # build and bind first
    torch.cuda.synchronize()
    with Count() as count:
        from repro_torch.kernels.node_fused import ops as nf_ops
        nf_ops.fused_node_pass(*args, **kw)
    assert len(count.ops) <= 12, count.ops


@pytest.mark.parametrize("mode", sorted(_seg_scan.MODES))
@pytest.mark.parametrize("n", [0, 1, 3, 16, 18, 40, 129, 300, 513])
@pytest.mark.parametrize("item", [4, 8])
def test_seg_scan_geometry_mirror_matches_the_build(mode, n, item):
    _need_card()
    import ctypes

    lib = (nk._lib().nf_geometry if mode in ("pass", "contract")
           else hk._lib().ht_geometry)
    out = (ctypes.c_int64 * 9)()
    lib(1, 10_000, n, item, _seg_scan.MODES[mode][0], out)
    g = _seg_scan.geometry(n, item, mode)
    assert tuple(out[:5]) == (g.tpc, g.rpt, g.tile_rows, g.rw, g.pitch)


def _panel_counts(m):
    kind = pk.variant(m)
    return {"panel_qr": 1, pk.kernel_name(kind): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,nb", [(7, 256, 32), (5, 70, 32), (3, 10, 16),
                                    (2, 5, 8), (6, 224, 3), (4, 38, 3)])
def test_panel_qr_kernel_matches_plain(dtype, b, m, nb):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m * nb)
    a = torch.randn(b, m, nb, generator=g, device="cuda", dtype=dtype)
    keep = a.clone()
    _platform.reset_launch_counts()
    got = pk.panel_qr(a)
    assert _platform.launch_counts() == _panel_counts(m)
    want = pr.panel_qr_ref(a)
    torch.cuda.synchronize()
    assert torch.equal(a, keep)  # panel_qr leaves its input as it is
    for x, y in zip(got, want):
        assert _rel(x, y) <= TOL[dtype]["pq"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,nb,lda", [(7, 256, 32, 35), (6, 224, 3, 3),
                                        (5, 70, 32, 35), (4, 38, 3, 35),
                                        (3, 1024, 32, 512), (2, 4096, 32, 33),
                                        (1, 544, 32, 32), (2, 5000, 32, 35),
                                        (1, 4097, 32, 35), (3, 5000, 8, 35),
                                        (1, 100_003, 32, 35), (2, 6000, 3, 3),
                                        (1, 5000, 9, 35), (2, 4500, 17, 20),
                                        (1, 4100, 16, 16), (1, 4200, 24, 24)])
def test_panel_qr_wy_kernel_matches_plain(dtype, b, m, nb, lda):
    """The in-place form on a strided column block of a wider matrix: R
    left in the block (the other columns untouched), V and beta as the
    plain version's (random full-rank panels, so they are unique), T equal
    to `_panel_to_wy` of the kernel's own V and beta, and the variant the
    size picks, by the launch counts (``panel_qr_grid`` above 4,096 rows)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m + lda)
    full = torch.randn(b, m, lda, generator=g, device="cuda", dtype=dtype)
    orig = full.clone()
    _platform.reset_launch_counts()
    v, beta, t = pk.panel_qr_wy(full[:, :, :nb])
    assert _platform.launch_counts() == _panel_counts(m)
    v_p, beta_p, r_p = pr.panel_qr_ref(orig[:, :, :nb])
    torch.cuda.synchronize()
    tol = TOL[dtype]["pq"]
    assert _rel(full[:, :, :nb], r_p) <= tol
    assert torch.equal(full[:, :, nb:], orig[:, :, nb:])
    assert _rel(v, v_p) <= tol and _rel(beta, beta_p) <= tol
    t_own = postprocess._panel_to_wy(v.double(), beta.double())
    assert _rel(t, t_own) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,nb", [(3, 1024, 32), (2, 4096, 32),
                                    (2, 900, 7), (1, 4500, 32)])
def test_panel_qr_wide_panel_uses_cluster_or_grid_kernel(dtype, b, m, nb):
    """Panels taller than one block's 256 rows go to the cluster variant,
    those taller than a 16-CTA cluster's 4,096 rows to the cooperative grid
    variant (by the launch counts), and agree with the plain version
    (random full-rank panels)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m + nb)
    a = torch.randn(b, m, nb, generator=g, device="cuda", dtype=dtype)
    _platform.reset_launch_counts()
    got = pk.panel_qr(a)
    want_kind = "cluster" if m <= 4096 else "grid"
    assert _platform.launch_counts() == {"panel_qr": 1,
                                         f"panel_qr_{want_kind}": 1}
    want = pr.panel_qr_ref(a)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert _rel(x, y) <= TOL[dtype]["pq"]


@pytest.mark.parametrize("m", [1, 38, 256, 257, 1024, 4096, 4097, 100_000,
                               24_117_248])
def test_panel_qr_variant_mirror_matches_the_build(m):
    _need_card()
    assert pk.variant_of_build(m) == pk.variant(m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_panel_qr_grid_runs_batches_in_waves(dtype):
    """A batch of 200 panels [4200, 8] is more than the card's co-resident
    CTAs, so the grid variant factors it in waves inside its one launch;
    every panel agrees with the plain version."""
    _need_card()
    b, m, nb = 200, 4200, 8
    shape = pk.grid_shape(b, m, nb, dtype)
    assert shape["per"] == 1 and shape["waves"] > 1
    g = torch.Generator(device="cuda").manual_seed(b + m)
    a = torch.randn(b, m, nb, generator=g, device="cuda", dtype=dtype)
    orig = a.clone()
    _platform.reset_launch_counts()
    v, beta, t = pk.panel_qr_wy(a)
    assert _platform.launch_counts() == {"panel_qr": 1, "panel_qr_grid": 1}
    v_p, beta_p, r_p = pr.panel_qr_ref(orig)
    torch.cuda.synchronize()
    tol = TOL[dtype]["pq"]
    assert _rel(a, r_p) <= tol
    assert _rel(v, v_p) <= tol and _rel(beta, beta_p) <= tol
    assert _rel(t, postprocess._panel_to_wy(v.double(), beta.double())) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_panel_qr_grid_rank_deficient_panel(dtype):
    """A tall panel with repeated columns and zero rows: R, V and beta are
    not unique there, so R is held on RᵀR against the plain version's and
    (V, beta) on the factorization they define — Qᵀ·A = R with
    Q = H₁…H_nb, and β·vᵀv = 2 for every reflector with β ≠ 0."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6000)
    full = torch.randn(1, 6000, 35, generator=g, device="cuda", dtype=dtype)
    full[:, :, 16:32] = full[:, :, :16]
    full[:, 100:300] = 0
    a = full[:, :, :32]
    orig = a.clone()
    _platform.reset_launch_counts()
    v, beta, t = pk.panel_qr_wy(a)
    assert _platform.launch_counts() == {"panel_qr": 1, "panel_qr_grid": 1}
    _, _, r_p = pr.panel_qr_ref(orig)
    torch.cuda.synchronize()
    tol = TOL[dtype]["pq"]
    gram = lambda r: r.double().mT @ r.double()
    assert _rel(gram(a), gram(r_p)) <= tol
    x, vd, bd = orig.double(), v.double(), beta.double()
    qa = postprocess._apply_wy(x, vd, postprocess._panel_to_wy(vd, bd))
    assert _rel(qa, a) <= tol
    orth = (bd * (vd * vd).sum(dim=-2) - 2).abs() * (bd != 0)
    assert float(orth.max()) <= tol
    assert _rel(t, postprocess._panel_to_wy(vd, bd)) <= tol


def _no_panel_to_wy(*args):
    raise AssertionError("_panel_to_wy called on the card path")


def test_card_qr_forms_t_in_the_kernel(monkeypatch):
    """A card ``qr`` and a wide ``blocked_qr_r`` take T from the kernel:
    `_panel_to_wy` is patched to raise, and the launch counts show the
    one-block and the cluster variants."""
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    r_p = figaro.Session(device="cuda").qr(tree, dtype=torch.float64)
    monkeypatch.setattr(postprocess, "_panel_to_wy", _no_panel_to_wy)
    _platform.reset_launch_counts()
    r_k = figaro.Session(use_kernel=True, assembly="band").qr(
        tree, dtype=torch.float64)
    counts = _platform.launch_counts()
    assert counts.get("panel_qr_reg", 0) > 0
    assert counts.get("panel_qr", 0) == counts["panel_qr_reg"]
    assert _rel(r_k, r_p) <= 1e-9
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(1, 1024, 64, generator=g, device="cuda",
                    dtype=torch.float64)
    _platform.reset_launch_counts()
    r_w = postprocess.blocked_qr_r(a, use_kernel=True)
    assert _platform.launch_counts() == {"panel_qr": 2, "panel_qr_cluster": 2}
    monkeypatch.undo()
    r_plain = postprocess.blocked_qr_r(a)
    assert _rel(postprocess.normalize_sign(r_w),
                postprocess.normalize_sign(r_plain)) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,n", [(1, 100_003, 1), (2, 4_099, 3),
                                   (1, 777, 40)])
def test_segmented_tail_kernel_matches_plain(dtype, b, m, n):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m + n)
    first = torch.rand(m, generator=g, device="cuda") < 0.05
    first[0] = True
    data = torch.randn(b, m, n, generator=g, device="cuda", dtype=dtype)
    wa = data * (torch.rand(m, 1, generator=g, device="cuda", dtype=dtype)
                 + 0.5)
    ca = torch.rand(m, generator=g, device="cuda", dtype=dtype)
    cb = -torch.rand(m, generator=g, device="cuda", dtype=dtype)
    got = hk.segmented_tail(data, wa, first, ca, cb)
    want = hr.segmented_tail_ref(data, wa, first, ca, cb)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL[dtype]["nf"]


def test_segmented_head_tail_kernel_path_launches_and_matches():
    _need_card()
    m, n = 50_000, 4
    g = torch.Generator(device="cuda").manual_seed(0)
    first = torch.rand(m, generator=g, device="cuda") < 0.01
    first[0] = True
    seg = torch.cumsum(first.long(), 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    pos = torch.arange(m, device="cuda") - starts[seg]
    data = torch.randn(m, n, generator=g, device="cuda", dtype=torch.float64)
    w = torch.rand(m, generator=g, device="cuda", dtype=torch.float64) + 0.5
    k = int(seg[-1]) + 1
    _platform.reset_launch_counts()
    got = heads_tails.segmented_head_tail(data, w, seg, pos, k,
                                          use_kernel=True)
    assert _platform.launch_counts() == {hk.NAME: 1, hk.CUMSUM_NAME: 1}
    want = heads_tails.segmented_head_tail(data, w, seg, pos, k)
    for x, y in zip(got, want):
        assert _rel(x, y) <= 1e-9


BF16_TOL = (2.0 ** -7, 1e-3, 0.0)


def _flash_run(q, k, v, qpos, kpos, causal=True, window=None):
    """The kernel (asserting through the launch counts which one ran) and
    the plain version on the same inputs."""
    _platform.reset_launch_counts()
    got = fk.flash_attention(q, k, v, qpos, kpos, causal=causal,
                             window=window)
    kind = fk.SM90_NAME if q.dtype == torch.bfloat16 else fk.MMA_NAME
    assert _platform.launch_counts() == {fk.NAME: 1, kind: 1}
    want = fr.flash_attention_ref(q, k, v, qpos, kpos, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    return got, want


def _qkv(b, tq, tk, hq, hkv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, tq, hq, hd, generator=g, device="cuda").to(dtype),
            torch.randn(b, tk, hkv, hd, generator=g, device="cuda").to(dtype),
            torch.randn(b, tk, hkv, hd, generator=g, device="cuda").to(dtype))


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, (0.0, 0.0, 2e-5)),
    (torch.bfloat16, BF16_TOL),
    (torch.float64, (0.0, 0.0, 1e-12)),
])
@pytest.mark.parametrize("b,tq,tk,hq,hkv,hd,causal,window", [
    (1, 8, 8, 2, 2, 128, True, None),
    (2, 300, 300, 8, 2, 128, True, None),
    (1, 100, 260, 4, 4, 64, True, None),    # unaligned; tk > tq
    (2, 128, 384, 8, 2, 128, True, 96),     # GQA + sliding window
    (1, 64, 64, 2, 1, 256, False, None),    # non-causal
    (1, 70, 70, 4, 2, 32, True, None),
    (1, 77, 203, 4, 2, 64, True, None),     # Tq, Tk no multiple of any tile
    (2, 130, 261, 4, 1, 256, True, 100),    # hd 256 (64-key tiles), window
    (1, 333, 333, 2, 2, 32, False, 50),     # hd 32 (64-byte swizzle)
    (1, 1, 129, 4, 2, 128, True, None),     # one query row
])
def test_flash_attention_kernel_matches_plain(dtype, tol, b, tq, tk, hq, hkv,
                                              hd, causal, window):
    _need_card()
    q, k, v = _qkv(b, tq, tk, hq, hkv, hd, dtype, tq * hd)
    qpos = torch.arange(tk - tq, tk, device="cuda", dtype=torch.int32)
    kpos = torch.arange(tk, device="cuda", dtype=torch.int32)
    got, want = _flash_run(q, k, v, qpos, kpos, causal, window)
    assert _flash_excess(got, want, tol) <= 1.0


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, 40)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bf16_packed_sequences(causal, window, hd):
    """Two sequences packed in one row of 300 tokens: the positions restart
    at 0 in the middle of a 128-key tile, so tile skipping and the
    fully-visible test must go by position extremes, not by row index."""
    _need_card()
    q, k, v = _qkv(1, 300, 300, 4, 2, hd, torch.bfloat16, hd + 7)
    pos = torch.cat([torch.arange(170), torch.arange(130)]).to(
        device="cuda", dtype=torch.int32)
    got, want = _flash_run(q, k, v, pos, pos, causal, window)
    assert _flash_excess(got, want, BF16_TOL) <= 1.0


def test_flash_attention_bf16_encoder_non_causal():
    """whisper-tiny's encoder: bf16 without causality over 1,500 keys
    (eleven full 128-key tiles and a tail of 92, which no causal test
    hides), GQA group 1 at hd 64, against the plain version at one bf16
    step; the tail's keys carry values far from the rest, so a tail
    dropped or read past shows."""
    _need_card()
    q, k, v = _qkv(2, 1500, 1500, 6, 6, 64, torch.bfloat16, 1500)
    v[:, 1408:] += 8.0
    pos = torch.arange(1500, device="cuda", dtype=torch.int32)
    got, want = _flash_run(q, k, v, pos, pos, causal=False)
    assert _flash_excess(got, want, BF16_TOL) <= 1.0


@pytest.mark.parametrize("hd", [32, 128, 256])
def test_flash_attention_bf16_padded_key_block(hd):
    """A block of padded keys (k_pos = −1) in the middle of the keys, across
    a tile boundary."""
    _need_card()
    q, k, v = _qkv(2, 200, 400, 4, 2, hd, torch.bfloat16, hd)
    qpos = torch.arange(200, 400, device="cuda", dtype=torch.int32)
    kpos = torch.arange(400, device="cuda", dtype=torch.int32)
    kpos[100:260] = -1
    got, want = _flash_run(q, k, v, qpos, kpos)
    assert _flash_excess(got, want, BF16_TOL) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_fully_masked_row_is_zero(dtype):
    _need_card()
    q, k, v = _qkv(1, 70, 70, 2, 2, 64, dtype, 5)
    qpos = torch.arange(70, device="cuda", dtype=torch.int32)
    kpos = qpos.clone()
    kpos[:10] = -1  # query rows 0..9 see no key
    got, want = _flash_run(q, k, v, qpos, kpos)
    assert bool((got[:, :10] == 0).all())
    tol = BF16_TOL if dtype == torch.bfloat16 else (0.0, 0.0, 2e-5)
    assert _flash_excess(got, want, tol) <= 1.0


@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
def test_flash_sm90_shared_memory_mirror_matches_the_build(hd):
    _need_card()
    assert fk.smem_bytes_of_build(hd) == fk.sm90_smem_bytes(hd)


MMA_TOL = {torch.float32: (0.0, 0.0, 2e-5), torch.float64: (0.0, 0.0, 1e-12)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,tq,tk,hq,hkv,hd", [
    (1, 100, 2300, 8, 2, 128),  # Tk >= 2048: the K/V stages refill many times
    (2, 77, 77, 8, 2, 64),      # a GQA group of 4 in one block, Tq ragged
    (1, 50, 50, 12, 1, 32),     # a group of 12: blocks of 4 heads, 3 per group
    (1, 200, 333, 4, 1, 256),   # hd 256 (float64: O in two column halves)
])
def test_flash_attention_mma_edges(dtype, b, tq, tk, hq, hkv, hd):
    """The float32/float64 kernel where its tiling has edges: many K/V
    tiles, the GQA group folded into a block's rows with a ragged last
    block, groups larger than a block folds, and the widest head dim."""
    _need_card()
    q, k, v = _qkv(b, tq, tk, hq, hkv, hd, dtype, tk + hd)
    qpos = torch.arange(tk - tq, tk, device="cuda", dtype=torch.int32)
    kpos = torch.arange(tk, device="cuda", dtype=torch.int32)
    got, want = _flash_run(q, k, v, qpos, kpos)
    assert _flash_excess(got, want, MMA_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flash_attention_mma_long_rows_keep_their_accuracy(dtype):
    """4,096 causal keys with V offset by 3, so every output is near 3: a
    float32 sum that drifted by a few units in 1e5 over its ~1,500 tensor
    core products would exceed the bound (the tensor core's float32
    accumulation truncates; each tile's P.V is summed apart)."""
    _need_card()
    q, k, v = _qkv(1, 4096, 4096, 8, 2, 128, dtype, 4096)
    v = v + 3
    pos = torch.arange(4096, device="cuda", dtype=torch.int32)
    got, want = _flash_run(q, k, v, pos, pos)
    assert _flash_excess(got, want, MMA_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("causal,window", [(True, 40), (False, 40),
                                           (True, None)])
def test_flash_attention_mma_packed_sequences(dtype, causal, window):
    """Two sequences packed in one row of 300 tokens (positions restart
    at 0 inside a key tile), with and without a window, and padded keys."""
    _need_card()
    q, k, v = _qkv(1, 300, 300, 8, 2, 128, dtype, 11)
    pos = torch.cat([torch.arange(170), torch.arange(130)]).to(
        device="cuda", dtype=torch.int32)
    kpos = pos.clone()
    kpos[60:75] = -1
    got, want = _flash_run(q, k, v, pos, kpos, causal, window)
    assert _flash_excess(got, want, MMA_TOL[dtype]) <= 1.0


@pytest.mark.parametrize("dtype,hd", list(fk.MMA_TILES))
def test_flash_mma_shared_memory_mirror_matches_the_build(dtype, hd):
    _need_card()
    assert fk.mma_smem_bytes_of_build(dtype, hd) == fk.mma_smem_bytes(dtype,
                                                                      hd)


def test_session_kernel_path_launches_and_matches_plain_path():
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    _platform.reset_launch_counts()
    r_k = figaro.Session(use_kernel=True, assembly="band").qr(
        tree, dtype=torch.float64)
    counts = _platform.launch_counts()
    assert counts.get("node_fused", 0) > 0 and counts.get("panel_qr", 0) > 0
    r_p = figaro.Session(device="cuda").qr(tree, dtype=torch.float64)
    assert _rel(r_k, r_p) <= 1e-9


# -- the engine's captured program (one CUDA graph per R signature) ----------


def _bitwise(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("kind,dtype", [("qr", torch.float32),
                                        ("qr", torch.float64),
                                        ("svd", torch.float64),
                                        ("least_squares", torch.float64)])
def test_replay_equals_eager_bit_for_bit(kind, dtype):
    """The first call (eager), the second (the capture and its replay) and
    every later replay give the eager reference's answer bit for bit; one
    miss, one capture."""
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band")
    call = {"qr": lambda: sess.qr(tree, dtype=dtype),
            "svd": lambda: sess.svd(tree, dtype=dtype),
            "least_squares": lambda: sess.least_squares(tree, 0,
                                                        dtype=dtype)}[kind]
    first = call()
    assert sess.engine.capture_count() == 0 and sess.engine.graph_count() == 0
    replays = [call() for _ in range(2)]
    with sess.engine.eager_reference():
        eager = call()
    assert sess.engine.trace_count() == 1 and sess.engine.capture_count() == 1
    assert sess.engine.graph_count() == 1
    for got in [first] + replays:
        assert _bitwise(got, eager)


def test_svd_pca_lsq_replay_the_qr_graph():
    """float64 qr, svd, pca and lsq of one plan share one R graph: four
    misses, one capture (by svd, the R signature's second dispatch)."""
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band")
    sess.qr(tree, dtype=torch.float64)
    s, _ = sess.svd(tree)
    pca = sess.pca(tree, k=2)
    beta, _ = sess.least_squares(tree, 0)
    eng = sess.engine
    assert eng.trace_count() == 4 and eng.capture_count() == 1
    assert eng.capture_count("svd") == 1 and eng.graph_count() == 1
    plain = figaro.Session(device="cpu")
    assert _rel(s.cpu(), plain.svd(tree)[0]) <= 1e-9
    assert _rel(beta.cpu(), plain.least_squares(tree, 0)[0]) <= 1e-9
    assert _rel(pca.explained_variance.cpu(),
                plain.pca(tree, k=2).explained_variance) <= 1e-9


def test_replay_adds_the_captured_launches():
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band")
    _platform.reset_launch_counts()
    sess.qr(tree)  # the first call, eager: counted as it runs
    eager = _platform.launch_counts()
    assert eager.get("node_fused", 0) > 0 and eager.get("panel_qr", 0) > 0
    for n in (1, 2, 3):
        sess.qr(tree)  # a replay (the first after the capture): its counts
        assert sess.engine.capture_count() == 1
        assert _platform.launch_counts() == {
            k: v * (n + 1) for k, v in eager.items()}


def test_append_within_capacity_replays_and_regrow_captures_once():
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band", headroom=64)
    ds = sess.from_tree(tree)
    ds.qr(dtype=torch.float64)
    ds.qr(dtype=torch.float64)
    eng = sess.engine
    assert eng.trace_count() == 1 and eng.capture_count() == 1
    rev = ds.tree.db["Review"]
    keys = {a: rev.key_col(a)[:8].copy() for a in rev.key_attrs}
    assert ds.append("Review", keys, np.full((8, 1), 0.5)) is True
    r = ds.qr(dtype=torch.float64)
    assert eng.trace_count() == 1 and eng.capture_count() == 1
    plain = figaro.Session(device="cpu")
    assert _rel(postprocess.normalize_sign(r.cpu()),
                postprocess.normalize_sign(plain.qr(ds.tree,
                                                    dtype=torch.float64))) \
        <= 1e-9
    # past capacity: one regrow (the old spec's graph freed), one miss,
    # one capture
    cap = ds.stats()["nodes"]["Review"]["capacity_rows"]
    live = ds.stats()["nodes"]["Review"]["live_rows"]
    rows = cap - live + 1
    keys = {a: np.resize(rev.key_col(a), rows) for a in rev.key_attrs}
    assert ds.append("Review", keys, np.ones((rows, 1))) is False
    assert eng.graph_count() == 0
    ds.qr(dtype=torch.float64)
    r = ds.qr(dtype=torch.float64)
    assert ds.stats()["regrows"] == 1
    assert eng.trace_count() == 2 and eng.capture_count() == 2
    assert eng.graph_count() == 1
    assert _rel(postprocess.normalize_sign(r.cpu()),
                postprocess.normalize_sign(plain.qr(ds.tree,
                                                    dtype=torch.float64))) \
        <= 1e-9


def test_lru_eviction_frees_the_graph_memory():
    """max_cached=1: a small signature evicts a large one's entry, its
    graph and (the last graph gone) the pool; after empty_cache the
    reserved memory falls below what the large graph held."""
    _need_card()
    from repro_torch.core.join_tree import build_plan

    big = build_plan(yelp_like(scale=200_000, cols=4))
    small = build_plan(yelp_like(scale=400, cols=4))
    sess = figaro.Session(use_kernel=True, assembly="band", max_cached=1)
    for _ in range(2):  # eager, then the capture
        sess.qr(big, dtype=torch.float64)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    assert sess.engine.graph_count() == 1
    sess.qr(small, dtype=torch.float64)  # evicts big's entry and graph
    assert sess.engine.graph_count() == 0
    sess.qr(small, dtype=torch.float64)  # small's capture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    assert sess.engine.eviction_count("qr") == 1
    assert sess.engine.graph_count() == 1 and sess.engine.capture_count() == 2
    assert after < held - (64 << 20), (held, after)


def test_successive_regrows_keep_one_graph():
    """bucket=False: every append regrows onto exact capacities. Each regrow
    frees the superseded spec's graph, so across several the engine holds
    one graph and the reserved memory stays at about one graph's."""
    _need_card()
    tree = yelp_like(scale=20_000, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band", bucket=False)
    ds = sess.from_tree(tree)
    eng = sess.engine
    plain = figaro.Session(device="cpu")
    rev = ds.tree.db["Review"]
    reserved = []
    for i in range(4):
        ds.qr(dtype=torch.float64)
        r = ds.qr(dtype=torch.float64)  # the capture and its replay
        assert eng.graph_count() == 1 and eng.capture_count() == i + 1
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        assert _rel(postprocess.normalize_sign(r.cpu()),
                    postprocess.normalize_sign(plain.qr(
                        ds.tree, dtype=torch.float64))) <= 1e-9
        keys = {a: rev.key_col(a)[i:i + 8].copy() for a in rev.key_attrs}
        assert ds.append("Review", keys, np.full((8, 1), 0.25)) is False
        assert eng.graph_count() == 0  # the old spec's graph is released
    assert ds.stats()["regrows"] == 4
    assert max(reserved) <= reserved[0] * 1.25 + (16 << 20), reserved


def test_two_threads_dispatching_one_signature():
    _need_card()
    import threading

    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band")
    want = figaro.Session(device="cpu").qr(tree, dtype=torch.float64)
    got, errors = [], []

    def worker():
        try:
            for _ in range(4):
                got.append(sess.qr(tree, dtype=torch.float64).cpu())
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and len(got) == 8
    assert sess.engine.trace_count() == 1 and sess.engine.capture_count() == 1
    for r in got:
        assert _rel(postprocess.normalize_sign(r),
                    postprocess.normalize_sign(want)) <= 1e-9
    assert all(torch.equal(r, got[0]) for r in got)


def test_replay_alternating_plans_of_one_signature():
    """Two datasets whose plans share one capacity spec (near-miss fact
    sizes) replay one graph in turn: each replay copies in its own plan's
    index tensors when the plan changes, so each answer is its own."""
    _need_card()

    def tables(m_fact):
        rng = np.random.default_rng(m_fact)
        return {"Orders": ({"cust": np.arange(m_fact) % 8,
                            "prod": np.arange(m_fact) % 4},
                           rng.normal(size=(m_fact, 2)), ["amount", "qty"]),
                "Customers": ({"cust": np.arange(8)},
                              rng.normal(size=(8, 2)), ["age", "income"]),
                "Products": ({"prod": np.arange(4)},
                             rng.normal(size=(4, 1)), ["price"])}

    edges = [("Orders", "Customers"), ("Orders", "Products")]
    sess = figaro.Session(use_kernel=True, assembly="band")
    plain = figaro.Session(device="cpu")
    dss = [sess.ingest(tables(m)).join("Orders", edges) for m in (20, 24)]
    want = [plain.ingest(tables(m)).join("Orders", edges).qr(
        dtype=torch.float64) for m in (20, 24)]
    assert dss[0].plan.spec == dss[1].plan.spec
    for i in (0, 1, 0, 1, 1, 0):
        r = dss[i].qr(dtype=torch.float64)
        assert _rel(r.cpu(), want[i]) <= 1e-9
    assert sess.engine.trace_count() == 1 and sess.engine.capture_count() == 1


# -- serving: captures from any thread, served batches, staging ---------------


def test_worker_thread_captures_a_signature_warmed_on_the_main_thread():
    """The main thread runs a signature's first (eager) dispatch; a fresh
    thread (no cuBLAS handle of its own yet) makes the second, which
    captures, and its replay answers as eager."""
    _need_card()
    import threading

    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band")
    sess.qr(tree, dtype=torch.float64)  # eager, on this thread
    got, errors = {}, []

    def worker():
        try:
            got["r"] = sess.qr(tree, dtype=torch.float64)
            got["captures"] = sess.engine.capture_count()
            got["again"] = sess.qr(tree, dtype=torch.float64)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not errors, errors
    assert got["captures"] == 1 and sess.engine.graph_count() == 1
    with sess.engine.eager_reference():
        eager = sess.qr(tree, dtype=torch.float64)
    assert torch.equal(got["r"], eager) and torch.equal(got["again"], eager)
    assert torch.equal(sess.qr(tree, dtype=torch.float64), eager)
    assert sess.engine.capture_count() == 1


@pytest.mark.parametrize("kind", ["qr", "svd"])
def test_served_batch_equals_its_synchronous_batched_dispatch(kind):
    """Three requests coalesced into one B=3 batch (bucket 4), three times:
    eager, then the capture, then a replay. Each answer equals the same
    batch dispatched synchronously at the same capacity bit for bit, and
    an eager batch of one at 1e-9; the node pass and panel_qr launched."""
    _need_card()
    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band")
    ds = sess.from_tree(tree)
    server = ds.serve(kind=kind, dtype=torch.float64, max_batch=4)
    rng = np.random.default_rng(5)
    reqs = [tuple(np.asarray(d) * rng.uniform(0.5, 2.0, np.shape(d)[-1])
                  for d in ds.plan.data) for _ in range(3)]
    _platform.reset_launch_counts()
    for _ in range(3):
        server.pause()
        futures = [server.submit(r) for r in reqs]
        server.resume()
        answers = [f.result(timeout=300) for f in futures]
    launches = _platform.launch_counts()
    assert launches.get("node_fused", 0) > 0 and launches.get("panel_qr", 0)
    assert sess.engine.capture_count() == 1
    batch = tuple(np.stack([r[j] for r in reqs]) for j in range(len(reqs[0])))
    sync = getattr(sess.engine, kind)(
        ds.plan, batch, batched=True, batch_capacity=4, dtype=torch.float64,
        use_kernel=True, assembly="band")
    assert sess.engine.capture_count() == 1
    for i, got in enumerate(answers):
        want = sync[i] if kind == "qr" else (sync[0][i], sync[1][i])
        assert _bitwise(got, want), i
        with sess.engine.eager_reference():
            one = getattr(ds, kind)(reqs[i], dtype=torch.float64)
        if kind == "qr":
            assert _rel(postprocess.normalize_sign(got),
                        postprocess.normalize_sign(one)) <= 1e-9
        else:
            assert _rel(got[0], one[0]) <= 1e-9
    server.close()


def test_stage_copies_on_the_engines_copy_stream():
    """`stage` copies from pinned buffers on the engine's copy stream: its
    event completes while the current stream is still busy, and the
    dispatch that consumes the staged batch (waiting on that event) answers
    as the unstaged one through the same graph, bit for bit."""
    _need_card()
    from repro_torch.core.engine import Staged
    from repro_torch.core.join_tree import build_plan

    plan = build_plan(yelp_like(scale=400, cols=3))
    eng = figaro.Session(use_kernel=True, assembly="band",
                         donate_data=True).engine
    batch = tuple(np.stack([np.asarray(d)] * 2) for d in plan.data)
    # the kernel path: deterministic (the plain one sums with atomics)
    kw = dict(batched=True, dtype=torch.float64, use_kernel=True,
              assembly="band")
    eng.qr(plan, batch, **kw)  # eager
    want = eng.qr(plan, batch, **kw)  # the capture's replay
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # keeps the current stream busy ~1 s
    staged = eng.stage(batch)
    assert isinstance(staged, Staged) and staged.device.type == "cuda"
    staged.event.synchronize()
    assert not torch.cuda.current_stream().query(), \
        "the staged copy waited for the current stream"
    # a leaf given as the parts of a coalesced batch is concatenated
    parts = eng.stage(tuple([d[:1], d[1:]] for d in batch))
    parts.event.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(parts, staged, strict=True))
    got = eng.qr(plan, staged, **kw)
    assert torch.equal(got, want)
    on_card = eng.stage(staged)  # leaves already on the card pass through
    assert all(a is b for a, b in zip(on_card, staged))


def test_node_pass_batch_offsets_past_int32():
    """A batched node pass whose B·m·n passes 2³¹ elements (each matrix
    below it): the last rows of the last batch, where a 32-bit offset would
    wrap, against the plain version on those rows (segments of 64 rows, so
    a segment-aligned slice is a pass of its own)."""
    _need_card()
    b, m, n, seg = 3, 1 << 25, 24, 64
    assert b * m * n > 2 ** 31 > m * n
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(31)
    pos = torch.arange(m, device=dev) % seg
    last = torch.arange(seg - 1, m, seg, device=dev)
    live = torch.ones(m // seg, dtype=torch.bool, device=dev)
    w = torch.rand(m, generator=g, device=dev) + 0.5
    es = torch.rand(m, generator=g, device=dev) + 0.5
    data = torch.randn(b, m, n, generator=g, device=dev)
    slab, heads, norms = nk.fused_node_pass(data, w, pos, es, last, live)
    _seg_scan.check()
    for bi, lo in ((b - 1, m - 4096), (0, 0)):
        hi, s0, s1 = lo + 4096, lo // seg, (lo + 4096) // seg
        want = nr.fused_node_pass_ref(data[bi:bi + 1, lo:hi], w[lo:hi],
                                      pos[lo:hi], es[lo:hi],
                                      last[s0:s1] - lo, live[s0:s1])
        assert _rel(slab[bi:bi + 1, lo:hi], want[0]) <= TOL[torch.float32]["nf"]
        assert _rel(heads[bi:bi + 1, s0:s1], want[1]) <= TOL[torch.float32]["nf"]
        assert _rel(norms[s0:s1], want[2]) <= TOL[torch.float32]["nf"]


def test_one_rank_nccl_mesh_dispatches_on_the_card(tmp_path):
    """A one-rank NCCL group on the card: its data mesh is ``cuda:0``; a
    sharded dispatch (the batch staged with ``stage(shard=)`` too) answers
    as the unsharded one through the same graph, bit for bit, and the
    distributed QR of a tall matrix runs its panels on the grid kernel and
    equals `postprocess_r0` within 1e-9. A mesh of one rank issues no
    collective, so nothing here needs a peer."""
    _need_card()
    import datetime

    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.core.join_tree import build_plan
    from repro_torch.launch.mesh import make_data_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_data_mesh()
        assert mesh.size == 1 and mesh.backend == "nccl"
        assert mesh.device == torch.device("cuda", 0)
        plan = build_plan(yelp_like(scale=400, cols=3))
        eng = figaro.Session(use_kernel=True, assembly="band").engine
        batch = tuple(np.stack([np.asarray(d), 2.0 * np.asarray(d),
                                np.asarray(d)]) for d in plan.data)
        kw = dict(batched=True, dtype=torch.float64, use_kernel=True,
                  assembly="band")
        eng.qr(plan, batch, **kw)  # eager
        want = eng.qr(plan, batch, **kw)  # the capture's replay
        got = eng.qr(plan, batch, shard=mesh, **kw)  # the same graph
        assert torch.equal(got, want)
        staged = eng.stage(batch, shard=mesh)
        assert staged.device == mesh.device and staged.shard[1:] == (3, 3)
        assert torch.equal(eng.qr(plan, staged, shard=mesh, **kw), want)
        a = torch.randn(1 << 14, 24, dtype=torch.float64, device="cuda")
        _platform.reset_launch_counts()
        r = distributed.distributed_qr_r(a, mesh, use_kernel=True)
        assert _platform.launch_counts().get("panel_qr_grid", 0) > 0
        r_ref = postprocess.postprocess_r0(a)
        assert _rel(r, r_ref) < 1e-9
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_mesh_serves_on_the_card(tmp_path, monkeypatch):
    """A served stream over a one-rank NCCL mesh (``Session(mesh=)``, rank 0
    the controller of nothing): the same held requests, an append within
    capacity, a regrowing one and a second stream give the answers of the
    same stream through a server without a mesh bit for bit, the server
    issues no collective, and node_fused and panel_qr launch."""
    _need_card()
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_data_mesh

    calls = []
    for name in ("all_gather", "all_reduce", "broadcast", "scatter",
                 "broadcast_object_list", "all_gather_object",
                 "batch_isend_irecv"):
        fn = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_data_mesh()
        assert mesh.size == 1 and mesh.control is None
        sess = figaro.Session(mesh=mesh, use_kernel=True, assembly="band")
        tree = yelp_like(scale=400, cols=3)
        datasets = (sess.from_tree(tree), sess.from_tree(tree))
        rng = np.random.default_rng(5)

        def requests(plan, k):
            return [tuple(np.asarray(d) * rng.uniform(0.5, 2.0, d.shape[-1])
                          for d in plan.data) for _ in range(k)]

        def stream(server, reqs):
            server.pause()
            futures = [server.submit(r) for r in reqs]
            server.resume()
            return [f.result(timeout=300) for f in futures]

        def grow(ds, name, rows):
            rel = ds.tree.db[name]
            pick = np.arange(rows) % rel.num_rows
            keys = {a: rel.key_col(a)[pick].copy() for a in rel.key_attrs}
            return ds.append(name, keys, np.ones((rows, rel.data.shape[1])))

        _platform.reset_launch_counts()
        meshed = datasets[0].serve("svd", max_batch=4)
        lone = datasets[1].serve("svd", max_batch=4, mesh=None)
        answers = []
        for step in range(2):
            reqs = requests(datasets[0].plan, 6)
            answers.append([stream(s, reqs) for s in (meshed, lone)])
            if step == 0:
                nodes = datasets[0].stats()["nodes"]
                room = {n: v["capacity_rows"] - v["live_rows"]
                        for n, v in nodes.items()}
                fits = max(room, key=room.get)
                assert room[fits] > 0
                for ds in datasets:
                    assert grow(ds, fits, 1) is True
                    assert grow(ds, "CheckIn", room["CheckIn"] + 1) is False
        meshed.close()
        lone.close()
        launches = _platform.launch_counts()
        assert launches.get("node_fused", 0) > 0
        assert launches.get("panel_qr", 0) > 0
        assert calls == []
        for got, want in answers:
            for a, b in zip(got, want, strict=True):
                assert all(torch.equal(x, y) for x, y in zip(a, b))
    finally:
        dist.destroy_process_group()


def _lm_smoke(device, compute_dtype="float32", name="qwen3-8b"):
    """``name``'s smoke configuration and a model of it with seeded
    weights, made on the CPU and copied to ``device``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_config(name, smoke=True),
                              compute_dtype=compute_dtype)
    cpu = Transformer(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    model = Transformer(cfg, device=device)
    model.load_state_dict(cpu.state_dict())
    return cfg, model


def _cache_leaves(c):
    return [c["pos"]] + [leaf for sub in c["blocks"].values()
                         for leaves in sub.values()
                         for leaf in leaves.values()]


def _replay_vs_eager(cfg, model, prompt=17):
    """A `DecodeGraph` replay against the eager decode step from the same
    cache and tokens, three times: logits and every cache leaf bit for
    bit; capturing runs nothing. The prompts carry an encoder-decoder's
    frames or a patch config's patches (numpy, seeded)."""
    from repro_torch.train import serve

    prefill = serve.make_prefill(cfg, 40)
    decode = serve.make_decode_step(cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (3, prompt)))}
    if cfg.is_enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.encoder_len, cfg.d_model), np.float32))
    if cfg.patch_positions:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.patch_positions, cfg.d_model), np.float32))
    logits, cache = prefill(model, batch)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    logits, cache = decode(model, cache, tok)  # the eager warm-up step
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    snap = {"pos": cache["pos"].clone(), "blocks": {
        j: {kind: {n: leaf.clone() for n, leaf in leaves.items()}
            for kind, leaves in sub.items()}
        for j, sub in cache["blocks"].items()}}
    graph = serve.DecodeGraph(model, cfg, cache, tok)
    try:
        assert all(torch.equal(a, b) for a, b in zip(_cache_leaves(cache),
                                                     _cache_leaves(snap)))
        for _ in range(3):
            replayed = graph(tok).clone()
            eager, snap = decode(model, snap, tok)
            assert torch.equal(replayed, eager)
            assert all(torch.equal(a, b) for a, b in zip(
                _cache_leaves(cache), _cache_leaves(snap)))
            tok = eager.argmax(-1)[:, None].to(torch.int32)
        assert int(cache["pos"]) == cfg.patch_positions + prompt + 4
    finally:
        graph.close()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_replay_is_bit_equal_to_eager(compute_dtype):
    """A `DecodeGraph` replay against the eager decode step from the same
    cache and tokens: logits and every cache leaf bit for bit; capturing
    runs nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model = _lm_smoke("cuda", compute_dtype)
    _replay_vs_eager(cfg, model)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mixtral-8x22b", "arctic-480b",
                                  "rwkv6-1.6b", "jamba-v0.1-52b"])
def test_moe_and_ssm_decode_replay_is_bit_equal_to_eager(name,
                                                         compute_dtype):
    """The same through MoE layers (the routing's sort, capacity and
    scatter-adds on the device, no host read), mamba's conv and ssm states
    and rwkv's shift and wkv states, each written in place: a replay
    equals the eager step bit for bit. mixtral's smoke window of 8 slots
    is decoded past through the ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model = _lm_smoke("cuda", compute_dtype, name)
    _replay_vs_eager(cfg, model)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["whisper-tiny", "llava-next-34b"])
def test_enc_dec_and_patch_decode_replay_is_bit_equal_to_eager(
        name, compute_dtype):
    """The same over whisper-smoke's cross-attention, which reads the
    ``cross`` caches its prefill filled from the frames and writes nothing,
    and llava-smoke's cache, whose first 8 slots hold the patches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, model = _lm_smoke("cuda", compute_dtype, name)
    _replay_vs_eager(cfg, model)


def test_sample_loop_on_the_card_matches_the_cpu():
    """Greedy `sample_loop` on the card (one eager step, then replays)
    gives the CPU loop's tokens, and the card's teacher-forced logits are
    within float32's 1e-4 of max(1, max |logits|) of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.train import serve

    cfg, gpu = _lm_smoke("cuda")
    _, cpu = _lm_smoke("cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    steps, max_len = 10, 9 + 10 + 1
    want = serve.sample_loop(cpu, cfg, {"tokens": tokens}, steps=steps,
                             max_len=max_len, device="cpu")
    got = serve.sample_loop(gpu, cfg, {"tokens": tokens}, steps=steps,
                            max_len=max_len)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        logits, cache = serve.make_prefill(cfg, max_len, dev)(
            model, {"tokens": tokens})
        out = [logits.cpu()]
        for j in range(steps - 1):
            logits, cache = serve.make_decode_step(cfg, dev)(
                model, cache, want[:, j:j + 1])
            out.append(logits.cpu())
        if dev == "cpu":
            ref = torch.stack(out)
        else:
            assert _rel(torch.stack(out), ref) < 1e-4


@pytest.mark.parametrize("orthogonal", [False, True])
def test_train_step_on_the_card_matches_the_cpu(orthogonal):
    """One `make_train_step` step (qwen3 smoke, float32 compute, remat on)
    on the card and on the CPU from the same weights and tokens: the
    metrics within 1e-5 relative, the parameters and moments within rtol
    2e-4 and atol 2e-6 plus the gradient's tolerance carried through Adam
    (`_adam_hold.hold_adam_step`: 1e-6 of each leaf's largest, 4e-5 for
    the orthogonalized gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from _adam_hold import flat, hold_adam_step
    from repro_torch.models.weights import opt_state_to_numpy, params_to_numpy
    from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
    from repro_torch.train import TrainState, make_train_step

    opt = AdamWConfig(lr=warmup_cosine(3e-3, 1, 10))
    tokens = np.random.default_rng(3).integers(0, 512, (4, 32))
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, model = _lm_smoke(dev)
        cfg = dataclasses.replace(cfg, remat=True)
        state = TrainState(model=model, opt_state=adamw_init(model, opt),
                           step=torch.zeros((), dtype=torch.int32,
                                            device=dev))
        before = opt_state_to_numpy(state.opt_state, model)
        step = make_train_step(cfg, opt, orthogonal_update=orthogonal,
                               device=None if dev == "cuda" else "cpu")
        _, metrics = step(state, {"tokens": tokens})
        assert metrics["loss"].device.type == dev
        mom = opt_state_to_numpy(state.opt_state, model)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {"params": flat(params_to_numpy(model)),
                     "mu": flat(mom["mu"]), "nu": flat(mom["nu"])})
    (m_c, ref), (m_g, got) = out["cpu"], out["cuda"]
    for key, want in m_c.items():
        assert abs(m_g[key] - want) <= 1e-5 * abs(want), key
    hold_adam_step(got, {k: flat(before[k]) for k in ("mu", "nu")}, ref,
                   step=1, lr=m_c["lr"], b1=opt.b1, b2=opt.b2, eps=opt.eps,
                   tau=4e-5 if orthogonal else 1e-6, orthogonal=orthogonal)


def test_flash_branch_refuses_autograd_on_the_card():
    """The flash kernel writes an output autograd never sees: under
    autograd the branch raises on the card as on the CPU, and nothing
    falls back to _attend; `make_train_step` refuses the config."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg, model = _lm_smoke("cuda", "bfloat16")
    cfg = dataclasses.replace(cfg, use_flash_kernel=True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16))).cuda()
    _platform.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="no backward"):
        model.loss_fn({"tokens": tokens}, cfg)
    assert _platform.launch_counts().get("flash_attention", 0) == 0
    with pytest.raises(NotImplementedError, match="_attend"):
        make_train_step(cfg, AdamWConfig())
