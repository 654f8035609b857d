"""CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc; without them each test skips (the
decision is taken inside the test, never at import). On the machine with the
card, run them without the suite's conftest (which imports JAX)::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float64 1e-9 and float32 1e-5 (node_fused) / 1e-4 (panel_qr),
relative to max(1, |plain|) — the bounds the CPU suite holds the plain
versions to against the JAX package.
"""

import os
import shutil

import pytest
import torch

from repro_torch import figaro
from repro_torch.data.relational import yelp_like
from repro_torch.kernels import _platform
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
    e_k, s_k = nk.node_fused(*args)
    e_r, s_r = nr.node_fused_ref(*args)
    torch.cuda.synchronize()
    assert _rel(e_k, e_r) <= TOL[dtype]["nf"]
    assert _rel(s_k, s_r) <= TOL[dtype]["nf"]
    assert bool((e_k[:, dead] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,m,nb", [(7, 256, 32), (5, 70, 32), (3, 10, 16),
                                    (2, 5, 8)])
def test_panel_qr_kernel_matches_plain(dtype, b, m, nb):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m * nb)
    a = torch.randn(b, m, nb, generator=g, device="cuda", dtype=dtype)
    got = pk.panel_qr(a)
    want = pr.panel_qr_ref(a)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert _rel(x, y) <= TOL[dtype]["pq"]


def test_panel_qr_refuses_a_panel_too_large_for_shared_memory():
    _need_card()
    with pytest.raises(ValueError, match="shared memory"):
        pk.panel_qr(torch.zeros(1, 2048, 32, device="cuda",
                                dtype=torch.float64))


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
