#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py                 # the full run: exit 0 = all checks passed
    python3 chip_smoke.py --scale 40000   # a smaller database, for a quick look

Phases (any failure raises and the script exits non-zero, printing no
result line):

  1. card     — the card's name and power limit (nvidia-smi), torch and CUDA
                versions; TF32 off for matmuls and cuDNN.
  2. build    — builds every CUDA kernel of the path from ``src/repro_torch/
                csrc`` (one nvcc per source, in parallel) and prints the time.
  3. kernels  — each kernel against its plain PyTorch version on the card, in
                float32 and float64: node_fused on random segments that
                straddle its tiles, with dead rows; then every node_fused and
                panel_qr call of one ``qr`` dispatch of the configuration
                below, captured with its real inputs (the TSQR leaf panels
                [B, 256, 32] cut from that configuration's R₀ among them),
                each timed beside its plain version and, for panel_qr, beside
                ``torch.geqrf`` on the same panels. panel_qr is held to its
                plain version on RᵀR and, for V and beta, to the
                factorization they define (see `reflector_error`).
  4. main     — ``yelp_like(scale=4_000_000, cols=16)``: Review 8 M rows,
                N = 35 columns, R₀ ≈ 2.4·10⁷ rows at bucketed capacity. The
                plan is built on the host (timed), then
                ``Session(use_kernel=True, assembly="band", device="cuda")``
                runs qr (float32) and svd, pca(k=8), least_squares (float64),
                each timed as the median of 3 after one warm-up. The launch
                counters are zeroed just before and read just after; every
                kernel must have launched. R is checked against the same
                session with ``use_kernel=False`` on the card (float64,
                after normalize_sign), and R₀ᵀR₀ against AᵀA of the
                materialized join of ``yelp_like(scale=400, cols=3)``.
                Last, torch.profiler's device time by kernel for one call
                each of qr, svd and the unfused qr, with the device's busy
                share of the call.
  5. summary  — one ``{"kernels": [...]}`` line, then, last, the
                ``{"ok": true, "device": {...}}`` line.

Tolerances (float64 against the plain version or the unfused path):
relative 1e-9 of the largest magnitude compared — the JAX package's own
kernel-vs-XLA bound (tests/test_kernel_path.py:30) scaled to these values;
float32: node_fused 1e-5 and panel_qr 1e-4 relative (the JAX package's
recorded float32 gaps are 9.5e-7 and 2.5e-5).

Bounds: ``bound_ms`` is the larger of the bytes each call must move (inputs
read once, outputs written once) over 3.35 TB/s and its floating-point
operations over the H100 SXM's peak for the type without tensor cores
(67 TFLOP/s float32, 34 TFLOP/s float64; NVIDIA's data sheet).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
TOL = {("node_fused", "float32"): 1e-5, ("node_fused", "float64"): 1e-9,
       ("panel_qr", "float32"): 1e-4, ("panel_qr", "float64"): 1e-9}
REPS = 3  # timed runs after one warm-up
REPLACES = {"node_fused": "src/repro/kernels/node_fused/kernel.py:130",
            "panel_qr": "src/repro/kernels/panel_qr/kernel.py:71"}


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max(1, max |want|))."""
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    scale = max(1.0, float(want.double().abs().max())) if want.numel() \
        else 1.0
    return err, err / scale


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn, reps: int = 3):
    """(last output, median seconds, all seconds, warm-up seconds) of ``fn``
    after one warm-up, each run ended by a synchronize."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), times, warm


# -- phase 1 ------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(_build.SOURCES)}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# -- phase 3 ------------------------------------------------------------------

def node_fused_cost(args) -> tuple[int, int]:
    """(bytes, flops) one node_fused call needs: data and five row vectors
    (plus the 1-byte flags) read once, two outputs written once; ~8 flops
    per element (mask, weight, scan add, two coefficient products, a
    difference, a sum and the emit scale)."""
    data = args[0]
    m = data.shape[-2]
    item = data.element_size()
    return 3 * data.numel() * item + m * (5 * item + 1), 8 * data.numel()


def panel_qr_cost(a) -> tuple[int, int]:
    """(bytes, flops) of one panel_qr call: A read once, V and R written
    once, beta written once; per Householder step k on an m×nb panel, the
    norm, the reflector and v'v (~5(m−k)), w = v'A and the rank-1 update
    (4(m−k)(nb−k))."""
    m, nb = a.shape[-2:]
    batch = a.numel() // max(m * nb, 1)
    item = a.element_size()
    flops = sum(5 * (m - k) + 4 * (m - k) * (nb - k)
                for k in range(min(m, nb)))
    return (3 * a.numel() + batch * nb) * item, batch * flops


def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_segments(m, n, batch, dtype, seed):
    """node_fused inputs with random short segments and dead rows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    first = torch.rand(m, generator=g, device=dev) < 0.02
    first[0] = True
    dead = (torch.rand(m, generator=g, device=dev) < 0.1) & ~first
    w = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    w[dead] = 0
    ds = (~dead).to(dtype)
    ca = torch.rand(m, generator=g, device=dev, dtype=dtype)
    cb = -w * torch.rand(m, generator=g, device=dev, dtype=dtype)
    es = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    data = torch.rand(batch, m, n, generator=g, device=dev,
                      dtype=dtype) * 2 - 1
    return [data, ds, w, first, ca, cb, es], dead


def check_random_segments():
    import torch
    from repro_torch.kernels.node_fused import kernel as nk, ref as nr

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        for (m, n, batch) in [(3_000_017, 1, 1), (1_000_003, 3, 2),
                              (200_001, 35, 1)]:
            args, dead = random_segments(m, n, batch, dtype, seed=m + n)
            e_k, s_k = nk.node_fused(*args)
            e_r, s_r = nr.node_fused_ref(*args)
            torch.cuda.synchronize()
            err = max(rel_err(e_k, e_r)[1], rel_err(s_k, s_r)[1])
            dead_max = float(e_k[:, dead].abs().max()) if bool(dead.any()) \
                else 0.0
            tol = TOL[("node_fused", name)]
            log(f"node_fused random segments {name} [{batch}, {m}, {n}]: "
                f"rel err {err:.3e} (tol {tol:g}), dead rows max "
                f"{dead_max:g}")
            check(err <= tol, f"node_fused {name} random segments")
            check(dead_max == 0.0, "node_fused dead rows exactly zero")


class Capture:
    """Records the inputs of every kernel-wrapper call while active."""

    def __init__(self):
        from repro_torch.kernels.node_fused import ops as nf_ops
        from repro_torch.kernels.panel_qr import ops as pq_ops

        self._mods = [(nf_ops, "node_fused"), (pq_ops, "panel_qr")]
        self.calls: dict[str, list] = {"node_fused": [], "panel_qr": []}

    def __enter__(self):
        self._saved = []
        for mod, name in self._mods:
            real = getattr(mod, name)
            self._saved.append((mod, name, real))

            def hook(*args, _real=real, _name=name):
                self.calls[_name].append([a.clone() for a in args])
                return _real(*args)

            setattr(mod, name, hook)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)


def reflector_error(a, v, beta, r, chunk: int = 8192) -> float:
    """How far the kernel's reflectors are from a valid factorization of
    ``a``: the larger of max |Qᵀ·A − R| / max(1, max |A|), with Q = H₁…H_nb
    rebuilt from (V, beta) in compact-WY form, and max |β·vᵀv − 2| over the
    reflectors with β ≠ 0 (each H = I − β·v·vᵀ orthogonal). In float64,
    over the batch in chunks."""
    from repro_torch.core.postprocess import _apply_wy, _panel_to_wy

    m, nb = a.shape[-2:]
    a, v, r = (x.reshape(-1, m, nb) for x in (a, v, r))
    beta = beta.reshape(-1, nb)
    worst = 0.0
    for lo in range(0, a.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        ac, vc, bc, rc = (x[sl].double() for x in (a, v, beta, r))
        qa = _apply_wy(ac, vc, _panel_to_wy(vc, bc))
        scale = max(1.0, float(ac.abs().max()))
        orth = (bc * (vc * vc).sum(dim=-2) - 2).abs() * (bc != 0)
        worst = max(worst, float((qa - rc).abs().max()) / scale,
                    float(orth.max()))
    return worst


def gram(r):
    """RᵀR in float64: the part of a QR factorization that is unique."""
    r = r.double()
    return r.mT @ r


def measure_path_kernels(calls, dtype: str, reps: int = 5) -> dict:
    """Kernel vs plain version (and library) over every captured call of one
    dispatch: the max errors and the summed times and bounds.

    node_fused: both outputs elementwise. panel_qr: RᵀR against the plain
    version's, and V and beta by `reflector_error`. R, V and beta are not
    compared elementwise at these inputs: R is unique only for a panel of
    full column rank, and TSQR leaves are not (one user's carried head
    repeats over all of that user's review rows, so a leaf's user block has
    rank ≤ the users in it). There a reflector is formed from roundoff and
    two correct factorizations differ in V, beta and whole rows of R, while
    RᵀR = AᵀA holds for both."""
    import torch
    from repro_torch.kernels.node_fused import kernel as nk, ref as nr
    from repro_torch.kernels.panel_qr import kernel as pk, ref as pr

    out = {}
    for name, kern, plain in (("node_fused", nk.node_fused,
                               nr.node_fused_ref),
                              ("panel_qr", pk.panel_qr, pr.panel_qr_ref)):
        err_abs = err_rel = refl = ms = plain_ms = lib_ms = b_ms = 0.0
        nbytes = flops = 0
        shapes = []
        for args in calls[name]:
            got = kern(*args)
            if name == "panel_qr":
                refl = max(refl, reflector_error(args[0], *got))
                got = got[2:]
            want = plain(*args)
            if name == "panel_qr":
                want = want[2:]
                got, want = [gram(got[0])], [gram(want[0])]
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                e_abs, e_rel = rel_err(g, w)
                err_abs, err_rel = max(err_abs, e_abs), max(err_rel, e_rel)
            del got, want
            ms += cuda_ms(lambda: kern(*args), reps)
            plain_ms += cuda_ms(lambda: plain(*args), 1)
            if name == "panel_qr":
                lib_ms += cuda_ms(lambda: torch.geqrf(args[0]), 1)
                cb, cf = panel_qr_cost(args[0])
            else:
                cb, cf = node_fused_cost(args)
            nbytes += cb
            flops += cf
            b_ms += bound_ms(cb, cf, dtype)[0]
            shapes.append(list(args[0].shape))
            torch.cuda.empty_cache()
        tol = TOL[(name, dtype)]
        what = "R'R" if name == "panel_qr" else "outputs"
        log(f"{name} {dtype}: {len(shapes)} calls per qr dispatch, largest "
            f"{max(shapes, key=math.prod)}; {what} vs plain: max abs err "
            f"{err_abs:.3e}, relative {err_rel:.3e} (tol {tol:g})"
            + (f"; reflectors {refl:.3e} (tol {tol:g})"
               if name == "panel_qr" else "")
            + f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            + (f", torch.geqrf {lib_ms:.3f} ms" if name == "panel_qr" else "")
            + f", bound {b_ms:.3f} ms ({bound_ms(nbytes, flops, dtype)[1]})")
        check(err_rel <= tol, f"{name} {dtype} against its plain version")
        check(refl <= tol, f"{name} {dtype} reflectors factor the panels")
        out[name] = {"calls": len(shapes), "shapes": shapes,
                     "max_abs_err": err_abs, "max_rel_err": err_rel,
                     "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms if name == "panel_qr" else None,
                     "bound_ms": b_ms,
                     "bound_by": bound_ms(nbytes, flops, dtype)[1]}
    return out


# -- phase 4 ------------------------------------------------------------------

def profile_once(label: str, fn) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of that call's wall time (kernels and copies on
    the one stream, summed; they do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Command Buffer")]
    attr = "self_device_time_total" if kernels and hasattr(
        kernels[0], "self_device_time_total") else "self_cuda_time_total"
    device_us = sum(getattr(e, attr) for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"profile {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{device_us / 1e3:.1f} ms ({100 * device_us / wall_us:.1f}%) over "
        f"{launches} kernels and copies")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:12]:
        log(f"  {getattr(e, attr) / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def gram_check_small(torch_dtype):
    import torch
    from repro_torch import figaro
    from repro_torch.core.materialize import materialize_join
    from repro_torch.data.relational import yelp_like

    tree = yelp_like(scale=400, cols=3)
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda")
    r0 = sess.r0(tree, dtype=torch_dtype)
    a = torch.as_tensor(materialize_join(tree), device="cuda",
                        dtype=torch_dtype)
    gram = a.T @ a
    err, rel = rel_err(r0.T @ r0, gram)
    log(f"small tree yelp_like(400, cols=3): join {a.shape[0]} rows, "
        f"R0'R0 vs A'A max abs err {err:.3e}, relative {rel:.3e} (tol 1e-9)")
    check(rel <= 1e-9, "R0'R0 == A'A on the small tree")
    return rel


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=4_000_000,
                        help="yelp_like scale (default: 4,000,000)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import figaro
    from repro_torch.core.join_tree import build_plan
    from repro_torch.core.postprocess import normalize_sign
    from repro_torch.data.relational import yelp_like
    from repro_torch.kernels import _platform

    t_start = time.perf_counter()
    log("== phase 1: card")
    phase_card()
    log("== phase 2: build")
    phase_build()

    log("== phase 3: kernels against their plain versions")
    check_random_segments()
    t0 = time.perf_counter()
    tree = yelp_like(scale=args.scale, cols=16)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(tree)
    t_plan = time.perf_counter() - t0
    spec = plan.spec
    log(f"host: yelp_like(scale={args.scale}, cols=16) generated in "
        f"{t_gen:.2f} s, plan built in {t_plan:.2f} s; N = {spec.num_cols}, "
        f"exact R0 rows {spec.r0_rows}")
    for sp in spec.nodes:
        log(f"  {sp.name}: m={sp.m} n={sp.n} K={sp.K} P={sp.P}")
    sess = figaro.Session(use_kernel=True, assembly="band", device="cuda")
    plain = figaro.Session(use_kernel=False, device="cuda")
    per_dtype = {}
    for torch_dtype in (torch.float32, torch.float64):
        name = str(torch_dtype).split(".")[1]
        t0 = time.perf_counter()
        with Capture() as cap:
            sess.qr(plan, dtype=torch_dtype)
            torch.cuda.synchronize()
        log(f"captured one {name} qr dispatch in "
            f"{time.perf_counter() - t0:.2f} s (first call: host bucketing "
            f"and H2D included for float32)")
        per_dtype[name] = measure_path_kernels(cap.calls, name)
        del cap
        torch.cuda.empty_cache()
    cap_plan = plan.__dict__["_capacity_plan"]
    log(f"capacity R0: {cap_plan.spec.r0_rows} rows x {spec.num_cols}")

    log("== phase 4: main path")
    _platform.reset_launch_counts()
    r32, t_qr, ts_qr, w_qr = wall(lambda: sess.qr(plan), REPS)
    (s, vt), t_svd, ts_svd, w_svd = wall(lambda: sess.svd(plan), REPS)
    pca, t_pca, ts_pca, w_pca = wall(lambda: sess.pca(plan, k=8), REPS)
    (beta, resid), t_lsq, ts_lsq, w_lsq = wall(
        lambda: sess.least_squares(plan, 0), REPS)
    launches = _platform.launch_counts()
    log(f"launch counts over the main path: {launches}")
    for kname in REPLACES:
        check(launches.get(kname, 0) > 0, f"{kname} launched on the path")
    _platform.reset_launch_counts()
    sess.qr(plan)
    torch.cuda.synchronize()
    per_qr = _platform.launch_counts()
    log(f"launches per qr dispatch: {per_qr}")
    n = spec.num_cols
    for label, tm, ts, w in (("qr float32", t_qr, ts_qr, w_qr),
                             ("svd float64", t_svd, ts_svd, w_svd),
                             ("pca(k=8) float64", t_pca, ts_pca, w_pca),
                             ("least_squares float64", t_lsq, ts_lsq,
                              w_lsq)):
        log(f"{label}: median {tm * 1e3:.1f} ms of "
            f"{[round(x * 1e3, 1) for x in ts]} ms (warm-up "
            f"{w * 1e3:.1f} ms)")
    check(r32.shape == (n, n) and r32.dtype == torch.float32,
          "qr shape/dtype")
    check(bool(torch.isfinite(r32).all()), "qr finite")
    check(s.shape == (n,) and vt.shape == (n, n) and
          bool(torch.isfinite(s).all()), "svd shape/finite")
    check(pca.components.shape == (8, n) and
          bool(torch.isfinite(pca.components).all()), "pca shape/finite")
    check(beta.shape == (n - 1,) and bool(torch.isfinite(beta).all())
          and bool(torch.isfinite(resid)), "lsq shape/finite")

    r_k = sess.qr(plan, dtype=torch.float64)
    t0 = time.perf_counter()
    r_p = plain.qr(plan, dtype=torch.float64)
    torch.cuda.synchronize()
    t_plain_qr = time.perf_counter() - t0
    err_abs, err_rel = rel_err(normalize_sign(r_k), normalize_sign(r_p))
    log(f"R (kernel path) vs R (use_kernel=False), float64 on the card: max "
        f"abs err {err_abs:.3e}, relative {err_rel:.3e} (tol 1e-9); the "
        f"unfused qr took {t_plain_qr * 1e3:.1f} ms")
    check(err_rel <= 1e-9, "kernel-path R matches the unfused path")
    err32 = rel_err(gram(r32), gram(r_k))[1]
    log(f"float32 R'R vs float64 R'R: relative {err32:.3e} (tol 1e-4)")
    check(err32 <= 1e-4, "float32 R within float32 accuracy of float64 R")
    s_p, _ = plain.svd(plan)
    s_rel = rel_err(s, s_p)[1]
    log(f"singular values vs unfused path: relative {s_rel:.3e}")
    check(s_rel <= 1e-9, "singular values match the unfused path")
    gram_rel = gram_check_small(torch.float64)
    profile_once("qr float32", lambda: sess.qr(plan))
    profile_once("svd float64", lambda: sess.svd(plan))
    profile_once("qr float64, use_kernel=False",
                 lambda: plain.qr(plan, dtype=torch.float64))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; elapsed {time.perf_counter() - t_start:.1f} s")

    log("== phase 5: summary")
    kernels = []
    for kname in REPLACES:
        f32, f64 = per_dtype["float32"][kname], per_dtype["float64"][kname]
        entry = {"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{kname}.cu",
                 "replaces": REPLACES[kname],
                 "launches": launches.get(kname, 0),
                 "launches_per_qr": per_qr.get(kname, 0),
                 "dtype": "float32",
                 "max_abs_err": f32["max_abs_err"],
                 "max_err": f32["max_abs_err"],
                 "max_rel_err": f32["max_rel_err"],
                 "ms": f32["ms"], "kernel_ms": f32["ms"],
                 "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                 "bound_by": f32["bound_by"],
                 "library_ms": f32["library_ms"],
                 "float64": {k: f64[k] for k in ("max_abs_err",
                                                 "max_rel_err", "ms",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
        kernels.append(entry)
    log(json.dumps({"main_path_ms": {"qr_f32": t_qr * 1e3,
                                     "svd_f64": t_svd * 1e3,
                                     "pca_f64": t_pca * 1e3,
                                     "lsq_f64": t_lsq * 1e3},
                    "plan_build_s": t_plan, "scale": args.scale,
                    "r_rel_err_vs_unfused": err_rel,
                    "small_gram_rel_err": gram_rel}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
