#!/usr/bin/env python3
"""Where the time of the node pass's single-pass scan goes, on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/seg_scan_trace.py

Builds ``src/repro_torch/csrc/node_fused.cu`` with ``-DSEG_TRACE`` (the
package's nvcc flags otherwise) into ``build/seg_scan_trace/``: thread 0 of
every block then records the global timer at its start and after each phase
of its tile. Runs the node pass (``kernel.fused_node_pass``) at the shapes of
the nine passes of the main configuration at capacity
(``yelp_like(scale=4_000_000, cols=16)``: [m, n] and K slots, random
segments with K starts, every slot live, the masked first passes with a
data_scale of ones), in float32 and float64, and prints for each pass its
time with a contiguous destination, with a strided one (the band of a
[m, 35] buffer at column 3) and with whole rows of that buffer (the slab at
column 3, zeros in the rest, as R₀'s assembly has it), each the mean of 20
calls by CUDA events; its bytes bound for the slab alone and for whole rows
(inputs read once, outputs written once, 3.35 TB/s); and, for the
whole-rows call, the tiles' mean time per phase — drawing the tile
("ticket"), staging it ("stage"), the chunk sums and their scan ("scan"),
publishing the aggregate ("publish"), the look-back ("lookback"), the
rescan and epilogue ("emit") and the stores ("store") — with the launch's
span and the blocks resident at once. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
R0_COLS = 35  # N of the main configuration
# The main configuration's passes at capacity: (m, n, K, masked).
PASSES = [(8_388_608, 1, 8_388_608, True),    # Review (root): tails
          (524_288, 16, 524_288, True), (524_288, 16, 524_288, False),  # User
          (524_288, 16, 524_288, True), (524_288, 18, 524_288, False),  # Business
          (2_097_152, 1, 524_288, True), (524_288, 1, 524_288, False),  # Category
          (2_097_152, 1, 524_288, True), (524_288, 1, 524_288, False)]  # CheckIn
PHASES = ["ticket", "stage", "scan", "publish", "lookback", "emit", "store"]
MAX_TRACED = 1 << 16  # kMaxTraced


def case(m, n, k, masked, dtype, seed):
    """fused_node_pass arguments: k random segments over m rows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    cut = torch.randperm(m - 1, device=dev, generator=g)[:k - 1] + 1
    first = torch.zeros(m, dtype=torch.bool, device=dev)
    first[0] = True
    first[cut] = True
    seg = torch.cumsum(first.long(), 0) - 1
    starts = torch.nonzero(first).squeeze(1)
    pos = torch.arange(m, device=dev) - starts[seg]
    last = torch.cat([starts[1:], torch.tensor([m], device=dev)]) - 1
    live = torch.ones(k, dtype=torch.bool, device=dev)
    w = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    es = torch.rand(m, generator=g, device=dev, dtype=dtype) + 0.5
    ds = torch.ones(m, device=dev, dtype=dtype) if masked else None
    data = torch.randn(1, m, n, generator=g, device=dev, dtype=dtype)
    return (data, w, pos, es, last, live), ds


def bound_ms(m, n, k, masked, item, width) -> float:
    """Bytes of one pass writing rows ``width`` wide
    (`chip_smoke.node_pass_cost`) over 3.35 TB/s."""
    rows = m * ((3 if masked else 2) * item + 8)
    slots = k * (8 + 1 + item + n * item)
    return ((m * n + m * width) * item + rows + slots) / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, reps=20) -> float:
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


def main(argv=None) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("seg_scan_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build, _seg_scan
    from repro_torch.kernels.node_fused import kernel as nk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    out = REPO / "build" / "seg_scan_trace" / "libnode_fused_trace.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    built = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DSEG_TRACE", "-o", str(out),
         str(_build._CSRC / "node_fused.cu")], capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(out))
    lib.nf_trace_copy.argtypes = [ctypes.c_void_p]
    lib.nf_trace_copy.restype = ctypes.c_int
    _build._libs[nk.NAME] = lib  # the traced build serves the wrapper
    trace = np.zeros(MAX_TRACED * 8, dtype=np.uint64)
    for dtype in (torch.float32, torch.float64):
        item = dtype.itemsize
        totals = [0.0] * 5
        for i, (m, n, k, masked) in enumerate(PASSES):
            args, ds = case(m, n, k, masked, dtype, i)
            rows = torch.empty(1, m, R0_COLS, device="cuda", dtype=dtype)
            contiguous = cuda_ms(lambda: nk.fused_node_pass(
                *args, data_scale=ds))
            strided = cuda_ms(lambda: nk.fused_node_pass(
                *args, data_scale=ds, out=rows[..., 3:3 + n]))
            whole = cuda_ms(lambda: nk.fused_node_pass(
                *args, data_scale=ds, out=rows, out_col=3))
            bnd = bound_ms(m, n, k, masked, item, n)
            bnd_rows = bound_ms(m, n, k, masked, item, R0_COLS)
            for at, v in enumerate((contiguous, strided, whole, bnd,
                                    bnd_rows)):
                totals[at] += v
            check = lib.nf_trace_copy(ctypes.c_void_p(trace.ctypes.data))
            if check != 0:
                raise RuntimeError(f"nf_trace_copy failed: CUDA error {check}")
            g = _seg_scan.geometry(n, item, "pass")
            tiles = min(MAX_TRACED, -(-m // g.tile_rows))
            t = trace.reshape(MAX_TRACED, 8)[:tiles].astype(np.int64)
            marks = t[:, [7, 0, 1, 2, 3, 4, 5, 6]]
            phases = np.diff(marks, axis=1).mean(axis=0) / 1e3
            span = (marks[:, -1].max() - marks[:, 0].min()) / 1e3
            busy = (marks[:, -1] - marks[:, 0]).sum() / 1e3
            print(f"{str(dtype)[6:]} [{m}, {n}] K {k}: contiguous "
                  f"{contiguous:.4f} ms, strided {strided:.4f} ms, whole rows "
                  f"{whole:.4f} ms, bound {bnd:.4f} ms (whole rows "
                  f"{bnd_rows:.4f}); {tiles} tiles of {g.tile_rows} rows, span "
                  f"{span:.1f} us, {busy / span:.1f} blocks at once; per tile "
                  + " ".join(f"{name} {v:.2f}"
                             for name, v in zip(PHASES, phases)) + " us",
                  flush=True)
        print(f"{str(dtype)[6:]} nine passes: contiguous {totals[0]:.4f} ms, "
              f"strided {totals[1]:.4f} ms, whole rows {totals[2]:.4f} ms, "
              f"bound {totals[3]:.4f} ms (whole rows {totals[4]:.4f})",
              flush=True)
    _seg_scan.check()
    return 0


if __name__ == "__main__":
    sys.exit(main())
