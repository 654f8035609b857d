#!/usr/bin/env python3
"""Where the time of panel_qr's grid variant goes, pass by pass, on the card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 tools/panel_qr_grid_trace.py              # full-scale R0
    python3 tools/panel_qr_grid_trace.py --rows 335872

Builds ``src/repro_torch/csrc/panel_qr.cu`` with ``-DPQ_TRACE`` (the
package's nvcc flags otherwise) into ``build/panel_qr_trace/``: CTA 0 of the
grid variant then records the global timer after each phase of a launch.
Factors the two panels of the tall path's ``blocked_qr_r`` on a random
float64 R₀-like matrix [rows, 35] (columns 0–31, then 32–34 of the rows
below 32, in place, as the path does) and prints, for each panel, the
launch's time split by phase — the steps' reductions ("scalars"), their
passes over the rows ("pass"), an inner block's closing pass
("block end"), its reduction and T_b ("block sums"), its compact-WY update
of the columns to its right ("trail"), the waits at the grid barriers
("sync") and T ("T") — and, with ``--steps``, every step's line. The times
are CTA 0's view, read after the second of two launches. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PHASES = {1: "scalars", 2: "pass", 6: "block end", 3: "sync", 4: "block sums",
          5: "trail", 9: "sync"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=24_117_248,
                        help="rows of R0 (default: the yelp configuration's "
                        "capacity, 24,117,248)")
    parser.add_argument("--steps", action="store_true",
                        help="print every step of the 32-column panel")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("panel_qr_grid_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.panel_qr import kernel as pk

    out = REPO / "build" / "panel_qr_trace" / "libpanel_qr_trace.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    built = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DPQ_TRACE", "-o", str(out),
         str(_build._CSRC / "panel_qr.cu")], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(out))
    _build._libs["panel_qr"] = lib  # the wrapper launches the traced build
    lib.pq_trace_read.argtypes = [ctypes.c_void_p]
    lib.pq_trace_read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 1024)()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())

    g = torch.Generator(device="cuda").manual_seed(args.rows)
    r0 = torch.randn(1, args.rows, 35, generator=g, device="cuda",
                     dtype=torch.float64)
    for lo, hi in ((0, 32), (32, 35)):
        panel = r0[:, lo:, lo:hi]
        for _ in range(2):
            pk.panel_qr_wy(panel)
            torch.cuda.synchronize()
        if lib.pq_trace_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("pq_trace_read failed")
        marks = []
        for i in range(512):
            marks.append((buf[2 * i], buf[2 * i + 1]))
            if buf[2 * i] == 9999:
                break
        by_phase: dict[str, float] = {}
        lines = []
        for (_, t_prev), (label, t) in zip(marks, marks[1:]):
            name = "T" if label == 9999 else PHASES[label % 100]
            step = label // 100 - 1
            us = (t - t_prev) / 1e3
            by_phase[name] = by_phase.get(name, 0.0) + us
            lines.append(f"  step {step:3d} {name:10s} {us:10.1f} us")
        total = (marks[-1][1] - marks[0][1]) / 1e3
        shape = pk.grid_shape(1, panel.shape[1], hi - lo, torch.float64)
        print(f"panel [1, {panel.shape[1]}, {hi - lo}] float64, {shape['per']}"
              f" CTAs: {total:.1f} us; "
              + ", ".join(f"{k} {v:.1f}" for k, v in by_phase.items()))
        if args.steps and hi - lo == 32:
            print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
