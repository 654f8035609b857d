#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the CUDA cards of this machine.

    python3 figbench/run.py --workload favorita.serve_qr --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The first line of standard output names the
card, the number of cards and the card's power limit; the last is the result,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` the ``breakdown`` of the traced window, and
last ``checks``, each compared number beside its limit. The same numbers are
the last lines of standard error.

Exits non-zero and prints no result where the machine has fewer CUDA cards
than the cell asks for, or where JAX or the JAX package (``repro``) was
loaded by the time the window closed. The kernels of the port are built on
the first run in a checkout, under ``build/`` there.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    import torch

    from figbench.harness import ImportBoundary, run_cell
    from figbench.manifest import Manifest

    manifest = Manifest(ROOT)
    chips = manifest.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"figbench: {args.workload} needs {chips} CUDA card(s), this "
              f"machine has {found}", file=sys.stderr)
        return 2
    print(f"figbench: card {torch.cuda.get_device_name(0)}, {found} "
          f"card(s), power limit {_power_limit()}", flush=True)

    def log(*parts):
        print(*parts, file=sys.stderr, flush=True)

    try:
        out = run_cell(args.workload, args.seed % (1 << 64), args.seconds,
                       bool(args.trace), device="cuda", t_start=_T0,
                       manifest=manifest, log=log)
    except ImportBoundary as e:
        log(f"figbench: {e}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
