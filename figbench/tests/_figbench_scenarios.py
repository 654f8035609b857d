"""Whole runs of the benchmark's cells on the CPU at a tiny size, some with a
fault planted in the port, printed one JSON line each.

    PYTHONPATH=src python figbench/tests/_figbench_scenarios.py [--cuda] SCENARIO...

A scenario is ``<cell>:<case>`` with ``case`` one of

- ``sound``: the port as it is;
- ``answer``: every R altered where it is produced (one entry of the top
  row moved by 1e-3 of the diagonal before the sign normalization);
- ``half``: in every batched dispatch of two or more requests, the second
  half of the batch answered from the first half's data;
- ``control``: the port in its next precision down (`run_cell`'s control).

Runs in a process of its own, so no test's imports (JAX among them) reach
the run, and prints the top-level names of the forbidden modules loaded at
the end. The run skips the harness's look for a card and runs on the CPU
(the kernels' plain versions), or with ``--cuda`` on the card.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: Sizes a CPU run holds; the schemas, widths and traffic are the cells'.
TINY = {"favorita": {"sales_rows": 800, "stores": 4, "items": 10,
                     "days": 12}}


def tiny_config(manifest, cell: str) -> dict:
    name = manifest.cell(cell)["config"]
    return dict(manifest.config(name), **TINY[name])


def _plant(case: str):
    """Plant ``case``'s fault; returns the undo."""
    from repro_torch.core import engine, postprocess

    if case == "answer":
        real = postprocess.normalize_sign

        def altered(r):
            r = r.clone()
            r[..., 0, -1] += 1e-3 * r[..., 0, 0].abs()
            return real(r)

        postprocess.normalize_sign = altered
        return lambda: setattr(postprocess, "normalize_sign", real)
    if case == "half":
        real = engine.FigaroEngine._dispatch

        def half(self, kind, plan, data, **kw):
            if kind.endswith("_batched") and data is not None:
                import torch

                leaves = [torch.as_tensor(d) for d in data]
                b = leaves[0].shape[0]
                if b >= 2:
                    h = b // 2
                    data = tuple(torch.cat([d[:b - h], d[:h]]) for d in leaves)
            return real(self, kind, plan, data, **kw)

        engine.FigaroEngine._dispatch = half
        return lambda: setattr(engine.FigaroEngine, "_dispatch", real)
    return lambda: None


def main(argv) -> int:
    from figbench.harness import forbidden_modules, run_cell
    from figbench.manifest import Manifest

    manifest = Manifest()
    device = "cpu"
    if argv and argv[0] == "--cuda":
        device, argv = "cuda", argv[1:]
    for scenario in argv:
        cell, case = scenario.split(":")
        undo = _plant(case)
        try:
            out = run_cell(cell, 20240601, 1.0, False, device=device,
                           control=case == "control", manifest=manifest,
                           config=tiny_config(manifest, cell),
                           log=lambda *a: None)
        finally:
            undo()
        print(json.dumps({"scenario": scenario, "correct": out["correct"],
                          "checks": out["checks"],
                          "attempted": out["attempted"]}), flush=True)
    print(json.dumps({"forbidden": forbidden_modules()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
