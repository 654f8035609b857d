#!/usr/bin/env python3
"""The correctness check's control: the cell's answers one precision below
the configuration's, held to the same plain reference and limits. A sound
limit is one the control fails.

    python3 figbench/control.py --workload favorita.serve_qr --seeds 11,12,13 --seconds 5

Two controls, one JSON line each a seed:

- ``program``: the cell's timed path at its own size and load with the
  port's own next precision down switched on (TF32 matmuls for a float32
  cell, float32 for a float64 one);
- ``reference``: the reference put in the port's place, its Gram matrix made
  in TF32 (emulated: inputs rounded to TF32, float32 sums) for a float32
  cell and in float32 for a float64 one, and the answers worked out from it
  in float32. Where the port's lower precision does not reach the cell's
  path (no matmul a float32 TF32 switch could take), this is the control.

With ``--sound`` each seed's sound run of the port comes first, so one
process reads both. The benchmark's own runs (``run.py``) never run a
control.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def reference_control(manifest, cell: str, seed: int, device="cpu",
                      config=None) -> dict:
    """The reference control's numbers for ``cell`` on ``seed``."""
    import torch

    from figbench.data import feature_sets, make_tables
    from figbench.reference.checks import check_answer
    from figbench.reference.join import Join
    from figbench.reference.lower import answer_from_gram, tf32

    spec = manifest.cell(cell)
    config = config or manifest.config(spec["config"])
    traffic = manifest.traffic(spec["traffic"])
    limits = manifest.limits(cell)
    tables = make_tables(config, seed)
    join = Join(tables, config["root"], config["edges"], device=device)
    if "kind" in traffic:  # served: a feature set of the cell's own pool
        values = config["values"]
        leaves = feature_sets(tables, join.preorder, 1, seed, values["low"],
                              values["high"])[0]
        vals = dict(zip(join.preorder, leaves))
        calls = [{"kind": traffic["kind"]}]
    else:
        vals = {n: t.data for n, t in tables.items()}
        calls = traffic["calls"]
    ref = join.gram([vals])[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    low = join.gram([vals], dtype=torch.float32,
                    inputs=tf32 if traffic["dtype"] == "float32" else None)[0]
    label = config["label"]
    worst: dict = {}
    for call in calls:
        answer = answer_from_gram(call["kind"], *low, k=call.get("k"),
                                  label_col=join.columns.index(label))
        got = check_answer(call["kind"], answer, join.columns, join.columns,
                           ref, k=call.get("k"), label=label)
        for name, value in got.items():
            worst[name] = max(worst.get(name, 0.0), value)
    checks = {n: {"value": v, "limit": limits[n]} for n, v in worst.items()}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--sound", action="store_true")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from figbench.harness import run_cell
    from figbench.manifest import Manifest

    if not torch.cuda.is_available():
        print("figbench control: needs a CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)

    def log(*parts):
        print(*parts, file=sys.stderr, flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        for control in ([False, True] if args.sound else [True]):
            out = run_cell(args.workload, seed, args.seconds, False,
                           control=control, manifest=manifest, log=log)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "run": "program" if control else "sound",
                              "correct": out["correct"],
                              "attempted": out["attempted"],
                              "checks": out["checks"]}), flush=True)
        out = reference_control(manifest, args.workload, seed, device="cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "run": "reference", **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
