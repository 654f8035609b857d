"""The port's figaro-lint command line:
`python -m repro_torch.analysis [--baseline FILE] [--report R] [paths...]`.

Exit status: 0 when every finding is baselined, 1 when new findings exist,
and 1 when the baseline has gone stale (entries whose violation was fixed —
a baseline must stay exact). The port's tree runs with no baseline.

From the repository root, with ``PYTHONPATH=src``:

    python -m repro_torch.analysis src/repro_torch        # must print 0
    python -m repro_torch.analysis --report unused        # import graph
    python -m repro_torch.analysis --report callgraph src/repro_torch
"""

from __future__ import annotations

import argparse
import sys

from .baseline import empty_baseline, load_baseline
from .framework import analyze_paths, load_program
from .imports import unused_report
from .rules import all_rules

_DEFAULT_PATH = "src/repro_torch"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="figaro-lint for the port: AST checks of repro_torch's "
                    "graph-key/dtype/kernel/lock/capture invariants.")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to analyze (default: "
                        "src/repro_torch)")
    p.add_argument("--baseline", metavar="FILE",
                   help="accepted findings, each with its justification; "
                        "only findings NOT in it fail the run")
    p.add_argument("--report", choices=("findings", "unused", "callgraph"),
                   default="findings",
                   help="findings (default), the unused-module report, or "
                        "the figaro-flow call graph with its capture roots "
                        "and captured/host classification")
    return p


def _run_findings(args) -> int:
    findings = analyze_paths(args.paths or [_DEFAULT_PATH], rules=all_rules())
    baseline = load_baseline(args.baseline) if args.baseline \
        else empty_baseline()
    new, baselined = baseline.split(findings)
    stale = baseline.stale(findings)
    for f in new:
        print(f.render())
    if baselined:
        print(f"-- {len(baselined)} baselined finding(s) suppressed")
    for rule, path, message in stale:
        print(f"-- stale baseline entry (violation fixed — delete it): "
              f"{rule} {path}: {message}")
    print(f"figaro-lint: {len(new)} finding(s)"
          + (f", {len(stale)} stale baseline entr"
             + ("y" if len(stale) == 1 else "ies") if stale else ""))
    return 1 if (new or stale) else 0


def _run_unused(args) -> int:
    report = unused_report()
    print(f"import-graph roots: {', '.join(report['roots'])}")
    for cls in ("facade", "entrypoint", "external-only", "orphan"):
        mods = [m for m, i in report["modules"].items()
                if i["class"] == cls]
        if not mods:
            continue
        print(f"\n{cls} ({len(mods)}):")
        for m in mods:
            extra = ""
            if cls == "external-only":
                refs = report["modules"][m].get("referenced_by", [])
                extra = f"  <- {', '.join(refs[:2])}" + \
                        (" ..." if len(refs) > 2 else "")
            print(f"  {m}{extra}")
    orphans = report["orphans"]
    print(f"\n{len(orphans)} orphan module(s)"
          + (" — dead code, safe to delete" if orphans else ""))
    return 0


def _run_callgraph(args) -> int:
    print(load_program(args.paths or [_DEFAULT_PATH]).graph.render_text())
    return 0


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.report == "unused":
        return _run_unused(args)
    if args.report == "callgraph":
        return _run_callgraph(args)
    return _run_findings(args)


if __name__ == "__main__":
    sys.exit(main())
