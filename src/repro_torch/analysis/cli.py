"""The port's figaro-lint command line:
`python -m repro_torch.analysis [options] [paths...]`.

Exit status: 0 when every finding is baselined (or ``--warn-only``), 1 when
new findings exist, and 1 when the baseline has gone stale (entries whose
violation was fixed — a baseline must stay exact). The port's tree runs with
no baseline.

From the repository root, with ``PYTHONPATH=src``:

    python -m repro_torch.analysis src/repro_torch        # must print 0
    python -m repro_torch.analysis --json src/repro_torch # machine-readable
    python -m repro_torch.analysis --baseline FILE src/repro_torch
    python -m repro_torch.analysis --warn-only tools/     # advisory sweep
    python -m repro_torch.analysis --report unused        # import graph
    python -m repro_torch.analysis --report callgraph src/repro_torch
    python -m repro_torch.analysis --report callgraph --dot g.dot src/repro_torch
    python -m repro_torch.analysis --write-baseline FILE src/repro_torch
"""

from __future__ import annotations

import argparse
import json
import sys

from .baseline import empty_baseline, load_baseline, write_baseline
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
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write the current findings to FILE (keeping the "
                        "justifications of --baseline's entries that still "
                        "match) and exit 0")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--report", choices=("findings", "unused", "callgraph"),
                   default="findings",
                   help="findings (default), the unused-module report, or "
                        "the figaro-flow call graph with its capture roots "
                        "and captured/host classification")
    p.add_argument("--dot", metavar="FILE",
                   help="with --report callgraph: also write the graph as "
                        "Graphviz DOT to FILE")
    p.add_argument("--warn-only", action="store_true",
                   help="report findings but always exit 0")
    p.add_argument("--root", default=None,
                   help="directory findings' paths are relative to "
                        "(default: cwd)")
    p.add_argument("--src-root", default="src",
                   help="package root for --report unused (default: src)")
    return p


def _run_findings(args) -> int:
    findings = analyze_paths(args.paths or [_DEFAULT_PATH], rules=all_rules(),
                             root=args.root)
    baseline = load_baseline(args.baseline) if args.baseline \
        else empty_baseline()

    if args.write_baseline:
        write_baseline(args.write_baseline, findings, previous=baseline)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    new, baselined = baseline.split(findings)
    stale = baseline.stale(findings)

    if args.json:
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "baselined": len(baselined),
            "stale_baseline": [list(fp) for fp in stale],
        }, indent=2))
    else:
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
    if args.warn_only:
        return 0
    return 1 if (new or stale) else 0


def _run_unused(args) -> int:
    report = unused_report(src_root=args.src_root)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
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
    graph = load_program(args.paths or [_DEFAULT_PATH], root=args.root).graph
    if args.json:
        print(json.dumps(graph.to_json(), indent=2))
    else:
        print(graph.render_text())
    if args.dot:
        with open(args.dot, "w", encoding="utf-8") as fh:
            fh.write(graph.render_dot())
        if not args.json:
            print(f"-- DOT graph written to {args.dot}")
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
