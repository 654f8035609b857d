"""FGT009 — a host sync reachable from a CUDA-graph capture (the port's
counterpart of the JAX package's FIG009, whose regions are jit traces).

The engine captures its body into one CUDA graph per signature (`core/engine.py`,
``with torch.cuda.graph(...)``) and replays it after. A capture records
kernels; it does not run them. So a host read of a device value inside it
(``.item()``, ``.cpu()``, ``int(t)``, ``if t:``, a ``torch.linalg`` call
that checks its ``info`` on the host, ``torch.cuda.synchronize()``) either
fails the capture — on the card only, and only on the branch the capture
took — or reads a value the replays never update. The CPU suite never
captures a graph, so no CPU test can catch it, and the helper that syncs is
typically modules away from the ``with`` block.

This rule is purely a consumer of figaro-flow: `callgraph` marks the captured
region, `dataflow` runs the taint fixpoint and records every sink applied to
a device value (and every synchronize); each sink becomes a finding carrying
the root→site call chain as ``traced_context``.

Host values never fire: the root's static parameters, closure variables,
tensor metadata (``.shape``, ``.dtype``, ``.device``, ``.numel()``) and
``plan.spec`` are all concrete in the dataflow lattice.
"""

from __future__ import annotations

from typing import Iterator

from ..framework import FileContext, Finding, Rule, Severity, port_path


class CaptureSyncRule(Rule):
    rule_id = "FGT009"
    severity = Severity.ERROR
    fix_hint = ("compute the value before the capture (host side, from "
                "shapes or the plan), keep the captured path free of host "
                "reads, or use the `_ex` form of a torch.linalg call and "
                "check its info after the replay")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        return iter(())  # whole-program rule: see check_program

    def check_program(self, program) -> Iterator[Finding]:
        flow = program.dataflow()
        for sink in flow.sinks:
            fi = program.graph.functions[sink.qname]
            if port_path(fi.ctx.path) is None:
                continue
            full = program.captured_chain(sink.qname)
            chain = tuple(q.split(":", 1)[1] for q in full)
            root = program.graph.roots.get(full[0] if full else sink.qname)
            via = f" (captured via {' -> '.join(chain)})" if len(chain) > 1 \
                else ""
            kind = root.kind if root is not None else "cuda.graph"
            yield self.finding(
                fi.ctx, sink.node,
                f"`{sink.op}` on `{sink.expr}` inside `{fi.short}` — a host "
                f"sync reachable from a {kind} capture{via}",
                traced_context=chain)
