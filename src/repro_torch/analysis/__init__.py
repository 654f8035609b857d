"""figaro-lint for the port: static analysis of the invariants `repro_torch`
lives or dies by.

The JAX package's `repro.analysis` (FIG001–FIG012) is written for JAX: its
dtype rule knows ``jax.numpy``, its trace rules start at ``jax.jit``,
``pallas_call`` and ``shard_map``, and most of its rules see nothing in the
port. The port's hazards are of its own: a CUDA graph replays what its
capture recorded, so an option its body reads but its key omits is a
silent wrong answer, and a host sync or a side effect inside a capture
fails, or runs once, on the card only — where the CPU suite never looks.
This package is the port's own copy of the framework (it imports nothing
of the JAX package) with the rules retargeted, each numbered after its JAX
counterpart:

  FGT002  graph-key        every option the engine's ``_body`` reads on a
                           kind's path is in ``_STATIC[kind]`` (the graph
                           key); so is every option ``_tail`` reads; every
                           ``_STATIC`` name is a keyword of the public
                           method that dispatches the kind
                           (FIG002 retrace-hazard)
  FGT003  dtype-drift      narrowing dtype literals (torch.float32/float16/
                           bfloat16/half/float) in core/ and kernels/
                           function bodies; any sub-f64 float in
                           core/counts.py (FIG003)
  FGT004  kernel-launch    wrappers choose plain or kernel through
                           `_platform.is_cpu` only; no try/except fallback
                           around a build, import or launch; no environment
                           switch in kernels/ or core/; no build or
                           ``import triton`` at module level
                           (FIG004 pallas-kernel)
  FGT005  lock-discipline  mutable attributes of lock-owning classes
                           (FigaroEngine, PlanHolder, AsyncFigaroServer,
                           the serving link) written outside a lock (FIG005)
  FGT006  thread-escape    shared mutable state read/mutated without the
                           owning lock from thread-reachable methods (FIG006)
  FGT007  san-routing      threads and locks not routed through the port's
                           sanitizer wrappers (FIG007)
  FGT008  import-boundary  no jax/jaxlib/repro import in repro_torch; the
                           planner imports no torch and nothing of the port
                           outside itself; the analysis imports the
                           standard library only (FIG008 jaxfree-planner)
  FGT009  capture-sync     .item()/.tolist()/.cpu()/.numpy()/int()/a tensor
                           as a condition/an info-checking torch.linalg
                           call on a device value, or a synchronize, inside
                           a CUDA-graph capture (figaro-flow: call graph +
                           dataflow fixpoint) (FIG009 host-sync)
  FGT010  capture-effects  self./global/closure writes, print, counter
                           bumps and draws from a global RNG inside a
                           capture, under a lock or not (the kernel
                           libraries' and the scan's memo caches and
                           `_platform.count_launch` exempted by name)
                           (FIG010 trace-effects)
  FGT011  donation         a request list read again after a dispatch of a
                           donating engine (FIG011)
  FGT012  slab-layout      symbolic proofs over the port's PlanSpec/
                           bucket_spec/SlabBand arithmetic (FIG012)

FIG001 compat-pin has no counterpart: the port has no ``compat.py``, since
it pins no JAX spellings (ROADMAP A14.6).

This lint stands alone and owns every check of the port: it needs nothing
of the JAX package, as the port does not, and goes on checking the port
without it. The JAX package's lint checks the JAX package. (Its own test,
`tests/test_analysis.py`, scans all of ``src/`` by its scope, so its
path-free rules FIG005, FIG006 and FIG012 read the port too while both
packages live side by side; FGT005, FGT006 and FGT012 are the port's
checks of record.)

FGT009 and FGT010 ride on **figaro-flow** (`repro_torch.analysis.callgraph`
+ `repro_torch.analysis.dataflow`): a whole-program call graph whose roots
are the callees of calls inside ``with torch.cuda.graph(...)`` (the
engine's ``_body``) and the callables handed to
``torch.cuda.make_graphed_callables``, and a per-function device-tensor
taint summary composed to a fixpoint. Inspect the classification with

    python -m repro_torch.analysis --report callgraph src/repro_torch

Pure stdlib `ast` — no torch, numpy or jax import — so it runs anywhere.
Every rule is scoped to ``repro_torch/`` paths. Run it from the repository
root with ``PYTHONPATH=src``; the tree must give no finding, with no
baseline:

    python -m repro_torch.analysis src/repro_torch

Suppress a deliberate violation on its own line, with a reason:

    x = t.item()  # figaro-lint: disable=FGT009 -- eager path only

or file-wide near the top of the module:

    # figaro-lint: disable-file=FGT003 -- a bf16 kernel's own table
"""

from .baseline import Baseline, load_baseline  # noqa: F401
from .callgraph import CallGraph, Program  # noqa: F401
from .dataflow import Dataflow  # noqa: F401
from .framework import (Finding, Rule, Severity, analyze_paths,  # noqa: F401
                        analyze_source, load_program)
from .imports import ImportGraph, unused_report  # noqa: F401
from .rules import all_rules  # noqa: F401

__all__ = ["Finding", "Rule", "Severity", "analyze_paths", "analyze_source",
           "all_rules", "Baseline", "load_baseline", "ImportGraph",
           "unused_report", "CallGraph", "Program", "Dataflow",
           "load_program"]
