"""figaro-plan: cost-based join-tree orientation planning.

The paper's runtime hinges on which relation roots the join tree (Table 2
reports up to 394x between orientations of one schema), yet the result R0 is
orientation-invariant up to signs. This package picks the orientation for the
user:

  * `stats` — exact per-relation cardinalities, per-join-key distinct counts
    and fan-out estimates, collected at ingest and updated incrementally on
    append (pure numpy, never on the device).
  * `cost` — the paper's complexity model per rooted orientation: rotation
    work is Sum_i rows_i x carried-width_i, and only non-root nodes pay the
    second (projection) head/tail pass, which is what makes the root choice
    matter.
  * `orient` — enumerate every rooted orientation of the acyclic join graph,
    rank by estimated cost, `choose_root`.
  * `explain` — human-readable candidate ranking (backs `ds.explain()`).
  * `replan` — `Replanner`: tracks appended key volume and proposes a re-root
    when growth shifts the cost ranking past a hysteresis threshold.

Everything here is numpy + stdlib on purpose: planning runs at ingest time on
the host. The modules are copies of the JAX package's `repro.planner`, so the
port ranks orientations, picks roots and prints `explain()` exactly as the
reference does.
"""

from .cost import NodeCost, OrientationCost, orientation_cost, plan_cost
from .explain import explain_text
from .orient import (choose_root, enumerate_roots, orient_edges,
                     rank_orientations, validate_names)
from .replan import Replanner
from .stats import DatabaseStats, RelationStats, stats_for

__all__ = [
    "DatabaseStats",
    "RelationStats",
    "stats_for",
    "NodeCost",
    "OrientationCost",
    "orientation_cost",
    "plan_cost",
    "choose_root",
    "enumerate_roots",
    "orient_edges",
    "rank_orientations",
    "validate_names",
    "explain_text",
    "Replanner",
]
