"""Human-readable orientation ranking — backs ``JoinDataset.explain()``."""

from __future__ import annotations

from typing import Sequence

from .cost import OrientationCost

__all__ = ["explain_text"]


def explain_text(ranking: Sequence[OrientationCost],
                 chosen: str | None = None,
                 current: str | None = None) -> str:
    """Render a ranked orientation table plus the winner's node breakdown.

    ``chosen`` marks the planner's pick (``*``), ``current`` the orientation a
    live dataset is actually running (``=``) — they differ after appends shift
    the estimates but before an adaptive re-root lands.
    """
    if not ranking:
        return "no orientations to rank"
    lines = ["join-tree orientations, cheapest first "
             # the JAX package's exact wording: explain() reads the same
             # in both packages
             "(cost ~ element touches; see repro.planner.cost):"]
    width = max(len(oc.root) for oc in ranking)
    for i, oc in enumerate(ranking):
        marks = ("*" if oc.root == chosen else " ") + \
                ("=" if oc.root == current else " ")
        ratio = oc.total / ranking[0].total if ranking[0].total else 1.0
        lines.append(f"  {marks}{i + 1}. root={oc.root:<{width}}  "
                     f"cost={oc.total:>12.0f}  ({ratio:.2f}x)")
    best = ranking[0]
    lines.append(f"  per-node breakdown for root={best.root}:")
    for nc in best.nodes:
        role = "root" if nc.is_root else f"child of {best.parent[nc.name]}"
        lines.append(
            f"    {nc.name:<{width}}  m={nc.m:<8d} K={nc.K:<8d} "
            f"w={nc.width:<4d} first={nc.first_pass:<10.0f} "
            f"gather={nc.gather:<10.0f} project={nc.project:<10.0f} [{role}]")
    if chosen is not None:
        lines.append(f"  * = planner choice ({chosen})")
    if current is not None:
        lines.append(f"  = = currently running ({current})")
    return "\n".join(lines)
