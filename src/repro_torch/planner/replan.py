"""Adaptive re-rooting policy: when appends shift the cost ranking, propose
a better root — with hysteresis so alternating appends cannot flap.

The policy is deliberately plain host Python: the facade consults it
after each append, outside any trace. It owns the *decision* only; the
mechanics of swapping the live plan (drain the async servers, rebuild, install)
belong to `repro_torch.api.JoinDataset` + `repro_torch.core.plan_cache.PlanHolder`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .cost import OrientationCost, orientation_cost
from .orient import enumerate_roots
from .stats import DatabaseStats

__all__ = ["Replanner"]


@dataclasses.dataclass
class Replanner:
    """Tracks exact stats under appends and proposes hysteresis-gated re-roots.

    ``hysteresis`` is the relative margin the challenger must win by:
    a re-root is proposed only when ``best.total * (1 + hysteresis) <
    current.total``. After a switch the old root would itself need to get
    ``(1 + hysteresis)`` cheaper again to win back, so two orientations whose
    costs oscillate by less than the margin settle on one of them instead of
    flapping (asserted in tests/test_planner.py and tests/test_torch_planner.py).
    """

    stats: DatabaseStats
    names: tuple[str, ...]
    edges: tuple[tuple[str, str], ...]
    current_root: str
    hysteresis: float = 0.5
    appended_rows: dict[str, int] = dataclasses.field(default_factory=dict)

    def note_append(self, name: str, keys: np.ndarray) -> None:
        """Fold an append's key rows into the stats (exactly, incrementally)."""
        keys = np.asarray(keys)
        rows = 1 if keys.ndim == 1 else int(keys.shape[0])
        self.appended_rows[name] = self.appended_rows.get(name, 0) + rows
        self.stats.update(name, keys)

    def ranking(self) -> list[OrientationCost]:
        ranked = [orientation_cost(self.stats, parent)
                  for _, parent in enumerate_roots(self.names, self.edges)]
        ranked.sort(key=lambda oc: (oc.total, oc.root))
        return ranked

    def proposal(self) -> str | None:
        """Root to re-root onto, or None to stay put."""
        ranked = self.ranking()
        best = ranked[0]
        if best.root == self.current_root:
            return None
        current = next(oc for oc in ranked if oc.root == self.current_root)
        if best.total * (1.0 + self.hysteresis) < current.total:
            return best.root
        return None

    def on_reroot(self, root: str) -> None:
        """Record that the dataset now runs rooted at ``root``."""
        self.current_root = root
