"""Batched group-by count queries over the join tree (paper §5, Algorithm 1).

Computes, for every node ``i`` of the join tree:

  Φ↓_i(x̄_p)  join size of S_i's subtree, grouped by the parent-shared key
  Φ↑_i(x̄_p)  join size of everything *outside* S_i's subtree
  Φ°_i(x̄_i)  join size of all relations except S_i, grouped by X̄_i

in two passes (bottom-up, then top-down), linear time. Every accumulation is
an ``index_add_`` / gather over the plan's index tensors on the device.

Counts can exceed 2^31 quickly (they multiply along the tree), so they are
computed in floating point of a configurable dtype; sqrt of the counts is what
FiGaRo actually consumes. The default is float64: float32 is exact only up to
2^24, beyond which the full-join sizes round and ``phi_circ`` (= full / rpk)
silently corrupts the emission scaling. A numpy int64 reference lives in
`compute_counts_reference` for exactness tests.

Capacity-padded (masked) plans — see `repro_torch.core.plan_cache` — carry
group slots with ``group_count == 0``; their counts are identically zero, and
every division below is guarded so 0/0 resolves to 0 instead of NaN. For exact
plans all denominators are >= 1, so the guards are value-neutral.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._platform import resolve_device

from .join_tree import FigaroPlan

__all__ = ["NodeCounts", "compute_counts", "compute_counts_reference"]


class NodeCounts(dict):
    """Per-node aggregate bundle: keys rpk, theta_down, phi_down, full, phi_up, phi_circ."""


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with 0/0 -> 0 (dead capacity slots of masked plans)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _segment_sum(values: torch.Tensor, segment: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = values.new_zeros(num_segments)
    return out.index_add_(0, segment, values)


def compute_counts(plan: FigaroPlan, dtype=torch.float64, *,
                   device=None) -> list[NodeCounts]:
    """Algorithm 1. Returns one `NodeCounts` per node index.

    A host plan is moved to ``device`` first (cached on the plan); a plan
    already on a device computes there and ``device`` is ignored.
    """
    if plan.device is None:
        plan = plan.to(resolve_device(device))
    spec = plan.spec
    out: list[NodeCounts] = [NodeCounts() for _ in spec.nodes]

    # --- PASS 1 (bottom-up): ROWS_PER_KEY, Θ↓, Φ↓ -------------------------
    for idx in reversed(spec.preorder):
        sp, ix = spec.nodes[idx], plan.index[idx]
        rpk = ix.group_count.to(dtype)
        theta = rpk
        for ch in sp.children:
            phi_down_child = out[ch]["phi_down"]  # [P_child]
            theta = theta * phi_down_child[ix.child_lookup[ch]]
        out[idx]["rpk"] = rpk
        out[idx]["theta_down"] = theta
        if sp.parent >= 0:
            out[idx]["phi_down"] = _segment_sum(theta, ix.group_to_pgroup,
                                                sp.P)

    # --- PASS 2 (top-down): FULL_JOIN_SIZE, Φ↑, Φ° ------------------------
    for idx in spec.preorder:
        sp, ix = spec.nodes[idx], plan.index[idx]
        if sp.parent >= 0:
            up = out[idx]["phi_up"]  # set by the parent below
            full = out[idx]["theta_down"] * up[ix.group_to_pgroup]
        else:
            full = out[idx]["theta_down"]
        out[idx]["full"] = full
        out[idx]["phi_circ"] = _safe_div(full, out[idx]["rpk"])
        for ch in sp.children:
            full_ij = _segment_sum(full, ix.child_lookup[ch],
                                   spec.nodes[ch].P)
            out[ch]["phi_up"] = _safe_div(full_ij, out[ch]["phi_down"])

    return out


def compute_counts_reference(plan: FigaroPlan) -> list[dict[str, np.ndarray]]:
    """Same two-pass recurrences in numpy int64 (exact) — test oracle.

    Takes a host plan (numpy index arrays)."""
    nodes = plan.nodes
    out: list[dict[str, np.ndarray]] = [dict() for _ in nodes]
    for idx in reversed(plan.preorder):
        nd = nodes[idx]
        rpk = nd.group_count.astype(np.int64)
        theta = rpk.copy()
        for ch in nd.children:
            theta = theta * out[ch]["phi_down"][nd.child_lookup[ch]]
        out[idx]["rpk"] = rpk
        out[idx]["theta_down"] = theta
        if nd.parent >= 0:
            acc = np.zeros(nd.P, dtype=np.int64)
            np.add.at(acc, nd.group_to_pgroup, theta)
            out[idx]["phi_down"] = acc
    for idx in plan.preorder:
        nd = nodes[idx]
        if nd.parent >= 0:
            full = out[idx]["theta_down"] * out[idx]["phi_up"][nd.group_to_pgroup]
        else:
            full = out[idx]["theta_down"]
        out[idx]["full"] = full
        if not np.all(full % out[idx]["rpk"] == 0):
            raise AssertionError(f"node {idx}: full count not divisible by rpk")
        out[idx]["phi_circ"] = full // out[idx]["rpk"]
        for ch in nd.children:
            acc = np.zeros(nodes[ch].P, dtype=np.int64)
            np.add.at(acc, nd.child_lookup[ch], full)
            if not np.all(acc % out[ch]["phi_down"] == 0):
                raise AssertionError(f"node {ch}: phi_up not integral")
            out[ch]["phi_up"] = acc // out[ch]["phi_down"]
    return out
