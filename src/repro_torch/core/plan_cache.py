"""Plan capacities: bucketed signatures and live-row masks.

A plan's node sizes ``(m, K, P)`` change with every table that is ingested;
this module rounds them up so that near-miss shapes share one plan
signature, the key of the engine's per-signature cache:

  * `bucket_spec(spec)` rounds every node's sizes up to powers of two, so all
    plans whose live sizes fall in the same buckets share one `PlanSpec`.
  * `pad_plan(plan, cap_spec)` embeds an exact plan into such a capacity spec:
    index arrays are padded to capacity shapes and a **live-row mask** rides
    along in the index.

Capacity vs live size (the contract every layer observes):

  * **capacity** is static: `NodeSpec.m/K/P`, the R₀ row layout, `r0_rows` —
    all bucketed, all part of the signature;
  * **live size** is dynamic: the row mask and the zeroed tail of
    ``group_count`` (dead group slots have count 0). `figaro.figaro_r0` uses
    the mask as the Givens weight vector (dead rows rotate with weight 0 and
    emit zero R₀ rows) and `counts.compute_counts` resolves the resulting
    0/0 aggregates to 0, so a capacity plan computes exactly what the
    underlying exact plan computes, padded with zero rows.

Padding layout invariants (relied on by the masked math):

  * dead rows sit at the tail of each node's row range and are appended to
    the **last live group** with continuing ``pos_in_group`` — never a
    segment start, so segmented prefix sums keep positive denominators;
  * dead group slots (``[K_live, K_cap)``) hold zero rows (``group_count
    0``), attach to the last live pgroup with continuing ``pos_in_pgroup``,
    and look up the child's last live P-slot — harmless, because their
    ``theta``/``full`` counts are identically 0;
  * dead pgroup slots hold zero groups, so carried scales ``√Φ↓`` vanish.

This is the bucketing half of the JAX package's ``core/plan_cache.py``; the
append path (``refresh_plan``, ``PlanHolder``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .join_tree import FigaroPlan, JoinTree, NodeIndex, PlanSpec, build_plan

__all__ = [
    "next_pow2",
    "bucket_spec",
    "pad_plan",
    "pad_data",
    "build_capacity_plan",
    "spec_fits",
]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def bucket_spec(spec: PlanSpec, *, headroom: int = 0) -> PlanSpec:
    """Round every node's ``(m, K, P)`` up to powers of two and recompute the
    R₀ row layout for the bucketed sizes. Column layout is untouched (the
    feature schema is part of the tenant's signature, not its load).

    ``headroom`` rows are added to every node's live row count before
    bucketing, guaranteeing streaming appends of up to that many rows stay
    inside the capacity even when the live size sits exactly on a power of
    two (where ``next_pow2`` alone would leave zero slack)."""
    nodes = [dataclasses.replace(sp, m=next_pow2(sp.m + headroom),
                                 K=next_pow2(sp.K), P=next_pow2(sp.P))
             for sp in spec.nodes]
    row_acc = 0  # emission order: reversed preorder, m tail rows then K
    for i in reversed(spec.preorder):
        nodes[i] = dataclasses.replace(nodes[i], tail_row0=row_acc,
                                       out_row0=row_acc + nodes[i].m)
        row_acc += nodes[i].m + nodes[i].K
    return dataclasses.replace(
        spec, nodes=tuple(nodes),
        total_rows=sum(sp.m for sp in nodes), r0_rows=row_acc)


def spec_fits(live: PlanSpec, cap: PlanSpec) -> bool:
    """True iff an exact plan with spec ``live`` embeds into capacities
    ``cap``: same topology/schema, per-node sizes within capacity."""
    if (live.names != cap.names or live.preorder != cap.preorder
            or live.root != cap.root or live.num_cols != cap.num_cols):
        return False
    for sp, cp in zip(live.nodes, cap.nodes):
        if (sp.name != cp.name or sp.parent != cp.parent
                or sp.children != cp.children or sp.n != cp.n
                or sp.col_start != cp.col_start
                or sp.subtree_start != cp.subtree_start
                or sp.subtree_width != cp.subtree_width
                or sp.child_rel_col0 != cp.child_rel_col0):
            return False
        if sp.m > cp.m or sp.K > cp.K or sp.P > cp.P:
            return False
    return True


def _pad_tail(arr: np.ndarray, size: int, fill) -> np.ndarray:
    """Pad a 1-D int index array up to ``size`` with a constant fill value."""
    arr = np.asarray(arr)
    pad = size - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])


def pad_data(data, spec: PlanSpec):
    """Zero-pad per-node data ([..., m_i, n_i], numpy arrays or tensors) on
    the row axis up to the capacities of ``spec``. Data already at capacity
    pass through."""
    out = []
    for sp, d in zip(spec.nodes, data):
        if not isinstance(d, torch.Tensor):
            d = np.asarray(d)
        if d.shape[-2] > sp.m or d.shape[-1] != sp.n:
            raise ValueError(
                f"{sp.name}: data shape {tuple(d.shape)} does not fit "
                f"capacity ({sp.m}, {sp.n})")
        pad = sp.m - d.shape[-2]
        if pad and isinstance(d, torch.Tensor):
            d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        elif pad:
            widths = [(0, 0)] * (d.ndim - 2) + [(0, pad), (0, 0)]
            d = np.pad(d, widths)
        out.append(d)
    return tuple(out)


def _pad_index(ix: NodeIndex, sp_live, sp_cap,
               child_live_p: Mapping[int, int]) -> NodeIndex:
    """Embed one node's exact index arrays into capacity shapes (see module
    docstring for the layout invariants this establishes)."""
    m, k, p = sp_live.m, sp_live.K, sp_live.P
    mc, kc, pc = sp_cap.m, sp_cap.K, sp_cap.P
    last_group = k - 1
    last_pgroup = p - 1
    # Dead rows join the last live group, continuing its positions.
    row_to_group = _pad_tail(ix.row_to_group, mc, last_group)
    pos_in_group = _pad_tail(ix.pos_in_group, mc, 0)
    if mc > m:
        pos_in_group[m:] = ix.group_count[last_group] + np.arange(
            mc - m, dtype=pos_in_group.dtype)
    row_seg_start = _pad_tail(ix.row_seg_start, mc,
                              ix.group_start[last_group])
    # Dead group slots: zero rows, attached to the last live pgroup.
    group_start = _pad_tail(ix.group_start, kc, m)
    group_count = _pad_tail(ix.group_count, kc, 0)
    group_to_pgroup = _pad_tail(ix.group_to_pgroup, kc, last_pgroup)
    group_seg_start = _pad_tail(ix.group_seg_start, kc,
                                ix.group_seg_start[last_group])
    pos_in_pgroup = _pad_tail(ix.pos_in_pgroup, kc, 0)
    if kc > k:
        pos_in_pgroup[k:] = ix.pgroup_count[last_pgroup] + np.arange(
            kc - k, dtype=pos_in_pgroup.dtype)
    pgroup_count = _pad_tail(ix.pgroup_count, pc, 0)
    child_lookup = {}
    for ch, lookup in ix.child_lookup.items():
        # Dead parent groups point at the child's last LIVE P-slot; their
        # `full` count is 0, so the gather/segment-sum they feed is inert.
        child_lookup[ch] = _pad_tail(lookup, kc, child_live_p[ch] - 1)
    mask = np.zeros(mc, dtype=np.float64)
    mask[:m] = 1.0
    return NodeIndex(
        row_to_group=row_to_group, row_seg_start=row_seg_start,
        pos_in_group=pos_in_group, group_start=group_start,
        group_count=group_count, group_to_pgroup=group_to_pgroup,
        group_seg_start=group_seg_start, pos_in_pgroup=pos_in_pgroup,
        pgroup_count=pgroup_count, child_lookup=child_lookup, row_mask=mask)


def pad_plan(plan: FigaroPlan, cap_spec: PlanSpec | None = None) -> FigaroPlan:
    """Embed an exact plan into a capacity spec (default: its own buckets).

    Returns a masked host `FigaroPlan` whose spec is ``cap_spec`` — every
    plan padded into the same capacities shares one engine signature.
    """
    if plan.device is not None:
        raise ValueError("pad_plan takes a host plan (numpy index arrays)")
    if any(ix.row_mask is not None for ix in plan.index):
        raise ValueError("pad_plan expects an exact plan")
    cap_spec = bucket_spec(plan.spec) if cap_spec is None else cap_spec
    if not spec_fits(plan.spec, cap_spec):
        raise ValueError("plan does not fit the requested capacity spec")
    live_p = {sp.idx: sp.P for sp in plan.spec.nodes}
    index = [
        _pad_index(ix, sp_live, sp_cap, live_p)
        for sp_live, sp_cap, ix in zip(plan.spec.nodes, cap_spec.nodes,
                                       plan.index)
    ]
    data = pad_data(plan.data, cap_spec) if plan.data else ()
    return FigaroPlan(spec=cap_spec, index=tuple(index), data=data)


def build_capacity_plan(tree: JoinTree, *, dtype=np.float64,
                        cap_spec: PlanSpec | None = None,
                        headroom: int = 0) -> FigaroPlan:
    """Ingest + pad in one step.

    ``headroom`` reserves extra row capacity per node (see `bucket_spec`) so
    a known append rate cannot immediately overflow a bucket.
    """
    exact = build_plan(tree, dtype=dtype)
    if cap_spec is None:
        cap_spec = bucket_spec(exact.spec, headroom=headroom)
    return pad_plan(exact, cap_spec)
