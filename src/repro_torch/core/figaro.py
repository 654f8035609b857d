"""FiGaRo (paper §6, Algorithm 2): pushing Givens rotations past the join.

Bottom-up over the join tree; per node:

  HEADS_AND_TAILS            per-join-key head/tail of the node's data columns;
                             tails scaled by √Φ° go to the output, heads into
                             the carried `Data` matrix (one row per key X̄_i).
  PROCESS_AND_JOIN_CHILDREN  gather children's carried heads through the key
                             lookup, apply the cross-subtree scale products
                             (lines 21–26 of Algorithm 2).
  PROJECT_AWAY_JOIN_ATTRS    generalized head/tail over `Data` weighted by the
                             carried scales; generalized tails scaled by √Φ↑ go
                             to the output, heads (one row per X̄_p) are carried
                             to the parent with scales √Φ↓.

The result ``R₀`` is almost upper-triangular with at most M non-zero rows and
satisfies ``A[:, Ȳ] = Q·[R₀; 0]`` for orthogonal Q (Theorem 6.1) — equivalently
``R₀ᵀR₀ == AᵀA``, the invariant the tests enforce.

Execution model: plain PyTorch on the plan's device. A host plan is moved to
the device once (`FigaroPlan.to`, cached). The per-node data carry a leading
batch dimension throughout ([B, m_i, n_i]); the counts, weights and scales
depend on the plan alone and are shared by the batch, so a batch of B
feature-sets costs one pass, and `figaro_r0` is the B = 1 case.

Two hot-path variants:

  * ``use_kernel=True`` routes each node's two head/tail passes through the
    fused `kernels/node_fused` pass: live-row masking, the weighted segmented
    scans of the data and of the squared weights, the tail coefficients and
    formula, segment-start zeroing, √Φ emission scaling and the heads (each
    segment's inclusive sum at its last row, no second [m, n] reduction) in
    one single-pass CUDA kernel per pass.
    ``use_kernel=False`` (default) is the unfused plain-PyTorch path —
    `segmented_head_tail` per pass.

  * ``assembly`` picks how the emitted slabs become R₀. ``"padded"``
    (default) pads every slab to the full ``num_cols`` width and concatenates
    in emission order. ``"band"`` writes each slab into a zeros
    [r0_rows, num_cols] buffer at its band (``PlanSpec.bands``), so beyond
    the single zero fill each slab moves only its own rowsᵢ·widthᵢ elements
    (`assembly_traffic` is the analytic model). On the kernel path R₀ is
    allocated first and never zero-filled: the bands tile its rows, each
    pass writes its slab as whole rows of R₀ (its columns, zeros in the
    rest), and the root's Data blocks are scaled straight into the root's
    rows, so no slab is copied (but a leaf root's). Both produce
    bit-identical layouts. The assembly's copies run inside a
    ``figaro.r0_assembly`` profiler range.

Capacity-padded plans (`repro_torch.core.plan_cache`): when a node carries a
``row_mask``, the static shapes above are *capacities* and the mask is the
weight vector of every row-level Givens sequence — dead rows contribute
nothing (weight 0, data zeroed) and the corresponding R₀ rows are exactly
zero. The fused kernel keeps this contract: the mask rides in as the
kernel's ``data_scale`` so masked slab rows are exactly zero straight out of
the kernel.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels._platform import resolve_device

from .counts import compute_counts
from .heads_tails import segmented_head_tail
from .join_tree import FigaroPlan, PlanSpec

__all__ = ["figaro_r0", "figaro_r0_batched", "figaro_r0_fn",
           "assembly_traffic"]

ASSEMBLIES = ("padded", "band")


def _pad_cols(block: torch.Tensor, col0: int, num_cols: int) -> torch.Tensor:
    """Embed ``block`` into columns [col0, col0+w) of an all-zero [.., rows, N] slab."""
    return F.pad(block, (col0, num_cols - col0 - block.shape[-1]))


def _assemble_padded(spec: PlanSpec, tail_slabs, out_slabs) -> torch.Tensor:
    """Every slab padded to full width, concatenated in emission order."""
    slabs = []
    for idx in reversed(spec.preorder):
        sp = spec.nodes[idx]
        slabs.append(_pad_cols(tail_slabs[idx], sp.col_start, spec.num_cols))
        slabs.append(_pad_cols(out_slabs[idx], sp.subtree_start, spec.num_cols))
    return torch.cat(slabs, dim=-2)


def _band_rows(spec: PlanSpec, r0: torch.Tensor) -> dict:
    """{(node, kind): (the rows of ``r0`` [B, r0_rows, num_cols] that slab's
    band spans, the band's first column)}. The bands tile R₀'s rows."""
    return {(b.node, b.kind): (r0[..., b.row0:b.row0 + b.rows, :], b.col0)
            for b in spec.bands}


def _assemble_band(spec: PlanSpec, tail_slabs, out_slabs,
                   r0: torch.Tensor | None = None) -> torch.Tensor:
    """Band-wise R₀ assembly (bit-identical layout to the padded path).

    Every slab's destination is a contiguous band recorded in
    ``PlanSpec.bands`` — rows [row0, row0+rows) × columns [col0, col0+width)
    of R₀, zero outside — so each slab is copied once, at its own width, into
    one zeros [B, r0_rows, num_cols] buffer. Given ``r0``, the kernel path's
    buffer, slabs already written as whole rows of it (None here) are not
    copied again.
    """
    if r0 is None:
        ref = out_slabs[spec.root]
        r0 = ref.new_zeros(ref.shape[:-2] + (spec.r0_rows, spec.num_cols))
    for (node, kind), (rows, col0) in _band_rows(spec, r0).items():
        slab = tail_slabs[node] if kind == "tail" else out_slabs[node]
        if slab is not None:
            rows[..., col0:col0 + slab.shape[-1]].copy_(slab)
    return r0


def assembly_traffic(spec: PlanSpec, *, assembly: str = "padded",
                     itemsize: int = 8) -> int:
    """Analytic bytes *written* by R₀ assembly.

    ``"padded"`` writes a full-width copy of every slab narrower than
    ``num_cols`` (the pad) plus the final [r0_rows, num_cols] concat;
    ``"band"`` writes the zero fill once plus each slab at its own band
    width.
    """
    full = spec.r0_rows * spec.num_cols
    if assembly == "padded":
        pad_writes = sum(b.rows * spec.num_cols for b in spec.bands
                         if b.width != spec.num_cols)
        return (pad_writes + full) * itemsize
    if assembly == "band":
        band_writes = sum(b.rows * b.width for b in spec.bands)
        return (full + band_writes) * itemsize
    raise ValueError(f"unknown assembly {assembly!r}; expected {ASSEMBLIES}")


def _segment_last(group_to_pgroup: torch.Tensor, num_groups: int,
                  num_pgroups: int) -> torch.Tensor:
    """Last group index of every pgroup, 0 for a pgroup with no group.

    The JAX package takes ``segment_max`` of an empty segment, which gives
    the integer identity, and the kernel wrapper then clips it to 0; a
    scatter-max without the initial value and the same clip match that.
    """
    ids = torch.arange(num_groups, device=group_to_pgroup.device)
    init = torch.full((num_pgroups,), -1, dtype=ids.dtype, device=ids.device)
    last = init.scatter_reduce(0, group_to_pgroup, ids, reduce="amax",
                               include_self=False)
    return torch.clamp(last, min=0)


def _r0_batch(plan: FigaroPlan, data: Sequence[torch.Tensor], *,
              use_kernel: bool, assembly: str) -> torch.Tensor:
    """Algorithm 2 over per-node data [B, m_i, n_i] on the plan's device;
    returns [B, r0_rows, num_cols]."""
    if use_kernel:
        from repro_torch.kernels.node_fused import ops as nf_ops
    spec = plan.spec
    dtype = data[0].dtype
    counts = compute_counts(plan, dtype=dtype)
    # The kernel path with band assembly writes each slab straight into R₀
    # as whole rows (its band's columns, zeros in the rest): the bands tile
    # R₀'s rows, so R₀ needs no zero fill.
    bands = {}
    r0 = None
    if use_kernel and assembly == "band":
        r0 = data[0].new_empty((data[0].shape[0], spec.r0_rows,
                                spec.num_cols))
        bands = _band_rows(spec, r0)

    # Carried state per node (filled children-first); emitted slabs by node.
    carried_data: dict[int, torch.Tensor] = {}
    carried_scales: dict[int, torch.Tensor] = {}
    tail_slabs: dict[int, torch.Tensor] = {}
    out_slabs: dict[int, torch.Tensor] = {}

    for idx in reversed(spec.preorder):  # children strictly before parents
        sp = spec.nodes[idx]
        ix = plan.index[idx]
        cnt = counts[idx]
        x = data[idx]

        # --- HEADS_AND_TAILS (lines 11-16) --------------------------------
        # Capacity-padded plans weight the Givens sequences by the live-row
        # mask: dead rows carry weight 0 (they neither move the prefix sums
        # nor receive a tail) and their data is zeroed so the padded slab rows
        # of R₀ come out identically zero. Dead rows are never segment starts
        # (plan_cache appends them to the last live group), so every division
        # inside the head/tail formulas stays well-posed.
        mask = ix.row_mask.to(dtype) if ix.row_mask is not None else None
        weights = mask if mask is not None else x.new_ones(sp.m)
        phi_circ_row = cnt["phi_circ"][ix.row_to_group]
        if use_kernel:
            last = ix.group_start + ix.group_count - 1
            live = ix.group_count > 0
            out, col0 = bands.get((idx, "tail"), (None, 0))
            slab, heads, _ = nf_ops.fused_node_pass(
                x, weights, ix.pos_in_group, torch.sqrt(phi_circ_row), last,
                live, data_scale=mask, out=out, out_col=col0)
            tail_slabs[idx] = None if out is not None else slab
        else:
            if mask is not None:
                x = x * mask[:, None]
            heads, tails, _ = segmented_head_tail(
                x, weights, ix.row_to_group, ix.pos_in_group, sp.K)
            tail_slabs[idx] = tails * torch.sqrt(phi_circ_row)[:, None]

        scales = torch.sqrt(cnt["rpk"])  # √|S_i^x̄|, one per key
        # --- PROCESS_AND_JOIN_CHILDREN (lines 17-26) ----------------------
        if sp.children:
            gathered = []  # (data [B, K, w_ch], scale [K]) in child order
            for ch in sp.children:
                lookup = ix.child_lookup[ch]
                gathered.append((carried_data.pop(ch)[:, lookup],
                                 carried_scales.pop(ch)[lookup]))
            prod_all = functools.reduce(torch.mul, [s for _, s in gathered])
            blocks = [(heads, prod_all)]  # (block, its row scale)
            for j, (dj, _) in enumerate(gathered):
                prod_except = functools.reduce(
                    torch.mul,
                    [s for k, (_, s) in enumerate(gathered) if k != j],
                    scales)  # scales = √rpk_i  (line 24's `scales[x̄_i]` factor)
                blocks.append((dj, prod_except))
            # Children subtrees are column-contiguous after the node's own
            # columns (validated at plan build) — Data is a pure concat. The
            # root's Data is its R₀ slab: with a band destination each block
            # is scaled straight into its columns of the band.
            root_rows = bands.get((idx, "out"), (None, 0))[0] \
                if sp.parent < 0 else None
            if root_rows is None:
                data_mat = torch.cat([blk * f[:, None] for blk, f in blocks],
                                     dim=-1)
            else:  # the root's band is whole rows of R₀
                col = 0
                for blk, f in blocks:
                    width = blk.shape[-1]
                    torch.mul(blk, f[:, None],
                              out=root_rows[..., col:col + width])
                    col += width
                data_mat = None
            scales = scales * prod_all  # line 26
        else:
            data_mat = heads  # width == n for a leaf

        # --- PROJECT_AWAY_JOIN_ATTRIBUTES (lines 27-34) / root (lines 7-8) -
        if sp.parent >= 0:
            phi_up_group = cnt["phi_up"][ix.group_to_pgroup]
            if use_kernel:
                # Dead group slots continue the last live pgroup's segment
                # with scale 0, so the segment-final gather index may safely
                # land on them — the inclusive sums are unchanged past the
                # last live member.
                last = _segment_last(ix.group_to_pgroup, sp.K, sp.P)
                live = ix.pgroup_count > 0
                out, col0 = bands.get((idx, "out"), (None, 0))
                slab, gheads, _ = nf_ops.fused_node_pass(
                    data_mat, scales, ix.pos_in_pgroup,
                    torch.sqrt(phi_up_group), last, live, out=out,
                    out_col=col0)
                out_slabs[idx] = None if out is not None else slab
            else:
                gheads, gtails, _ = segmented_head_tail(
                    data_mat, scales, ix.group_to_pgroup, ix.pos_in_pgroup,
                    sp.P)
                out_slabs[idx] = gtails * torch.sqrt(phi_up_group)[:, None]
            carried_data[idx] = gheads
            carried_scales[idx] = torch.sqrt(cnt["phi_down"])
        else:
            out_slabs[idx] = data_mat  # None: already in its band

    with record_function("figaro.r0_assembly"):
        if assembly == "band":
            r0 = _assemble_band(spec, tail_slabs, out_slabs, r0)
        else:
            r0 = _assemble_padded(spec, tail_slabs, out_slabs)
    if r0.shape[-2:] != (spec.r0_rows, spec.num_cols):
        raise AssertionError((tuple(r0.shape), spec.r0_rows, spec.num_cols))
    return r0


def device_inputs(plan: FigaroPlan, data, dtype, device, batched: bool):
    """(device plan, per-node data [B, m_i, n_i] in ``dtype`` on its device).

    A host plan moves to ``device`` (cached); ``data`` defaults to the plan's
    own and gains a batch axis of one unless ``batched``.
    """
    if plan.device is None:
        plan = plan.to(resolve_device(device))
    if data is None:
        if batched:
            raise ValueError("a batched dispatch needs explicit "
                             "[B, m_i, n_i] data")
        data = plan.data
    data = [torch.as_tensor(d, device=plan.device).to(dtype) for d in data]
    if not batched:
        data = [d.unsqueeze(0) for d in data]
    for sp, d in zip(plan.spec.nodes, data):
        if d.ndim != 3 or tuple(d.shape[-2:]) != (sp.m, sp.n):
            raise ValueError(f"{sp.name}: data shape {tuple(d.shape)} does "
                             f"not match the plan's ({sp.m}, {sp.n})")
    return plan, data


def figaro_r0(
    plan: FigaroPlan,
    data: Sequence | None = None,
    *,
    dtype=torch.float32,
    use_kernel: bool = False,
    assembly: str = "padded",
    device=None,
) -> torch.Tensor:
    """Run Algorithm 2; returns R₀ [plan.r0_rows, plan.num_cols] on the device.

    ``data[i]`` overrides node i's data matrix (same row order as the plan).
    A host plan runs on ``device`` (default: the card); a plan already moved
    with `FigaroPlan.to` runs where it lives. ``use_kernel`` routes the
    per-node passes through the fused kernel; ``assembly`` ("padded" |
    "band") picks the R₀ materialization — the layouts are identical, only
    the traffic differs.
    """
    if assembly not in ASSEMBLIES:
        raise ValueError(f"unknown assembly {assembly!r}; expected {ASSEMBLIES}")
    plan, data = device_inputs(plan, data, dtype, device, batched=False)
    return _r0_batch(plan, data, use_kernel=use_kernel, assembly=assembly)[0]


def figaro_r0_batched(
    plan: FigaroPlan,
    data_batch: Sequence,
    *,
    dtype=torch.float32,
    use_kernel: bool = False,
    assembly: str = "padded",
    device=None,
) -> torch.Tensor:
    """Algorithm 2 over a leading batch axis of the data matrices.

    ``data_batch[i]`` is [B, m_i, n_i]; the plan (and therefore the counts,
    which depend only on the index structure) is held fixed across the batch —
    one join structure serving B feature-sets per dispatch. Returns
    [B, r0_rows, num_cols].
    """
    if assembly not in ASSEMBLIES:
        raise ValueError(f"unknown assembly {assembly!r}; expected {ASSEMBLIES}")
    plan, data = device_inputs(plan, data_batch, dtype, device, batched=True)
    return _r0_batch(plan, data, use_kernel=use_kernel, assembly=assembly)


def figaro_r0_fn(plan: FigaroPlan, *, dtype=torch.float32,
                 use_kernel: bool = False, assembly: str = "padded",
                 device=None):
    """A closure ``data -> R₀`` for a fixed plan.

    The plan is closed over: a host plan moves to ``device`` (default: the
    card) once, here, and on the card each call replays one CUDA graph per
    data signature, captured on its second call (see
    `core.engine._PlanClosure`). ``data`` is per-node [m_i, n_i] (default:
    the plan's own). For plan-generic dispatch, which shares one graph
    across same-signature plans, use `repro_torch.core.engine.FigaroEngine`.
    """
    from .engine import _PlanClosure  # engine imports this module

    return _PlanClosure(plan, dtype=dtype, use_kernel=use_kernel,
                        assembly=assembly, device=device)
