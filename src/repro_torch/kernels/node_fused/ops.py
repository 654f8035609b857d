"""Public wrapper: one fused FiGaRo node pass, heads included.

`fused_node_pass` is the kernel-path unit `core.figaro.figaro_r0` calls twice
per join-tree node (HEADS_AND_TAILS and PROJECT_AWAY_JOIN_ATTRS). All the
[m, n]-sized work — live-row masking, the weighted segmented scan, the
generalized-tail formula, segment-start zeroing and √Φ emission scaling —
happens in `node_fused`: the CUDA kernel for tensors on the card, its plain
version (`ref.node_fused_ref`) for tensors on the CPU. What stays plain
PyTorch is O(m)/O(K) vector work: the weight-norm scans that feed the tail
coefficients, and the head extraction, which gathers each segment's **final**
inclusive sum instead of re-reducing the matrix.
"""

from __future__ import annotations

import torch

from repro_torch.core.heads_tails import segmented_cumsum
from repro_torch.kernels import _platform

from . import kernel, ref


def node_fused(data, data_scale, weights, first, coef_a, coef_b, emit_scale):
    """(emitted, s_incl): the CUDA kernel on the card, the plain version on
    the CPU (see `kernel.node_fused` for the contract)."""
    if _platform.is_cpu(data, data_scale, weights, first, coef_a, coef_b,
                        emit_scale):
        return ref.node_fused_ref(data, data_scale, weights, first, coef_a,
                                  coef_b, emit_scale)
    return kernel.node_fused(data, data_scale, weights, first, coef_a, coef_b,
                             emit_scale)


def fused_node_pass(
    data: torch.Tensor,         # [..., m, n] node rows, NOT pre-masked
    weights: torch.Tensor,      # [m] Givens weight v (dead rows: 0)
    pos_in_seg: torch.Tensor,   # [m] 0 at segment starts
    emit_scale: torch.Tensor,   # [m] √Φ per row (0 allowed; starts auto-zeroed)
    last_of_seg: torch.Tensor,  # [K] row index of each segment's last member
    seg_live: torch.Tensor,     # [K] bool — live segment slots
    *,
    data_scale: torch.Tensor | None = None,  # [m] row mask (None = ones)
):
    """One fused head/tail pass over contiguous row segments.

    Returns:
      slab:  [..., m, n] — ``emit_scale·T(seg, v)`` rows, segment starts (and
             every masked row) exactly zero: the finished R₀ slab.
      heads: [..., K, n] — ``H(seg, v)`` per live segment, zeros on dead slots.
      norms: [K]         — ‖v_seg‖₂, zeros on dead slots.

    Dead capacity-slot contract (see `core.plan_cache`): dead rows carry
    ``weights == data_scale == 0`` and are never segment starts, dead segment
    slots have ``seg_live`` False and may point ``last_of_seg`` anywhere.
    """
    m = data.shape[-2]
    dtype = data.dtype
    weights = weights.to(dtype)
    first = pos_in_seg == 0
    if data_scale is None:
        data_scale = torch.ones(m, dtype=dtype, device=data.device)
    # Tail coefficients from [m] weight scans (cheap; every [m, n] op is in
    # the kernel). Same guarded formulas as `segmented_head_tail`: dead rows
    # (weight 0, never starts) get coef_a=1, coef_b=0 and a zeroed data row,
    # so their slab rows come out identically zero.
    w2 = weights * weights
    c_incl = segmented_cumsum(w2, first)
    c_excl = c_incl - w2
    c_excl_safe = torch.where(pos_in_seg > 0, c_excl, torch.ones_like(c_excl))
    coef_a = torch.sqrt(c_excl_safe / c_incl)
    coef_b = -weights / torch.sqrt(c_excl_safe * c_incl)
    # Fold the segment-start zeroing into the emission scale: a start row's
    # "tail" is garbage (it is the head's slot), so it must never emit.
    emit = (emit_scale * (pos_in_seg > 0)).to(dtype)
    slab, s_incl = node_fused(data, data_scale.to(dtype).contiguous(),
                              weights.contiguous(), first.contiguous(),
                              coef_a.contiguous(), coef_b.contiguous(),
                              emit.contiguous())

    # Heads by gather: the inclusive sums at a segment's last row ARE the
    # segment totals (dead trailing rows add weight-0 nothing).
    last = torch.clamp(last_of_seg, 0, m - 1)
    norms = torch.sqrt(c_incl[last])
    heads = s_incl[..., last, :] / torch.where(
        norms > 0, norms, torch.ones_like(norms))[:, None]
    heads = torch.where(seg_live[:, None], heads, torch.zeros_like(heads))
    norms = torch.where(seg_live, norms, torch.zeros_like(norms))
    return slab, heads.to(dtype), norms.to(dtype)
