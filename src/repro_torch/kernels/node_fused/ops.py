"""Public wrapper: one fused FiGaRo node pass, heads included.

`fused_node_pass` is the kernel-path unit `core.figaro.figaro_r0` calls twice
per join-tree node (HEADS_AND_TAILS and PROJECT_AWAY_JOIN_ATTRS). For tensors
on the card the whole pass — live-row masking, the weighted segmented scans
of the data and of the squared weights, the tail coefficients, the
generalized-tail formula, segment-start zeroing, √Φ emission scaling and the
heads at each segment's last row — runs in the CUDA kernel
(`kernel.fused_node_pass`, two launches, no [m]-sized torch op). For tensors
on the CPU it runs the plain version (`ref.fused_node_pass_ref`, the JAX
package's order of arithmetic through `segmented_cumsum`).

`node_fused` is the TPU kernel's own contract (coefficients given), kept
callable the same way.
"""

from __future__ import annotations

import torch

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
    out: torch.Tensor | None = None,  # [..., m, W] destination rows
    out_col: int = 0,  # the slab's first column in ``out``
):
    """One fused head/tail pass over contiguous row segments.

    Returns:
      slab:  [..., m, n] — ``emit_scale·T(seg, v)`` rows, segment starts (and
             every masked row) exactly zero: the finished R₀ slab. When
             ``out`` is given (any view with a unit column stride and
             W ≥ out_col + n columns, such as the slab's rows of R₀), the
             slab is written into ``out[..., out_col:out_col + n]`` and the
             rest of ``out`` is zeroed; that view is returned.
      heads: [..., K, n] — ``H(seg, v)`` per live segment, zeros on dead slots.
      norms: [K]         — ‖v_seg‖₂, zeros on dead slots.

    Dead capacity-slot contract (see `core.plan_cache`): dead rows carry
    ``weights == data_scale == 0`` and are never segment starts, dead segment
    slots have ``seg_live`` False and may point ``last_of_seg`` anywhere.
    Live slots end at distinct rows.
    """
    if _platform.is_cpu(data, weights, pos_in_seg, emit_scale, last_of_seg,
                        seg_live, *(() if data_scale is None
                                    else (data_scale,))):
        return ref.fused_node_pass_ref(data, weights, pos_in_seg, emit_scale,
                                       last_of_seg, seg_live,
                                       data_scale=data_scale, out=out,
                                       out_col=out_col)
    return kernel.fused_node_pass(data, weights, pos_in_seg, emit_scale,
                                  last_of_seg, seg_live,
                                  data_scale=data_scale, out=out,
                                  out_col=out_col)
