"""Plain PyTorch versions of the fused node pass (same contracts as ops.py).

`node_fused_ref` is the plain version of the TPU kernel's contract
(``kernel.node_fused``). `fused_node_pass_ref` is the plain version of the
whole pass, coefficients and head gather included — the counterpart of the
JAX package's ``kernels/node_fused/ref.py:fused_node_pass_ref`` and of
``kernel.fused_node_pass``. The wrappers run them for CPU tensors, and
``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.heads_tails import segmented_cumsum


def node_fused_ref(data, data_scale, weights, first, coef_a, coef_b,
                   emit_scale):
    """(emitted, s_incl) for data [..., m, n] and [m] row vectors.

    Accumulates in float64 for float64 data and in float32 otherwise, as the
    kernel does.
    """
    acc = torch.float64 if data.dtype == torch.float64 else torch.float32
    col = lambda v: v.to(acc)[:, None]
    d = data.to(acc) * col(data_scale)
    wa = d * col(weights)
    s_incl = segmented_cumsum(wa, first)
    emitted = col(emit_scale) * (col(coef_a) * d
                                 + col(coef_b) * (s_incl - wa))
    return emitted.to(data.dtype), s_incl.to(data.dtype)


def fused_node_pass_ref(data, weights, pos_in_seg, emit_scale, last_of_seg,
                        seg_live, *, data_scale=None, out=None, out_col=0):
    """Reference (slab, heads, norms) — see `ops.fused_node_pass`; with
    ``out`` the slab is copied into ``out[..., out_col:out_col + n]``, the
    rest of ``out`` zeroed, and that view returned."""
    m = data.shape[-2]
    dtype = data.dtype
    weights = weights.to(dtype)
    first = pos_in_seg == 0
    if data_scale is not None:
        data = data * data_scale.to(dtype)[:, None]

    w2 = weights * weights
    wa = data * weights[:, None]
    c_incl = segmented_cumsum(w2, first)
    s_incl = segmented_cumsum(wa, first)
    c_excl = c_incl - w2
    s_excl = s_incl - wa
    c_excl_safe = torch.where(pos_in_seg > 0, c_excl, torch.ones_like(c_excl))
    tails = (torch.sqrt(c_excl_safe / c_incl)[:, None] * data
             - (weights / torch.sqrt(c_excl_safe * c_incl))[:, None] * s_excl)
    emit = emit_scale * (pos_in_seg > 0)
    slab = emit.to(dtype)[:, None] * tails

    last = torch.clamp(last_of_seg, 0, m - 1)
    norms = torch.sqrt(c_incl[last])
    heads = s_incl[..., last, :] / torch.where(
        norms > 0, norms, torch.ones_like(norms))[:, None]
    heads = torch.where(seg_live[:, None], heads, torch.zeros_like(heads))
    norms = torch.where(seg_live, norms, torch.zeros_like(norms))
    if out is not None:
        n = slab.shape[-1]
        out[..., :out_col].zero_()
        out[..., out_col + n:].zero_()
        slab = out[..., out_col:out_col + n].copy_(slab)
    return slab, heads.to(dtype), norms.to(dtype)
