"""Plain PyTorch version of the segmented-tail kernel."""

from __future__ import annotations

from repro_torch.core.heads_tails import segmented_cumsum


def segmented_tail_ref(data, wa, first, coef_a, coef_b):
    """``coef_a·data + coef_b·(segmented_cumsum(wa, first) − wa)`` for data
    and wa [..., m, n] and [m] row vectors (``first`` bool), in the data's
    dtype — the kernel's contract."""
    col = lambda v: v.to(data.dtype)[:, None]
    excl = segmented_cumsum(wa, first) - wa
    return col(coef_a) * data + col(coef_b) * excl
