"""Public wrappers for the head_tail kernels.

The CUDA kernels run for tensors on the card; their plain versions
(`ref.segmented_tail_ref`, `core.heads_tails.segmented_cumsum`) run for
tensors on the CPU. Nothing else chooses.
"""

from __future__ import annotations

from repro_torch.core.heads_tails import segmented_cumsum as _cumsum_ref
from repro_torch.kernels import _platform

from . import kernel, ref


def segmented_tail(data, wa, first, coef_a, coef_b):
    """Segmented generalized tail: [..., m, n] (rows at segment starts are
    ``coef_a·data``; the caller masks them). See `kernel.segmented_tail`."""
    if _platform.is_cpu(data, wa, first, coef_a, coef_b):
        return ref.segmented_tail_ref(data, wa, first, coef_a, coef_b)
    return kernel.segmented_tail(data, wa, first, coef_a, coef_b)


def segmented_cumsum(x, first):
    """Segmented inclusive prefix sum of ``x`` [m] or [..., m, n] over rows,
    restarting where ``first`` is set. See `kernel.segmented_cumsum`."""
    if _platform.is_cpu(x, first):
        return _cumsum_ref(x, first)
    return kernel.segmented_cumsum(x, first)
