"""Public wrapper for the segmented-tail kernel.

The CUDA kernel runs for tensors on the card; its plain version
(`ref.segmented_tail_ref`) runs for tensors on the CPU. Nothing else chooses.
"""

from __future__ import annotations

from repro_torch.kernels import _platform

from . import kernel, ref


def segmented_tail(data, wa, first, coef_a, coef_b):
    """Segmented generalized tail: [..., m, n] (rows at segment starts are
    ``coef_a·data``; the caller masks them). See `kernel.segmented_tail`."""
    if _platform.is_cpu(data, wa, first, coef_a, coef_b):
        return ref.segmented_tail_ref(data, wa, first, coef_a, coef_b)
    return kernel.segmented_tail(data, wa, first, coef_a, coef_b)
