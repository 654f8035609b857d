"""Public wrapper for the panel-QR kernel.

The CUDA kernel runs for panels on the card; its plain version
(`ref.panel_qr_ref`) runs for panels on the CPU. Nothing else chooses.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _platform

from . import kernel, ref


def panel_qr(a: torch.Tensor):
    """Householder panel factorization: (V, beta, R_panel) for [..., m, nb]."""
    if _platform.is_cpu(a):
        return ref.panel_qr_ref(a)
    return kernel.panel_qr(a)
