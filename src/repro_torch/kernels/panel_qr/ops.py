"""Public wrappers for the panel-QR kernel.

The CUDA kernels run for panels on the card; their plain versions
(`ref.panel_qr_ref`, `ref.panel_qr_wy_ref`) run for panels on the CPU.
Nothing else chooses.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _platform

from . import kernel, ref


def panel_qr(a: torch.Tensor):
    """Householder panel factorization: (V, beta, R_panel) for [..., m, nb];
    ``a`` is left as it is."""
    if _platform.is_cpu(a):
        return ref.panel_qr_ref(a)
    return kernel.panel_qr(a)


def panel_qr_wy(a: torch.Tensor):
    """Householder panel factorization in place: R over ``a`` [B, m, nb]
    (zero below the diagonal), returns (V, beta, T) with
    H_1 … H_nb = I − V·T·Vᵀ."""
    if _platform.is_cpu(a):
        return ref.panel_qr_wy_ref(a)
    return kernel.panel_qr_wy(a)
