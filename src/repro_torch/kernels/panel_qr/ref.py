"""Plain PyTorch version of the panel-QR kernel: `core.postprocess.householder_panel`."""

from __future__ import annotations

import torch

from repro_torch.core.postprocess import householder_panel


def panel_qr_ref(a: torch.Tensor):
    """(V unit-diagonal, beta, R_panel) for [..., m, nb] panels, with R_panel
    zero below the diagonal — the kernel's contract."""
    v, beta, r = householder_panel(a)
    return v, beta, torch.triu(r)
