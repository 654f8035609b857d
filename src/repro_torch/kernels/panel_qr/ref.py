"""Plain PyTorch versions of the panel-QR kernel: `core.postprocess.householder_panel`,
and with it `_panel_to_wy` for the in-place form."""

from __future__ import annotations

import torch

from repro_torch.core.postprocess import _panel_to_wy, householder_panel


def panel_qr_ref(a: torch.Tensor):
    """(V unit-diagonal, beta, R_panel) for [..., m, nb] panels, with R_panel
    zero below the diagonal — the kernel's contract."""
    v, beta, r = householder_panel(a)
    return v, beta, torch.triu(r)


def panel_qr_wy_ref(a: torch.Tensor):
    """`panel_qr_ref` with R written over ``a`` [B, m, nb] (or [m, nb]) in
    place, returning (V, beta, T) with T = `_panel_to_wy` (V, beta)."""
    v, beta, r = panel_qr_ref(a)
    a.copy_(r)
    m, nb = a.shape[-2:]
    t = _panel_to_wy(v.reshape(-1, m, nb), beta.reshape(-1, nb))
    return v, beta, t.reshape(beta.shape[:-1] + (nb, nb))
