"""Householder panel factorization — the post-processing hot spot.

`ops.panel_qr` and `ops.panel_qr_wy` are the wrappers: the CUDA kernels
(`kernel.py`, ``csrc/panel_qr.cu``) on the card, the plain versions
(`ref.py`) on the CPU.
"""

from .ops import panel_qr, panel_qr_wy
from .ref import panel_qr_ref, panel_qr_wy_ref

__all__ = ["panel_qr", "panel_qr_wy", "panel_qr_ref", "panel_qr_wy_ref"]
