"""Householder panel factorization — the post-processing hot spot.

`ops.panel_qr` is the wrapper: the CUDA kernel (`kernel.py`,
``csrc/panel_qr.cu``) on the card, the plain version (`ref.py`) on the CPU.
"""

from .ops import panel_qr
from .ref import panel_qr_ref

__all__ = ["panel_qr", "panel_qr_ref"]
