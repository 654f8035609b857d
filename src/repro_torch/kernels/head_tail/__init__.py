"""Segmented generalized-tail transform — the kernel behind
``core.heads_tails.segmented_head_tail(use_kernel=True)``.

`ops.segmented_tail` is the wrapper: the CUDA kernel (`kernel.py`,
``csrc/head_tail.cu``) on the card, the plain version (`ref.py`) on the CPU.
`ops.segmented_cumsum` is the same scan's segmented inclusive prefix sum,
which the kernel path forms its weight norms with on the card.
"""

from .ops import segmented_cumsum, segmented_tail
from .ref import segmented_tail_ref

__all__ = ["segmented_cumsum", "segmented_tail", "segmented_tail_ref"]
