"""Fused attention forward with an online softmax — the kernel behind the
LM's train-mode attention with ``cfg.use_flash_kernel``.

`ops.flash_attention` is the wrapper: the CUDA kernel (`kernel.py`,
``csrc/flash_attn.cu``) on the card, the plain version (`ref.py`) on the CPU.
"""

from .ops import flash_attention
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref"]
