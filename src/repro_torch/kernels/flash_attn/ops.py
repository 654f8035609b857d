"""Public wrapper for the flash-attention kernel.

It keeps the JAX package's layout (``flash_attn/ops.py``): q [B, Tq, Hq, hd],
k/v [B, Tk, Hkv, hd], positions [Tq] / [Tk]. The CUDA kernel runs for
tensors on the card; its plain version (`ref.flash_attention_ref`) runs for
tensors on the CPU. Nothing else chooses.
"""

from __future__ import annotations

from repro_torch.kernels import _platform

from . import kernel, ref


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int | None = None):
    """Fused GQA attention (see `kernel.flash_attention`)."""
    if _platform.is_cpu(q, k, v, q_pos, k_pos):
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window)
    return kernel.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                  window=window)
