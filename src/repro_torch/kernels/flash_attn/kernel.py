"""Fused attention forward as a hand-written CUDA kernel
(``csrc/flash_attn.cu``): one block per (batch, query head, 64 query rows),
online softmax over KV tiles in shared memory, GQA folded by indexing.

`flash_attention` checks its inputs, allocates the output with
``torch.empty`` and launches on the current stream through the ctypes
binding. It takes CUDA tensors only; the wrapper in ``ops.py`` decides
between it and the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "flash_attention"
SOURCE = "flash_attn"
DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
HEAD_DIMS = (32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int


def _lib():
    lib = _build.library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        lib.fa_launch.argtypes = ([_C] + [_P] * 6 + [_I] * 6 + [_C, _C, _I]
                                  + [_P])
        lib.fa_launch.restype = _C
        lib._repro_bound = True
    return lib


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int | None = None):
    """Attention of CUDA q [B, Tq, Hq, hd] over k/v [B, Tk, Hkv, hd] with
    Hq % Hkv == 0; q_pos [Tq] and k_pos [Tk] integer positions (−1 = padded
    key). Returns [B, Tq, Hq, hd] in q's dtype (bfloat16, float32 or
    float64; hd in `HEAD_DIMS`)."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {list(DTYPES)}, got {q.dtype}")
    if q.device.type != "cuda" or q.ndim != 4 or k.ndim != 4:
        raise ValueError("flash_attention takes CUDA tensors q [B, Tq, Hq, hd] "
                         "and k, v [B, Tk, Hkv, hd]")
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, tk, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, Tk, Hkv, {hd}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of KV heads {hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q_pos.shape != (tq,) or k_pos.shape != (tk,):
        raise ValueError(f"positions must be [{tq}] and [{tk}], got "
                         f"{tuple(q_pos.shape)} and {tuple(k_pos.shape)}")
    for t in (k, v, q_pos, k_pos):
        if t.device != q.device:
            raise ValueError(f"inputs span {q.device} and {t.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fa_launch(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                        out.data_ptr(), b, tq, tk, hq, hkv, hd, int(causal),
                        int(window is not None),
                        0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {err}")
    _platform.count_launch(NAME)
    return out
