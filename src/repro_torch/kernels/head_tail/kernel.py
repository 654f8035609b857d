"""The segmented-tail transform as a hand-written CUDA kernel
(``csrc/head_tail.cu``, on the segmented scan of ``csrc/seg_scan.cuh``).

`segmented_tail` checks its inputs, allocates the output and the scan
scratch with ``torch.empty``, and launches the kernel's three phases on the
current stream through the ctypes binding. The source is built with nvcc on
first use (`repro_torch.kernels._build`). It takes CUDA tensors only; the
wrapper in ``ops.py`` decides between it and the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "segmented_tail"
SOURCE = "head_tail"

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _build.library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.ht_launch_f32, lib.ht_launch_f64):
            fn.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 4 + [_P]
            fn.restype = ctypes.c_int
        lib.ht_num_tiles.argtypes = [_I] * 3
        lib.ht_num_tiles.restype = _I
        lib._repro_bound = True
    return lib


def segmented_tail(data, wa, first, coef_a, coef_b):
    """``coef_a·data + coef_b·(segmented exclusive Σ wa)`` for CUDA data and
    wa [..., m, n] and [m] row vectors.

    ``first`` is a bool [m] (segment starts); coef_a and coef_b have the
    data's dtype. Leading batch dimensions share the row vectors and fold
    into the kernel's columns.
    """
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segmented_tail takes float32 or float64, got "
                        f"{data.dtype}")
    if data.device.type != "cuda" or data.ndim < 2:
        raise ValueError("segmented_tail takes a CUDA tensor [..., m, n]")
    if wa.shape != data.shape or wa.dtype != data.dtype \
            or wa.device != data.device:
        raise ValueError(f"wa must match data: {tuple(data.shape)} "
                         f"{data.dtype}, got {tuple(wa.shape)} {wa.dtype}")
    m, n = data.shape[-2:]
    batch = data.numel() // max(m * n, 1)
    for v in (first, coef_a, coef_b):
        if v.shape != (m,) or v.device != data.device or not v.is_contiguous():
            raise ValueError(f"row vectors must be contiguous [{m}] on "
                             f"{data.device}, got {tuple(v.shape)} on {v.device}")
    if coef_a.dtype != data.dtype or coef_b.dtype != data.dtype \
            or first.dtype != torch.bool:
        raise TypeError("coef_a and coef_b must match the data dtype; first "
                        "is bool")
    data = data.contiguous()
    wa = wa.contiguous()
    out = torch.empty_like(data)
    if data.numel() == 0:
        return out
    lib = _lib()
    tiles = lib.ht_num_tiles(batch, m, n)
    blk_x = torch.empty(tiles * batch * n, dtype=data.dtype, device=data.device)
    blk_f = torch.empty(tiles, dtype=torch.uint8, device=data.device)
    carry = torch.empty_like(blk_x)
    fn = lib.ht_launch_f64 if data.dtype == torch.float64 else lib.ht_launch_f32
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = fn(data.data_ptr(), wa.data_ptr(), first.data_ptr(),
             coef_a.data_ptr(), coef_b.data_ptr(), batch, m, n, out.data_ptr(),
             blk_x.data_ptr(), blk_f.data_ptr(), carry.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segmented_tail launch failed with CUDA error {err}")
    _platform.count_launch(NAME)
    return out
