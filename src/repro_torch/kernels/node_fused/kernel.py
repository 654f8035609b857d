"""The fused node pass as a hand-written CUDA kernel (``csrc/node_fused.cu``).

`node_fused` checks its inputs, allocates the outputs and the scan scratch
with ``torch.empty``, and launches the kernel's three phases on the current
stream through the ctypes binding. The source is built with nvcc on first
use (`repro_torch.kernels._build`). It takes CUDA tensors only; the wrapper
in ``ops.py`` decides between it and the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "node_fused"

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _build.library(NAME)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.nf_launch_f32, lib.nf_launch_f64):
            fn.argtypes = [_P] * 7 + [_I] * 3 + [_P] * 5 + [_P]
            fn.restype = ctypes.c_int
        lib.nf_num_tiles.argtypes = [_I] * 3
        lib.nf_num_tiles.restype = _I
        lib._repro_bound = True
    return lib


def node_fused(data, data_scale, weights, first, coef_a, coef_b, emit_scale):
    """(emitted, s_incl) for CUDA data [..., m, n] and [m] row vectors.

    ``first`` is a bool [m] (segment starts); every other row vector has the
    data's dtype. Leading batch dimensions of ``data`` share the row vectors
    and fold into the kernel's columns.
    """
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node_fused takes float32 or float64, got {data.dtype}")
    if data.device.type != "cuda" or data.ndim < 2:
        raise ValueError("node_fused takes a CUDA tensor [..., m, n]")
    m, n = data.shape[-2:]
    batch = data.numel() // max(m * n, 1)
    rows = (data_scale, weights, coef_a, coef_b, emit_scale)
    for v in rows + (first,):
        if v.shape != (m,) or v.device != data.device or not v.is_contiguous():
            raise ValueError(f"row vectors must be contiguous [{m}] on "
                             f"{data.device}, got {tuple(v.shape)} on {v.device}")
    if any(v.dtype != data.dtype for v in rows) or first.dtype != torch.bool:
        raise TypeError("row vectors must match the data dtype; first is bool")
    data = data.contiguous()
    emitted = torch.empty_like(data)
    s_incl = torch.empty_like(data)
    if data.numel() == 0:
        return emitted, s_incl
    lib = _lib()
    tiles = lib.nf_num_tiles(batch, m, n)
    blk_x = torch.empty(tiles * batch * n, dtype=data.dtype, device=data.device)
    blk_f = torch.empty(tiles, dtype=torch.uint8, device=data.device)
    carry = torch.empty_like(blk_x)
    fn = lib.nf_launch_f64 if data.dtype == torch.float64 else lib.nf_launch_f32
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = fn(data.data_ptr(), data_scale.data_ptr(), weights.data_ptr(),
             first.data_ptr(), coef_a.data_ptr(), coef_b.data_ptr(),
             emit_scale.data_ptr(), batch, m, n, emitted.data_ptr(),
             s_incl.data_ptr(), blk_x.data_ptr(), blk_f.data_ptr(),
             carry.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"node_fused launch failed with CUDA error {err}")
    _platform.count_launch(NAME)
    return emitted, s_incl
