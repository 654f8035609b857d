"""The segmented-tail transform as a hand-written CUDA kernel
(``csrc/head_tail.cu``, on the single-pass segmented scan of
``csrc/seg_scan.cuh``).

`segmented_tail` is the TPU kernel's contract (one launch, counted as
``segmented_tail``); `segmented_cumsum` is the same scan's cumsum mode, the
segmented inclusive prefix sum that ``segmented_head_tail(use_kernel=True)``
forms its c_incl with on the card (one launch, counted as
``segmented_cumsum``). Each checks its inputs, allocates its output and one
scratch buffer with ``torch.empty`` and launches on the current stream
through the ctypes binding; CUDA tensors only (``ops.py`` decides between
these and the plain versions). The source is built with nvcc on first use
(`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform, _seg_scan

NAME = "segmented_tail"
CUMSUM_NAME = "segmented_cumsum"
SOURCE = "head_tail"

_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int


def _lib():
    lib = _build.library(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.ht_launch_f32, lib.ht_launch_f64):
            fn.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 4
            fn.restype = _C
        for fn in (lib.ht_cumsum_f32, lib.ht_cumsum_f64):
            fn.argtypes = [_P] * 2 + [_I] * 3 + [_P] * 4
            fn.restype = _C
        lib.ht_geometry.argtypes = [_I, _I, _I, _C, _C, _P]
        lib.ht_geometry.restype = None
        lib._repro_bound = True
    return lib


def _check(data, name):
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {data.dtype}")
    if data.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor")


def _check_rows(m, device, *vectors):
    for v in vectors:
        if v.shape != (m,) or v.device != device or not v.is_contiguous():
            raise ValueError(f"row vectors must be contiguous [{m}] on "
                             f"{device}, got {tuple(v.shape)} on {v.device}")


def segmented_tail(data, wa, first, coef_a, coef_b):
    """``coef_a·data + coef_b·(segmented exclusive Σ wa)`` for CUDA data and
    wa [..., m, n] and [m] row vectors.

    ``first`` is a bool [m] (segment starts); coef_a and coef_b have the
    data's dtype. Leading batch dimensions share the row vectors.
    """
    _check(data, "segmented_tail")
    if data.ndim < 2:
        raise ValueError("segmented_tail takes a CUDA tensor [..., m, n]")
    if wa.shape != data.shape or wa.dtype != data.dtype \
            or wa.device != data.device:
        raise ValueError(f"wa must match data: {tuple(data.shape)} "
                         f"{data.dtype}, got {tuple(wa.shape)} {wa.dtype}")
    m, n = data.shape[-2:]
    batch = data.numel() // max(m * n, 1)
    _check_rows(m, data.device, first, coef_a, coef_b)
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
    buf = _seg_scan.scratch(lib.ht_geometry, batch, m, n, data.dtype, "tail",
                            data.device)
    fn = lib.ht_launch_f64 if data.dtype == torch.float64 else lib.ht_launch_f32
    stream = torch.cuda.current_stream(data.device).cuda_stream
    _seg_scan.launch(fn, NAME, (
        data.data_ptr(), wa.data_ptr(), first.data_ptr(), coef_a.data_ptr(),
        coef_b.data_ptr(), batch, m, n, out.data_ptr(), buf.data_ptr()),
        stream)
    _platform.count_launch(NAME)
    return out


def segmented_cumsum(x, first):
    """Inclusive prefix sum over rows that restarts wherever ``first`` (bool
    [m]) is set, for a CUDA ``x`` [m] or [..., m, n]."""
    _check(x, "segmented_cumsum")
    m = x.shape[0] if x.ndim == 1 else x.shape[-2]
    n = 1 if x.ndim == 1 else x.shape[-1]
    batch = x.numel() // max(m * n, 1)
    _check_rows(m, x.device, first)
    if first.dtype != torch.bool:
        raise TypeError("first must be bool")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    buf = _seg_scan.scratch(lib.ht_geometry, batch, m, n, x.dtype, "cumsum",
                            x.device)
    fn = lib.ht_cumsum_f64 if x.dtype == torch.float64 else lib.ht_cumsum_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _seg_scan.launch(fn, CUMSUM_NAME, (
        x.data_ptr(), first.data_ptr(), batch, m, n, out.data_ptr(),
        buf.data_ptr()), stream)
    _platform.count_launch(CUMSUM_NAME)
    return out
