"""The fused node pass as a hand-written CUDA kernel (``csrc/node_fused.cu``
on the single-pass segmented scan of ``csrc/seg_scan.cuh``).

Two entries, both on CUDA tensors only (``ops.py`` decides between them and
the plain versions):

* `fused_node_pass` — the whole pass of the main path: coefficients, slab
  (optionally straight into a strided destination such as a band of R₀),
  heads and norms, in one memset and two launches (``nf_prep``, O(K), then
  the scan). It
  issues no torch op besides the allocation of its outputs and one scratch
  buffer. Counted as ``node_fused``.
* `node_fused` — the TPU kernel's own contract (coefficients given,
  ``(emitted, s_incl)`` out), the same scan in its contract mode. Counted as
  ``node_fused_contract``.

The source is built with nvcc on first use (`repro_torch.kernels._build`).
A launch that fails raises; a look-back that ran out of its spin bound
raises at the next launch (`_seg_scan.raise_if_timed_out`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform, _seg_scan

NAME = "node_fused"
CONTRACT_NAME = "node_fused_contract"

_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int


def _lib():
    lib = _build.library(NAME)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.nf_launch_f32, lib.nf_launch_f64):
            fn.argtypes = [_P] * 7 + [_I] * 3 + [_P] * 5
            fn.restype = _C
        for fn in (lib.nf_pass_f32, lib.nf_pass_f64):
            fn.argtypes = ([_P] * 4 + [_C, _P, _P, _C, _P] + [_I] * 4
                           + [_P] + [_I] * 4 + [_P] * 5)
            fn.restype = _C
        lib.nf_geometry.argtypes = [_I, _I, _I, _C, _C, _P]
        lib.nf_geometry.restype = None
        lib._repro_bound = True
    return lib


def _row_vector(v, m, device, what, dtype=None):
    if v.shape != (m,) or v.device != device or not v.is_contiguous():
        raise ValueError(f"{what} must be a contiguous [{m}] vector on "
                         f"{device}, got {tuple(v.shape)} on {v.device}")
    if dtype is not None and v.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {v.dtype}")


def _check_data(data, name):
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {data.dtype}")
    if data.device.type != "cuda" or data.ndim < 2:
        raise ValueError(f"{name} takes a CUDA tensor [..., m, n]")


def node_fused(data, data_scale, weights, first, coef_a, coef_b, emit_scale):
    """(emitted, s_incl) for CUDA data [..., m, n] and [m] row vectors.

    ``first`` is a bool [m] (segment starts); every other row vector has the
    data's dtype. Leading batch dimensions of ``data`` share the row vectors.
    """
    _check_data(data, "node_fused")
    m, n = data.shape[-2:]
    batch = data.numel() // max(m * n, 1)
    for v, what in ((data_scale, "data_scale"), (weights, "weights"),
                    (coef_a, "coef_a"), (coef_b, "coef_b"),
                    (emit_scale, "emit_scale")):
        _row_vector(v, m, data.device, what, data.dtype)
    _row_vector(first, m, data.device, "first", torch.bool)
    data = data.contiguous()
    emitted = torch.empty_like(data)
    s_incl = torch.empty_like(data)
    if data.numel() == 0:
        return emitted, s_incl
    lib = _lib()
    buf = _seg_scan.scratch(lib.nf_geometry, batch, m, n, data.dtype,
                            "contract", data.device)
    fn = lib.nf_launch_f64 if data.dtype == torch.float64 else lib.nf_launch_f32
    stream = torch.cuda.current_stream(data.device).cuda_stream
    _seg_scan.launch(fn, "node_fused", (
        data.data_ptr(), data_scale.data_ptr(), weights.data_ptr(),
        first.data_ptr(), coef_a.data_ptr(), coef_b.data_ptr(),
        emit_scale.data_ptr(), batch, m, n, emitted.data_ptr(),
        s_incl.data_ptr(), buf.data_ptr()), stream)
    _platform.count_launch(CONTRACT_NAME)
    return emitted, s_incl


def fused_node_pass(data, weights, pos_in_seg, emit_scale, last_of_seg,
                    seg_live, *, data_scale=None, out=None, out_col=0):
    """(slab, heads, norms) of one node pass on the card; see
    `ops.fused_node_pass` for ``out`` and ``out_col``."""
    _check_data(data, "fused_node_pass")
    dtype, device = data.dtype, data.device
    m, n = data.shape[-2:]
    lead = data.shape[:-2]
    batch = data.numel() // max(m * n, 1)
    k = last_of_seg.shape[0]
    if weights.dtype != dtype:
        weights = weights.to(dtype)
    if emit_scale.dtype != dtype:
        emit_scale = emit_scale.to(dtype)
    if data_scale is not None and data_scale.dtype != dtype:
        data_scale = data_scale.to(dtype)
    for v, what in ((weights, "weights"), (emit_scale, "emit_scale"),
                    (pos_in_seg, "pos_in_seg")) + (
                        ((data_scale, "data_scale"),) if data_scale is not None
                        else ()):
        _row_vector(v, m, device, what)
    if pos_in_seg.dtype not in (torch.int32, torch.int64) \
            or last_of_seg.dtype not in (torch.int32, torch.int64):
        raise TypeError("pos_in_seg and last_of_seg must be int32 or int64")
    _row_vector(last_of_seg, k, device, "last_of_seg")
    _row_vector(seg_live, k, device, "seg_live", torch.bool)
    if out is None:
        out = torch.empty(data.shape, dtype=dtype, device=device)
    elif (out.shape[:-1] != data.shape[:-1] or out.dtype != dtype
          or out.device != device or out.stride(-1) != 1 or out.ndim > 3
          or not 0 <= out_col <= out.shape[-1] - n):
        raise ValueError(f"out must be [..., {m}, >= {out_col} + {n}] {dtype} "
                         f"on {device} (at most one batch dimension) with "
                         f"unit column stride, got {tuple(out.shape)} "
                         f"{out.dtype} stride {out.stride()}")
    slab = out[..., out_col:out_col + n]
    data = data.contiguous()
    heads = torch.empty(lead + (k, n), dtype=dtype, device=device)
    norms = torch.empty(k, dtype=dtype, device=device)
    if m == 0:
        if k:
            raise ValueError("fused_node_pass: segment slots over no rows")
        return slab, heads, norms
    lib = _lib()
    buf = _seg_scan.scratch(lib.nf_geometry, batch, m, n, dtype, "pass",
                            device)
    out_rs = out.stride(-2) if out.ndim >= 2 else n
    out_bs = out.stride(0) if out.ndim == 3 else m * out_rs
    fn = lib.nf_pass_f64 if dtype == torch.float64 else lib.nf_pass_f32
    stream = torch.cuda.current_stream(device).cuda_stream
    _seg_scan.launch(fn, "fused_node_pass", (
        data.data_ptr(),
        data_scale.data_ptr() if data_scale is not None else None,
        weights.data_ptr(), pos_in_seg.data_ptr(),
        int(pos_in_seg.dtype == torch.int64), emit_scale.data_ptr(),
        last_of_seg.data_ptr(), int(last_of_seg.dtype == torch.int64),
        seg_live.data_ptr(), batch, m, n, k, out.data_ptr(), out_bs, out_rs,
        out.shape[-1], out_col, heads.data_ptr(), norms.data_ptr(),
        buf.data_ptr()), stream)
    _platform.count_launch(NAME)
    return slab, heads, norms
