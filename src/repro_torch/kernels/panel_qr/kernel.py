"""Householder panel factorization as a hand-written CUDA kernel
(``csrc/panel_qr.cu``): one block per panel, the panel in shared memory.

`panel_qr` checks its inputs, refuses a panel too large for one block's
shared memory, allocates the outputs with ``torch.empty`` and launches on
the current stream through the ctypes binding. It takes CUDA tensors only;
the wrapper in ``ops.py`` decides between it and the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "panel_qr"

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _build.library(NAME)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.pq_launch_f32, lib.pq_launch_f64):
            fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
            fn.restype = ctypes.c_int
        lib.pq_smem_bytes.argtypes = [_I] * 3
        lib.pq_smem_bytes.restype = _I
        lib.pq_smem_limit.argtypes = []
        lib.pq_smem_limit.restype = _I
        lib._repro_bound = True
    return lib


def panel_qr(a: torch.Tensor):
    """(V [..., m, nb], beta [..., nb], R_panel [..., m, nb]) for CUDA panels."""
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"panel_qr takes float32 or float64, got {a.dtype}")
    if a.device.type != "cuda" or a.ndim < 2:
        raise ValueError("panel_qr takes a CUDA tensor [..., m, nb]")
    m, nb = a.shape[-2:]
    lead = a.shape[:-2]
    batch = a.numel() // max(m * nb, 1)
    lib = _lib()
    need = lib.pq_smem_bytes(m, nb, a.element_size())
    if need > lib.pq_smem_limit():
        raise ValueError(
            f"panel [{m}, {nb}] of {a.dtype} needs {need} bytes of shared "
            f"memory, more than the {lib.pq_smem_limit()} one block may use; "
            "use a narrower panel or fewer TSQR leaf rows")
    a = a.contiguous()
    v = torch.empty_like(a)
    r = torch.empty_like(a)
    beta = torch.empty(lead + (nb,), dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return v, beta, r
    fn = lib.pq_launch_f64 if a.dtype == torch.float64 else lib.pq_launch_f32
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), v.data_ptr(), beta.data_ptr(), r.data_ptr(),
             batch, m, nb, stream)
    if err != 0:
        raise RuntimeError(f"panel_qr launch failed with CUDA error {err}")
    _platform.count_launch(NAME)
    return v, beta, r
