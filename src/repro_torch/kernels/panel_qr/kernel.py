"""Householder panel factorization as hand-written CUDA kernels
(``csrc/panel_qr.cu``), one block per panel, in two variants:

  ``smem``  the panel in shared memory (``panel_qr_kernel``), for every panel
            whose footprint fits one block's 227 KiB;
  ``gmem``  the panel in a device-memory scratch buffer
            (``panel_qr_gmem_kernel``), for wider ones.

`variant` picks one from the panel's size alone (`smem_bytes` and
`SMEM_LIMIT` mirror the source's ``smem_bytes`` and ``kMaxSmem``), so the
choice is visible without the library.
`panel_qr` checks its inputs, allocates the outputs (and the scratch) with
``torch.empty`` and launches on the current stream through the ctypes
binding. Both variants count as ``panel_qr`` launches; the device-memory one
also counts as ``panel_qr_gmem``. It takes CUDA tensors only; the wrapper in
``ops.py`` decides between it and the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "panel_qr"
GMEM_NAME = "panel_qr_gmem"
SMEM_LIMIT = 232_448  # bytes one block may opt into on sm_90 (kMaxSmem)

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _build.library(NAME)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.pq_launch_f32, lib.pq_launch_f64):
            fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
            fn.restype = ctypes.c_int
        for fn in (lib.pq_launch_gmem_f32, lib.pq_launch_gmem_f64):
            fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
            fn.restype = ctypes.c_int
        lib.pq_gmem_scratch_elems.argtypes = [_I] * 2
        lib.pq_gmem_scratch_elems.restype = _I
        lib._repro_bound = True
    return lib


def smem_bytes(m: int, nb: int, itemsize: int) -> int:
    """Shared memory the ``smem`` variant needs for one [m, nb] panel: the
    panel (nb columns of m + 1), the reflector (m), the reduction scratch
    (33) and w = v'A (nb) — ``smem_bytes`` of the source."""
    return (nb * (m + 1) + m + 33 + nb) * itemsize


def variant(m: int, nb: int, itemsize: int) -> str:
    """``"smem"`` when an [m, nb] panel fits one block's shared memory,
    else ``"gmem"``."""
    return "smem" if smem_bytes(m, nb, itemsize) <= SMEM_LIMIT else "gmem"


def panel_qr(a: torch.Tensor):
    """(V [..., m, nb], beta [..., nb], R_panel [..., m, nb]) for CUDA panels."""
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"panel_qr takes float32 or float64, got {a.dtype}")
    if a.device.type != "cuda" or a.ndim < 2:
        raise ValueError("panel_qr takes a CUDA tensor [..., m, nb]")
    m, nb = a.shape[-2:]
    lead = a.shape[:-2]
    batch = a.numel() // max(m * nb, 1)
    a = a.contiguous()
    v = torch.empty_like(a)
    r = torch.empty_like(a)
    beta = torch.empty(lead + (nb,), dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return v, beta, r
    lib = _lib()
    f64 = a.dtype == torch.float64
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ptrs = (a.data_ptr(), v.data_ptr(), beta.data_ptr(), r.data_ptr())
    kind = variant(m, nb, a.element_size())
    if kind == "smem":
        fn = lib.pq_launch_f64 if f64 else lib.pq_launch_f32
        err = fn(*ptrs, batch, m, nb, stream)
    else:
        scratch = torch.empty(batch * lib.pq_gmem_scratch_elems(m, nb),
                              dtype=a.dtype, device=a.device)
        fn = lib.pq_launch_gmem_f64 if f64 else lib.pq_launch_gmem_f32
        err = fn(*ptrs, scratch.data_ptr(), batch, m, nb, stream)
    if err != 0:
        raise RuntimeError(f"panel_qr launch failed with CUDA error {err}")
    _platform.count_launch(NAME)
    if kind == "gmem":
        _platform.count_launch(GMEM_NAME)
    return v, beta, r
