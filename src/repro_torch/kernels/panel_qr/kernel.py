"""Householder panel factorization with the compact-WY factor T, as
hand-written CUDA kernels (``csrc/panel_qr.cu``) in three variants, chosen
from the panel's height alone:

  ``reg``      one block per panel, two rows per thread in registers
               (``panel_qr_reg_kernel``), for m <= `CTA_ROWS`;
  ``cluster``  the same kernel on a thread-block cluster of
               ceil(m / `CTA_ROWS`) CTAs per panel, the partial sums crossing
               it through distributed shared memory, for m <=
               `CTA_ROWS` · `MAX_CLUSTER`;
  ``grid``     a cooperative grid of every co-resident CTA, each owning a
               contiguous range of a panel's rows, one grid-wide reduction
               per Householder step (``panel_qr_grid_kernel``), for taller
               ones, up to a whole R₀; it works on the panel in place and
               takes only a small workspace of partial sums (`grid_shape`).

`variant` mirrors the source's ``pq_variant_of`` (`CTA_ROWS` and
`MAX_CLUSTER` are its ``kCtaRows`` and ``kMaxCluster``), so the choice is
visible without the library; `VARIANTS` is indexed by the library's
``pq_variant``. Panels are at most `MAX_NB` columns wide.

`panel_qr_wy` factors a batch of panels in place: it reads the panel through
its row and batch strides (a column block of a larger matrix needs no copy),
writes R over it and returns (V, beta, T). `panel_qr` keeps the plain
contract — (V, beta, R) with its input untouched — by factoring a copy.
Every launch counts as ``panel_qr`` and under its variant's name. Both take
CUDA tensors only; the wrappers in ``ops.py`` decide between them and the
plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "panel_qr"
VARIANTS = ("reg", "cluster", "grid")  # by pq_variant's return value
CTA_ROWS = 256     # rows of one CTA (kCtaRows)
MAX_CLUSTER = 16   # CTAs of one panel (kMaxCluster)
MAX_NB = 32        # widest panel (kMaxNb)
NO_CLUSTER_FITS = -1

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _build.library(NAME)
    if not getattr(lib, "_repro_bound", False):
        for fn in (lib.pq_wy_launch_f32, lib.pq_wy_launch_f64):
            fn.argtypes = [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
            fn.restype = ctypes.c_int
        lib.pq_grid_shape.argtypes = [_I, _I, _I, ctypes.c_int,
                                      ctypes.POINTER(_I)]
        lib.pq_grid_shape.restype = ctypes.c_int
        lib.pq_error_name.argtypes = [ctypes.c_int]
        lib.pq_error_name.restype = ctypes.c_char_p
        lib.pq_variant.argtypes = [_I]
        lib.pq_variant.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def kernel_name(kind: str) -> str:
    """The launch-count name of one variant: ``panel_qr_<kind>``."""
    return f"{NAME}_{kind}"


def variant_of_build(m: int) -> str:
    """The variant the built library picks for a panel of ``m`` rows."""
    return VARIANTS[_lib().pq_variant(m)]


def variant(m: int) -> str:
    """``"reg"``, ``"cluster"`` or ``"grid"`` for a panel of ``m`` rows."""
    if m <= CTA_ROWS:
        return "reg"
    return "cluster" if m <= CTA_ROWS * MAX_CLUSTER else "grid"


def cluster_size(m: int) -> int:
    """CTAs per panel of the ``reg`` and ``cluster`` variants."""
    return -(-m // CTA_ROWS)


def grid_shape(batch: int, m: int, nb: int, dtype: torch.dtype) -> dict:
    """How the built ``grid`` variant lays ``batch`` panels [m, nb] over the
    current card: its co-resident CTAs (``resident``), CTAs per panel
    (``per``), panels at once (``wave``), rounds inside the launch
    (``waves``) and the workspace it takes (``work_elems``, of ``dtype``)."""
    out = (_I * 5)()
    err = _lib().pq_grid_shape(batch, m, nb, int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"panel_qr (grid): {_error(err)}")
    return dict(zip(("resident", "per", "wave", "waves", "work_elems"), out))


def _error(err: int) -> str:
    name = _lib().pq_error_name(err)
    return f"CUDA error {err} ({name.decode() if name else 'unknown'})"


def panel_qr_wy(a: torch.Tensor):
    """Factor CUDA panels ``a`` [B, m, nb] (last dimension contiguous,
    nb <= 32) in place: R is written over ``a``, zero below the diagonal.
    Returns (V [B, m, nb] unit-diagonal, beta [B, nb], T [B, nb, nb]) with
    H_1 … H_nb = I − V·T·Vᵀ."""
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"panel_qr takes float32 or float64, got {a.dtype}")
    if a.device.type != "cuda" or a.ndim != 3:
        raise ValueError("panel_qr takes a CUDA tensor [B, m, nb]")
    batch, m, nb = a.shape
    if nb > MAX_NB:
        raise ValueError(f"panel_qr takes panels at most {MAX_NB} columns "
                         f"wide, got {nb}")
    if nb > 1 and a.stride(2) != 1:
        raise ValueError("panel_qr needs the panel's columns contiguous "
                         "(stride 1 in the last dimension)")
    v = torch.empty((batch, m, nb), dtype=a.dtype, device=a.device)
    beta = torch.empty((batch, nb), dtype=a.dtype, device=a.device)
    t = torch.empty((batch, nb, nb), dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return v, beta.zero_(), t.zero_()
    lib = _lib()
    kind = variant(m)
    work = None
    if kind == "grid":
        work = torch.empty(grid_shape(batch, m, nb, a.dtype)["work_elems"],
                           dtype=a.dtype, device=a.device)
    fn = lib.pq_wy_launch_f64 if a.dtype == torch.float64 \
        else lib.pq_wy_launch_f32
    err = fn(a.data_ptr(), a.stride(1), a.stride(0), v.data_ptr(),
             beta.data_ptr(), t.data_ptr(),
             0 if work is None else work.data_ptr(),
             0 if work is None else work.numel(), batch, m, nb,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err == NO_CLUSTER_FITS:
        raise RuntimeError(f"panel_qr: no cluster of {cluster_size(m)} CTAs "
                           f"fits the card for a panel of {m} rows")
    if err != 0:
        raise RuntimeError(f"panel_qr ({kind}) launch failed: {_error(err)}")
    _platform.count_launch(NAME)
    _platform.count_launch(kernel_name(kind))
    return v, beta, t


def panel_qr(a: torch.Tensor):
    """(V [..., m, nb], beta [..., nb], R_panel [..., m, nb]) for CUDA
    panels, ``a`` untouched (the kernel factors a contiguous copy)."""
    if a.ndim < 2:
        raise ValueError("panel_qr takes a CUDA tensor [..., m, nb]")
    m, nb = a.shape[-2:]
    lead = a.shape[:-2]
    r = a.reshape((-1, m, nb)).clone(memory_format=torch.contiguous_format)
    v, beta, _ = panel_qr_wy(r)
    return (v.reshape(lead + (m, nb)), beta.reshape(lead + (nb,)),
            r.reshape(lead + (m, nb)))
