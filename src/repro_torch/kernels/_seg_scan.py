"""Host side of the single-pass segmented scan (``csrc/seg_scan.cuh``).

The scan is shared by the node_fused and head_tail kernels, each in its own
modes (``MODES``). This module mirrors the kernel's launch shape
(`geometry`, checked against the source text on the CPU and against the
build on the card), allocates a launch's scratch with one ``torch.empty``,
and keeps the error word the kernel writes when a look-back runs out of its
spin bound: a pinned host word the card writes through its mapping, read
here without a synchronize. A wrapper calls `raise_if_timed_out` before it
launches, so a timed-out launch raises at the next launch at the latest;
`check` synchronizes first and raises for every launch so far.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.sanitizer.locks import san_lock

__all__ = ["THREADS", "SMEM_BUDGET", "MODES", "Geometry", "geometry",
           "error_word", "raise_if_timed_out", "check", "scratch", "launch"]

THREADS = 256        # kThreads
SMEM_BUDGET = 48 * 1024  # kSmemBudget
# mode -> (code, staged [rows, n] matrices, per-row arrays of T (for 4- and
# 8-byte T), of int32 and of int64, w² lane): mats_of, row_t_of, row_i_of,
# row_l_of and w2_of in the source.
MODES = {"pass": (0, 1, (4, 5), 1, 1, True), "contract": (1, 2, 5, 0, 0, False),
         "tail": (2, 2, 2, 0, 0, False), "cumsum": (3, 1, 0, 0, 0, False)}


@dataclasses.dataclass(frozen=True)
class Geometry:
    tpc: int        # threads per data column
    rpt: int        # rows one thread scans serially (odd)
    tile_rows: int  # tpc * rpt
    rw: int         # rows of the w² lane per thread
    pitch: int      # row pitch of a staged matrix (odd)


def geometry(n: int, itemsize: int, mode: str) -> Geometry:
    """The kernel's tile for n columns of ``itemsize``-byte values
    (``segscan::geometry``)."""
    _, mats, row_t, row_i, row_l, _ = MODES[mode]
    if isinstance(row_t, tuple):
        row_t = row_t[itemsize == 8]
    tpc = THREADS if n == 0 else (THREADS // n if n <= THREADS else 1)
    pitch = n | 1
    per_row = (mats * pitch * itemsize + row_t * itemsize + 4 * row_i
               + 8 * row_l + 1)
    rpt = max(1, (SMEM_BUDGET // per_row) // tpc)
    if rpt % 2 == 0:
        rpt -= 1
    tile_rows = tpc * rpt
    return Geometry(tpc, rpt, tile_rows, -(-tile_rows // THREADS), pitch)


_error = None
_error_lock = san_lock("seg_scan._error_lock")


def error_word():
    """(pinned int32 tensor, its numpy view): the word the kernels write
    their error code into. Created on first use."""
    global _error
    with _error_lock:
        if _error is None:
            word = torch.zeros(1, dtype=torch.int32, pin_memory=True)
            _error = (word, word.numpy())
        return _error


def raise_if_timed_out() -> None:
    """Raise if a launch so far (that has finished) ran out of its look-back
    spin bound; its outputs are then wrong."""
    if _error is not None and _error[1][0] != 0:
        raise RuntimeError(
            "a segmented-scan launch timed out waiting for a predecessor "
            "tile's prefix (look-back spin bound); its outputs are invalid")


def check() -> None:
    """Synchronize the card and raise if any launch so far timed out."""
    torch.cuda.synchronize()
    raise_if_timed_out()


def scratch(lib_geometry, batch, m, n, dtype, mode, device):
    """The uint8 scratch of one launch (the kernel zeroes what needs it):
    its size comes from the library's own ``*_geometry``."""
    import ctypes

    out = (ctypes.c_int64 * 9)()
    lib_geometry(batch, m, n, dtype.itemsize, MODES[mode][0], out)
    return torch.empty(int(out[7]), dtype=torch.uint8, device=device)


def launch(fn, name, args, stream) -> None:
    """Call a library's launch function with ``args``, the error word and the
    stream; raise if it returns a CUDA error, or if an earlier launch timed
    out."""
    raise_if_timed_out()
    err = fn(*args, error_word()[0].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
