"""Fused attention forward as hand-written CUDA kernels, chosen by dtype:

- bfloat16: ``csrc/flash_attn_sm90.cu``, for Hopper's tensor cores — one
  block per (batch, query head, 128 query rows), two consumer warpgroups
  running wgmma on Q·Kᵀ and P·V, one producer warp feeding K and V tiles by
  TMA through a two-stage ring;
- float32 and float64: ``csrc/flash_attn.cu``, also on the tensor cores —
  float32 as 3xTF32 (each operand split into TF32 hi and lo parts, three
  products into one float32 sum), on wgmma up to hd 128 and on mma.sync at
  hd 256, and float64 on the FP64 tensor cores (DMMA, mma.sync); one block
  per (batch, KV head, query rows of its GQA group), K and V tiles fed by
  cp.async. Its variant is ``"mma"``, counted as `MMA_NAME`.

`flash_attention` checks its inputs, allocates the output with
``torch.empty`` and launches on the current stream through the ctypes
binding. It takes CUDA tensors only; the wrapper in ``ops.py`` decides
between it and the plain version. A kernel that does not build or launch
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _platform

NAME = "flash_attention"  # counted for every launch, of either kernel
SM90_NAME = "flash_attention_sm90"
MMA_NAME = "flash_attention_mma"
SOURCE = "flash_attn"
SM90_SOURCE = "flash_attn_sm90"
MMA_DTYPES = {torch.float32: 1, torch.float64: 2}  # fa_launch's codes
DTYPES = (torch.bfloat16, *MMA_DTYPES)
HEAD_DIMS = (32, 64, 128, 256)
# flash_attn_sm90.cu's tiles per head dim: (query rows BQ, keys per tile BK),
# and its ring of K/V stages.
SM90_TILES = {32: (128, 128), 64: (128, 128), 128: (128, 128), 256: (128, 64)}
SM90_STAGES = 2
# flash_attn.cu's tiles per (dtype, head dim): (warps of 16 query rows, keys
# per tile BK, output columns per block, the products on wgmma (float32: two
# warpgroups) rather than mma.sync).
MMA_TILES = {
    (torch.float32, 32): (8, 32, 32, True),
    (torch.float32, 64): (8, 32, 64, True),
    (torch.float32, 128): (8, 32, 128, True),
    (torch.float32, 256): (4, 16, 256, False),
    (torch.float64, 32): (8, 64, 32, False),
    (torch.float64, 64): (8, 32, 64, False),
    (torch.float64, 128): (8, 32, 128, False),
    (torch.float64, 256): (4, 16, 128, False),
}
SMEM_LIMIT = 232_448  # shared memory one block may take on the H100

_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int


def bind(lib, source: str = SOURCE):
    """Declare the C signatures of a loaded library of ``source`` (also
    one built elsewhere from a variant of it, as the tools do)."""
    if source == SM90_SOURCE:
        lib.fa_sm90_launch.argtypes = ([_P] * 6 + [_I] * 6 + [_C, _C, _I]
                                       + [_P])
        lib.fa_sm90_launch.restype = _C
        lib.fa_sm90_smem_bytes.argtypes = [_I]
        lib.fa_sm90_smem_bytes.restype = _C
    else:
        lib.fa_launch.argtypes = ([_C] + [_P] * 6 + [_I] * 6 + [_C, _C, _I]
                                  + [_P])
        lib.fa_launch.restype = _C
        lib.fa_smem_bytes.argtypes = [_C, _I]
        lib.fa_smem_bytes.restype = _C
    return lib


def _lib(source: str):
    lib = _build.library(source)
    if not getattr(lib, "_repro_bound", False):
        bind(lib, source)
        lib._repro_bound = True
    return lib


def variant(dtype: torch.dtype) -> str:
    """``"sm90"`` (``flash_attn_sm90.cu``) for bfloat16; ``"mma"``
    (``flash_attn.cu``) for float32, on wgmma up to hd 128 and on mma.sync
    at hd 256, and for float64, on DMMA (mma.sync)."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {list(DTYPES)}, got {dtype}")
    return "sm90" if dtype == torch.bfloat16 else "mma"


def sm90_smem_bytes(hd: int) -> int:
    """Shared memory one block of the sm90 kernel takes at head dim ``hd``:
    1 KiB of alignment slack, the Q tile, two K and V tiles per stage and
    64 bytes of barriers — ``Tile<HD>::kSmem`` of the source."""
    bq, bk = SM90_TILES[hd]
    return 1024 + bq * hd * 2 + SM90_STAGES * 2 * bk * hd * 2 + 64


def mma_smem_bytes(dtype: torch.dtype, hd: int) -> int:
    """Shared memory one block of the float32/float64 kernel takes:
    ``Tile<T, HD>::kSmem`` of the source. On wgmma (float32), 1 KiB of
    alignment slack and swizzled TF32 hi and lo parts of Q (all the block's
    rows), of the K tile and of Vᵀ; on mma.sync, float32 keeps one hi/lo
    split of the K and V tiles in fragment order, and Q takes (16 rows per
    warp) x (hd + 4). The one raw stage holds a K tile at row pitch hd + 4
    and a V tile at (output columns) + 4 (float32) or + 2 (float64); then,
    as int32, the key positions of the stage and of the tile being
    computed, one ballot word per 32 keys of a 32-tile window, and the
    block's two query position extremes (and each warpgroup's, on
    wgmma)."""
    warps, bk, cols, wgmma = MMA_TILES[(dtype, hd)]
    f32 = dtype == torch.float32
    item = 4 if f32 else 8
    rows = 16 * warps
    if wgmma:
        split = 256 + 2 * rows * hd + 4 * bk * hd
    else:
        split = 2 * bk * (hd + cols) if f32 else 0
    stage = bk * (hd + 4) + bk * (cols + (4 if f32 else 2))
    q = 0 if wgmma else rows * (hd + 4)
    ints = 3 * bk + 2 + (4 if wgmma else 0)
    return item * (split + stage + q) + 4 * ints


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int | None = None):
    """Attention of CUDA q [B, Tq, Hq, hd] over k/v [B, Tk, Hkv, hd] with
    Hq % Hkv == 0; q_pos [Tq] and k_pos [Tk] integer positions (−1 = padded
    key). Returns [B, Tq, Hq, hd] in q's dtype (bfloat16, float32 or
    float64; hd in `HEAD_DIMS`)."""
    kind = variant(q.dtype)
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
    # TMA (bfloat16) and cp.async (float32, float64) read from 16-byte
    # aligned addresses: a view at an odd offset is copied.
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (q.contiguous(), k.contiguous(), v.contiguous()))
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), b, tq, tk, hq, hkv, hd,
            int(causal), int(window is not None),
            0 if window is None else int(window), stream)
    if kind == "sm90":
        err = _lib(SM90_SOURCE).fa_sm90_launch(*args)
    else:
        err = _lib(SOURCE).fa_launch(MMA_DTYPES[q.dtype], *args)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed with "
                           f"error {err} (a CUDA error code, or 10000 + a "
                           "CUresult when a TMA tensor map was refused)")
    _platform.count_launch(NAME)
    _platform.count_launch(SM90_NAME if kind == "sm90" else MMA_NAME)
    return out


def smem_bytes_of_build(hd: int) -> int:
    """The sm90 kernel's shared memory at ``hd`` as the built source states
    it (loads the library; the card only)."""
    return int(_lib(SM90_SOURCE).fa_sm90_smem_bytes(hd))


def mma_smem_bytes_of_build(dtype: torch.dtype, hd: int) -> int:
    """The float32/float64 kernel's shared memory as the built source
    states it (loads the library; the card only)."""
    return int(_lib(SOURCE).fa_smem_bytes(MMA_DTYPES[dtype], hd))
