"""A numpy emulation of the float32 flash kernel's arithmetic
(``src/repro_torch/csrc/flash_attn.cu``, 3xTF32 on the tensor cores), in
the kernel's order: the TF32 split, the tensor core's float32
accumulation, which truncates, one instruction of eight products at a
time, the two chains of S on wgmma, the fragment order of P's keys, the
online softmax with ``__expf`` and each row's sum of P over its four
lanes.

It is a model, not the kernel bit for bit: the tensor core's alignment of
the products inside one instruction and ``ex2.approx``'s own rounding are
not modelled. `tests/test_torch_flash.py` holds it against the JAX
package's Pallas kernel; ``tools/flash_mma_emulation_check.py`` holds the
kernel against it on the card. numpy only (and the port's tile table).
"""

import numpy as np
import torch

from repro_torch.kernels.flash_attn import kernel as fa_kernel


def tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero, the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _trunc32(x):
    """float64 to float32 rounded toward zero, as the tensor core's float32
    accumulator rounds (the low 29 of float64's 52 mantissa bits cleared)."""
    bits = np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)
    return (bits & np.uint64(0xFFFFFFFFE0000000)).view(np.float64).astype(
        np.float32)


def _fma32(a, b, c):
    """float32 a·b + c rounded once (nvcc contracts the kernel's a * b + c)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def mma_sum(acc, a, b, order, split: bool, group: int = 8):
    """acc + a @ b as the kernel's tensor-core instructions form it. The
    contracted index is taken eight at a time in ``order`` (the order the
    kernel's fragments hold it), and each step issues the products lo·hi,
    hi·lo, hi·hi of the TF32 split (``split``: 3xTF32; else one hi·hi
    pass). One instruction adds its eight products, exact, to the float32
    accumulator and truncates the sum toward zero (``group`` 4: each four
    products, a more lossy model the card's outputs agree with less; see
    ``tools/flash_mma_emulation_check.py``)."""
    ah, bh = tf32(a), tf32(b)
    pairs = ([(tf32(a - ah), bh), (ah, tf32(b - bh)), (ah, bh)] if split
             else [(ah, bh)])
    pairs = [(x.astype(np.float64), y.astype(np.float64)) for x, y in pairs]
    for i in range(0, len(order), 8):
        for x, y in pairs:
            for j in range(i, i + 8, group):
                idx = order[j:j + group]
                acc = _trunc32(acc + x[:, idx] @ y[idx])
    return acc


def expf(x):
    """float32 exp of the kernel's accuracy: ``__expf``, 2^(x·log2 e) with
    x·log2 e rounded to float32 (its ``ex2.approx`` taken as exact)."""
    t = x.astype(np.float32) * np.float32(1.4426950408889634)
    return np.exp2(t.astype(np.float64)).astype(np.float32)


def emulate_mma(q, k, v, qpos, kpos, causal, window, split=True,
                tile_sums=True, group=8):
    """The float32 kernel's arithmetic on the CPU, in its order, one tile of
    its BK keys (`MMA_TILES` of the head dim) at a time; the rows of a KV
    head's query heads together. S = Q·Kᵀ by `mma_sum` from zero in every
    tile (on wgmma in two chains, the even and the odd 8-column steps,
    added at the end), scaled by float32(hd^-1/2); the online softmax in
    float32 (running max from −1e30, masked keys exactly 0, `expf`), each
    row's l summed as its four lanes sum it; P·V by `mma_sum` with the keys
    of each 8 in P's fragment order (0, 2, 4, 6, 1, 3, 5, 7), into a zeroed
    accumulator added to the rescaled O by one FMA (``tile_sums``), or, as
    the kernel's first version did, straight into O after O is rescaled;
    out = O / max(l, 1e-30). ``group``: as `mma_sum`'s."""
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    _, bk, _, wgmma = fa_kernel.MMA_TILES[(torch.float32, hd)]
    chains = ([np.arange(hd).reshape(-1, 8)[c::2].ravel() for c in (0, 1)]
              if wgmma else [np.arange(hd)])
    kv_order = np.arange(bk).reshape(-1, 4, 2).transpose(0, 2, 1).ravel()
    scale = np.float32(1.0 / np.sqrt(hd))
    neg = np.float32(-1e30)
    out = np.zeros_like(q)
    for bi in range(b):
        for hk in range(hkv):
            rows = q[bi, :, hk * grp:(hk + 1) * grp].transpose(1, 0, 2)
            rows = rows.reshape(grp * tq, hd)
            rpos = np.tile(qpos, grp)[:, None]
            n = rows.shape[0]
            m = np.full(n, neg, np.float32)
            lanes = np.zeros((n, 4), np.float32)
            o = np.zeros((n, hd), np.float32)
            for k0 in range(0, tk, bk):
                kt = k[bi, k0:k0 + bk, hk]
                vt = v[bi, k0:k0 + bk, hk]
                kp = np.full(bk, -1, np.int32)
                kp[:len(kt)] = kpos[k0:k0 + bk]
                kt = np.pad(kt, ((0, bk - len(kt)), (0, 0)))
                vt = np.pad(vt, ((0, bk - len(vt)), (0, 0)))
                ok = kp[None] >= 0
                if causal:
                    ok = ok & (kp[None] <= rpos)
                if window is not None:
                    ok = ok & (kp[None] > rpos - window)
                parts = [mma_sum(np.zeros((n, bk), np.float32), rows, kt.T,
                                 c, split, group) for c in chains]
                s = parts[0] if len(parts) == 1 else parts[0] + parts[1]
                s = np.where(ok, s * scale, neg)
                mx = np.maximum(m, s.max(axis=1))
                corr = expf(m - mx)
                p = np.where(ok, expf(s - mx[:, None]), np.float32(0))
                # lane t holds keys 8j + 2t, 8j + 2t + 1, summed in key order
                psum = np.zeros((n, 4), np.float32)
                for j in range(bk // 8):
                    for e in range(2):
                        psum += p[:, 8 * j + e:8 * j + 8:2]
                lanes = _fma32(lanes, corr[:, None], psum)
                if tile_sums:
                    pv = mma_sum(np.zeros((n, hd), np.float32), p, vt,
                                 kv_order, split, group)
                    o = _fma32(o, corr[:, None], pv)
                else:
                    o = mma_sum(o * corr[:, None], p, vt, kv_order, split,
                                group)
                m = mx
            lsum = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
            res = o / np.maximum(lsum, np.float32(1e-30))[:, None]
            out[bi, :, hk * grp:(hk + 1) * grp] = res.reshape(
                grp, tq, hd).transpose(1, 0, 2)
    return out
