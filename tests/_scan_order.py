"""The single-pass segmented scan's order of arithmetic, emulated on the CPU.

``src/repro_torch/csrc/seg_scan.cuh`` cannot run here, so these functions
repeat its arithmetic step by step in the I/O type, with the tile shape of
`repro_torch.kernels._seg_scan.geometry`: each tile's rows in chunks scanned
serially from zero, a Hillis-Steele scan over a tile's chunks, the tiles
chained in order (a tile with a segment start, or its batch's first tile,
publishes its aggregate as its inclusive prefix; any other tile's prefix is
the previous prefix plus its aggregate — what the kernel's look-back
reproduces whichever prefix it finds), then each chunk rescanned from its
carry-in. The squared weights of the node pass are a lane of their own,
chunked over all the block's threads. Every operation is one correctly
rounded operation, as every kernel operation is one correctly rounded
intrinsic, so the emulation and the kernel agree bit for bit.

Imported by the CPU tests (against the Pallas kernels and
``segmented_cumsum``) and by the GPU tests (against the kernel); it needs
torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._seg_scan import THREADS, geometry


def _root(x):
    """A correctly rounded square root, as the kernel's (torch's vectorized
    CPU sqrt may differ from it in the last place)."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def _blocks(x, tiles, tile_rows, nchunks, chunk_rows):
    """[..., m, L] -> [..., tiles, nchunks, chunk_rows, L], zero-padded."""
    m = x.shape[-2]
    pad_m = tiles * tile_rows - m
    x = torch.nn.functional.pad(x, (0, 0, 0, pad_m))
    x = x.reshape(x.shape[:-2] + (tiles, tile_rows, x.shape[-1]))
    pad_t = nchunks * chunk_rows - tile_rows
    x = torch.nn.functional.pad(x, (0, 0, 0, pad_t))
    return x.reshape(x.shape[:-2] + (nchunks, chunk_rows, x.shape[-1]))


def tile_scan(v, first, tile_rows, chunk_rows, nchunks):
    """Segmented inclusive prefix sums of ``v`` [B, m, L] over rows (starts
    at ``first`` [m] bool), in the kernel's order: tiles of ``tile_rows``
    rows, each cut into ``nchunks`` chunks of ``chunk_rows`` rows (rows past
    the tile's end belong to no chunk)."""
    b, m, lanes = v.shape
    tiles = max(1, -(-m // tile_rows))
    vb = _blocks(v, tiles, tile_rows, nchunks, chunk_rows)
    fb = _blocks(first[:, None], tiles, tile_rows, nchunks, chunk_rows)[..., 0]
    valid = _blocks(torch.ones(m, 1, dtype=torch.bool), tiles, tile_rows,
                    nchunks, chunk_rows)[..., 0]
    if tile_rows < nchunks * chunk_rows:  # rows past the tile's end
        in_tile = torch.arange(nchunks * chunk_rows).reshape(
            nchunks, chunk_rows) < tile_rows
        valid = valid & in_tile
    x = torch.zeros(b, tiles, nchunks, lanes, dtype=v.dtype)
    cf = torch.zeros(tiles, nchunks, dtype=torch.bool)
    for k in range(chunk_rows):
        vk, fk, ok = vb[..., k, :], fb[..., k], valid[..., k]
        x = torch.where(ok[..., None], torch.where(fk[..., None], vk, x + vk),
                        x)
        cf = cf | (fk & ok)
    hx, hf = x, cf
    off = 1
    while off < nchunks:
        later = torch.where(hf[:, off:, None], hx[:, :, off:],
                            hx[:, :, :-off] + hx[:, :, off:])
        hx = torch.cat([hx[:, :, :off], later], dim=2)
        hf = torch.cat([hf[:, :off], hf[:, off:] | hf[:, :-off]], dim=1)
        off *= 2
    agg = hx[:, :, -1]                      # [B, tiles, L]
    tile_start = cf.any(dim=1)              # [tiles]
    carry = torch.zeros_like(agg)
    inc = agg[:, 0]
    for t in range(1, tiles):
        carry[:, t] = inc
        inc = agg[:, t] if bool(tile_start[t]) else inc + agg[:, t]
    chunk_carry = torch.cat(
        [carry[:, :, None],
         torch.where(hf[:, :-1, None], hx[:, :, :-1],
                     carry[:, :, None] + hx[:, :, :-1])], dim=2)
    run = chunk_carry
    out = torch.empty_like(vb)
    for k in range(chunk_rows):
        vk, fk, ok = vb[..., k, :], fb[..., k], valid[..., k]
        run = torch.where(ok[..., None],
                          torch.where(fk[..., None], vk, run + vk), run)
        out[..., k, :] = run
    out = out.reshape(b, tiles, nchunks * chunk_rows, lanes)[:, :, :tile_rows]
    return out.reshape(b, tiles * tile_rows, lanes)[:, :m]


def _data_scan(v, first, mode):
    """The data lanes of ``v`` [B, m, n] in the geometry of ``mode``."""
    n = v.shape[-1]
    g = geometry(n, v.element_size(), mode)
    return tile_scan(v, first, g.tile_rows, g.rpt, g.tpc)


def _batched(x):
    return x.reshape((-1,) + x.shape[-2:])


def cumsum_order(x, first):
    """The cumsum mode: ``x`` [m] or [..., m, n]."""
    if x.ndim == 1:
        return _data_scan(x[None, :, None], first, "cumsum")[0, :, 0]
    return _data_scan(_batched(x), first, "cumsum").reshape(x.shape)


def tail_order(data, wa, first, coef_a, coef_b):
    """The tail mode (the TPU segmented_tail_kernel's contract)."""
    s = _data_scan(_batched(wa), first, "tail").reshape(wa.shape)
    col = lambda v: v[:, None]
    return col(coef_a) * data + col(coef_b) * (s - wa)


def contract_order(data, data_scale, weights, first, coef_a, coef_b,
                   emit_scale):
    """The contract mode (the TPU node_fused_kernel's contract):
    (emitted, s_incl)."""
    col = lambda v: v[:, None]
    d = data * col(data_scale)
    wa = d * col(weights)
    s = _data_scan(_batched(wa), first, "contract").reshape(wa.shape)
    emitted = col(emit_scale) * (col(coef_a) * d + col(coef_b) * (s - wa))
    return emitted, s


def node_pass_order(data, weights, pos_in_seg, emit_scale, last_of_seg,
                    seg_live, *, data_scale=None):
    """The node-pass mode: (slab, heads, norms), inputs as for
    ``fused_node_pass`` (row vectors in the data's dtype)."""
    m, n = data.shape[-2:]
    col = lambda v: v[:, None]
    first = pos_in_seg == 0
    d = data * col(data_scale) if data_scale is not None else data
    wa = d * col(weights)
    s = _data_scan(_batched(wa), first, "pass").reshape(wa.shape)
    g = geometry(n, data.element_size(), "pass")
    w2 = weights * weights
    c = tile_scan(w2[None, :, None], first, g.tile_rows, g.rw,
                  THREADS)[0, :, 0]
    one = torch.ones((), dtype=data.dtype)
    cex = torch.where(first, one, c - w2)
    coef_a = _root(cex / c)
    coef_b = -(weights / _root(cex * c))
    emit = torch.where(first, torch.zeros((), dtype=data.dtype), emit_scale)
    slab = col(emit) * (col(coef_a) * d + col(coef_b) * (s - wa))
    last = torch.clamp(last_of_seg, 0, m - 1)
    norm = _root(c[last])
    heads = s[..., last, :] / torch.where(norm > 0, norm, one)[:, None]
    heads = torch.where(seg_live[:, None], heads, torch.zeros((), dtype=data.dtype))
    norms = torch.where(seg_live, norm, torch.zeros((), dtype=data.dtype))
    return slab, heads, norms
