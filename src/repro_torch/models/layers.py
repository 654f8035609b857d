"""Shared neural layers of the LM: norms, RoPE, GQA attention, the dense MLP.

The port of the JAX package's ``models/layers.py``. Its ``init_*`` /
``apply_*`` pairs become modules (`RMSNorm`, `LayerNorm`, `Attention`,
`MLP`) whose parameters keep the JAX shapes (``wq [d, Hq, hd]``,
``wo [Hq, hd, d]``, ``w_gate [d, ff]``, …) so a JAX parameter tree loads as
it is (`models.weights.params_from_jax`). A module's ``init_`` fills its
parameters from an explicit `torch.Generator`; the constructor leaves them
uninitialized. Weights are cast to the compute dtype at the call, as JAX
casts them. Attention is ported in its train branch, its KV-cache branch
(prefill, decode; a linear buffer, or a ring buffer under a sliding
window), which writes the cache's tensors in place, and its cross branch
(the decoder's attention over the encoder's output, or over the K/V a
prefill cached from it). The flash branch raises `NotImplementedError`
whenever autograd would record through it (`FLASH_NO_BACKWARD`).

Over a mesh each layer splits its compute over the ``model`` axis on the
layout of `repro_torch.sharding.rules` (``self.tp``, a
`repro_torch.sharding.collectives.ModelAxis`; without a mesh the trivial
axis, whose collectives are the identity, and the same code runs):
attention on the rank's q heads (``wq``, ``wo``) and on the kv heads they
read (``wk``/``wv`` split with them where the kv heads divide the axis,
else held whole and cut), or, where the heads do not divide the axis,
row-parallel (``wq``/``wk``/``wv`` on the rank's rows of d, all heads
attended, ``wo``'s columns gathered); the MLP on its ff columns. The cache
branches read and write the rank's part of a cache laid out by
`repro_torch.sharding.cache` (``cache["split"]``, a `CacheSplit`): where
the cache holds the rank's kv heads they attend as training does; where it
holds every kv head on the rank's slots (``kv_seq_over_model``, or the
slots over ``data`` under ``shard_seq``) the rank gathers every q head,
attends over its slots and combines the online softmax's statistics over
the slot group (`_attend_cache`), then keeps its own heads for ``wo``;
where it holds the rank's columns of the head dim, the logits are summed
over ``model`` and the output's columns gathered. A decode step's slot is
written by the rank that holds it, decided on the device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.cache import TRIVIAL_SPLIT
from repro_torch.sharding.collectives import TRIVIAL
from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}

_PAD_POS = 2**31 - 1  # int32 max: a padded key slot

# The flash branch runs the forward only: on the card its CUDA kernel writes
# an output autograd never sees, so a backward through it would give the
# attention weights no gradient. The branch refuses to record instead, on
# every device, as the JAX package's ``jax.grad`` through its kernel fails.
FLASH_NO_BACKWARD = (
    "use_flash_kernel=True has no backward: the JAX package's flash kernel "
    "defines none, so training takes the _attend path "
    "(use_flash_kernel=False); run the flash branch under torch.no_grad() "
    "or torch.inference_mode()")


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype norms, softmax and logits of ``dtype`` values are computed
    in: float32, or float64 for float64 (a float64 reference keeps no
    float32 step)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in `wide_dtype`."""
    return t.to(wide_dtype(t.dtype))


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> torch.Tensor:
    """Truncated normal on [−2, 2] times ``scale``, by default 1/√fan_in
    with fan_in = shape[0] (the JAX package's ``dense_init``, ``wo`` and
    the expert stacks [E, d, ff], whose fan_in is E, included)."""
    if scale is None:
        scale = 1.0 / math.sqrt(w.shape[0] if w.ndim >= 2 else 1)
    if w.dtype == torch.float32:
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(scale)
    # Drawn in float32 in slices of at most 2**28 elements: a float32 copy
    # of a whole expert stack (arctic's [128, 7168, 4864]) would take 18 GB.
    for part in w.split(max(1, (1 << 28) // max(1, w[0].numel()))):
        tmp = torch.empty(part.shape, dtype=torch.float32, device=w.device)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
        part.copy_(tmp.mul_(scale))
    return w


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """RMS norm in float32, cast back to the input dtype (``norm="rms"``)."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    @torch.no_grad()
    def init_(self, generator=None):
        self.scale.fill_(1.0)

    def forward(self, x):
        xf = wide(x)
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6)
                * self.scale.to(xf.dtype)).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm with scale and bias in float32 (``norm="layer"``)."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device)

    @torch.no_grad()
    def init_(self, generator=None):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        xf = wide(x)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        return (y * self.scale.to(xf.dtype)
                + self.bias.to(xf.dtype)).to(x.dtype)


def make_norm(cfg: ModelConfig, d: int | None = None, device=None):
    cls = LayerNorm if cfg.norm == "layer" else RMSNorm
    return cls(d or cfg.d_model, dtype_of(cfg.param_dtype), device)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = wide(x)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.to(xf.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None,
               dtype=torch.float32) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=dtype,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    xf = wide(x)
    freqs = rope_freqs(x.shape[-1], theta, x.device, xf.dtype)
    ang = positions[..., None].to(xf.dtype) * freqs  # [..., T, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm / sliding window / cross-attention)
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, causal: bool, window: int | None, dtype):
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = (kp != _PAD_POS) & (kp >= 0)  # padded / unwritten cache slots
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    return torch.where(ok, zero, torch.finfo(dtype).min)


def _sdpa(q, k, v, bias):
    """q [B,Tq,Hq,hd], k/v [B,Tk,Hkv,hd] (GQA broadcast), bias [Tq,Tk]."""
    b, tq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, tq, hkv, hq // hkv, hd)
    logits = wide(torch.einsum("bqkgd,bskd->bkgqs", qg, k))
    logits = logits / math.sqrt(hd)
    logits = logits + bias.to(logits.dtype)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, tq, hq, hd)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window, block_kv: int,
                    split=TRIVIAL_SPLIT, hd: int | None = None):
    """Online softmax over KV blocks; activation memory O(Tq·block_kv).

    Over a rank's part of a cache, ``split`` (a `CacheSplit` of the
    cache's ``k``) says how the part lies. Where it splits the head dim,
    q and the cache hold the rank's columns: the logits are summed over
    the ranks (the scale is √``hd``, the whole head dim), and the output's
    columns gathered. Where it splits the slots, the statistics are
    combined over the slot group: the max of m, each rank's l and acc
    rescaled to it, then summed. `TRIVIAL_SPLIT` splits neither."""
    b, tq, hq, hdc = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    block_kv = min(block_kv, tk)  # a block holds at most the rank's slots
    nb = -(-tk // block_kv)
    pad = nb * block_kv - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_PAD_POS)
    kb = k.reshape(b, nb, block_kv, hkv, hdc)
    vb = v.reshape(b, nb, block_kv, hkv, hdc)
    pb = k_pos.reshape(nb, block_kv)
    # As JAX: the scale is √hd rounded to q's dtype, divided in q's dtype.
    qg = q.reshape(b, tq, hkv, g, hdc) / torch.tensor(math.sqrt(hd or hdc),
                                                      dtype=q.dtype)
    wd = wide_dtype(q.dtype)
    m = torch.full((b, hkv, g, tq), float("-inf"), dtype=wd, device=q.device)
    l = torch.zeros((b, hkv, g, tq), dtype=wd, device=q.device)
    acc = torch.zeros((b, hkv, g, tq, hdc), dtype=wd, device=q.device)
    for i in range(nb):
        logits = split.reduce(wide(torch.einsum(
            "bqkgd,bskd->bkgqs", qg, kb[:, i])), "k", 3)
        logits = logits + _mask_bias(q_pos, pb[i], causal, window, wd)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + wide(torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(q.dtype), vb[:, i]))
        m = m_new
    if split.split("k", 1):  # the slot group's statistics combined
        m_all = split.reduce(m, "k", 1, op="max")
        corr = torch.exp(m - m_all)
        l = split.reduce(l * corr, "k", 1)
        acc = split.reduce(acc * corr[..., None], "k", 1)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, tq, hq, hdc)
    return split.gather(out, "k", 3, 3, out=True)


def _attend_cache(q, k, v, q_pos, k_pos, causal, window, block_kv: int,
                  split, hd: int):
    """Attention of q [B, Tq, Hq, hd_c] over the rank's part of a cache
    (k, v [B, S_r, Hkv, hd_c], its slots' positions ``k_pos`` [S_r]): as
    training's (`_attend`) where ``split`` splits neither the slots nor
    the head dim, else `_sdpa_blockwise` over the part with ``split``."""
    if not (split.split("k", 1) or split.split("k", 3)):
        return _attend(q, k, v, q_pos, k_pos, causal, window, block_kv)
    return _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window, block_kv,
                           split, hd)


def _attend(q, k, v, q_pos, k_pos, causal, window, block_kv):
    """Dispatch direct vs. blockwise (online-softmax) attention."""
    if k.shape[1] > block_kv:
        return _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window,
                               block_kv)
    bias = _mask_bias(q_pos, k_pos, causal, window, wide_dtype(q.dtype))
    return _sdpa(q, k, v, bias)


def _proj(x, w):
    """einsum("btd,dhk->bthk") as one matmul."""
    b, t, d = x.shape
    return (x.reshape(b * t, d) @ w.reshape(d, -1)).reshape(
        (b, t) + tuple(w.shape[1:]))


class Attention(nn.Module):
    """GQA attention: self-attention in train mode (no cache), prefill and
    decode; cross-attention over an encoder's output."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        dt = dtype_of(cfg.param_dtype)
        self.wq = _param((d, nq, hd), dt, device)
        self.wk = _param((d, nkv, hd), dt, device)
        self.wv = _param((d, nkv, hd), dt, device)
        self.wo = _param((nq, hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), dt, device)
            self.k_norm = _param((hd,), dt, device)
        self.tp = TRIVIAL  # the model axis (`Placement.shard` sets it)

    @torch.no_grad()
    def init_(self, generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        if hasattr(self, "q_norm"):
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)

    def forward(self, x, cfg: ModelConfig, *, positions=None,
                causal: bool = True, cross: bool = False, kv_x=None,
                cache=None, cache_pos=None):
        """Modes, as JAX's ``attention``:

          train:    cache=None  -> attend over x (blockwise if long)
          prefill:  cache given, T > 1  -> attend over x, then fill the cache
          decode:   cache given, T == 1 -> write one slot, attend over the
                    whole cache
          cross:    cross=True  -> attend over ``kv_x`` [B, Tk, d], or over
                    the ``{"k", "v"}`` of a cache that holds them

        ``cache`` is one layer's ``{"k", "v", "pos"}`` (`init_attn_cache`);
        ``cache_pos`` the 0-d write position of a decode step, a device
        tensor. Returns ``(y, cache)``: the cache's tensors are written in
        place and the same dict comes back (None in train mode), where JAX
        returns a new one. A decode step reads no device value on the host,
        so it can be captured into a CUDA graph. The cross branch writes
        nothing and returns the cache it was given.
        """
        b, t, _ = x.shape
        cdt = dtype_of(cfg.compute_dtype)
        if positions is None:
            positions = torch.arange(t, device=x.device)
        xc = self._in(x).to(cdt)
        q = self._heads(xc, self.wq, cdt)
        if cfg.qk_norm:
            q = rms_norm_vec(q, self._whole(self.q_norm))
        if cross:
            return self._cross(x, q, cfg, positions, kv_x, cache), cache
        # With a cache, K and V of every kv head the rank's weights give
        # (the cache may hold kv heads its q heads do not read).
        k, v = self._kv(xc, cfg, cdt, every=cache is not None)
        if cfg.qk_norm:
            k = rms_norm_vec(k, self._whole(self.k_norm))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        window = cfg.swa_window
        if cache is None:  # train
            if cfg.use_flash_kernel:
                if torch.is_grad_enabled() and (
                        q.requires_grad or k.requires_grad
                        or v.requires_grad):
                    raise NotImplementedError(FLASH_NO_BACKWARD)
                from repro_torch.kernels.flash_attn import ops as fa_ops
                pos = positions.to(torch.int32)
                out = fa_ops.flash_attention(q, k, v, pos, pos, causal=causal,
                                             window=window)
            else:
                out = _attend(q, k, v, positions, positions, causal, window,
                              cfg.attn_block_kv)
        elif t == 1:  # decode step
            split = cache.get("split", TRIVIAL_SPLIT)
            _write_slot(cache, split, self._cache_part(k, split),
                        self._cache_part(v, split), positions, cache_pos,
                        window)
            s0, s1 = split.span("k", 1, cache["pos"].shape[0])
            out = _attend_cache(self._cache_q(q, split),
                                cache["k"].to(cdt), cache["v"].to(cdt),
                                positions, cache["pos"][s0:s1], True,
                                window, cfg.attn_block_kv, split,
                                q.shape[-1])
            out = self._own_heads(out, split)
        else:  # prefill: attend over the prompt itself, then fill the cache
            split = cache.get("split", TRIVIAL_SPLIT)
            ks, vs = self._read_kv(k, v, cfg)
            out = _attend(q, ks, vs, positions, positions, causal, window,
                          cfg.attn_block_kv)
            _fill_cache(cache, split, self._cache_part(k, split),
                        self._cache_part(v, split), positions)
        return self._out(out, x, cdt), cache

    # -- the split over `model` ---------------------------------------------

    def _rows(self) -> bool:
        """Row-parallel: the heads do not divide the model axis, so
        ``wq``/``wk``/``wv`` hold the rank's rows of d."""
        return self.tp.split("wq", 0)

    def _in(self, x):
        """An input held alike over ``model`` for the rank's projections:
        copied in, and cut to the rank's rows of d where row-parallel."""
        x = self.tp.copy(x)
        if self._rows():
            r0, r1 = self.tp.span("wq", 0, self.wq.shape[0])
            x = x[..., r0:r1]
        return x

    def _whole(self, w):
        """A parameter held whole over ``model`` for per-head work: copied
        in where the rank works on its own heads, as it is where every
        rank works on all of them (row-parallel)."""
        return w if self._rows() else self.tp.copy(w)

    def _heads(self, xc, w, cdt):
        """``_proj`` of ``xc`` (from `_in`) on ``w``: the rank's heads, or
        all heads' sums over the ranks' rows where row-parallel."""
        y = _proj(xc, w.to(cdt))
        return self.tp.reduce(y) if self._rows() else y

    def _kv(self, src, cfg: ModelConfig, cdt, *, every: bool = False):
        """K and V of ``src`` (from `_in`) for the rank's q heads: all kv
        heads where row-parallel or one rank; the rank's kv heads where
        they divide the axis; else (``wk``/``wv`` held whole) the kv heads
        its q heads read, repeated per q head where its q heads do not
        fall on whole GQA groups — or, with ``every``, all kv heads
        (`_read_kv` then takes the ones its q heads read)."""
        tp = self.tp
        wk, wv = self.wk, self.wv
        if self._rows() or tp.split("wk", 1):
            return self._heads(src, wk, cdt), self._heads(src, wv, cdt)
        if tp.split("wq", 1):  # held whole, read in part by this rank
            wk, wv = tp.copy(wk), tp.copy(wv)
        if every:
            return _proj(src, wk.to(cdt)), _proj(src, wv.to(cdt))
        k0, k1 = self._kv_span(cfg)
        if (k0, k1) != (0, cfg.n_kv_heads):
            wk, wv = wk[:, k0:k1], wv[:, k0:k1]
        return self._repeat(_proj(src, wk.to(cdt)), _proj(src, wv.to(cdt)),
                            cfg)

    def _kv_span(self, cfg: ModelConfig) -> tuple[int, int]:
        """The kv heads [k0, k1) the rank's q heads read."""
        g = cfg.n_heads // cfg.n_kv_heads
        h0, h1 = self.tp.span("wq", 1, cfg.n_heads)
        return h0 // g, (h1 - 1) // g + 1

    def _repeat(self, k, v, cfg: ModelConfig):
        """K, V of the kv heads [k0, k1) repeated per q head where the
        rank's q heads do not fall on whole GQA groups."""
        g = cfg.n_heads // cfg.n_kv_heads
        h0, h1 = self.tp.span("wq", 1, cfg.n_heads)
        k0, k1 = self._kv_span(cfg)
        if k1 - k0 > 1 and (h0 % g or h1 % g):
            idx = torch.arange(h0, h1, device=k.device) // g - k0
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return k, v

    def _read_kv(self, k, v, cfg: ModelConfig):
        """Of `_kv`'s ``every`` K and V, the ones the rank's q heads read
        (what `_kv` gives without it)."""
        if self._rows() or self.tp.split("wk", 1):
            return k, v
        k0, k1 = self._kv_span(cfg)
        if (k0, k1) != (0, cfg.n_kv_heads):
            k, v = k[:, :, k0:k1], v[:, :, k0:k1]
        return self._repeat(k, v, cfg)

    # -- the cache's layout ----------------------------------------------------

    def _gathers_q(self, split) -> bool:
        """Whether the rank attends with every q head over its part of the
        cache: the cache holds every kv head, and the rank's q heads are
        its own."""
        return not split.split("k", 2) and self.tp.split("wq", 1)

    def _cache_part(self, k, split):
        """`_kv`'s ``every`` K (or V) as the cache holds it: the rank's
        columns of the head dim where the cache splits it."""
        if split.split("k", 3):
            c0, c1 = split.span("k", 3, k.shape[-1])
            k = k[..., c0:c1]
        return k

    def _cache_q(self, q, split):
        """q as it attends over the rank's part of the cache: every head
        (gathered) where `_gathers_q`, its columns where the cache splits
        the head dim."""
        if self._gathers_q(split):
            q = self.tp.gather(q, 2, "wq", 1)
        return self._cache_part(q, split)

    def _own_heads(self, out, split):
        """The rank's heads of an attention output over every head."""
        if self._gathers_q(split):
            h0, h1 = self.tp.span("wq", 1, self.wq.shape[1])
            out = out[:, :, h0:h1]
        return out

    def _cross(self, x, q, cfg: ModelConfig, positions, kv_x, cache):
        """The cross branch: no RoPE, every key visible (keys at
        ``arange(Tk)``, no causality, no window), never the flash kernel,
        as JAX's. Without a cache K and V come from ``kv_x`` (``k_norm``
        applied under qk-norm) through ``_attend``. With one, a prefill
        (``kv_x`` given) first writes ``kv_x``'s K and V, without
        ``k_norm`` (what JAX's ``_fill_cross_caches`` stores), into the
        rank's part of it; the branch then attends over that part
        (`_attend_cache`)."""
        cdt = q.dtype
        if cache is None:
            k, v = self._kv(self._in(kv_x).to(cdt), cfg, cdt)
            if cfg.qk_norm:
                k = rms_norm_vec(k, self._whole(self.k_norm))
            k_pos = torch.arange(k.shape[1], device=k.device)
            out = _attend(q, k, v, positions, k_pos, False, None,
                          cfg.attn_block_kv)
            return self._out(out, x, cdt)
        split = cache.get("split", TRIVIAL_SPLIT)
        ck, cv = cache["k"], cache["v"]
        tk = split.full("k", 1, ck.shape[1])
        s0, s1 = split.span("k", 1, tk)
        if kv_x is not None:
            k, v = self._kv(self._in(kv_x).to(cdt), cfg, cdt, every=True)
            ck.copy_(self._cache_part(k, split)[:, s0:s1])
            cv.copy_(self._cache_part(v, split)[:, s0:s1])
        k_pos = torch.arange(s0, s1, device=ck.device)
        out = _attend_cache(self._cache_q(q, split), ck.to(cdt),
                            cv.to(cdt), positions, k_pos, False, None,
                            cfg.attn_block_kv, split, q.shape[-1])
        return self._out(self._own_heads(out, split), x, cdt)

    def cross_kv(self, enc_out, cfg: ModelConfig):
        """The K and V the cross branch reads from ``enc_out`` [B, Tk, d]
        for the rank's q heads, in the compute dtype and without
        ``k_norm``: what JAX's ``_fill_cross_caches`` stores in a
        prefill's cache."""
        cdt = dtype_of(cfg.compute_dtype)
        return self._kv(self._in(enc_out).to(cdt), cfg, cdt)

    def _out(self, out, x, cdt):
        """The output projection ``einsum("bthk,hkd->btd")`` in ``cdt``,
        cast to ``x``'s dtype: the rank's heads' part summed over the
        ranks, or, row-parallel, the rank's columns of d gathered."""
        b, t = out.shape[:2]
        nq, hd, d = self.wo.shape
        if self._rows():
            out = self.tp.copy(out)
        y = out.reshape(b * t, nq * hd) @ self.wo.to(cdt).reshape(nq * hd, d)
        y = y.reshape(b, t, d)
        if self._rows():
            y = self.tp.gather(y, -1, "wo", 2)
        else:
            y = self.tp.reduce(y)
        return y.to(x.dtype)


def _fill_cache(cache, split, k, v, positions) -> None:
    """Prefill's write of a prompt's K, V (as the cache holds them) and
    positions into ``cache``: at slots [0, t) when the prompt fits, else
    its last ``slots`` rows rolled by ``t % slots`` (ring-aligned), as
    JAX's prefill branch; the rank writes its slots [s0, s1) of that, and
    the whole ``pos`` leaf."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    t, slots = k.shape[1], cp.shape[0]
    s0, s1 = split.span("k", 1, slots)
    if t <= slots:
        n = max(0, min(s1, t) - s0)
        ck[:, :n] = k[:, s0:s0 + n]
        cv[:, :n] = v[:, s0:s0 + n]
        cp[:t] = positions
    else:  # ring buffer (SWA), or a prompt longer than max_len
        shift = t % slots
        ck.copy_(torch.roll(k[:, -slots:], shift, dims=1)[:, s0:s1])
        cv.copy_(torch.roll(v[:, -slots:], shift, dims=1)[:, s0:s1])
        cp.copy_(torch.roll(positions[-slots:], shift, dims=0))


def _write_slot(cache, split, k, v, positions, cache_pos, window) -> None:
    """A decode step's write of its K, V (as the cache holds them) and
    position at slot ``cache_pos`` (ring: modulo the slots; linear: JAX's
    dynamic_update_slice clamps a start past the end, so a cache decoded
    at pos >= slots writes its last slot). The rank whose slots [s0, s1)
    hold it writes it, the others write back what they hold; the owner is
    decided on the device, so the step reads nothing on the host. Every
    rank writes the whole ``pos`` leaf."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    slots = cp.shape[0]
    slot = (cache_pos % slots if window is not None
            else cache_pos.clamp(0, slots - 1)).reshape(1).long()
    k, v, local = k.to(ck.dtype), v.to(cv.dtype), slot
    if split.split("k", 1):  # the slots' owner writes, the others keep
        s0, s1 = split.span("k", 1, slots)
        local = (slot - s0).clamp(0, s1 - s0 - 1)
        mine = (slot >= s0) & (slot < s1)
        k = torch.where(mine, k, ck.index_select(1, local))
        v = torch.where(mine, v, cv.index_select(1, local))
    ck.index_copy_(1, local, k)
    cv.index_copy_(1, local, v)
    cp.index_copy_(0, slot, positions.to(cp.dtype))


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device=None) -> dict:
    """One layer's empty KV cache: ``k``, ``v`` [batch, slots, Hkv, hd] in
    ``dtype`` and ``pos`` [slots] int32 at −1 (unwritten), with ``slots =
    min(max_len, swa_window)`` under a window, else ``max_len``."""
    slots = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device)}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The SwiGLU MLP; over ``model`` on the rank's ff columns (``w_gate``,
    ``w_up``) and rows (``w_down``), the output summed over the ranks."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        self.w_gate = _param((d, ff), dt, device)
        self.w_up = _param((d, ff), dt, device)
        self.w_down = _param((ff, d), dt, device)
        self.tp = TRIVIAL

    @torch.no_grad()
    def init_(self, generator):
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def forward(self, x, cfg: ModelConfig):
        cdt = dtype_of(cfg.compute_dtype)
        xc = self.tp.copy(x).to(cdt)
        h = F.silu(xc @ self.w_gate.to(cdt)) * (xc @ self.w_up.to(cdt))
        return self.tp.reduce(h @ self.w_down.to(cdt)).to(x.dtype)
