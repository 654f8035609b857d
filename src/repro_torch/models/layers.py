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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6) * self.scale.float()).to(x.dtype)


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
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def make_norm(cfg: ModelConfig, d: int | None = None, device=None):
    cls = LayerNorm if cfg.norm == "layer" else RMSNorm
    return cls(d or cfg.d_model, dtype_of(cfg.param_dtype), device)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # [..., T, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
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
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits / math.sqrt(hd)
    logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, tq, hq, hd)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window, block_kv: int):
    """Online softmax over KV blocks; activation memory O(Tq·block_kv)."""
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nb = -(-tk // block_kv)
    pad = nb * block_kv - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_PAD_POS)
    kb = k.reshape(b, nb, block_kv, hkv, hd)
    vb = v.reshape(b, nb, block_kv, hkv, hd)
    pb = k_pos.reshape(nb, block_kv)
    # As JAX: the scale is √hd rounded to q's dtype, divided in q's dtype.
    qg = q.reshape(b, tq, hkv, g, hd) / torch.tensor(math.sqrt(hd),
                                                     dtype=q.dtype)
    m = torch.full((b, hkv, g, tq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, g, tq), device=q.device)
    acc = torch.zeros((b, hkv, g, tq, hd), device=q.device)
    for i in range(nb):
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kb[:, i]).float()
        logits = logits + _mask_bias(q_pos, pb[i], causal, window,
                                     torch.float32)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(q.dtype), vb[:, i]).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, tq, hq, hd)


def _attend(q, k, v, q_pos, k_pos, causal, window, block_kv):
    """Dispatch direct vs. blockwise (online-softmax) attention."""
    if k.shape[1] > block_kv:
        return _sdpa_blockwise(q, k, v, q_pos, k_pos, causal, window,
                               block_kv)
    bias = _mask_bias(q_pos, k_pos, causal, window, torch.float32)
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
        xc = x.to(cdt)
        q = _proj(xc, self.wq.to(cdt))
        if cfg.qk_norm:
            q = rms_norm_vec(q, self.q_norm)
        if cross:
            return self._cross(x, q, cfg, positions, kv_x, cache), cache
        k = _proj(xc, self.wk.to(cdt))
        v = _proj(xc, self.wv.to(cdt))
        if cfg.qk_norm:
            k = rms_norm_vec(k, self.k_norm)
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
            ck, cv, cp = cache["k"], cache["v"], cache["pos"]
            slots = ck.shape[1]
            # JAX's dynamic_update_slice clamps a start past the end: a
            # linear cache decoded at pos >= slots writes its last slot.
            slot = (cache_pos % slots if window is not None
                    else cache_pos.clamp(0, slots - 1)).reshape(1).long()
            ck.index_copy_(1, slot, k.to(ck.dtype))
            cv.index_copy_(1, slot, v.to(cv.dtype))
            cp.index_copy_(0, slot, positions.to(cp.dtype))
            out = _attend(q, ck.to(cdt), cv.to(cdt), positions, cp, True,
                          window, cfg.attn_block_kv)
        else:  # prefill: attend over the prompt itself, then fill the cache
            out = _attend(q, k, v, positions, positions, causal, window,
                          cfg.attn_block_kv)
            _fill_cache(cache, k, v, positions)
        return self._out(out, x, cdt), cache

    def _cross(self, x, q, cfg: ModelConfig, positions, kv_x, cache):
        """The cross branch: no RoPE, every key visible (keys at
        ``arange(Tk)``, no causality, no window), through ``_attend`` and
        never the flash kernel, as JAX's. K and V come from a cache that
        holds them, cast to the compute dtype, else from ``kv_x``; only the
        latter applies ``k_norm`` under qk-norm (JAX's prefill caches them
        without it)."""
        cdt = q.dtype
        if cache is not None and "k" in cache:
            k, v = cache["k"].to(cdt), cache["v"].to(cdt)
        else:
            k, v = self.cross_kv(kv_x, cfg)
            if cfg.qk_norm:
                k = rms_norm_vec(k, self.k_norm)
        k_pos = torch.arange(k.shape[1], device=k.device)
        out = _attend(q, k, v, positions, k_pos, False, None,
                      cfg.attn_block_kv)
        return self._out(out, x, cdt)

    def cross_kv(self, enc_out, cfg: ModelConfig):
        """The K and V the cross branch reads from ``enc_out`` [B, Tk, d],
        in the compute dtype and without ``k_norm``: what JAX's
        ``_fill_cross_caches`` stores in a prefill's cache."""
        cdt = dtype_of(cfg.compute_dtype)
        src = enc_out.to(cdt)
        return _proj(src, self.wk.to(cdt)), _proj(src, self.wv.to(cdt))

    def _out(self, out, x, cdt):
        """The output projection ``einsum("bthk,hkd->btd")`` in ``cdt``,
        cast to ``x``'s dtype."""
        b, t = out.shape[:2]
        nq, hd, d = self.wo.shape
        y = out.reshape(b * t, nq * hd) @ self.wo.to(cdt).reshape(nq * hd, d)
        return y.reshape(b, t, d).to(x.dtype)


def _fill_cache(cache, k, v, positions) -> None:
    """Prefill's write of a prompt's K, V and positions into ``cache``: at
    slots [0, t) when the prompt fits, else its last ``slots`` rows rolled
    by ``t % slots`` (ring-aligned), as JAX's prefill branch."""
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    t, slots = k.shape[1], ck.shape[1]
    if t <= slots:
        ck[:, :t] = k
        cv[:, :t] = v
        cp[:t] = positions
    else:  # ring buffer (SWA), or a prompt longer than max_len
        shift = t % slots
        ck.copy_(torch.roll(k[:, -slots:], shift, dims=1))
        cv.copy_(torch.roll(v[:, -slots:], shift, dims=1))
        cp.copy_(torch.roll(positions[-slots:], shift, dims=0))


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
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        self.w_gate = _param((d, ff), dt, device)
        self.w_up = _param((d, ff), dt, device)
        self.w_down = _param((ff, d), dt, device)

    @torch.no_grad()
    def init_(self, generator):
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def forward(self, x, cfg: ModelConfig):
        cdt = dtype_of(cfg.compute_dtype)
        xc = x.to(cdt)
        h = F.silu(xc @ self.w_gate.to(cdt)) * (xc @ self.w_up.to(cdt))
        return (h @ self.w_down.to(cdt)).to(x.dtype)
