"""State-space / linear-RNN mixers: Mamba (jamba) and RWKV-6 (Finch).

The port of the JAX package's ``models/ssm.py``. Both mixers are diagonal
linear recurrences ``h_t = a_t ⊙ h_{t-1} + u_t``. `chunked_recurrence`
walks the time axis in chunks of ``cfg.ssm_chunk`` steps carrying the
state (JAX's outer ``lax.scan``, here a Python loop); inside a chunk the
recurrence closes with the associative scan `_assoc_inclusive`, on
`repro_torch.core.heads_tails._assoc_scan` (JAX's
``lax.associative_scan`` recursion, so the decay products associate as
JAX's do). While autograd records, each chunk runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of the chunk body):
the backward pass recomputes a chunk's [B, chunk, state] products instead
of keeping them. Decode is the one-step update of the same code (T = 1).

`Mamba`, `RWKV` (the time mix) and `RWKVCMix` (the channel mix) hold
JAX's parameters under JAX's names. ``forward(x, cfg, cache)`` returns
``(y, cache)``: given a cache (one layer's, as `init_mamba_cache`,
`init_rwkv_cache` and `init_cmix_cache` make it), the new states are
written into its tensors in place and the same dict comes back, as the
attention branch does, so a decode step can be captured into a CUDA
graph; without one, a new dict of the states.

As in JAX, a sequence longer than a chunk and not a multiple of it is
padded with zeros at its end, and the state returned is the one after the
padding: Mamba's padded steps keep the state (their Δ is 0), RWKV's zero
it (their decay is 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.heads_tails import _assoc_scan
from .config import MambaConfig, ModelConfig, RWKVConfig
from .layers import _param, dense_init_, dtype_of


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def chunked_recurrence(inputs, init_state, body, chunk: int):
    """Chunks of the time axis (dim 1 of every input) in order.

    ``body(h0, *chunk_inputs) -> (h_out, chunk_outputs)``. Returns (the
    outputs concatenated over chunks, the final state). While autograd
    records, each chunk is checkpointed (non-reentrant, so what ``body``
    closes over gets its gradient too)."""
    t = inputs[0].shape[1]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        inputs = [_pad_time(x, pad) for x in inputs]
    nc = (t + pad) // chunk
    remat = torch.is_grad_enabled()
    h, outs = init_state, []
    for c in range(nc):
        xs = [x[:, c * chunk:(c + 1) * chunk] for x in inputs]
        if remat:
            h, y = torch.utils.checkpoint.checkpoint(body, h, *xs,
                                                     use_reentrant=False)
        else:
            h, y = body(h, *xs)
        outs.append(y)
    y = outs[0] if nc == 1 else torch.cat(outs, dim=1)
    return (y[:, :t] if pad else y), h


def _ssm_combine(a, b):
    """(d_a, u_a) ⊕ (d_b, u_b) = (d_b·d_a, d_b·u_a + u_b): JAX's operator,
    operand for operand. XLA contracts d_b·u_a + u_b into one fused
    multiply-add under ``jit``; ``addcmul`` rounds it once too (on the CPU
    bit for bit as XLA's), and is one kernel where the two operations are
    two."""
    return b[0] * a[0], torch.addcmul(b[1], b[0], a[1])


def _assoc_inclusive(decay, u):
    """Inclusive states of h_t = decay_t ⊙ h_{t-1} + u_t along dim 1 (h_0
    = 0) and the running decay products: ``hs = uu + dd·h0``."""
    dd, uu = _assoc_scan([decay, u], 1, _ssm_combine)
    return dd, uu


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _write(cache, new: dict) -> dict:
    """The new states into ``cache``'s tensors in place (the same dict
    comes back), or ``new`` itself without a cache."""
    if cache is None:
        return new
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


# ---------------------------------------------------------------------------
# Mamba (selective SSM, mamba-1 recurrence as in jamba)
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    """JAX's ``init_mamba`` / ``apply_mamba``: in_proj, a causal depthwise
    conv over time carrying its last ``d_conv - 1`` inputs, a selective
    scan with softplus Δ in float32 and ``a = −exp(a_log)``, the ``d_skip``
    term, the ``silu(z)`` gate and out_proj."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        mc = cfg.mamba or MambaConfig()
        d = cfg.d_model
        di = mc.expand * d
        dtr = mc.dt_rank or d // 16
        dt = dtype_of(cfg.param_dtype)
        self.in_proj = _param((d, 2 * di), dt, device)
        self.conv_w = _param((mc.d_conv, di), dt, device)
        self.conv_b = _param((di,), dt, device)
        self.x_proj = _param((di, dtr + 2 * mc.d_state), dt, device)
        self.dt_proj = _param((dtr, di), dt, device)
        self.dt_bias = _param((di,), dt, device)
        self.a_log = _param((di, mc.d_state), dt, device)
        self.d_skip = _param((di,), dt, device)
        self.out_proj = _param((di, d), dt, device)

    @torch.no_grad()
    def init_(self, generator):
        for w in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            dense_init_(w, generator)
        dense_init_(self.conv_w, generator, scale=0.2)
        self.conv_b.zero_()
        self.dt_bias.fill_(-4.6)  # softplus^-1(~0.01)
        di, ds = self.a_log.shape
        self.a_log.copy_(torch.log(torch.arange(
            1, ds + 1, dtype=self.a_log.dtype,
            device=self.a_log.device).repeat(di, 1)))
        self.d_skip.fill_(1.0)

    def forward(self, x, cfg: ModelConfig, cache=None):
        """x [B, T, d] → ``(y [B, T, d] in x's dtype, {"conv", "ssm"})``."""
        mc = cfg.mamba or MambaConfig()
        cdt = dtype_of(cfg.compute_dtype)
        b = x.shape[0]
        di = mc.expand * cfg.d_model
        xz = x.to(cdt) @ self.in_proj.to(cdt)
        xi, z = xz.chunk(2, dim=-1)
        if cache is None:
            conv_state = torch.zeros(b, mc.d_conv - 1, di, dtype=cdt,
                                     device=x.device)
            h0 = torch.zeros(b, di, mc.d_state, dtype=torch.float32,
                             device=x.device)
        else:
            conv_state, h0 = cache["conv"], cache["ssm"]
        y, conv_state, h_last = self._inner(xi, z, conv_state, h0, cfg)
        out = y @ self.out_proj.to(cdt)
        return out.to(x.dtype), _write(cache, {"conv": conv_state.to(cdt),
                                               "ssm": h_last})

    def _inner(self, x, z, conv_state, h0, cfg: ModelConfig):
        """JAX's ``_mamba_inner`` on the post-projection x [B, T, di]."""
        mc = cfg.mamba or MambaConfig()
        cdt = dtype_of(cfg.compute_dtype)
        t = x.shape[1]
        ds = mc.d_state
        dtr = mc.dt_rank or cfg.d_model // 16

        # Causal depthwise conv over time (state = last d_conv-1 inputs).
        xin = torch.cat([conv_state.to(cdt), x], dim=1)
        new_conv_state = xin[:, -(mc.d_conv - 1):]
        conv_w = self.conv_w.to(cdt)
        conv = sum(xin[:, i:i + t] * conv_w[i] for i in range(mc.d_conv))
        x = F.silu(conv + self.conv_b.to(cdt))

        dbc = x @ self.x_proj.to(cdt)
        dt_r, bmat, cmat = dbc.split([dtr, ds, ds], dim=-1)
        delta = _softplus(dt_r @ self.dt_proj.to(cdt)
                          + self.dt_bias.to(cdt)).float()
        a = -torch.exp(self.a_log.float())  # [di, ds]

        def body(h, delta_c, b_c, x_c):  # [B,L,di], [B,L,ds], [B,L,di]
            decay = torch.exp(delta_c[..., None] * a)            # [B,L,di,ds]
            u = (delta_c * x_c.float())[..., None] * \
                b_c.float()[:, :, None, :]                       # [B,L,di,ds]
            dd, uu = _assoc_inclusive(decay, u)
            hs = uu + dd * h[:, None]
            return hs[:, -1], hs

        hs, h_last = chunked_recurrence((delta, bmat, x), h0.float(), body,
                                        cfg.ssm_chunk)
        y = (hs.to(cdt) @ cmat[..., None]).squeeze(-1)  # btds,bts->btd
        del hs
        y = y + x * self.d_skip.to(cdt)
        y = y * F.silu(z)
        return y, new_conv_state, h_last


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """One Mamba layer's empty state: ``conv`` [batch, d_conv − 1, d_inner]
    in the compute dtype, ``ssm`` [batch, d_inner, d_state] float32."""
    mc = cfg.mamba or MambaConfig()
    di = mc.expand * cfg.d_model
    return {"conv": torch.zeros(batch, mc.d_conv - 1, di,
                                dtype=dtype_of(cfg.compute_dtype),
                                device=device),
            "ssm": torch.zeros(batch, di, mc.d_state, dtype=torch.float32,
                               device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear attention + channel mix
# ---------------------------------------------------------------------------


class RWKV(nn.Module):
    """JAX's ``init_rwkv`` / ``apply_rwkv``, the time mix: the
    data-dependent token shift (five LoRA mixes), the decay
    exp(−exp(w0 + lora)) in float32, the wkv recurrence with the
    ``bonus`` term, a per-head group norm (eps 1e-5), the gate and wo."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        rc = cfg.rwkv or RWKVConfig()
        d = cfg.d_model
        dt = dtype_of(cfg.param_dtype)
        self.mu = _param((5, d), dt, device)  # r,k,v,w,g shifts
        self.mix_w1 = _param((d, 5 * rc.lora_mix), dt, device)
        self.mix_w2 = _param((5, rc.lora_mix, d), dt, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _param((d, d), dt, device))
        self.w0 = _param((d,), dt, device)
        self.decay_w1 = _param((d, rc.lora_decay), dt, device)
        self.decay_w2 = _param((rc.lora_decay, d), dt, device)
        self.bonus = _param((d // rc.head_size, rc.head_size), dt, device)
        self.ln_x = _param((d,), dt, device)

    @torch.no_grad()
    def init_(self, generator):
        dense_init_(self.mu, generator, scale=0.2)
        dense_init_(self.mix_w1, generator)
        dense_init_(self.mix_w2, generator, scale=0.1)
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo):
            dense_init_(w, generator)
        self.w0.fill_(-2.0)
        dense_init_(self.decay_w1, generator)
        dense_init_(self.decay_w2, generator, scale=0.1)
        dense_init_(self.bonus, generator, scale=0.5)
        self.ln_x.fill_(1.0)

    def forward(self, x, cfg: ModelConfig, cache=None):
        """x [B, T, d] → ``(y [B, T, d] in x's dtype, {"shift",
        "state"})``."""
        rc = cfg.rwkv or RWKVConfig()
        cdt = dtype_of(cfg.compute_dtype)
        b, t, d = x.shape
        hd = rc.head_size
        h = d // hd
        xc = x.to(cdt)
        if cache is None:
            x_prev_last = torch.zeros(b, 1, d, dtype=cdt, device=x.device)
            s0 = torch.zeros(b, h, hd, hd, dtype=torch.float32,
                             device=x.device)
        else:
            x_prev_last, s0 = cache["shift"].to(cdt), cache["state"]
        x_prev = torch.cat([x_prev_last, xc[:, :-1]], dim=1)
        dx = x_prev - xc

        # Data-dependent token-shift (ddlerp): per-channel r,k,v,w,g mixes.
        lora = torch.tanh(xc @ self.mix_w1.to(cdt)).reshape(b, t, 5,
                                                             rc.lora_mix)
        mix = self.mu.to(cdt)[None, None] + torch.einsum(
            "btcl,cld->btcd", lora, self.mix_w2.to(cdt))
        xr, xk, xv, xw, xg = [xc + dx * mix[:, :, i] for i in range(5)]

        r = (xr @ self.wr.to(cdt)).reshape(b, t, h, hd)
        k = (xk @ self.wk.to(cdt)).reshape(b, t, h, hd)
        v = (xv @ self.wv.to(cdt)).reshape(b, t, h, hd)
        g = F.silu(xg @ self.wg.to(cdt))
        # Data-dependent decay w_t = exp(-exp(w0 + lora_w(x_w))) in (0, 1).
        wlog = self.w0.float() + (xw.float() @ self.decay_w1.float()) \
            @ self.decay_w2.float()
        decay = torch.exp(-torch.exp(wlog)).reshape(b, t, h, hd)
        u = self.bonus.float()  # [h, hd]

        def body(s, r_c, k_c, v_c, w_c):  # [B,L,h,hd]
            kf, vf = k_c.float(), v_c.float()
            kv = kf[..., :, None] * vf[..., None, :]        # [B,L,h,hd,hd]
            dd, uu = _assoc_inclusive(w_c[..., None], kv)
            hs = uu + dd * s[:, None]
            s_prev = torch.cat([s[:, None], hs[:, :-1]], dim=1)
            rf = r_c.float()
            y = (rf[..., None, :] @ s_prev).squeeze(-2)     # blhk,blhkv->blhv
            y = y + (rf * u * kf).sum(-1, keepdim=True) * vf
            return hs[:, -1], y

        y, s_last = chunked_recurrence((r, k, v, decay), s0, body,
                                       cfg.ssm_chunk)
        # Per-head group norm, then gate + output projection.
        mu_ = y.mean(-1, keepdim=True)
        var = ((y - mu_) ** 2).mean(-1, keepdim=True)
        yf = (y - mu_) * torch.rsqrt(var + 1e-5)
        yf = yf.reshape(b, t, d) * self.ln_x.float()
        out = (yf.to(cdt) * g) @ self.wo.to(cdt)
        return out.to(x.dtype), _write(cache, {"shift": xc[:, -1:],
                                               "state": s_last})


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """One RWKV time mix's empty state: ``shift`` [batch, 1, d] in the
    compute dtype, ``state`` [batch, heads, hd, hd] float32."""
    rc = cfg.rwkv or RWKVConfig()
    h = cfg.d_model // rc.head_size
    return {"shift": torch.zeros(batch, 1, cfg.d_model,
                                 dtype=dtype_of(cfg.compute_dtype),
                                 device=device),
            "state": torch.zeros(batch, h, rc.head_size, rc.head_size,
                                 dtype=torch.float32, device=device)}


class RWKVCMix(nn.Module):
    """JAX's ``init_rwkv_cmix`` / ``apply_rwkv_cmix``, the channel mix:
    its own token shift, relu² keys, a sigmoid receptance gate."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        self.mu_k = _param((d,), dt, device)
        self.mu_r = _param((d,), dt, device)
        self.wk = _param((d, ff), dt, device)
        self.wv = _param((ff, d), dt, device)
        self.wr = _param((d, d), dt, device)

    @torch.no_grad()
    def init_(self, generator):
        dense_init_(self.mu_k, generator, scale=0.2)
        dense_init_(self.mu_r, generator, scale=0.2)
        for w in (self.wk, self.wv, self.wr):
            dense_init_(w, generator)

    def forward(self, x, cfg: ModelConfig, cache=None):
        """x [B, T, d] → ``(y [B, T, d] in x's dtype, {"shift"})``."""
        cdt = dtype_of(cfg.compute_dtype)
        b, _, d = x.shape
        xc = x.to(cdt)
        prev = torch.zeros(b, 1, d, dtype=cdt, device=x.device) \
            if cache is None else cache["shift"].to(cdt)
        dx = torch.cat([prev, xc[:, :-1]], dim=1) - xc
        xk = xc + dx * self.mu_k.to(cdt)
        xr = xc + dx * self.mu_r.to(cdt)
        kk = torch.square(F.relu(xk @ self.wk.to(cdt)))
        vv = kk @ self.wv.to(cdt)
        rr = torch.sigmoid(xr @ self.wr.to(cdt))
        return (rr * vv).to(x.dtype), _write(cache, {"shift": xc[:, -1:]})


def init_cmix_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """One channel mix's empty state: ``shift`` [batch, 1, d] in the
    compute dtype."""
    return {"shift": torch.zeros(batch, 1, cfg.d_model,
                                 dtype=dtype_of(cfg.compute_dtype),
                                 device=device)}
