"""Plain PyTorch version of the flash-attention kernel: the materialized
softmax, with GQA folded by broadcasting (no copies of K and V).

A query row with no visible key gives zeros, as the kernel does (the JAX
package's oracle gives NaN there and its TPU kernel an average of V over the
padded key block; neither occurs on causal self-attention, where every row
sees its own position).
"""

from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, q_pos, k_pos, *, causal: bool = True,
                        window: int | None = None):
    """q [B, Tq, Hq, hd], k/v [B, Tk, Hkv, hd], q_pos [Tq], k_pos [Tk]
    (−1 = padded slot) -> [B, Tq, Hq, hd] in q's dtype.

    Scores, softmax and the weighted sum are in float64 for float64 inputs
    and in float32 otherwise, as the kernel accumulates.
    """
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(acc).reshape(b, tq, hkv, hq // hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(acc)) * (1.0 / hd ** 0.5)
    kp = k_pos[None, :]
    qp = q_pos[:, None]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(s - m)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(acc))
    return out.reshape(b, tq, hq, hd).to(q.dtype)
