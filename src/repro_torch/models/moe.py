"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch.

The port of the JAX package's ``models/moe.py``. `MoE` holds JAX's
parameters (``router [d, E]``, ``w_gate``/``w_up [E, d, ff]``, ``w_down
[E, ff, d]``) and applies ``apply_moe``: a float32 router softmax, top-k
gates renormalized, a stable sort of the assignments by expert, each
expert's first ``cap`` assignments kept (the rest dropped, in sorted
order), a scatter-add into [G, E, cap, d] buffers, SwiGLU experts as
batched products, and a gather and weighted scatter-add back to the
tokens. ``aux`` is the Switch-style load-balancing loss plus the router
z-loss, in float32.

Dispatch is gather/scatter, not a one-hot product, so the expert work is
tokens·k·3·d·ff as in JAX. ``cfg.moe_groups`` splits the tokens into
groups, each routed and capacity-bounded on its own (one group when it
does not divide B·T), which changes which assignments drop. Ties among
the router's probabilities go to the lower expert index, as
``lax.top_k`` breaks them. Nothing here reads a device value on the host,
so a decode step through a MoE layer can be captured into a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _param, dense_init_, dtype_of


def capacity(cfg: ModelConfig, tokens: int) -> tuple[int, int]:
    """``(groups, cap)`` of a MoE layer over ``tokens`` = B·T tokens:
    ``cfg.moe_groups`` (1 when it does not divide them) and each expert's
    slots per group, ``capacity_factor·n·k/E`` rounded up to a multiple of
    8 and at least 8 (JAX's, worked out from the static shapes)."""
    mc = cfg.moe
    grp = max(1, cfg.moe_groups)
    if tokens % grp != 0:  # tiny smoke batches: fall back to one group
        grp = 1
    cap = int(mc.capacity_factor * (tokens // grp) * mc.top_k
              / mc.num_experts)
    return grp, max(8, -(-cap // 8) * 8)


class MoE(nn.Module):
    """A routed SwiGLU MoE layer (JAX's ``init_moe`` / ``apply_moe``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        self.router = _param((d, e), dt, device)
        self.w_gate = _param((e, d, ff), dt, device)
        self.w_up = _param((e, d, ff), dt, device)
        self.w_down = _param((e, ff, d), dt, device)

    @torch.no_grad()
    def init_(self, generator):
        dense_init_(self.router, generator, scale=0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def route(self, x, cfg: ModelConfig):
        """The routing of ``x`` [B, T, d]: ``(xt [G, n, d] in the compute
        dtype, logits and probs [G, n, E] float32, gate weights [G, n, k]
        renormalized, experts [G, n, k])``."""
        mc = cfg.moe
        b, t, d = x.shape
        grp, _ = capacity(cfg, b * t)
        xt = x.reshape(grp, b * t // grp, d).to(dtype_of(cfg.compute_dtype))
        logits = xt.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)
        # lax.top_k: the k largest, ties to the lower index (a stable sort;
        # torch.topk promises no order among equals).
        gate_w, gate_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        gate_w, gate_e = gate_w[..., :mc.top_k], gate_e[..., :mc.top_k]
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
        return xt, logits, probs, gate_w, gate_e

    def dropped(self, x, cfg: ModelConfig) -> torch.Tensor:
        """The number of ``x``'s assignments past their expert's capacity
        (0-d int64 on the device), as `forward` drops them."""
        xt, _, _, gate_w, gate_e = self.route(x, cfg)
        _, cap = capacity(cfg, x.shape[0] * x.shape[1])
        keep = _dispatch_order(gate_e, gate_w, cfg.moe.num_experts, cap)[3]
        return (~keep).sum()

    def forward(self, x, cfg: ModelConfig):
        """x [B, T, d] → ``(y [B, T, d] in x's dtype, aux)``, aux a 0-d
        float32 tensor."""
        mc = cfg.moe
        b, t, d = x.shape
        e, k = mc.num_experts, mc.top_k
        cdt = dtype_of(cfg.compute_dtype)
        n = b * t
        grp, cap = capacity(cfg, n)
        nl = n // grp
        xt, logits, probs, gate_w, gate_e = self.route(x, cfg)

        # Load-balancing auxiliary loss (Switch-style) + router z-loss; the
        # assignment counts carry no gradient.
        me = probs.mean(dim=(0, 1))
        ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
            0, gate_e.reshape(-1),
            torch.ones(n * k, dtype=torch.float32, device=x.device)) / (n * k)
        aux = mc.aux_loss_coef * e * torch.sum(me * ce)
        aux = aux + mc.router_z_coef * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2)

        # Per-group dispatch into [G, E·cap, d]: a dropped assignment adds
        # zeros at its expert's slot 0, as JAX's where(keep, …, 0).
        slot, stok, sw, keep = _dispatch_order(gate_e, gate_w, e, cap)
        base = (torch.arange(grp, device=x.device) * (e * cap))[:, None]
        rows = torch.arange(grp, device=x.device)[:, None] * nl + stok
        src = torch.where(keep[..., None], xt.reshape(n, d)[rows],
                          torch.zeros((), dtype=cdt, device=x.device))
        buf = torch.zeros(grp * e * cap, d, dtype=cdt, device=x.device)
        buf = buf.index_add(0, (base + slot).reshape(-1), src.reshape(-1, d))

        # The experts: batched products over E, every group's slots as rows.
        xe = buf.reshape(grp, e, cap, d).transpose(0, 1).reshape(
            e, grp * cap, d)
        h = F.silu(torch.bmm(xe, self.w_gate.to(cdt))) * torch.bmm(
            xe, self.w_up.to(cdt))
        out = torch.bmm(h, self.w_down.to(cdt)).reshape(
            e, grp, cap, d).transpose(0, 1).reshape(grp * e * cap, d)

        # Combine: each token sums its kept assignments' weighted outputs.
        gathered = out[(base + slot).reshape(-1)].reshape(grp, nl * k, d)
        contrib = torch.where(keep[..., None], gathered * sw[..., None].to(cdt),
                              torch.zeros((), dtype=cdt, device=x.device))
        y = torch.zeros(n, d, dtype=cdt, device=x.device).index_add(
            0, rows.reshape(-1), contrib.reshape(-1, d))
        return y.reshape(b, t, d).to(x.dtype), aux.float()


def _dispatch_order(gate_e, gate_w, e: int, cap: int):
    """JAX's ``_dispatch_one`` over every group at once: the assignments
    [G, n·k] sorted stably by expert; returns each one's ``slot`` in its
    group's [E·cap] buffer, its token ``stok``, its weight ``sw`` and
    ``keep`` (within its expert's first ``cap``)."""
    grp, nl, k = gate_e.shape
    nk = nl * k
    flat_e = gate_e.reshape(grp, nk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    sw = gate_w.reshape(grp, nk).gather(-1, order)
    stok = order // k  # the token of assignment j is j // k
    # Position within expert = rank - first rank of that expert.
    experts = torch.arange(e, device=se.device, dtype=se.dtype)
    first = torch.searchsorted(se, experts.expand(grp, e).contiguous(),
                               side="left")
    pos = torch.arange(nk, device=se.device) - first.gather(-1, se)
    keep = pos < cap
    slot = se * cap + torch.where(keep, pos, torch.zeros_like(pos))
    return slot, stok, sw, keep
