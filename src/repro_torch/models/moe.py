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

In a data-parallel train step (``data_axes`` set by
`repro_torch.sharding.placement.Placement.shard`) each rank holds a
contiguous block of the global batch's tokens, and the layer computes what
JAX's computes over the whole batch: the groups and capacity are the global
batch's; ``me``, ``ce`` and the z-loss are means over the global tokens (one
all-reduce; their value is global and their gradient this rank's tokens' —
an autograd all-reduce would sum the ranks' identical gradients, which the
step's reduction over the data ranks then sums again); and an assignment's
place in its expert's queue counts the earlier tokens of its group on other
ranks: where the groups do not fall on rank boundaries (``moe_groups`` not
a multiple of the data ranks), the ranks all-gather their per-group expert
counts once a layer and add the earlier ranks' (JAX's token-major stable
sort). Each rank runs the experts over its own kept assignments. Without
data axes (serving, a step without a mesh) the same code runs with the
whole batch as the one rank's block.

Over the mesh's ``model`` axis (``self.tp``) every model rank routes its
data rank's tokens alike (the routing, groups, capacity, slots and aux
unchanged) and runs the experts on its own part: under expert parallelism
(``num_experts`` divides the axis) its E/m experts' slots, otherwise every
expert on its columns of the ff dim. Its weighted contributions are
combined and summed over the model ranks. The tokens dispatched and the
gate weights enter that rank-local work through `ModelAxis.copy`; the
router's logits and the aux are computed alike on every rank and do not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.collectives import TRIVIAL
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
        self.data_axes = None  # a data-parallel step's `DataAxes`
        self.tp = TRIVIAL  # the model axis (`Placement.shard` sets it)

    @torch.no_grad()
    def init_(self, generator):
        dense_init_(self.router, generator, scale=0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            dense_init_(w, generator)

    def route(self, x, cfg: ModelConfig):
        """The routing of ``x`` [B, T, d]: ``(xt [G, n, d] in the compute
        dtype, logits and probs [G, n, E] float32, gate weights [G, n, k]
        renormalized, experts [G, n, k])``."""
        b, t, d = x.shape
        grp, _ = capacity(cfg, b * t)
        xt = x.reshape(grp, b * t // grp, d).to(dtype_of(cfg.compute_dtype))
        return (xt,) + self._gates(xt, cfg)

    def _gates(self, xt, cfg: ModelConfig):
        """Router logits and probs (float32), the top-k gate weights
        renormalized and their experts, over ``xt``'s last dim."""
        logits = xt.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)
        # lax.top_k: the k largest, ties to the lower index (a stable sort;
        # torch.topk promises no order among equals).
        gate_w, gate_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        k = cfg.moe.top_k
        gate_w, gate_e = gate_w[..., :k], gate_e[..., :k]
        gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gate_w, gate_e

    def dropped(self, x, cfg: ModelConfig) -> torch.Tensor:
        """The number of ``x``'s assignments past their expert's capacity
        (0-d int64 on the device), as `forward` drops them."""
        b, t, d = x.shape
        _, _, _, gate_w, gate_e = self.route(x, cfg)
        keep = self._dispatch(gate_e.reshape(b * t, -1),
                              gate_w.reshape(b * t, -1), cfg)[3]
        return (~keep).sum()

    def _dispatch(self, gate_e, gate_w, cfg: ModelConfig):
        """JAX's ``_dispatch_one`` over every group of this rank's tokens
        (``gate_e``, ``gate_w`` [n_loc, k]): the assignments sorted stably
        by (group, expert), token-major within; returns each one's
        ``slot`` in the [G_loc·E·cap] buffers, its token ``stok``, its
        weight ``sw``, ``keep`` (within its expert's first ``cap`` of the
        group) and ``g_loc``, the number of groups this rank's tokens
        touch."""
        dp = self.data_axes
        size, index = (1, 0) if dp is None else (dp.size, dp.index)
        e = cfg.moe.num_experts
        n_loc, k = gate_e.shape
        grp, cap = capacity(cfg, n_loc * size)
        nl = n_loc * size // grp
        dev = gate_e.device
        # This rank's tokens are global tokens [index·n_loc, …): their
        # groups, local group ids from g0, and their places in the queues.
        first_tok = index * n_loc
        g0 = first_tok // nl
        g_loc = (first_tok + n_loc - 1) // nl - g0 + 1
        gid = (first_tok + torch.arange(n_loc, device=dev)) // nl - g0
        key = gid.repeat_interleave(k) * e + gate_e.reshape(-1)
        order = torch.argsort(key, stable=True)
        sk = key[order]
        sw = gate_w.reshape(-1)[order]
        stok = order // k  # the token of assignment j is j // k
        # Position within expert = rank - first rank of that expert.
        start = torch.searchsorted(
            sk, torch.arange(g_loc * e, device=dev, dtype=sk.dtype),
            side="left")
        pos = torch.arange(n_loc * k, device=dev) - start[sk]
        if grp % size:  # a group spans ranks: add the earlier ranks'
            cnt = torch.zeros(grp * e, dtype=torch.int64,
                              device=dev).index_add_(
                0, g0 * e + sk, torch.ones_like(sk))
            prefix = dp.gather(cnt)[:index].sum(dim=0)
            pos = pos + prefix[g0 * e + sk]
        keep = pos < cap
        slot = sk * cap + torch.where(keep, pos, torch.zeros_like(pos))
        return slot, stok, sw, keep, g_loc

    def forward(self, x, cfg: ModelConfig):
        """x [B, T, d] → ``(y [B, T, d] in x's dtype, aux)``, aux a 0-d
        float32 tensor. In a data-parallel step ``x`` is this rank's block
        of the global batch, and the groups, capacity and aux are the
        global batch's."""
        mc = cfg.moe
        b, t, d = x.shape
        e, k = mc.num_experts, mc.top_k
        cdt = dtype_of(cfg.compute_dtype)
        dp = self.data_axes
        n_loc = b * t
        n = n_loc * (1 if dp is None else dp.size)
        _, cap = capacity(cfg, n)
        xt = x.reshape(n_loc, d).to(cdt)
        logits, probs, gate_w, gate_e = self._gates(xt, cfg)

        # Load-balancing auxiliary loss (Switch-style) + router z-loss over
        # the global tokens: one all-reduce of the local sums. The
        # assignment counts carry no gradient; ``me`` and the z-loss carry
        # this rank's tokens'.
        psum = probs.sum(dim=0)
        zsum = torch.sum(torch.logsumexp(logits, dim=-1) ** 2)
        counts = torch.zeros(e, dtype=torch.float32,
                             device=x.device).index_add_(
            0, gate_e.reshape(-1),
            torch.ones(n_loc * k, dtype=torch.float32, device=x.device))
        tot = torch.cat([psum, counts, zsum[None]]).detach()
        if dp is not None:
            tot = dp.sum(tot)
        me = tot[:e] / n + (psum - psum.detach()) / n
        ce = tot[e:2 * e] / (n * k)
        z = tot[2 * e] / n + (zsum - zsum.detach()) / n
        aux = mc.aux_loss_coef * e * torch.sum(me * ce)
        aux = aux + mc.router_z_coef * z

        # Dispatch into [G_loc·E_m·cap, d], E_m this model rank's experts
        # [e0, e1) (all of them on one rank or under the ff split): a
        # dropped assignment, or one to another rank's expert, adds zeros
        # at slot 0, as JAX's where(keep, …, 0).
        slot, stok, sw, keep, g_loc = self._dispatch(gate_e, gate_w, cfg)
        tp = self.tp
        e0, e1 = tp.span("w_gate", 0, e)
        em = e1 - e0
        if tp.split("w_gate", 0):
            ex = slot // cap % e
            keep = keep & (ex >= e0) & (ex < e1)
            slot = torch.where(keep, ((slot // (cap * e)) * em + ex - e0)
                               * cap + slot % cap, torch.zeros_like(slot))
        xt = tp.copy(xt)
        src = torch.where(keep[:, None], xt[stok],
                          torch.zeros((), dtype=cdt, device=x.device))
        buf = torch.zeros(g_loc * em * cap, d, dtype=cdt, device=x.device)
        buf = buf.index_add(0, slot, src)

        # The experts: batched products over E_m, every group's slots as
        # rows (under the ff split, the rank's ff columns).
        xe = buf.reshape(g_loc, em, cap, d).transpose(0, 1).reshape(
            em, g_loc * cap, d)
        h = F.silu(torch.bmm(xe, self.w_gate.to(cdt))) * torch.bmm(
            xe, self.w_up.to(cdt))
        out = torch.bmm(h, self.w_down.to(cdt)).reshape(
            em, g_loc, cap, d).transpose(0, 1).reshape(g_loc * em * cap, d)

        # Combine: each token sums its kept assignments' weighted outputs,
        # then the model ranks' parts are summed.
        contrib = torch.where(keep[:, None],
                              out[slot] * tp.copy(sw)[:, None].to(cdt),
                              torch.zeros((), dtype=cdt, device=x.device))
        y = torch.zeros(n_loc, d, dtype=cdt, device=x.device).index_add(
            0, stok, contrib)
        return tp.reduce(y).reshape(b, t, d).to(x.dtype), aux.float()
