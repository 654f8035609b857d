"""Model assembly: init, train-mode forward, loss, and serving (prefill and
decode with caches).

The port of the JAX package's ``models/transformer.py``. A super-block is a
static list of `LayerSpec`s; each `Sublayer` is norm → mixer (GQA
attention, `ssm.Mamba` or the `ssm.RWKV` time mix) → residual, then, in an
encoder-decoder's decoder, norm → cross-attention over the encoder's output
→ residual, then norm → MLP (dense SwiGLU, a routed `moe.MoE`, arctic's
dense MLP and MoE in parallel, or the `ssm.RWKVCMix` channel mix) →
residual. `Transformer` holds the embedding, the stack and the head as
modules whose parameters keep the JAX shapes; the depth is a `ModuleList`
of super-blocks walked by a Python loop (JAX's ``lax.scan``). An
encoder-decoder (``is_enc_dec``, whisper) adds a second such stack, the
non-causal ``encoder`` over ``batch["frames"]`` [B, T, d] with learned
positions ``enc_pos`` and ``enc_norm``; a config with ``patch_positions``
(llava) projects ``batch["patches"]`` [B, P, d] with ``patch_proj`` and
puts them before the tokens. ``forward`` and ``loss_fn`` return what JAX's
return: ``(logits, aux, offset)`` (``offset`` the patches' count) and
``(loss, {"ce", "aux", "zloss", "tokens"})``, ``aux`` the MoE layers'
auxiliary losses summed over the sub-layers of a block, then over the
blocks. ``init_cache``, ``prefill`` and ``decode_step`` keep JAX's cache
tree, ``{"blocks": {"pos<j>": {<kind>: {<leaf>: …}}}, "pos"}`` with the
kinds ``attn`` (``k``, ``v``, ``pos``), ``cross`` (``k``, ``v``: the
encoder's K/V, which a prefill replaces with its frames' and no decode
step writes), ``mamba`` (``conv``, ``ssm``), ``rwkv`` (``shift``,
``state``) and ``cmix`` (``shift``), each leaf stacked over the
super-blocks; ``decode_step`` writes it in place.

``cfg.remat`` is JAX's ``jax.checkpoint(block_fn)``: when autograd records,
each super-block runs under ``torch.utils.checkpoint`` (non-reentrant), so
the backward pass recomputes its activations instead of keeping them; an
eval forward, prefill and decode record nothing and run the blocks as they
are. ``scan_layers``, ``dp_axes`` and the activation constraints
(``_constrain_act``) have no effect: PyTorch runs the loop eagerly.

Over a mesh (`repro_torch.sharding.placement.Placement.bind`) every layer
splits its compute over the ``model`` axis (``tp``, a
`repro_torch.sharding.collectives.ModelAxis`; the trivial axis without a
mesh, and the same code). Here the embedding looks up the ids in the
rank's vocab rows (zeros elsewhere) and sums over the ranks, the patch
projection gathers its columns, and the head computes the rank's vocab
columns (``lm_head``'s, or ``embed``'s rows where tied): ``forward``
gathers the logits to [B, S, padded_vocab], ``loss_fn`` never does — its
log-sum-exp and target logit are summed over the ranks' columns.

Prefill and decode over a mesh (a model sharded by
`repro_torch.train.serve.shard_model`, or a sharded train state's) run the
same split on a cache laid out as JAX's ``cache_specs`` lays it out
(`repro_torch.sharding.cache.CacheLayout`): each rank holds its rows over
the data axes (or, under ``shard_seq``, the one sequence whole) and its
slice of every leaf, and each layer reads and writes its part; the FSDP
leaves are gathered over the data axes per super-block (`Placement.bind`),
and the logits come back as the rank's rows gathered over ``model``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels._platform import resolve_device
from repro_torch.sharding.cache import CacheLayout, ServeCache
from repro_torch.sharding.collectives import TRIVIAL
from . import layers, moe as moe_lib, ssm
from .config import LayerSpec, ModelConfig
from .layers import dtype_of

# What a forward needs to agree on with the module it runs: the shapes and
# the layout of the parameters (and the experts' count, `_cfg`).
_SHAPE_FIELDS = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
                 "n_blocks", "block", "head_dim", "qk_norm", "norm",
                 "tie_embeddings", "param_dtype", "mamba", "rwkv",
                 "encoder_blocks", "encoder_block", "encoder_len",
                 "patch_positions")


_MIXERS = {"attn": layers.Attention, "mamba": ssm.Mamba, "rwkv6": ssm.RWKV}
_MIXER_CACHE = {"attn": "attn", "mamba": "mamba", "rwkv6": "rwkv"}


class Sublayer(nn.Module):
    """One residual sub-layer of a `LayerSpec` (JAX's ``_init_sublayer`` /
    ``_apply_sublayer``): norm → mixer → residual, norm → MLP → residual.
    Its modules are named as JAX's parameters: ``norm1``, ``mixer``,
    ``norm_x`` and ``cross`` (cross-attention, under ``spec.cross_attn``),
    ``norm2``, ``mlp`` (dense or the channel mix) and ``moe``."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, device=None):
        super().__init__()
        self.spec = spec
        self.norm1 = layers.make_norm(cfg, device=device)
        if spec.mixer in _MIXERS:
            self.mixer = _MIXERS[spec.mixer](cfg, device)
        if spec.cross_attn:
            self.norm_x = layers.make_norm(cfg, device=device)
            self.cross = layers.Attention(cfg, device)
        if spec.mlp != "none":
            self.norm2 = layers.make_norm(cfg, device=device)
        if spec.mlp in ("dense", "dense+moe"):
            self.mlp = layers.MLP(cfg, device)
        elif spec.mlp == "rwkv_cmix":
            self.mlp = ssm.RWKVCMix(cfg, device)
        if spec.mlp in ("moe", "dense+moe"):
            self.moe = moe_lib.MoE(cfg, device)

    def init_(self, generator):
        for child in self.children():
            child.init_(generator)

    def forward(self, x, cfg: ModelConfig, *, positions, causal: bool,
                enc_out=None, cache=None, cache_pos=None):
        """Returns ``(x, aux)``: ``aux`` the MoE layer's auxiliary loss (a
        0-d float32 tensor; None without one, where JAX adds a 0). ``cache``
        is the sub-layer's ``{<kind>: …}`` (`Transformer.init_cache`),
        written in place. ``enc_out`` is the encoder's output the
        cross-attention reads where the cache holds no K/V of it."""
        spec = self.spec
        aux = None
        h = self.norm1(x)
        if spec.mixer == "attn":
            y, _ = self.mixer(h, cfg, positions=positions, causal=causal,
                              cache=None if cache is None else cache["attn"],
                              cache_pos=cache_pos)
            x = x + y
        elif spec.mixer in _MIXERS:
            y, _ = self.mixer(h, cfg, cache=None if cache is None else
                              cache[_MIXER_CACHE[spec.mixer]])
            x = x + y
        if spec.cross_attn:
            y, _ = self.cross(self.norm_x(x), cfg, positions=positions,
                              causal=False, cross=True, kv_x=enc_out,
                              cache=None if cache is None else
                              cache.get("cross"))
            x = x + y
        if spec.mlp == "none":
            return x, aux
        h = self.norm2(x)
        if spec.mlp == "dense":
            x = x + self.mlp(h, cfg)
        elif spec.mlp == "moe":
            y, aux = self.moe(h, cfg)
            x = x + y
        elif spec.mlp == "dense+moe":  # arctic: parallel dense residual + MoE
            y, aux = self.moe(h, cfg)
            x = x + self.mlp(h, cfg) + y
        elif spec.mlp == "rwkv_cmix":
            y, _ = self.mlp(h, cfg, cache=None if cache is None else
                            cache["cmix"])
            x = x + y
        return x, aux


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp(logits, -1)`` over the vocab columns of every rank
    of ``axis`` (each holding its own, ``logits`` [..., V_m]): the max
    (detached) and Σ exp all-reduced. On one rank the same arithmetic as
    ``torch.logsumexp``, forward and backward, bit for bit; it saves
    ``logits`` and the result, as that does."""

    @staticmethod
    def forward(ctx, logits, axis):
        m = logits.amax(-1, keepdim=True)
        m = axis.max(m.masked_fill_(m.abs() == float("inf"), 0))
        se = axis.reduce(torch.sum((logits - m).exp_(), -1))
        lse = se.log_().add_(m.squeeze(-1))
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        logits, lse = ctx.saved_tensors
        return grad[..., None] * (logits - lse[..., None]).exp(), None


def _add(total, aux):
    """``total + aux`` where either may be None (a sum of nothing): JAX adds
    zeros there, which leaves the sum as it is."""
    return aux if total is None else total if aux is None else total + aux


def _block_forward(block, x, cfg: ModelConfig, positions, causal: bool,
                   enc_out=None, caches=None, cache_pos=None):
    """One super-block: its sub-layers in order, each given its slice of
    ``caches`` (the block's ``{"pos<j>": …}``). Returns ``(x, aux)``, the
    sub-layers' aux summed in order (JAX's ``block_fn``), None without a
    MoE layer."""
    aux = None
    for j, sub in enumerate(block):
        x, a = sub(x, cfg, positions=positions, causal=causal,
                   enc_out=enc_out,
                   cache=None if caches is None else caches[f"pos{j}"],
                   cache_pos=cache_pos)
        aux = _add(aux, a)
    return x, aux


class Transformer(nn.Module):
    """The model of a configuration: the decoder stack, and the encoder
    stack of an encoder-decoder.

    The constructor allocates the parameters (uninitialized) on ``device``
    (the card unless the caller names another, as every entry point);
    `init` fills them from a `torch.Generator`, or
    `repro_torch.models.weights.params_from_jax` loads a JAX tree.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = dtype_of(cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(cfg.padded_vocab, cfg.d_model,
                                              dtype=dt, device=device))
        self.blocks = nn.ModuleList(
            nn.ModuleList(Sublayer(spec, cfg, device) for spec in cfg.block)
            for _ in range(cfg.n_blocks))
        self.final_norm = layers.make_norm(cfg, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.padded_vocab, dtype=dt, device=device))
        if cfg.is_enc_dec:
            self.encoder = nn.ModuleList(
                nn.ModuleList(Sublayer(spec, cfg, device)
                              for spec in cfg.encoder_block)
                for _ in range(cfg.encoder_blocks))
            self.enc_norm = layers.make_norm(cfg, device=device)
            self.enc_pos = nn.Parameter(torch.empty(
                cfg.encoder_len, cfg.d_model, dtype=dt, device=device))
        if cfg.patch_positions:
            self.patch_proj = nn.Parameter(torch.empty(
                cfg.d_model, cfg.d_model, dtype=dt, device=device))
        # Runs in place of `_block_forward` when set: a sharded train step
        # gathers a super-block's parameters there
        # (`repro_torch.sharding.placement.Placement.bind`).
        self.block_runner = None
        self.tp = TRIVIAL  # the model axis (`Placement.shard` sets it)
        # The `Placement` of a sharded model (`shard_model`, `shard_state`).
        self.placement = None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Transformer":
        """Random init as JAX's ``init_params`` draws it (embedding and
        encoder positions N(0, 0.02²), dense weights truncated normal /
        √fan_in, norms 1), from ``generator``: the numbers differ from
        JAX's PRNG."""
        cfg = self.cfg
        self.embed.normal_(0.0, 0.02, generator=generator)
        for block in self.blocks:
            for sub in block:
                sub.init_(generator)
        self.final_norm.init_(generator)
        if not cfg.tie_embeddings:
            layers.dense_init_(self.lm_head, generator)
        if cfg.is_enc_dec:
            for block in self.encoder:
                for sub in block:
                    sub.init_(generator)
            self.enc_norm.init_(generator)
            self.enc_pos.normal_(0.0, 0.02, generator=generator)
        if cfg.patch_positions:
            layers.dense_init_(self.patch_proj, generator)
        return self

    def _cfg(self, cfg: ModelConfig | None) -> ModelConfig:
        if cfg is None:
            return self.cfg
        for f in _SHAPE_FIELDS:
            if getattr(cfg, f) != getattr(self.cfg, f):
                raise ValueError(f"config {cfg.name} differs from the "
                                 f"module's in {f}")
        if (cfg.moe and cfg.moe.num_experts) != (
                self.cfg.moe and self.cfg.moe.num_experts):
            raise ValueError(f"config {cfg.name} differs from the module's "
                             "in moe.num_experts")
        return cfg

    def _embed_inputs(self, cfg: ModelConfig, batch):
        """Token embedding, after the projected ``batch["patches"]`` under
        ``patch_positions``. Returns (x, positions, text_offset): positions
        over the whole sequence, the offset the patches' count."""
        cdt = dtype_of(cfg.compute_dtype)
        x = self._lookup(cfg, batch["tokens"])
        offset = 0
        if cfg.patch_positions:
            patches = self.tp.copy(batch["patches"].to(cdt))
            b, p, d = patches.shape
            patches = (patches.reshape(b * p, d) @ self.patch_proj.to(cdt)
                       ).reshape(b, p, -1)
            patches = self.tp.gather(patches, -1, "patch_proj", 1)
            x = torch.cat([patches, x], dim=1)
            offset = p
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions, offset

    def _lookup(self, cfg: ModelConfig, tokens):
        """``embed[tokens]`` in the compute dtype: over ``model``, the ids
        in the rank's rows [v0, v1) looked up, zeros for the others,
        summed over the ranks."""
        if not self.tp.split("embed", 0):
            return self.embed[tokens].to(dtype_of(cfg.compute_dtype))
        v0, v1 = self.tp.span("embed", 0, cfg.padded_vocab)
        ids = tokens.long() - v0
        inside = (ids >= 0) & (ids < v1 - v0)
        x = self.embed[ids.clamp(0, max(v1 - v0 - 1, 0))]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        return self.tp.reduce(x.to(dtype_of(cfg.compute_dtype)))

    def _encode(self, cfg: ModelConfig, frames):
        """The encoder over ``frames`` [B, T, d] (JAX's ``_encode``): the
        frames in the compute dtype plus ``enc_pos[:T]``, the encoder's
        super-blocks without causality, ``enc_norm``."""
        x = frames.to(dtype_of(cfg.compute_dtype))
        x = x + self.enc_pos.to(x.dtype)[None, :x.shape[1]]
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._stack(cfg, x, positions, stack=self.encoder,
                           causal=False)
        return self.enc_norm(x)

    def _head(self, cfg: ModelConfig):
        """(the head [d, V_m] of the rank's vocab columns, the leaf and dim
        its columns split as)."""
        if cfg.tie_embeddings:
            return self.embed.T, ("embed", 0)
        return self.lm_head, ("lm_head", 1)

    def _logits(self, cfg: ModelConfig, x):
        """Float32 logits (float64 under float64 compute) of the rank's
        vocab columns [v0, v1) (all of them on one rank), the vocab's
        padding masked."""
        head, (leaf, dim) = self._head(cfg)
        xf = layers.wide(self.tp.copy(x))
        logits = xf @ head.to(xf.dtype)
        if cfg.padded_vocab != cfg.vocab:  # mask the vocab-padding rows
            v0, v1 = self.tp.span(leaf, dim, cfg.padded_vocab)
            pad = torch.arange(v0, v1, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
        return logits

    def _full_logits(self, cfg: ModelConfig, x, logits=None):
        """`_logits` (``logits``, where given) gathered over ``model``:
        [..., padded_vocab]."""
        leaf, dim = self._head(cfg)[1]
        if logits is None:
            logits = self._logits(cfg, x)
        return self.tp.gather(logits, -1, leaf, dim)

    def _hidden(self, cfg: ModelConfig, batch):
        """The final norm's output over the sequence, aux and offset."""
        x, positions, offset = self._embed_inputs(cfg, batch)
        enc_out = (self._encode(cfg, batch["frames"]) if cfg.is_enc_dec
                   else None)
        x, aux = self._stack(cfg, x, positions, enc_out=enc_out)
        x = self.final_norm(x)
        if aux is None:  # no MoE layer
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux, offset

    def forward(self, batch, cfg: ModelConfig | None = None):
        """Logits over the sequence, a patch config's patches first: ([B,
        S, padded_vocab] float32, aux, offset), an encoder-decoder's
        decoder attending to ``batch["frames"]`` encoded. ``cfg``
        (default: the module's) may differ from the module's only in what
        does not shape the parameters, e.g. ``use_flash_kernel`` or
        ``compute_dtype``."""
        cfg = self._cfg(cfg)
        x, aux, offset = self._hidden(cfg, batch)
        return self._full_logits(cfg, x), aux, offset

    def _stack(self, cfg: ModelConfig, x, positions, caches=None,
               cache_pos=None, *, stack=None, causal: bool = True,
               enc_out=None, layout=None):
        """The super-blocks of ``stack`` (default: the decoder's) in order
        (JAX's ``_scan_stack``). Returns ``(x, aux)``, the blocks' aux
        summed in order (None without a MoE layer). ``caches`` is the
        stacked ``cache["blocks"]``, each block reading and writing its
        slice ``[i]`` of every leaf in place, each sub-layer's kind given
        its ``"split"`` under ``layout``. Without a cache, under
        ``cfg.remat`` and while autograd records, each super-block is
        checkpointed (JAX's ``jax.checkpoint(block_fn)``)."""
        aux = None
        remat = caches is None and cfg.remat and torch.is_grad_enabled()
        run = self.block_runner or _block_forward
        for i, block in enumerate(self.blocks if stack is None else stack):
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    run, block, x, cfg, positions, causal,
                    enc_out, use_reentrant=False)
            else:
                c = None if caches is None else {
                    j: {kind: dict({name: leaf[i] for name, leaf
                                    in sub.items()},
                                   split=layout.split(j, kind))
                        for kind, sub in kinds.items()}
                    for j, kinds in caches.items()}
                x, a = run(block, x, cfg, positions, causal, enc_out, c,
                           cache_pos)
            aux = _add(aux, a)
        return x, aux

    def loss_fn(self, batch, cfg: ModelConfig | None = None, *,
                sum_over=None, logits: bool = False):
        """Next-token cross entropy (+ MoE aux + z-loss). Returns (loss,
        metrics).

        ``sum_over`` (a data-parallel step's `DataAxes.sum`) sums a tensor
        over the ranks that hold the other rows of the global batch: the
        token count is then the global one, the metrics the global batch's
        (JAX's ``denom`` over the whole batch), and ``loss`` this rank's
        share of the global loss — its rows' terms over the global count,
        plus the MoE aux (global in value, its gradient this rank's
        tokens') — whose gradients, summed over the ranks, are the global
        loss's. Over ``model`` the loss is vocab-parallel: each rank holds
        its vocab columns' logits, the log-sum-exp and the target logit
        are summed over the ranks, and every model rank computes the same
        loss. ``logits=True`` adds ``metrics["logits"]``, the full logits
        [B, S, padded_vocab] (`forward`'s) of the same pass."""
        cfg = self._cfg(cfg)
        x, aux, offset = self._hidden(cfg, batch)
        logits_m = self._logits(cfg, x)
        full = None
        if logits:
            full = self._full_logits(cfg, x, logits_m)
        del x
        tokens = batch["tokens"]
        logits_text = logits_m[:, offset:][:, :-1]
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = torch.ones_like(targets, dtype=torch.float32) if mask is None \
            else mask[:, 1:].float()
        lse = _LogSumExp.apply(logits_text, self.tp)
        # A gather of the target logit where the rank holds it: JAX's
        # one-hot contraction adds zeros to the same value.
        head = self._head(cfg)[1]
        v0, v1 = self.tp.span(*head, cfg.padded_vocab)
        ids = targets.long() - v0
        inside = (ids >= 0) & (ids < v1 - v0)
        tgt_logit = logits_text.gather(
            -1, ids.clamp(0, max(v1 - v0 - 1, 0))[..., None]).squeeze(-1)
        if self.tp.split(*head):
            tgt_logit = self.tp.reduce(torch.where(
                inside, tgt_logit, torch.zeros((), dtype=tgt_logit.dtype,
                                               device=tgt_logit.device)))
        del logits_m, logits_text
        nll = (lse - tgt_logit) * mask
        count = mask.sum() if sum_over is None else sum_over(mask.sum())
        denom = torch.clamp(count, min=1.0)
        ce = nll.sum() / denom
        zloss = 1e-4 * ((lse * mask) ** 2).sum() / denom
        loss = ce + zloss + aux
        extra = {} if full is None else {"logits": full}
        if sum_over is not None:
            ce_g, zloss_g = sum_over(torch.stack([ce, zloss])).unbind(0)
            return loss, {"ce": ce_g, "aux": aux.detach(), "zloss": zloss_g,
                          "tokens": denom, **extra}
        return loss, {"ce": ce, "aux": aux, "zloss": zloss, "tokens": denom,
                      **extra}

    # -- serving: prefill and decode with caches -----------------------------

    def cache_shapes(self, batch: int, max_len: int,
                     cfg: ModelConfig | None = None,
                     cross_len: int | None = None) -> dict:
        """The full cache's tree of leaf shapes, ``{"blocks": {"pos<j>":
        {<kind>: {<leaf>: shape}}}, "pos": ()}``, for ``batch`` sequences
        of up to ``max_len`` positions (a ``cross`` cache of ``cross_len``
        frames, default ``encoder_len``): `init_cache`'s leaves."""
        cfg = self._cfg(cfg)
        with torch.device("meta"):
            tree = self._empty(cfg, batch, max_len, cross_len)
        return {"blocks": {j: {kind: {name: (cfg.n_blocks,) + tuple(t.shape)
                                      for name, t in leaves.items()}
                               for kind, leaves in kinds.items()}
                           for j, kinds in tree.items()}, "pos": ()}

    def _empty(self, cfg: ModelConfig, batch: int, max_len: int,
               cross_len: int | None) -> dict:
        """One super-block's empty caches on the current default device."""
        cdt = dtype_of(cfg.compute_dtype)
        out = {}
        for j, spec in enumerate(cfg.block):
            kinds = {}
            if spec.mixer == "attn":
                kinds["attn"] = layers.init_attn_cache(
                    cfg, batch, max_len, cdt)
            elif spec.mixer == "mamba":
                kinds["mamba"] = ssm.init_mamba_cache(cfg, batch)
            elif spec.mixer == "rwkv6":
                kinds["rwkv"] = ssm.init_rwkv_cache(cfg, batch)
            if spec.cross_attn:
                shape = (batch, cross_len or cfg.encoder_len,
                         cfg.n_kv_heads, cfg.resolved_head_dim)
                kinds["cross"] = {name: torch.zeros(shape, dtype=cdt)
                                  for name in ("k", "v")}
            if spec.mlp == "rwkv_cmix":
                kinds["cmix"] = ssm.init_cmix_cache(cfg, batch)
            out[f"pos{j}"] = kinds
        return out

    def init_cache(self, batch: int, max_len: int,
                   cfg: ModelConfig | None = None, *, layout=None,
                   cross_len: int | None = None) -> dict:
        """The empty per-super-block caches for ``batch`` sequences of up to
        ``max_len`` positions on the module's device, as JAX's
        ``init_cache`` returns them: ``{"pos<j>": {<kind>: …}}`` with
        ``attn`` (`layers.init_attn_cache` in the compute dtype), ``cross``
        (``k``, ``v`` [batch, encoder_len, Hkv, hd] zeros in the compute
        dtype; ``cross_len`` frames in place of ``encoder_len``), ``mamba``
        (`ssm.init_mamba_cache`), ``rwkv`` (`ssm.init_rwkv_cache`) and
        ``cmix`` (`ssm.init_cmix_cache`) as the sub-layer has them, each
        leaf stacked over the super-blocks. With a ``layout``
        (`repro_torch.sharding.cache.CacheLayout` of the global
        ``batch``), each leaf is this rank's slice of it. `prefill` wraps
        them as ``{"blocks": …, "pos": …}``."""
        cfg = self._cfg(cfg)
        with torch.device("meta"):
            tree = self._empty(cfg, batch, max_len, cross_len)
        out = {}
        for j, kinds in tree.items():
            out[j] = {}
            for kind, leaves in kinds.items():
                out[j][kind] = {}
                for name, leaf in leaves.items():
                    shape = (cfg.n_blocks,) + tuple(leaf.shape)
                    if layout is not None:
                        shape = layout.local_shape(j, kind, name)
                    out[j][kind][name] = torch.full(
                        shape, -1 if name == "pos" else 0, dtype=leaf.dtype,
                        device=self.embed.device)
        return out

    def _serving(self, shard_seq: bool):
        """The model's parameters as a sharded model's prefill and decode
        read them: `Placement.bind` (unless bound already), with the MoE
        layers' data axes off under ``shard_seq``."""
        if self.placement is None or self.block_runner is not None:
            return contextlib.nullcontext()
        return self.placement.bind(self, rows=not shard_seq)

    def _layout(self, cfg: ModelConfig, rows: int, max_len: int, batch, *,
                shard_seq: bool, kv_seq_over_model: bool) -> CacheLayout:
        mesh = None if self.placement is None else self.placement.mesh
        if shard_seq and rows != 1:
            raise ValueError(f"shard_seq serves one sequence; the batch "
                             f"has {rows}")
        if not self.tp.trivial and mesh is None:
            raise ValueError("the model is split over a model axis without "
                             "a placement")
        cross = batch["frames"].shape[1] if cfg.is_enc_dec else None
        shapes = self.cache_shapes(
            rows * CacheLayout.rows_of(mesh, shard_seq), max_len, cfg,
            cross)
        return CacheLayout(cfg, mesh, shapes, shard_seq=shard_seq,
                           kv_seq_over_model=kv_seq_over_model)

    @torch.inference_mode()
    def prefill(self, batch, max_len: int, cfg: ModelConfig | None = None,
                *, shard_seq: bool = False, kv_seq_over_model: bool = True):
        """Run the prompt ``batch["tokens"]`` [B, T] (after its
        ``"patches"`` under ``patch_positions``) through the stack into a
        new cache of ``max_len`` positions, which must hold the patches
        too. Returns ``(logits [B, padded_vocab] of the last position,
        {"blocks", "pos": T})``, ``pos`` a 0-d int32 tensor on the device
        (T counts the patches). An encoder-decoder first encodes
        ``batch["frames"]``, and each cross-attention writes its K/V of
        them into its ``cross`` cache, which takes the frames' length, as
        JAX's ``_fill_cross_caches`` replaces the leaf. Runs in inference
        mode, so the cache's tensors are inference tensors: `decode_step`
        (which also enters that mode) writes them in place.

        On a sharded model ``batch`` holds this rank's rows of the global
        batch (under ``shard_seq``, the one sequence, whole on every
        rank), the cache is this rank's slice of JAX's layout
        (`cache_specs` with ``shard_seq`` and ``kv_seq_over_model``; the
        returned tree carries it as ``layout``) and the logits are the
        rank's rows'. Collective: every rank of the mesh calls it."""
        cfg = self._cfg(cfg)
        with self._serving(shard_seq):
            x, positions, _ = self._embed_inputs(cfg, batch)
            b, t = x.shape[:2]
            layout = self._layout(cfg, b, max_len, batch,
                                  shard_seq=shard_seq,
                                  kv_seq_over_model=kv_seq_over_model)
            cross = batch["frames"].shape[1] if cfg.is_enc_dec else None
            blocks = self.init_cache(b * layout.rows, max_len, cfg,
                                     layout=layout, cross_len=cross)
            enc_out = None
            if cfg.is_enc_dec:
                enc_out = self._encode(cfg, batch["frames"])
            zero = torch.zeros((), dtype=torch.int32, device=x.device)
            x, _ = self._stack(cfg, x, positions, blocks, cache_pos=zero,
                               enc_out=enc_out, layout=layout)
            logits = self._full_logits(cfg, self.final_norm(x[:, -1:]))
        return logits[:, 0], ServeCache({"blocks": blocks, "pos": torch.full(
            (), t, dtype=torch.int32, device=x.device)}, layout)

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens,
                    cfg: ModelConfig | None = None):
        """One token step: ``tokens`` [B, 1] → ``(logits [B, padded_vocab],
        cache)``. The cache passed in is consumed, as a donated buffer
        would be: its tensors (``pos`` too) are written in place and the
        same dict comes back, where JAX returns a new one. Nothing here
        reads a device value on the host, so the step can be captured into
        a CUDA graph and replayed (`repro_torch.train.serve.sample_loop`).
        The cross-attention reads its ``cross`` cache and writes nothing.
        On a sharded model the cache is a sharded `prefill`'s (its
        ``layout`` says how) and ``tokens`` the rank's rows of it;
        collective."""
        cfg = self._cfg(cfg)
        layout = getattr(cache, "layout", None)
        if layout is None:
            if self.placement is not None and self.placement.mesh.size > 1:
                raise ValueError("decode over a mesh takes the cache its "
                                 "sharded prefill returned (it carries its "
                                 "layout)")
            layout = CacheLayout(cfg, None, {"blocks": {}, "pos": ()})
        with self._serving(layout.shard_seq):
            pos = cache["pos"]
            x = self._lookup(cfg, tokens)
            positions = pos + torch.arange(tokens.shape[1],
                                           dtype=torch.int32,
                                           device=x.device)
            x, _ = self._stack(cfg, x, positions, cache["blocks"],
                               cache_pos=pos, layout=layout)
            logits = self._full_logits(cfg, self.final_norm(x[:, -1:]))
        pos.add_(tokens.shape[1])
        return logits[:, 0], cache
