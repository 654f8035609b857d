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
(``_constrain_act``) have no effect on one card: PyTorch runs the loop
eagerly and nothing is sharded.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels._platform import resolve_device
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
        x = self.embed[batch["tokens"]].to(cdt)
        offset = 0
        if cfg.patch_positions:
            patches = batch["patches"].to(cdt)
            b, p, d = patches.shape
            patches = (patches.reshape(b * p, d) @ self.patch_proj.to(cdt)
                       ).reshape(b, p, -1)
            x = torch.cat([patches, x], dim=1)
            offset = p
        positions = torch.arange(x.shape[1], device=x.device)
        return x, positions, offset

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

    def _logits(self, cfg: ModelConfig, x):
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x.float() @ head.float()
        if cfg.padded_vocab != cfg.vocab:  # mask the vocab-padding rows
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(pad, torch.finfo(torch.float32).min)
        return logits

    def forward(self, batch, cfg: ModelConfig | None = None):
        """Logits over the sequence, a patch config's patches first: ([B,
        S, padded_vocab] float32, aux, offset), an encoder-decoder's
        decoder attending to ``batch["frames"]`` encoded. ``cfg``
        (default: the module's) may differ from the module's only in what
        does not shape the parameters, e.g. ``use_flash_kernel`` or
        ``compute_dtype``."""
        cfg = self._cfg(cfg)
        x, positions, offset = self._embed_inputs(cfg, batch)
        enc_out = (self._encode(cfg, batch["frames"]) if cfg.is_enc_dec
                   else None)
        x, aux = self._stack(cfg, x, positions, enc_out=enc_out)
        x = self.final_norm(x)
        if aux is None:  # no MoE layer
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(cfg, x), aux, offset

    def _stack(self, cfg: ModelConfig, x, positions, caches=None,
               cache_pos=None, *, stack=None, causal: bool = True,
               enc_out=None):
        """The super-blocks of ``stack`` (default: the decoder's) in order
        (JAX's ``_scan_stack``). Returns ``(x, aux)``, the blocks' aux
        summed in order (None without a MoE layer). ``caches`` is the
        stacked ``cache["blocks"]``, each block reading and writing its
        slice ``[i]`` of every leaf in place. Without a cache, under
        ``cfg.remat`` and while autograd records, each super-block is
        checkpointed (JAX's ``jax.checkpoint(block_fn)``)."""
        aux = None
        remat = caches is None and cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks if stack is None else stack):
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    _block_forward, block, x, cfg, positions, causal,
                    enc_out, use_reentrant=False)
            else:
                c = None if caches is None else {
                    j: {kind: {name: leaf[i] for name, leaf in sub.items()}
                        for kind, sub in kinds.items()}
                    for j, kinds in caches.items()}
                x, a = _block_forward(block, x, cfg, positions, causal,
                                      enc_out, c, cache_pos)
            aux = _add(aux, a)
        return x, aux

    def loss_fn(self, batch, cfg: ModelConfig | None = None):
        """Next-token cross entropy (+ MoE aux + z-loss). Returns (loss,
        metrics)."""
        logits, aux, offset = self.forward(batch, cfg)
        tokens = batch["tokens"]
        logits_text = logits[:, offset:][:, :-1]
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = torch.ones_like(targets, dtype=torch.float32) if mask is None \
            else mask[:, 1:].float()
        lse = torch.logsumexp(logits_text, dim=-1)
        # A gather of the target logit: JAX's one-hot contraction adds zeros
        # to the same value.
        tgt_logit = logits_text.gather(
            -1, targets[..., None].long()).squeeze(-1)
        del logits, logits_text
        nll = (lse - tgt_logit) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = nll.sum() / denom
        zloss = 1e-4 * ((lse * mask) ** 2).sum() / denom
        loss = ce + zloss + aux
        return loss, {"ce": ce, "aux": aux, "zloss": zloss, "tokens": denom}

    # -- serving: prefill and decode with caches -----------------------------

    def init_cache(self, batch: int, max_len: int,
                   cfg: ModelConfig | None = None) -> dict:
        """The empty per-super-block caches for ``batch`` sequences of up to
        ``max_len`` positions on the module's device, as JAX's
        ``init_cache`` returns them: ``{"pos<j>": {<kind>: …}}`` with
        ``attn`` (`layers.init_attn_cache` in the compute dtype), ``cross``
        (``k``, ``v`` [batch, encoder_len, Hkv, hd] zeros in the compute
        dtype), ``mamba`` (`ssm.init_mamba_cache`), ``rwkv``
        (`ssm.init_rwkv_cache`) and ``cmix`` (`ssm.init_cmix_cache`) as the
        sub-layer has them, each leaf stacked over the super-blocks.
        `prefill` wraps them as ``{"blocks": …, "pos": …}``."""
        cfg = self._cfg(cfg)
        dev = self.embed.device
        cdt = dtype_of(cfg.compute_dtype)
        out = {}
        for j, spec in enumerate(cfg.block):
            kinds = {}
            if spec.mixer == "attn":
                kinds["attn"] = layers.init_attn_cache(
                    cfg, batch, max_len, cdt, dev)
            elif spec.mixer == "mamba":
                kinds["mamba"] = ssm.init_mamba_cache(cfg, batch, dev)
            elif spec.mixer == "rwkv6":
                kinds["rwkv"] = ssm.init_rwkv_cache(cfg, batch, dev)
            if spec.cross_attn:
                shape = (batch, cfg.encoder_len, cfg.n_kv_heads,
                         cfg.resolved_head_dim)
                kinds["cross"] = {
                    name: torch.zeros(shape, dtype=cdt, device=dev)
                    for name in ("k", "v")}
            if spec.mlp == "rwkv_cmix":
                kinds["cmix"] = ssm.init_cmix_cache(cfg, batch, dev)
            out[f"pos{j}"] = {kind: {
                name: leaf.expand((cfg.n_blocks,) + leaf.shape).clone()
                for name, leaf in one.items()} for kind, one in kinds.items()}
        return out

    @torch.inference_mode()
    def prefill(self, batch, max_len: int, cfg: ModelConfig | None = None):
        """Run the prompt ``batch["tokens"]`` [B, T] (after its
        ``"patches"`` under ``patch_positions``) through the stack into a
        new cache of ``max_len`` positions, which must hold the patches
        too. Returns ``(logits [B, padded_vocab] of the last position,
        {"blocks", "pos": T})``, ``pos`` a 0-d int32 tensor on the device
        (T counts the patches). An encoder-decoder first encodes
        ``batch["frames"]`` and puts each cross-attention's K/V of them in
        its ``cross`` cache: a new leaf of the frames' length, as JAX's
        ``_fill_cross_caches`` replaces it. Runs in inference mode, so the
        cache's tensors are inference tensors: `decode_step` (which also
        enters that mode) writes them in place."""
        cfg = self._cfg(cfg)
        x, positions, _ = self._embed_inputs(cfg, batch)
        b, t = x.shape[:2]
        blocks = self.init_cache(b, max_len, cfg)
        enc_out = None
        if cfg.is_enc_dec:
            enc_out = self._encode(cfg, batch["frames"])
            self._fill_cross_caches(cfg, blocks, enc_out)
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        x, _ = self._stack(cfg, x, positions, blocks, cache_pos=zero,
                           enc_out=enc_out)
        logits = self._logits(cfg, self.final_norm(x[:, -1:]))
        return logits[:, 0], {"blocks": blocks, "pos": torch.full(
            (), t, dtype=torch.int32, device=x.device)}

    def _fill_cross_caches(self, cfg: ModelConfig, blocks: dict,
                           enc_out) -> None:
        """Each cross-attention's K/V of ``enc_out`` as the ``cross`` leaves
        of ``blocks``, stacked over the super-blocks (JAX's
        ``_fill_cross_caches``): new tensors of ``enc_out``'s length."""
        for j, spec in enumerate(cfg.block):
            if spec.cross_attn:
                kv = [block[j].cross.cross_kv(enc_out, cfg)
                      for block in self.blocks]
                blocks[f"pos{j}"]["cross"] = {
                    "k": torch.stack([k for k, _ in kv]),
                    "v": torch.stack([v for _, v in kv])}

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens,
                    cfg: ModelConfig | None = None):
        """One token step: ``tokens`` [B, 1] → ``(logits [B, padded_vocab],
        cache)``. The cache passed in is consumed, as a donated buffer
        would be: its tensors (``pos`` too) are written in place and the
        same dict comes back, where JAX returns a new one. Nothing here
        reads a device value on the host, so the step can be captured into
        a CUDA graph and replayed (`repro_torch.train.serve.sample_loop`).
        The cross-attention reads its ``cross`` cache and writes nothing."""
        cfg = self._cfg(cfg)
        pos = cache["pos"]
        x = self.embed[tokens].to(dtype_of(cfg.compute_dtype))
        positions = pos + torch.arange(tokens.shape[1], dtype=torch.int32,
                                       device=x.device)
        x, _ = self._stack(cfg, x, positions, cache["blocks"], cache_pos=pos)
        logits = self._logits(cfg, self.final_norm(x[:, -1:]))
        pos.add_(tokens.shape[1])
        return logits[:, 0], cache
