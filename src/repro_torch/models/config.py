"""Model configuration schema for the 10 assigned architectures.

A copy of the JAX package's ``models/config.py`` (pure dataclasses), so the
port reads the same configurations without importing it. The fields that
steer JAX's compilation and sharding (``scan_layers``, ``fsdp``,
``dp_axes``, ``ep_axes``, ``seq_shard_activations``, ``shard_logits``,
``attn_unroll_blocks``) have no effect on one card; ``remat`` checkpoints
each super-block while autograd records. ``moe_groups`` is semantic on
every device: MoE capacity applies per group of tokens, so it changes which
assignments drop (`repro_torch.models.moe`). The comments below are the JAX
package's.

A model is a stack of ``n_blocks`` identical *super-blocks*; each super-block
is a static list of `LayerSpec`s. Homogeneous archs use a 1-layer super-block
(n_blocks == n_layers); jamba uses an 8-layer super-block (1 attention : 7
mamba, MoE on odd positions). `lax.scan` runs over super-blocks so compiled
HLO size is independent of depth.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Mixer = Literal["attn", "mamba", "rwkv6", "none"]
Mlp = Literal["dense", "moe", "dense+moe", "rwkv_cmix", "none"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None  # default d_model // 16


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    lora_decay: int = 64
    lora_mix: int = 32


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    mlp: Mlp = "dense"
    cross_attn: bool = False  # decoder layers of enc-dec models


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_blocks: int  # number of scanned super-blocks
    block: tuple[LayerSpec, ...] = (LayerSpec(),)

    head_dim: int | None = None  # default d_model // n_heads
    qk_norm: bool = False
    swa_window: int | None = None  # sliding-window attention
    rope_theta: float = 1e4
    norm: Literal["rms", "layer"] = "rms"
    tie_embeddings: bool = False
    use_bias: bool = False

    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None

    # Encoder-decoder (whisper): encoder super-blocks + fixed frame count.
    encoder_blocks: int = 0
    encoder_block: tuple[LayerSpec, ...] = ()
    encoder_len: int = 0  # e.g. 1500 audio frames (frontend stubbed)

    # VLM (llava): number of prefix patch-embedding positions (stub frontend).
    patch_positions: int = 0

    # Precision / memory policy.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: bool = True
    # lax.scan over super-blocks (compile-size O(1) in depth). The dry-run's
    # cost pass sets False: XLA's cost_analysis counts loop bodies once, so
    # FLOP/collective accounting needs the unrolled artifact (launch/dryrun.py).
    scan_layers: bool = True
    # FSDP-style weight sharding over the data axis (ZeRO) — needed by the
    # biggest archs to fit; see sharding/rules.py.
    fsdp: bool = False
    # Attention KV-block size for the blockwise (online-softmax) path.
    attn_block_kv: int = 1024
    # Unroll the KV-block loop (Python loop instead of lax.scan). Used by the
    # dry-run cost pass: cost_analysis counts scan bodies once, so honest
    # FLOP/byte accounting of the fused (flash-style) attention needs the
    # unrolled artifact. Production keeps the scan (small HLO).
    attn_unroll_blocks: bool = False
    # Route train/prefill self-attention through the fused Pallas kernel
    # (kernels/flash_attn). TPU production path; on CPU it runs interpreted
    # (tests only) — the XLA blockwise scan is the CPU execution path.
    use_flash_kernel: bool = False
    # Chunk length of the two-level SSM/linear-RNN scan (models/ssm.py).
    ssm_chunk: int = 64
    # Mesh axis names carrying data parallelism, e.g. ("pod", "data").
    # When set, the model inserts with_sharding_constraint on activations at
    # block boundaries — without these, GSPMD propagation can replicate the
    # token dim and silently lose DP compute scaling (found in the dry-run;
    # see EXPERIMENTS.md §Perf iteration 0).
    dp_axes: tuple[str, ...] | None = None
    # Hierarchical MoE dispatch: split tokens into this many groups (== DP
    # shard count on the mesh) so the routing argsort/scatter stays local and
    # only capacity-bounded [G, E, C, d] buffers cross the expert axis.
    # 1 == the global sort (single-device semantics). §Perf iteration A1.
    moe_groups: int = 1
    # Mesh axes carrying the expert dimension (EP), e.g. ("model",) when
    # num_experts % |model| == 0; None -> TP-on-ff fallback.
    ep_axes: tuple[str, ...] | None = None
    # Sequence parallelism: shard the token/sequence dim of activations over
    # `model` between blocks (turns per-layer TP all-reduces into
    # reduce-scatter + all-gather and shards norm compute). §Perf iter Q1.
    seq_shard_activations: bool = False
    # Keep the vocab dim of the output logits sharded over `model` (decode
    # samples from the shards). §Perf iteration C1. No-op when dp_axes unset.
    shard_logits: bool = True

    # Sub-quadratic family? (drives long_500k applicability; see DESIGN.md)
    @property
    def subquadratic(self) -> bool:
        if self.swa_window is not None:
            return True
        mixers = {spec.mixer for spec in self.block}
        return bool(mixers & {"mamba", "rwkv6"}) and ("attn" not in mixers or
                                                      self.family == "hybrid")

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128 — lane-aligned and
        divisible by the 16-way model axis (production practice; padded ids
        are masked out of logits)."""
        return -(-self.vocab // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return self.n_blocks * len(self.block) + \
            self.encoder_blocks * len(self.encoder_block)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_blocks > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model-FLOPs in roofline)."""
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params() -> int:
            return d * hd * (nq + 2 * nkv) + nq * hd * d

        def dense_mlp() -> int:
            return 3 * d * ff  # SwiGLU

        def moe_mlp() -> int:
            assert self.moe is not None
            return self.moe.num_experts * 3 * d * ff + d * self.moe.num_experts

        def mamba_params() -> int:
            mc = self.mamba or MambaConfig()
            di = mc.expand * d
            dt_rank = mc.dt_rank or d // 16
            return (d * 2 * di + di * mc.d_conv + di * (dt_rank + 2 * mc.d_state)
                    + dt_rank * di + di * mc.d_state + di + di * d)

        def rwkv_params() -> int:
            rc = self.rwkv or RWKVConfig()
            return 4 * d * d + d * d + 2 * d * rc.lora_decay + \
                5 * 2 * d * rc.lora_mix + 2 * d * ff

        def spec_params(spec: LayerSpec) -> int:
            p = 0
            if spec.mixer == "attn":
                p += attn_params()
            elif spec.mixer == "mamba":
                p += mamba_params()
            elif spec.mixer == "rwkv6":
                p += rwkv_params()
            if spec.cross_attn:
                p += attn_params()
            if spec.mlp == "dense":
                p += dense_mlp()
            elif spec.mlp == "moe":
                p += moe_mlp()
            elif spec.mlp == "dense+moe":
                p += dense_mlp() + moe_mlp()
            elif spec.mlp == "rwkv_cmix":
                p += 2 * d * ff
            return p

        total += self.n_blocks * sum(spec_params(s) for s in self.block)
        total += self.encoder_blocks * sum(spec_params(s)
                                           for s in self.encoder_block)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of E experts) for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e, k = self.moe.num_experts, self.moe.top_k
        expert_p = self.moe.num_experts * 3 * self.d_model * self.d_ff
        n_moe_layers = self.n_blocks * sum(
            1 for s in self.block if s.mlp in ("moe", "dense+moe"))
        inactive = n_moe_layers * expert_p * (1 - k / e) // 1
        return int(full - inactive)
