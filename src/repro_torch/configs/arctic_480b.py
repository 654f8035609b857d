"""arctic-480b [moe]: 128 experts top-2 + dense residual (parallel).

35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base]. Dense-MoE hybrid: every layer runs a
dense SwiGLU residual in parallel with the routed MoE (`mlp="dense+moe"`).
~0.5T params: bf16 params + bf16 optimizer moments + FSDP over the data axis
(see EXPERIMENTS.md for the single-pod memory verdict).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000,
    n_blocks=35, block=(LayerSpec(mixer="attn", mlp="dense+moe"),),
    moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=1.25),
    fsdp=True, param_dtype="bfloat16", opt_state_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense+moe"),),
    moe=MoEConfig(num_experts=4, top_k=2),
    remat=False,
)
