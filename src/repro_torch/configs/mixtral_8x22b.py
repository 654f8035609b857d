"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088].
SWA window 4096 => ring-buffer KV cache (the reason long_500k is runnable).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    n_blocks=56, block=(LayerSpec(mixer="attn", mlp="moe"),),
    moe=MoEConfig(num_experts=8, top_k=2),
    swa_window=4096, fsdp=True,
)

SMOKE = ModelConfig(
    name="mixtral-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="moe"),),
    moe=MoEConfig(num_experts=4, top_k=2),
    swa_window=8, remat=False,
)
