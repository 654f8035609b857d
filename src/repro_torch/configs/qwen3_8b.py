"""qwen3-8b [dense]: qk-norm, GQA.

36L d_model=4096 32H (kv=8) d_ff=12288 vocab=151936 [hf:Qwen/Qwen3-8B].
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288, vocab=151936,
    n_blocks=36, block=(LayerSpec(mixer="attn", mlp="dense"),),
    qk_norm=True,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense"),),
    qk_norm=True, remat=False,
)
