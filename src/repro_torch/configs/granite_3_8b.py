"""granite-3-8b [dense]: GQA.

40L d_model=4096 32H (kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base].
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800, vocab=49155,
    n_blocks=40, block=(LayerSpec(mixer="attn", mlp="dense"),),
    fsdp=True,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense"),),
    remat=False,
)
