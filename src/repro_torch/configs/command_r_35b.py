"""command-r-35b [dense]: GQA, no-bias, 256k vocab.

40L d_model=8192 64H (kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01].
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000,
    n_blocks=40, block=(LayerSpec(mixer="attn", mlp="dense"),),
    fsdp=True,
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense"),),
    remat=False,
)
