"""minicpm-2b [dense]: llama-like, MHA (kv=36), tied embeddings, WSD schedule.

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753 [arXiv:2404.06395].
The WSD (warmup-stable-decay) schedule lives in optim/schedules.py and is the
default for this arch in launch/train.py.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760, vocab=122753,
    n_blocks=40, block=(LayerSpec(mixer="attn", mlp="dense"),),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="minicpm-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense"),),
    tie_embeddings=True, remat=False,
)
