"""llava-next-34b [vlm]: anyres tiling, vision frontend stubbed.

60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf]. Backbone only per the task spec:
`input_specs()` supplies precomputed patch embeddings [B, 2880, d] (anyres =
5 tiles x 576 patches); the vision tower is a stub. Patches prepend the text
sequence; loss masks them out.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    n_blocks=60, block=(LayerSpec(mixer="attn", mlp="dense"),),
    patch_positions=2880, fsdp=True,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense"),),
    patch_positions=8, remat=False,
)
