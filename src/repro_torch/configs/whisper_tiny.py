"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (precomputed frames).

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356].
Backbone only per the task spec: `input_specs()` supplies [B, 1500, d] frame
embeddings (the conv1d stack is a stub); 4 encoder + 4 decoder layers,
LayerNorm. Adaptation note (DESIGN.md): decoder uses RoPE instead of learned
positional embeddings; encoder keeps learned positions.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    n_blocks=4, block=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),
    encoder_blocks=4, encoder_block=(LayerSpec(mixer="attn", mlp="dense"),),
    encoder_len=1500, norm="layer",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),
    encoder_blocks=2, encoder_block=(LayerSpec(mixer="attn", mlp="dense"),),
    encoder_len=16, norm="layer", remat=False,
)
