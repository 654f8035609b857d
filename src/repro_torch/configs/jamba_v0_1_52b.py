"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887; hf].
Super-block of 8 layers: attention at position 3, Mamba elsewhere; MoE on odd
positions (every other layer), dense MLP on even — 4 scanned super-blocks.
"""

from repro_torch.models.config import LayerSpec, MambaConfig, ModelConfig, MoEConfig


def _block() -> tuple[LayerSpec, ...]:
    specs = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, mlp=mlp))
    return tuple(specs)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
    n_blocks=4, block=_block(),
    moe=MoEConfig(num_experts=16, top_k=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    fsdp=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_blocks=1, block=_block(),
    moe=MoEConfig(num_experts=4, top_k=2),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8),
    remat=False,
)
