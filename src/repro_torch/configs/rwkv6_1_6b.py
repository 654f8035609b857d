"""rwkv6-1.6b [ssm] "Finch": attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892]. head_size=64
(32 heads). Time-mix (wkv6) + channel-mix per layer; O(1)-state decode
(long_500k is the showcase shape).
"""

from repro_torch.models.config import LayerSpec, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
    n_blocks=24, block=(LayerSpec(mixer="rwkv6", mlp="rwkv_cmix"),),
    rwkv=RWKVConfig(head_size=64),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    d_model=64, n_heads=8, n_kv_heads=8, d_ff=128, vocab=512,
    n_blocks=2, block=(LayerSpec(mixer="rwkv6", mlp="rwkv_cmix"),),
    rwkv=RWKVConfig(head_size=8, lora_decay=8, lora_mix=4),
    remat=False,
)
