"""rwkv6-3b "Finch" [arXiv:2404.05892; hf]
32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Data-dependent decay; O(1) decode state -> runs long_500k.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536,
    mixer="rwkv6", attn_positions=(), sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6_3b_smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=192, vocab=256,
    mixer="rwkv6", attn_positions=(), sub_quadratic=True, remat="none",
)
