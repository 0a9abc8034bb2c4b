"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
    moe_experts=32, moe_top_k=8,
)

SMOKE = ModelConfig(
    name="granite_moe_1b_smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
    moe_experts=8, moe_top_k=4, remat="none",
)
