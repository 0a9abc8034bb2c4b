"""jamba-1.5-large-398b [arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave (1 attention layer per 8-layer super-block),
MoE on alternating layers.  Sub-quadratic (Mamba states + 1/8 attention
layers with seq-sharded KV) -> runs long_500k.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="jamba_15_large_398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    moe_experts=16, moe_top_k=2,
    pattern_len=8, attn_positions=(4,), moe_positions=(1, 3, 5, 7),
    mixer="mamba", sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="jamba_15_large_398b_smoke", family="hybrid", n_layers=4,
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
    moe_experts=4, moe_top_k=2,
    pattern_len=4, attn_positions=(2,), moe_positions=(1, 3),
    mixer="mamba", sub_quadratic=True, remat="none",
)
