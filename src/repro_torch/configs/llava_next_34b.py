"""llava-next-34b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000; anyres tiling.
Vision frontend is a STUB: input_specs provides precomputed patch
embeddings [B, 576, d_model] (the transformer backbone is the assignment).
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    n_extra_embeds=576,
)

SMOKE = ModelConfig(
    name="llava_next_34b_smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
    n_extra_embeds=16, remat="none",
)
