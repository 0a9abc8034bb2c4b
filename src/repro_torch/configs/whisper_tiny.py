"""whisper-tiny [arXiv:2212.04356; unverified]
Enc-dec: 4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536
vocab=51865.  Conv frontend is a STUB: input_specs provides precomputed
frame embeddings [B, 1500, d_model].
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper_tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    enc_layers=4, n_extra_embeds=1500,
)

SMOKE = ModelConfig(
    name="whisper_tiny_smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, vocab=256,
    enc_layers=2, n_extra_embeds=32, remat="none",
)
