"""yi-34b [arXiv:2403.04652; hf]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. llama-arch GQA.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="yi_34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
)

SMOKE = ModelConfig(
    name="yi_34b_smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256, remat="none",
)
