"""deepseek-coder-33b [arXiv:2401.14196; hf]
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256. llama-arch.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_coder_33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256,
)

SMOKE = ModelConfig(
    name="deepseek_coder_33b_smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256, remat="none",
)
