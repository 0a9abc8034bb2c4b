"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="stablelm_12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352,
)

SMOKE = ModelConfig(
    name="stablelm_12b_smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256, remat="none",
)
