"""paligemma-3b [vlm]: SigLIP frontend (STUB: input_specs supplies
precomputed patch embeddings) + gemma backbone.
[arXiv:2407.07726; hf]  18L d_model=2048 8H (kv=1) d_ff=16384
vocab=257216."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=257216, head_dim=256, act="gelu",
    prefix_len=256,                   # 256 image patch embeddings
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=1, d_ff=128, vocab_size=256,
                      head_dim=16, prefix_len=8)
