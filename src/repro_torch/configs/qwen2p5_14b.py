"""qwen2.5-14b [dense]: GQA with QKV bias. [hf:Qwen/Qwen2.5; hf]
48L d_model=5120 40H (kv=8) d_ff=13824 vocab=152064."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = CONFIG.scaled(num_layers=3, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=256,
                      head_dim=16)
