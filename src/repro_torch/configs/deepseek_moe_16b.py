"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed
top-6. [arXiv:2401.06066; hf]  28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_expert=1408, capacity_factor=1.25, adaptive=True),
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, d_ff=32, vocab_size=256,
                      moe=MoEConfig(num_experts=8, top_k=2,
                                    num_shared_experts=1, d_expert=32,
                                    capacity_factor=1.5, adaptive=True))
