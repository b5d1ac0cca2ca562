"""llama4-scout-17b-a16e [moe]: 16 experts top-1 (+1 shared), early
fusion (text backbone only here).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=1, num_shared_experts=1,
                  d_expert=8192, capacity_factor=1.25, adaptive=True),
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=64, vocab_size=256,
                      head_dim=16,
                      moe=MoEConfig(num_experts=4, top_k=1,
                                    num_shared_experts=1, d_expert=64,
                                    capacity_factor=1.5, adaptive=True))
