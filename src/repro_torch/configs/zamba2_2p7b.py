"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000 ssm_state=64."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=256),
    attn_every=6,                    # 9 shared-block applications
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, num_heads=4,
                      num_kv_heads=4, d_ff=128, vocab_size=256,
                      attn_every=2,
                      ssm=SSMConfig(d_state=16, head_dim=8, expand=2,
                                    d_conv=4, chunk=32))
