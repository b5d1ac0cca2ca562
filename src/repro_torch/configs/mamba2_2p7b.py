"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  64L d_model=2560 vocab=50280
ssm_state=128."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, attention="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled(num_layers=4, d_model=64, vocab_size=256,
                      ssm=SSMConfig(d_state=16, head_dim=8, expand=2,
                                    d_conv=4, chunk=32))
