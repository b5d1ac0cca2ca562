"""musicgen-large [audio]: decoder-only over EnCodec tokens, 4
codebooks (frontend STUB: input_specs supplies token frames).
[arXiv:2306.05284; hf]  48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, act="gelu", num_codebooks=4,
)

SMOKE = CONFIG.scaled(num_layers=3, d_model=64, num_heads=4,
                      num_kv_heads=4, d_ff=128, vocab_size=64,
                      num_codebooks=2)
