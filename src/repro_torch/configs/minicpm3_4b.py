"""minicpm3-4b [dense, MLA]: [hf:openbmb/MiniCPM3-4B; hf]
62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448."""
from .base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448, attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32,
                  v_head_dim=64),
)

SMOKE = CONFIG.scaled(num_layers=3, d_model=64, num_heads=4,
                      num_kv_heads=4, d_ff=128, vocab_size=256,
                      mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                    qk_nope_head_dim=8, qk_rope_head_dim=4,
                                    v_head_dim=8))
