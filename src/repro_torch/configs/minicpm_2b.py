"""minicpm-2b [dense]: llama-like, trained with the WSD schedule.
[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36) d_ff=5760
vocab=122753."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, tie_embeddings=True,
)

# the arch's training recipe: WSD (see repro.optim.schedules.wsd_schedule)
LR_SCHEDULE = "wsd"

SMOKE = CONFIG.scaled(num_layers=3, d_model=48, num_heads=4,
                      num_kv_heads=4, d_ff=96, vocab_size=256)
