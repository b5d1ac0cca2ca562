from .adamw import adamw_init, adamw_update, global_norm, OptConfig
from .grad_compress import compressed_psum, dequantize, quantize
from .schedules import wsd_schedule, cosine_schedule

__all__ = ["adamw_init", "adamw_update", "global_norm", "OptConfig",
           "wsd_schedule", "cosine_schedule", "quantize", "dequantize",
           "compressed_psum"]
