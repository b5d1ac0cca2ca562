"""Config registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)`` for every architecture of the JAX package's
registry (``repro/configs``), in its ``ARCH_IDS`` order.  The port keeps
its own copies of the config modules; an unknown arch raises
``KeyError``.
"""
from .base import (ModelConfig, MoEConfig, MLAConfig, SSMConfig,
                   ShapeConfig, SHAPES, shape_by_name, applicable_shapes)

from . import (zamba2_2p7b, minicpm3_4b, llama3_8b, minicpm_2b,
               qwen2p5_14b, paligemma_3b, mamba2_2p7b, deepseek_moe_16b,
               llama4_scout_17b, musicgen_large)

_MODULES = {
    "zamba2-2.7b": zamba2_2p7b,
    "minicpm3-4b": minicpm3_4b,
    "llama3-8b": llama3_8b,
    "minicpm-2b": minicpm_2b,
    "qwen2.5-14b": qwen2p5_14b,
    "paligemma-3b": paligemma_3b,
    "mamba2-2.7b": mamba2_2p7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "musicgen-large": musicgen_large,
}

ARCH_IDS = tuple(_MODULES.keys())


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r} (known: "
                       f"{', '.join(ARCH_IDS)})")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "shape_by_name", "applicable_shapes",
           "ARCH_IDS", "get_config", "get_smoke_config"]
