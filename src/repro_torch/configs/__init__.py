"""Config registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)`` for the architectures whose model family the
port runs (``dense`` and ``moe``, GQA attention).  The others stay in
the JAX package's registry until their family is ported (ROADMAP.md,
Queue 1 item 10); asking for one raises a ``KeyError`` that says so.
"""
from .base import (ModelConfig, MoEConfig, MLAConfig, SSMConfig,
                   ShapeConfig, SHAPES, shape_by_name, applicable_shapes)

from . import deepseek_moe_16b, llama3_8b

_MODULES = {
    "llama3-8b": llama3_8b,
    "deepseek-moe-16b": deepseek_moe_16b,
}

ARCH_IDS = tuple(_MODULES.keys())


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"{arch!r} is not ported to repro_torch yet (ported: "
                       f"{', '.join(ARCH_IDS)}); see ROADMAP.md, Queue 1 "
                       f"item 10")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "shape_by_name", "applicable_shapes",
           "ARCH_IDS", "get_config", "get_smoke_config"]
