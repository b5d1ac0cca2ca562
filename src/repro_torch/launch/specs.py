"""Stand-ins for every model input of a dry-run cell: ``meta`` tensors,
the port's ``ShapeDtypeStruct``.

Port of ``repro/launch/specs.py``.  Nothing here allocates.  Modality
frontends are stubs, as in JAX: ``input_specs`` supplies precomputed
patch embeddings (vlm) / token frames (audio) directly.  The cache is
``transformer.init_cache``'s layout as ``meta`` tensors; its index is a
host int in the port: 0 before a prefill, the last position before a
decode step (the step then reads the whole cache, as JAX's masked read
of every position does).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import transformer as T


def _tok_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_cache(cfg: ModelConfig, batch: int, max_len: int,
               index: int) -> dict:
    """``transformer.init_cache``'s layout as ``meta`` tensors, with the
    host-int ``index``."""
    out = {part: {n: _meta(shape, dt) for n, (shape, dt) in tensors.items()}
           for part, tensors in T.init_cache(cfg, batch, max_len).items()
           if part != "index"}
    out["index"] = index
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs for the step function selected by shape.kind."""
    gb, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        text = s - cfg.prefix_len
        specs = {"tokens": _meta(_tok_shape(cfg, gb, text), i32),
                 "labels": _meta(_tok_shape(cfg, gb, text), i32)}
        if cfg.prefix_len:
            specs["prefix_emb"] = _meta((gb, cfg.prefix_len, cfg.d_model),
                                        torch.bfloat16)
        return specs
    if shape.kind == "prefill":
        return {"tokens": _meta(_tok_shape(cfg, gb, s), i32),
                "cache": meta_cache(cfg, gb, s, 0)}
    if shape.kind == "decode":
        return {"token": _meta(_tok_shape(cfg, gb, 1), i32),
                "cache": meta_cache(cfg, gb, s, s - 1)}
    raise ValueError(shape.kind)
