"""Carry the JAX package's LM parameters into the port's modules.

``params_from_jax(tree, cfg)`` takes the output of
``repro.models.transformer.init`` as numpy (any nested dict of arrays;
the caller converts, this module imports no JAX), unstacks the
``[L, ...]`` layer leaves and casts every matrix to bf16 once, at load,
with round-to-nearest-even as XLA's ``astype`` does, so the port
multiplies by exactly the bf16 values JAX computes with.  Norm gains
stay float32.  Every leaf of the tree must find its parameter and every
parameter its leaf, with the same shape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import resolve_device
from .transformer import Transformer


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_path(name: str):
    """Parameter name -> (path in the JAX tree, layer index or None):
    ``layers.3.moe.w_up`` -> ``(("layers", "moe", "w_up"), 3)``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers", *parts[2:]), int(parts[1])
    return tuple(parts), None


def load_jax_tree(module, tree):
    """Fill ``module``'s parameters from the JAX tree ``tree`` (numpy
    leaves), matched by name (``layers.<i>.<path>`` reads row ``i`` of
    the stacked leaf ``layers/<path>``), each cast to the parameter's
    dtype.  Returns ``module``."""
    leaves = {path: np.asarray(a) for path, a in _leaves(tree)}
    used = set()
    for name, param in module.named_parameters():
        path, li = _jax_path(name)
        if path not in leaves:
            raise KeyError(f"load_jax_tree: no leaf {'/'.join(path)} for "
                           f"{name}")
        arr = leaves[path] if li is None else leaves[path][li]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"load_jax_tree: {name} is "
                             f"{tuple(param.shape)}, the leaf "
                             f"{'/'.join(path)} gives {tuple(arr.shape)}")
        src = torch.from_numpy(np.array(arr, np.float32))
        with torch.no_grad():
            param.copy_(src.to(param.dtype))   # float32 -> bf16: RNE
        used.add(path)
    unused = sorted("/".join(p) for p in leaves if p not in used)
    if unused:
        raise KeyError(f"load_jax_tree: leaves with no parameter: {unused}")
    return module


def params_from_jax(tree, cfg, device=None) -> Transformer:
    """A ``Transformer`` on ``device`` (cuda unless the caller names
    another) holding the parameters of the JAX tree ``tree``."""
    return load_jax_tree(Transformer(cfg, device=resolve_device(device)),
                         tree)
