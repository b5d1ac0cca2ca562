"""Carry LM parameters and optimizer state between the JAX package's
trees and the port's modules.

JAX keeps a model as a nested dict whose layer leaves are stacked
``[L, ...]`` (``repro.models.transformer.init``), and its optimizer
state as ``{"mu": tree, "nu": tree, "step": int32, "master"?: tree}``
(``repro.optim.adamw``).  The port keeps one ``Block`` per layer and an
optimizer state keyed by parameter name (``optim.adamw``).  This module
maps one to the other by name (``layers.3.moe.w_up`` is row 3 of the
leaf ``layers/moe/w_up``; under hybrid, whose layer leaves are stacked
``[G, attn_every, ...]``, ``layers.{g * attn_every + l}`` is row
``[g, l]``, and ``shared_attn.*`` is unstacked); it imports no JAX: the
caller passes numpy.

* :func:`params_from_jax` / :func:`load_jax_tree` -- a params tree into a
  ``Transformer``, each leaf cast to its parameter's dtype (float32 ->
  bf16 rounds to nearest even, as XLA's ``astype``), so the serving
  path multiplies by exactly the bf16 values JAX computes with, and a
  float32 train state loads as float32 (``param_dtype``);
* :func:`opt_state_from_jax` -- an optimizer state into the port's;
* :func:`train_state_to_jax_tree` -- the reverse, as numpy (bf16 as its
  16-bit pattern, ``core.host``), each tensor copied once into its row
  of a stacked leaf: the checkpoint's tree; or, with ``shapes_only``,
  the same tree of ``meta`` tensors, a restore template that holds no
  memory.

Every leaf must find its parameter and every parameter its leaf, with
the same shape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.graph import resolve_device
from ..core.host import from_host, host_dtype, host_tensor, to_host
from .layers import COMPUTE_DTYPE
from .transformer import Transformer, layer_stack


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _lead(module):
    """The leading dimensions of a model's stacked layer leaves
    (``transformer.layer_stack``); None for a module that is not a whole
    model."""
    return layer_stack(module.cfg) if isinstance(module, Transformer) else None


def _jax_path(name: str, lead=None):
    """Parameter name -> (path in the JAX tree, row or None):
    ``layers.3.moe.w_up`` -> ``(("layers", "moe", "w_up"), (3,))``; the
    row is layer 3's index into leaves stacked over ``lead`` (``(1, 1)``
    for ``lead=(2, 2)``), ``(3,)`` without ``lead``."""
    parts = name.split(".")
    if parts[0] == "layers":
        li = int(parts[1])
        row = ((li,) if lead is None
               else tuple(int(i) for i in np.unravel_index(li, lead)))
        return ("layers", *parts[2:]), row
    return tuple(parts), None


def _by_name(named: dict, tree, what: str, lead=None) -> dict:
    """``{name: numpy leaf (row)}`` for every name of ``named`` from the
    JAX tree ``tree``, shapes checked, no leaf left over."""
    leaves = {path: np.asarray(a) for path, a in _leaves(tree)}
    out, used = {}, set()
    for name, ref in named.items():
        path, li = _jax_path(name, lead)
        if path not in leaves:
            raise KeyError(f"{what}: no leaf {'/'.join(path)} for {name}")
        arr = leaves[path] if li is None else leaves[path][li]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: {name} is {tuple(ref.shape)}, the "
                             f"leaf {'/'.join(path)} gives "
                             f"{tuple(arr.shape)}")
        out[name] = arr
        used.add(path)
    unused = sorted("/".join(p) for p in leaves if p not in used)
    if unused:
        raise KeyError(f"{what}: leaves with no parameter: {unused}")
    return out


def load_jax_tree(module, tree):
    """Fill ``module``'s parameters from the JAX tree ``tree`` (numpy
    leaves), matched by name, each cast to the parameter's dtype.
    Returns ``module``."""
    named = dict(module.named_parameters())
    for name, arr in _by_name(named, tree, "load_jax_tree",
                              _lead(module)).items():
        param = named[name]
        with torch.no_grad():
            param.copy_(host_tensor(arr))
    return module


def params_from_jax(tree, cfg, device=None, *,
                    param_dtype: torch.dtype = COMPUTE_DTYPE) -> Transformer:
    """A ``Transformer`` on ``device`` (cuda unless the caller names
    another) holding the parameters of the JAX tree ``tree``: matrices
    of ``param_dtype`` (bf16 to serve, float32 to train), gains
    float32.  The parameters take no gradient until the caller asks
    (``model.requires_grad_()``)."""
    model = Transformer(cfg, device=resolve_device(device),
                        dtype=param_dtype)
    return load_jax_tree(model, tree)


def opt_state_from_jax(opt_tree, model) -> dict:
    """JAX's AdamW state (numpy leaves) as the port's, on ``model``'s
    device: ``mu``, ``nu`` and ``master`` (when present) float32 by
    parameter name, ``step`` an int32 scalar."""
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device
    state = {}
    for part in ("mu", "nu", "master"):
        if part in opt_tree:
            rows = _by_name(named, opt_tree[part], f"opt/{part}",
                            _lead(model))
            state[part] = {n: from_host(a, torch.float32, dev)
                           for n, a in rows.items()}
    state["step"] = torch.tensor(int(np.asarray(opt_tree["step"])),
                                 dtype=torch.int32, device=dev)
    return state


def jax_tree(named: dict, *, shapes_only: bool = False, lead=None) -> dict:
    """``{name: tensor}`` as JAX's nested dict of numpy leaves, the
    per-layer tensors stacked into ``[*lead, ...]`` (``[L, ...]``
    without ``lead``, L the layers named): each leaf allocated once on
    the host and each tensor copied once into it.  With ``shapes_only``
    the leaves are ``meta`` tensors of those shapes and dtypes, and
    nothing is copied."""
    rows: dict = {}
    for name, t in named.items():
        path, li = _jax_path(name, lead)
        rows.setdefault(path, {})[li] = t
    tree: dict = {}
    for path, by_layer in rows.items():
        t0 = next(iter(by_layer.values()))
        stack = lead if lead is not None else (len(by_layer),)
        if None in by_layer:
            shape = tuple(t0.shape)
        elif sorted(by_layer) == list(np.ndindex(*stack)):
            shape = (*stack, *t0.shape)
        else:
            raise KeyError(f"jax_tree: {'/'.join(path)} has the layer rows "
                           f"{sorted(by_layer)}")
        if shapes_only:
            leaf = torch.empty(shape, dtype=t0.dtype, device="meta")
        else:
            leaf = np.empty(shape, dtype=host_dtype(t0.dtype))
            rows_of = host_tensor(leaf)           # a view: fills ``leaf``
            for li, t in by_layer.items():
                (rows_of if li is None else rows_of[li]).copy_(t.detach())
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def train_state_to_jax_tree(model, opt_state: dict | None = None, *,
                            shapes_only: bool = False) -> dict:
    """``{"params": tree, "opt": {"mu", "nu", "step", "master"?}}`` in
    JAX's layout, as numpy copies on the host (``opt`` only when
    ``opt_state`` is given); with ``shapes_only``, as ``meta`` tensors
    (:func:`jax_tree`), the template a restore needs."""
    lead = _lead(model)
    out = {"params": jax_tree(dict(model.named_parameters()),
                              shapes_only=shapes_only, lead=lead)}
    if opt_state is not None:
        opt = {part: jax_tree(opt_state[part], shapes_only=shapes_only,
                              lead=lead)
               for part in ("mu", "nu", "master") if part in opt_state}
        step = opt_state["step"]
        opt["step"] = (torch.empty_like(step, device="meta") if shapes_only
                       else to_host(step))
        out["opt"] = opt
    return out
