"""Sharding rules of the port: parameter, optimizer, batch, cache and
activation specs per arch, applied as DTensor placements.

Port of ``repro/launch/sharding.py``.  Megatron tensor parallelism over
``model`` and FSDP-style parameter sharding over ``data``; the ``pod``
axis carries pure data parallelism (parameters replicated across pods,
gradients reduced over (pod, data)).

A spec is a tuple with one entry per tensor dim, as JAX's
``PartitionSpec``: a mesh-axis name, a tuple of names (the dim is
sharded over all of them, the first outermost) or None.
:func:`placements` turns it into DTensor placements on a
``DeviceMesh``.  The rules are path-based and name TRAILING dims: a
leaf's leading dims (layer stacks, hybrid groups, codebooks) are padded
with None.  JAX stacks each layer's parameters as ``[L, ...]`` leaves;
the port keeps one module per layer, so a port parameter's spec is
JAX's leaf spec without its leading stack dims
(``models.convert._jax_path`` names the leaf).

GSPMD's ``with_sharding_constraint`` becomes ``DTensor.redistribute``
(:func:`make_shard_fn`); ``jit``'s ``in_shardings`` become
:func:`distribute_params` and :func:`distribute_tree`.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..models import transformer as T
from ..models.convert import _jax_path

# trailing-dims spec per leaf name (non-MoE-expert params)
_BASE_RULES = {
    # embeddings / heads
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    # attention (gqa)
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # attention (mla)
    "wq_a": ("data", None),
    "wq_b": (None, "model"),
    "wkv_a": ("data", None),
    "wkv_b": (None, "model"),
    "q_norm": (None,),
    "kv_norm": (None,),
    # mlp
    "w_up": ("data", "model"),
    "w_gate": ("data", "model"),
    "w_down": ("model", "data"),
    # moe router
    "router": ("data", None),
    # mamba2
    "w_in": ("data", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "a_log": (None,),
    "dt_bias": (None,),
    "d_skip": (None,),
    "out_norm": ("model",),
    "w_out": ("model", "data"),
    # norms
    "norm": (None,),
    "norm1": (None,),
    "norm2": (None,),
    "final_norm": (None,),
}

# expert-stacked MoE params: leading E dim is the expert-parallel axis
_MOE_EXPERT_RULES = {
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}

_MOE_EXPERT_FSDP_RULES = {
    # H1: experts additionally FSDP-sharded over data on d_model
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}


def _in_moe(pstr: str) -> bool:
    return "/moe/" in f"/{pstr}/" and "/shared/" not in f"/{pstr}/"


def _pad(base: tuple, ndim: int, pstr: str) -> tuple:
    pad = ndim - len(base)
    assert pad >= 0, f"{pstr}: rank {ndim} < rule {base}"
    return (None,) * pad + tuple(base)


def leaf_spec(pstr: str, ndim: int, expert_fsdp: bool = False) -> tuple:
    """The spec of the JAX leaf at path ``pstr`` (``layers/moe/w_up``)
    of rank ``ndim`` (stack dims included)."""
    name = pstr.split("/")[-1]
    if _in_moe(pstr):
        rules = _MOE_EXPERT_FSDP_RULES if expert_fsdp else _MOE_EXPERT_RULES
        if name in rules:
            return _pad(rules[name], ndim, pstr)
    return _pad(_BASE_RULES.get(name, ()), ndim, pstr)


def param_specs(params: nn.Module, expert_fsdp: bool = False) -> dict:
    """``{name: spec}`` for every parameter of a port model (on any
    device, ``meta`` included): JAX's leaf spec without the leaf's
    leading layer-stack dims."""
    lead = T.layer_stack(params.cfg) if isinstance(params, T.Transformer) \
        else None
    out = {}
    for name, p in params.named_parameters():
        path, row = _jax_path(name, lead)
        stack = 0 if row is None else len(row)
        spec = leaf_spec("/".join(path), p.ndim + stack, expert_fsdp)
        out[name] = spec[stack:]
    return out


def opt_specs(params_spec: dict, master_weights: bool = False) -> dict:
    """Optimizer state mirrors param sharding; step is replicated."""
    out = {"mu": params_spec, "nu": params_spec, "step": ()}
    if master_weights:
        out["master"] = params_spec
    return out


def dp_axes_for(multi_pod: bool, global_batch: int):
    """Batch axes actually usable: long-context cells with batch 1
    cannot shard batch — fall back to replication (TP-only posture)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    size = 32 if multi_pod else 16
    return dp if global_batch % size == 0 else None


def _dp(multi_pod: bool, global_batch: int):
    """The batch dims' spec entry; a one-axis tuple is its axis, as
    ``PartitionSpec`` holds it."""
    dp = dp_axes_for(multi_pod, global_batch) if global_batch \
        else (("pod", "data") if multi_pod else "data")
    return dp[0] if isinstance(dp, tuple) and len(dp) == 1 else dp


def batch_specs(multi_pod: bool, num_codebooks: int = 1,
                with_prefix: bool = False, global_batch: int = 0) -> dict:
    dp = _dp(multi_pod, global_batch)
    tok = (dp, None) if num_codebooks == 1 else (dp, None, None)
    out = {"tokens": tok, "labels": tok}
    if with_prefix:
        out["prefix_emb"] = (dp, None, None)
    return out


def cache_specs(cfg, multi_pod: bool, global_batch: int = 0,
                seq_len: int = 0, model_size: int = 16) -> dict:
    """Decode-state sharding, the layout of ``transformer.init_cache``
    without its ``index`` (a host int in the port): batch over data
    axes; heads over model when the head count divides the model axis,
    else the SEQUENCE dim (sequence-parallel KV cache — the
    GQA-few-heads / MQA fallback)."""
    dp = _dp(multi_pod, global_batch)
    kv_ok = cfg.num_kv_heads % model_size == 0 and cfg.num_kv_heads > 0
    seq_ok = seq_len % model_size == 0 and seq_len > 0

    def spec(name, nd):
        if name in ("k", "v"):            # [L?, B, S, Hkv, hd]
            if kv_ok:
                base = (dp, None, "model", None)
            elif seq_ok:
                base = (dp, "model", None, None)
            else:
                base = (dp, None, None, None)
        elif name == "ckv":               # [L, B, S, r]
            base = (dp, "model" if seq_ok else None, None)
        elif name == "k_rope":            # [L, B, S, 1, rope]
            base = (dp, "model" if seq_ok else None, None, None)
        elif name == "h":                 # [G?, L?, B, H, P, N]
            base = (dp, "model", None, None)
        elif name == "conv":              # [G?, L?, B, k-1, C]
            base = (dp, None, "model")
        else:
            base = (dp,)
        return _pad(base, nd, name)

    return {part: {n: spec(n, len(shape))
                   for n, (shape, _) in tensors.items()}
            for part, tensors in T.init_cache(cfg, 1, 1).items()
            if part != "index"}


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 when the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim named at tensor dim ``i``, ``Replicate()`` elsewhere."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"spec {spec} names axis {axis!r}; the mesh "
                                 f"has {names}")
            out[names.index(axis)] = Shard(i)
    return tuple(out)


def make_shard_fn(mesh, multi_pod: bool, seqpar: bool = False,
                  moe_data: bool = False, dp_override=...):
    """Activation constrainer injected into the model: a DTensor
    activation is redistributed to JAX's spec for its name and rank; a
    plain tensor comes back as it went in.

    seqpar (H3): residual-stream activations are sharded over `model`
    on the SEQUENCE dim between blocks (Megatron sequence parallelism)
    so the per-block all-reduce becomes a reduce-scatter + all-gather
    pair — half the bytes on the wire.
    """
    dp = (("pod", "data") if multi_pod else "data") \
        if dp_override is ... else dp_override
    model_size = axis_size(mesh, "model")
    data_size = axis_size(mesh, "data") * axis_size(mesh, "pod")

    def to(x, spec):
        return x.redistribute(mesh, placements(spec, mesh))

    def shard_fn(name, x):
        if not isinstance(x, DTensor):
            return x
        if name == "moe_tok":
            # [G, TgK, D] / [G, TgK]: group dim rides the data axes
            if x.shape[0] % data_size == 0 and x.shape[0] > 1:
                return to(x, (dp, *([None] * (x.ndim - 1))))
            return x
        if name == "moe_buf":
            if x.ndim == 4:
                # grouped dispatch [G, E, C, D]: groups ride data,
                # experts ride model
                if x.shape[0] % data_size == 0 or x.shape[0] == 1:
                    gspec = dp if x.shape[0] > 1 else None
                    return to(x, (gspec, "model", None, None))
                return x
            # ungrouped [E, C, D] + moe_data: capacity dim over data
            if moe_data and x.shape[1] % data_size == 0:
                return to(x, ("model", dp, None))
            return x
        if (seqpar and x.ndim == 3 and x.shape[1] > 1
                and x.shape[1] % model_size == 0):
            spec = (dp, "model", None)
        elif x.ndim >= 3:
            spec = (dp, *([None] * (x.ndim - 1)))
        else:
            spec = (dp, None)
        return to(x, spec)

    return shard_fn


# ---------------------------------------------------------------------------
# distributing parameters, optimizer state, inputs
# ---------------------------------------------------------------------------

def _dtensor(t: torch.Tensor, mesh, spec: tuple, from_local: bool):
    pl = placements(spec, mesh)
    if from_local:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl)


def distribute_params(model: nn.Module, mesh, specs: dict, *,
                      from_local: bool = False) -> nn.Module:
    """Replace each parameter of ``model`` by a DTensor on ``mesh`` laid
    out by ``specs`` (:func:`param_specs`), in place; each keeps its
    ``requires_grad``.  ``from_local``: every parameter already holds
    this rank's shard (on a one-rank mesh, the whole tensor), wrapped
    without a copy; else each holds the whole tensor and this rank keeps
    its shard.  Returns ``model``."""
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rpartition(".")[0]) \
            if "." in name else model
        dt = _dtensor(p.detach(), mesh, specs[name], from_local)
        setattr(owner, name.rpartition(".")[2],
                nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, mesh, specs, *, from_local: bool = False):
    """A nested dict of tensors (the AdamW state, a batch, a cache) as
    DTensors laid out by the same-shaped dict ``specs``; a leaf with no
    spec (a host int, a key ``specs`` lacks) is kept as it is."""
    if isinstance(tree, dict):
        return {k: (distribute_tree(v, mesh, specs[k], from_local=from_local)
                    if isinstance(specs, dict) and k in specs else v)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _dtensor(tree, mesh, specs, from_local)
    return tree
