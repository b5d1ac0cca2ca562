"""int8 gradient compression for the data-parallel reduce.

Port of ``repro/optim/grad_compress.py``.  Block-scaled int8: per block
of 256 (the last tiles of the flattened tensor) an absmax scale, a
symmetric int8 quantize, an all-reduce of the payloads in int32 (sums
of int8 fit easily) and a dequantize with the max scale.  The padding
and scale primitives are ``core.wire``'s, as in the JAX package.

JAX's ``compressed_psum`` runs inside ``shard_map`` on each device's
gradient tree; here one process holds every slot's gradients, so
:func:`compressed_psum` takes one ``{name: tensor}`` per slot of a
``core.collectives`` mesh and returns one reduced set per slot.
"""
from __future__ import annotations

import torch

from ..core import collectives
from ..core.wire import BLOCK, block_absmax_scale, pad_to_block


def _round_clip(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127)


def quantize(x: torch.Tensor):
    """x: any-shape float -> (int8 blocks ``[N, 256]``, float32 scales
    ``[N]``, meta)."""
    blocks, npad = pad_to_block(x.to(torch.float32))
    scale = block_absmax_scale(blocks)
    q = _round_clip(blocks, scale).to(torch.int8)
    return q, scale[:, 0], (tuple(x.shape), npad)


def dequantize(q: torch.Tensor, scale: torch.Tensor, meta) -> torch.Tensor:
    shape, npad = meta
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    if npad:
        flat = flat[:-npad]
    return flat.reshape(shape)


def compressed_psum(grads, mesh: collectives.Mesh) -> list:
    """All-reduce gradients in int8 over the slots of ``mesh``:
    ``grads[d]`` is slot ``d``'s ``{name: tensor}`` (the port's form of
    a gradient tree, as ``train.steps`` builds it).

    Each slot quantizes with its own scales; the scales are max-reduced,
    each slot requantizes against the max (so the sum is coherent), the
    int32 payloads are sum-reduced and dequantized with the max scale.
    Returns one ``{name: tensor}`` per slot, each in its input's
    dtype."""
    if len(grads) != mesh.size:
        raise ValueError(f"compressed_psum: {len(grads)} gradient sets for "
                         f"a mesh of {mesh.size} slots")
    names = list(grads[0])
    if any(list(g) != names for g in grads[1:]):
        raise ValueError("compressed_psum: the slots' names differ")
    outs = [{} for _ in grads]
    for name in names:
        gs = [g[name] for g in grads]
        smax = collectives.all_reduce([quantize(g)[1] for g in gs], "max",
                                      mesh)
        payload = []
        for g, s in zip(gs, smax):
            blocks, npad = pad_to_block(g.to(torch.float32))
            payload.append(_round_clip(blocks, s[:, None]).to(torch.int32))
        total = collectives.all_reduce(payload, "add", mesh)
        for out, g, t, s in zip(outs, gs, total, smax):
            flat = (t.to(torch.float32) * s[:, None]).reshape(-1)
            if npad:
                flat = flat[:-npad]
            out[name] = flat.reshape(g.shape).to(g.dtype)
    return outs


__all__ = ["BLOCK", "quantize", "dequantize", "compressed_psum"]
