"""The torch scatter-combine of the unfused executors.

The ``xla`` executor pair (``core.balancer``) and the kernels' plain
versions (``kernels.ref``) combine a pass's candidates into the labels
with ``index_reduce_`` / ``index_add_``.  This module holds that one
step, below both of them.
"""
from __future__ import annotations

import warnings

import torch


def combine_neutral(combine: str, dtype: torch.dtype):
    """Identity element of a combiner: a candidate that can never win a
    ``min`` (dtype max / +inf) or change an ``add`` (0)."""
    if combine == "min":
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max
    if combine == "add":
        return 0
    raise ValueError(combine)


# scratch label columns that absorb the masked slots of a scatter.  One
# column would put every masked slot (most of a degree bin's tile) on
# one address, and the scatter's atomics then serialize on it: on an
# H100, ALB sssp on rmat(22, 16) spent 328 ms in the scatter-min with
# one column and 10 ms with the slots spread over this many.
_SCRATCH = 4096


def scatter_combine(labels, target, cand, emask, live, combine):
    """Batched scatter-combine (atomicMin/atomicAdd analog).

    labels : [B, V];  target/emask : batch-shared enumeration shape [S];
    ``live`` : [B, *S-broadcastable] per-query activity.  Returns a
    fresh ``[B, V]`` tensor: the scatter runs on a copy of ``labels``
    widened by ``_SCRATCH`` scratch columns that absorb every masked
    slot (JAX's ``mode="drop"``), so the caller's labels are never
    written.
    """
    b, v = labels.shape
    spread = v + (torch.arange(emask.numel(), dtype=torch.int32,
                               device=emask.device) & (_SCRATCH - 1))
    tgt = torch.where(emask.reshape(-1), target.reshape(-1), spread)
    full = live & emask[None]
    cand = cand.to(labels.dtype)
    if tgt.device.type == "cpu":
        # the same scatter; the CPU's kernels take int32 indices on a
        # path about 30 times slower than int64's
        tgt = tgt.long()
    out = torch.empty((b, v + _SCRATCH), dtype=labels.dtype,
                      device=labels.device)
    out[:, :v] = labels
    out[:, v:] = 0
    if combine == "min":
        cand = torch.where(full, cand, combine_neutral("min", labels.dtype))
        cand = cand.reshape(b, -1)
        if out.device.type == "cpu":
            # the same exact min; the CPU's index_reduce_ runs one slot
            # at a time, about 60 times slower at a bin's tile
            out.scatter_reduce_(1, tgt.expand(b, -1), cand, "amin",
                                include_self=True)
        else:
            with warnings.catch_warnings():
                # index_reduce_ warns once that its API is in beta
                warnings.simplefilter("ignore", UserWarning)
                out.index_reduce_(1, tgt, cand, "amin", include_self=True)
    elif combine == "add":
        cand = torch.where(full, cand, 0)
        out.index_add_(1, tgt, cand.reshape(b, -1))
    else:
        raise ValueError(combine)
    return out[:, :v]
