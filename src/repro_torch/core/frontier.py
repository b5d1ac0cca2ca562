"""Worklist (frontier) utilities (PyTorch port of ``repro/core/frontier.py``).

* dense frontier: ``bool[V]`` mask, or ``bool[B, V]`` for a batch of
  independent queries over the shared CSR;
* compacted frontier: ``int32[F]`` vertex indices padded with the
  out-of-range sentinel ``V``, where ``F`` is a *bucketed* capacity
  (:func:`next_bucket`).  The port has no jit cache to protect, but the
  bucket is part of the round's observable behaviour: the tile deal of
  ``balancer._tile_loads`` and the LB enumeration span both depend on it.
"""
from __future__ import annotations

import torch


def next_bucket(n: int, minimum: int = 64) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of set bits (the first ``size`` of them), padded with
    ``len(mask)`` (sentinel) — ``jnp.nonzero(mask, size=size,
    fill_value=len(mask))``.

    Fixed capacity without a host sync: each set bit's rank comes from
    an int32 prefix sum, and its index is scattered into a
    ``size + 1`` buffer whose last slot absorbs every bit that is unset
    or ranked past ``size`` (then sliced off)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), n, dtype=torch.int32, device=mask.device)
    out.index_put_((slot,), torch.arange(n, dtype=torch.int32,
                                         device=mask.device))
    return out[:size]


def count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def dirty_mask(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-label "touched this round" bitvector (Gluon's dirty set);
    elementwise, so a batched ``[B, V]`` pair gives a per-query mask."""
    return new != old


def dirty_vertices(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-**vertex** dirty mask: a vertex is dirty when its label changed
    in any query of the batch."""
    d = new != old
    return d if d.ndim == 1 else d.any(dim=0)


def union_frontier(frontier: torch.Tensor) -> torch.Tensor:
    """Dense union of a batch of frontiers: ``[B, V] -> [V]`` (identity
    on an un-batched ``[V]`` mask)."""
    return frontier if frontier.ndim == 1 else frontier.any(dim=0)


def rows_active(frontier: torch.Tensor) -> torch.Tensor:
    """Per-slot liveness ``bool[B]`` of a batched frontier: row b is
    active while any of its vertices is on the worklist."""
    return frontier.any(dim=-1)


def full_frontier(num_vertices: int, device) -> torch.Tensor:
    return torch.ones((num_vertices,), dtype=torch.bool, device=device)


def single_source(num_vertices: int, src: int, device) -> torch.Tensor:
    f = torch.zeros((num_vertices,), dtype=torch.bool, device=device)
    f[src] = True
    return f


def coerce_sources(sources, device) -> torch.Tensor:
    """Host-provided source vertices as a validated int32 ``[B]``
    vector on ``device`` — the one entry point through which batch
    source lists reach the device."""
    srcs = torch.as_tensor(sources, dtype=torch.int32).to(device)
    if srcs.ndim != 1:
        raise ValueError(
            f"sources must be a flat [B] vector of vertex ids; got "
            f"shape {tuple(srcs.shape)}")
    return srcs


def single_sources(num_vertices: int, sources, device) -> torch.Tensor:
    """Batched one-hot frontiers ``bool[B, V]``: row b activates only
    ``sources[b]``."""
    srcs = coerce_sources(sources, device)
    b = srcs.shape[0]
    f = torch.zeros((b, num_vertices), dtype=torch.bool, device=device)
    f[torch.arange(b, device=device), srcs] = True
    return f


def multi_source_state(num_vertices: int, sources, fill, device,
                       dtype=torch.int32):
    """Initial ``[B, V]`` state of a multi-source batch: labels filled
    with ``fill`` except 0 at each query's own source, plus the one-hot
    frontiers."""
    srcs = coerce_sources(sources, device)
    b = srcs.shape[0]
    labels = torch.full((b, num_vertices), int(fill), dtype=dtype,
                        device=device)
    labels[torch.arange(b, device=device), srcs] = 0
    return labels, single_sources(num_vertices, srcs, device)
