"""Worklist (frontier) utilities (PyTorch port of ``repro/core/frontier.py``).

* dense frontier: ``bool[V]`` mask, or ``bool[B, V]`` for a batch of
  independent queries over the shared CSR;
* compacted frontier: ``int32[F]`` vertex indices padded with the
  out-of-range sentinel ``V``, where ``F`` is a *bucketed* capacity
  (:func:`next_bucket`).  The port has no jit cache to protect, but the
  bucket is part of the round's observable behaviour: the tile deal of
  ``balancer._tile_loads`` and the LB enumeration span both depend on it.

The streaming layer seeds a repair frontier from the endpoints of
changed edges (:func:`seed_from_edges`), and the serving engine treats
each row of a ``[B, V]`` batch as a slot that is refilled with a fresh
source (:func:`refill_rows`) or restored from a preemption snapshot
(:func:`load_rows`).  The JAX package drops an out-of-range index
(``V`` for a vertex, ``B`` for a slot) with a ``mode="drop"`` scatter;
torch's scatters raise on one, so these helpers mask such entries out
(negative indices count from the end, as there) and never clip them
onto a real row.
"""
from __future__ import annotations

import numpy as np
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


def frontier_meta(row_ptr: torch.Tensor, frontier_idx: torch.Tensor):
    """degree / row start / validity for a compacted frontier over the
    CSR whose row pointers are ``row_ptr`` (``[V + 1]``): an id ``>= V``
    (the sentinel) is invalid, with degree 0 and row start 0 —
    ``_frontier_meta`` of ``repro.core.balancer``."""
    v = row_ptr.shape[0] - 1
    valid = frontier_idx < v
    safe = torch.where(valid, frontier_idx, 0)
    lo = row_ptr[safe]
    deg = torch.where(valid, row_ptr[safe + 1] - lo, 0)
    row_start = torch.where(valid, lo, 0)
    return deg, row_start, valid


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


def _in_range(idx: torch.Tensor, n: int) -> tuple:
    """``(normalized, keep)``: ``idx`` with negative entries counted from
    the end (``idx + n``), and whether each lies in ``[0, n)`` — the
    entries a ``mode="drop"`` scatter writes."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def seed_from_edges(src, dst, mask, num_vertices: int) -> torch.Tensor:
    """Dense ``bool[V]`` frontier seeded from the endpoints of changed
    edges, the worklist an incremental label repair starts from.
    ``src``/``dst``/``mask`` are the fixed-capacity ``[K]`` arrays of an
    update delta (``mask`` False = padding slot); both endpoints of every
    live entry are set.  Runs on ``src``'s device with no host read: a
    dropped entry writes the extra element ``V`` of a ``V + 1`` buffer,
    which is sliced off."""
    src = torch.as_tensor(src).long()
    dev = src.device
    mask = torch.as_tensor(mask, device=dev).bool()
    out = torch.zeros((num_vertices + 1,), dtype=torch.bool, device=dev)
    for ends in (src, torch.as_tensor(dst, device=dev).long()):
        idx, keep = _in_range(ends, num_vertices)
        out.index_fill_(0, torch.where(mask & keep, idx, num_vertices), True)
    return out[:num_vertices]


def _live_slots(slots, b: int) -> list:
    """``(position, slot)`` of each live entry of a host ``[K]`` slot
    vector: the sentinel ``B`` and anything else out of range dropped,
    negative slots counted from the end."""
    s = np.asarray(slots, dtype=np.int64)
    s = np.where(s < 0, s + b, s)
    return [(i, int(s[i]))
            for i in np.flatnonzero((s >= 0) & (s < b)).tolist()]


def refill_rows(labels: torch.Tensor, frontier: torch.Tensor, slots,
                sources, fill) -> tuple:
    """Admit fresh single-source queries into batch slots, in place of
    whatever the rows held (the serving engine's admission).

    ``slots``/``sources`` are int32 ``[K]`` host vectors; an unused
    entry names the sentinel slot ``B`` and is dropped.  Each named
    slot's labels row is reset to ``fill`` with 0 at its own source
    (clipped into ``[0, V)``, as the JAX package clips it) and its
    frontier row to the one-hot source, exactly
    :func:`multi_source_state` for that row.  Returns new
    ``(labels, frontier)``; the inputs are not written, and nothing
    crosses from the host (the rows are filled on the device)."""
    v = labels.shape[-1]
    src = np.clip(np.asarray(sources, dtype=np.int64), 0, v - 1).tolist()
    labels, frontier = labels.clone(), frontier.clone()
    for i, slot in _live_slots(slots, labels.shape[0]):
        # fills of views: a host scalar assigned by indexing would be
        # copied to the device, a syncing call each
        labels[slot].fill_(int(fill))
        labels[slot, src[i]].fill_(0)
        frontier[slot].fill_(False)
        frontier[slot, src[i]].fill_(True)
    return labels, frontier


def load_rows(labels: torch.Tensor, frontier: torch.Tensor, slots,
              label_rows, frontier_rows) -> tuple:
    """Restore snapshot rows into batch slots, the resume half of the
    serving engine's preempt / resume pair.  ``slots`` is an int32
    ``[K]`` host vector (sentinel ``B`` entries dropped) and
    ``label_rows``/``frontier_rows`` the ``[K, V]`` rows to restore
    (host or device; one copy each to the device); restoring them is
    exact.  Returns new ``(labels, frontier)``; the inputs are not
    written."""
    lrows = torch.as_tensor(label_rows).to(labels.device, labels.dtype)
    frows = torch.as_tensor(frontier_rows).to(frontier.device, torch.bool)
    labels, frontier = labels.clone(), frontier.clone()
    for i, slot in _live_slots(slots, labels.shape[0]):
        labels[slot] = lrows[i]
        frontier[slot] = frows[i]
    return labels, frontier


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
