"""Plain PyTorch versions of the mapping kernels.

Same output contract as ``repro/kernels/ref.py`` (and the CUDA kernels):
four outputs ``(graph_e, anchor_or_slot, val, mask)``, three for the
merge-path map ``(graph_e, slot_j, mask)``.  The kernel wrappers call
these for CPU tensors, and the CUDA kernels are held against them on
the card.  The one difference from the JAX oracles: ``twc_bin_map_ref``
returns exactly ``[N, W]`` (no padding of N to a TPU vertex tile).
"""
from __future__ import annotations

import torch


def edge_lb_map_ref(start_e, row_start, hval, total_edges, n_enum,
                    *, tile_edges: int = 2048, distribution: str = "cyclic",
                    num_tiles: int = 64):
    """Oracle for edge_lb.edge_lb_map: flat outputs of length
    ``ceil(w_per * num_tiles / tile_edges) * tile_edges``."""
    w_per = -(-n_enum // num_tiles)
    span = w_per * num_tiles            # exact bijection domain
    n_pad = -(-span // tile_edges) * tile_edges
    eid0 = torch.arange(n_pad, dtype=torch.int32, device=start_e.device)
    if distribution == "blocked":
        eid = (eid0 % num_tiles) * w_per + eid0 // num_tiles
    else:
        eid = eid0
    emask = (eid0 < span) & (eid < total_edges)
    eid_c = torch.where(emask, eid, 0)
    j = torch.searchsorted(start_e, eid_c, right=True, out_int32=True) - 1
    j = j.clamp(0, start_e.shape[0] - 1)
    ge = torch.where(emask, row_start[j] + (eid_c - start_e[j]), 0)
    return ge, j, hval[j], emask


def merge_path_map_ref(start_e, row_start, total_edges, ecap: int,
                       *, tile_edges: int = 2048):
    """Oracle for merge_path.merge_path_map: ids ``0..n-1`` with ``n =
    max(1, ceil(ecap / tile_edges)) * tile_edges``; ``j`` is the last
    slot with ``start_e <= id`` (searchsorted-right).  Where an id is
    masked (``id >= total_edges``) both ``graph_e`` and ``slot_j`` are
    0, as the CUDA kernel writes them."""
    n = max(1, -(-ecap // tile_edges)) * tile_edges
    eid = torch.arange(n, dtype=torch.int32, device=start_e.device)
    emask = eid < total_edges
    j = torch.searchsorted(start_e, eid, right=True, out_int32=True) - 1
    j = torch.where(emask, j.clamp(0, start_e.shape[0] - 1), 0)
    ge = torch.where(emask, row_start[j] + (eid - start_e[j]), 0)
    return ge, j, emask


def twc_bin_map_ref(vidx, deg, row_start, val, *, width: int,
                    chunk=0, sentinel: int = 1 << 30):
    """Oracle for twc_gather.twc_bin_map: ``[N, width]`` outputs."""
    off = (chunk * width
           + torch.arange(width, dtype=torch.int32,
                          device=vidx.device)[None, :])
    emask = (off < deg[:, None]) & (vidx[:, None] < sentinel)
    ge = torch.where(emask, row_start[:, None] + off, 0)
    anchor = vidx[:, None].expand(emask.shape)
    v = val[:, None].expand(emask.shape)
    return ge, anchor, v, emask
