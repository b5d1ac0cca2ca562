"""``merge_path_map``: equal-work edge tiles of the merge-path backend.

Port of ``repro/kernels/merge_path.py`` (Pallas, TPU) to the CUDA C++
kernel ``csrc/merge_path.cu``.  The frontier's edge ids ``[0, total)``
are cut into tiles of ``tile_edges`` consecutive ids; each tile bounds
its slot window by two co-rank searches over the exclusive degree
prefix sum ``start_e`` and maps every id to its slot and CSR edge by a
search inside that window.  No bins and no inspector.  The merge-path
executor's main path runs the fused ``relax.merge_path_relax`` instead
(the same tiles, combined into the labels in the kernel);
``ops.merge_path_apply`` sends through this map and the torch epilogue
only an operator the fused kernel does not take.

For CPU tensors the wrapper computes the plain version
(``ref.merge_path_map_ref``); for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import merge_path_map_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("merge_path")
    fn = lib.merge_path_map_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def merge_path_map(start_e: torch.Tensor, row_start: torch.Tensor,
                   total_edges, ecap: int, *, tile_edges: int = 2048):
    """Map ``ecap`` edge ids, rounded up to whole tiles, to their slots.

    ``start_e``/``row_start`` are int32 ``[H]`` (H >= 1): the exclusive
    degree prefix sum and the CSR row starts of the frontier members;
    ``total_edges`` is a host int or a one-element int32 tensor on the
    device (read there), and ids at or past it are masked.
    ``tile_edges`` must be a positive multiple of 128, as in the TPU
    kernel.  Returns flat ``(graph_e, slot_j, mask)`` of length
    ``max(1, ceil(ecap / tile_edges)) * tile_edges``; ``mask`` is bool,
    and ``graph_e``/``slot_j`` are 0 where it is False.
    """
    h = start_e.shape[0]
    dev = start_e.device
    if h < 1:
        raise ValueError("merge_path_map: needs H >= 1 slots")
    if tile_edges <= 0 or tile_edges % 128:
        raise ValueError(f"merge_path_map: tile_edges={tile_edges} is not "
                         f"a positive multiple of 128")
    build.check_vec("merge_path_map", "start_e", start_e, h, dev)
    build.check_vec("merge_path_map", "row_start", row_start, h, dev)
    if dev.type == "cpu":
        return merge_path_map_ref(start_e, row_start, total_edges, ecap,
                                  tile_edges=tile_edges)
    if dev.type != "cuda":
        raise ValueError(f"merge_path_map runs on cuda or cpu, not {dev}")
    total_ptr, total_host = build.scalar_arg("merge_path_map",
                                             "total_edges", total_edges, dev)
    n_tiles = max(1, -(-ecap // tile_edges))
    n = n_tiles * tile_edges
    if n >= 1 << 31:
        raise ValueError(f"merge_path_map: {n} ids exceed int32")
    ge = torch.empty((n,), dtype=torch.int32, device=dev)
    slot = torch.empty_like(ge)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    err = _lib()(start_e.data_ptr(), row_start.data_ptr(), total_ptr, h,
                 total_host, tile_edges, n_tiles, ge.data_ptr(),
                 slot.data_ptr(), mask.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merge_path_map: kernel launch failed with "
                           f"CUDA error {err}")
    build.count_launch(merge_path_map)
    return ge, slot, mask


merge_path_map.launches = merge_path_map.captured = 0
