"""``edge_lb_map``: the edge-balanced (LB) mapping kernel of the huge bin.

Port of ``repro/kernels/edge_lb.py`` (Pallas, TPU) to the CUDA C++
kernel ``csrc/edge_lb.cu``.  Every edge of the huge vertices gets an id
from the exclusive prefix sum of their degrees (``start_e``); each id is
dealt cyclic or blocked over ``num_tiles`` and mapped back to its slot
and CSR edge by binary search.  The enumeration span is exactly
``w_per * num_tiles`` with ``w_per = ceil(n_enum / num_tiles)``, padded
to a multiple of ``tile_edges``; positions past the span are masked
before the blocked permutation, so no edge is missed or repeated.

For CPU tensors the wrapper computes the plain version
(``ref.edge_lb_map_ref``); for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import edge_lb_map_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("edge_lb")
    fn = lib.edge_lb_map_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def edge_lb_map(start_e: torch.Tensor, row_start: torch.Tensor,
                hval: torch.Tensor, total_edges, n_enum: int, *,
                tile_edges: int = 2048, distribution: str = "cyclic",
                num_tiles: int = 64):
    """Run the LB mapping over ``n_enum`` edge ids.

    ``start_e``/``row_start`` are int32 ``[H]`` (H >= 1), ``hval`` int32
    or float32 ``[H]``; ``total_edges`` is a host int or a one-element
    int32 tensor on the device (read there).  Returns flat
    ``(graph_e, slot_j,
    src_val, mask)`` of length ``ceil(w_per * num_tiles / tile_edges) *
    tile_edges``; ``mask`` is bool.
    """
    h = start_e.shape[0]
    dev = start_e.device
    if h < 1:
        raise ValueError("edge_lb_map: the huge bin needs H >= 1 slots")
    if distribution not in ("cyclic", "blocked"):
        raise ValueError(f"unknown distribution {distribution!r}")
    build.check_vec("edge_lb_map", "start_e", start_e, h, dev)
    build.check_vec("edge_lb_map", "row_start", row_start, h, dev)
    build.check_vec("edge_lb_map", "hval", hval, h, dev,
                    ("int32", "float32"))
    if dev.type == "cpu":
        return edge_lb_map_ref(start_e, row_start, hval, total_edges,
                               n_enum, tile_edges=tile_edges,
                               distribution=distribution,
                               num_tiles=num_tiles)
    if dev.type != "cuda":
        raise ValueError(f"edge_lb_map runs on cuda or cpu, not {dev}")
    total_ptr, total_host = build.scalar_arg("edge_lb_map", "total_edges",
                                             total_edges, dev)
    w_per = -(-n_enum // num_tiles)
    span = w_per * num_tiles
    n_pad = -(-span // tile_edges) * tile_edges
    if n_pad >= 1 << 31:
        raise ValueError(f"edge_lb_map: {n_pad} ids exceed int32")
    ge = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    slot = torch.empty_like(ge)
    val_out = torch.empty((n_pad,), dtype=hval.dtype, device=dev)
    mask = torch.empty((n_pad,), dtype=torch.bool, device=dev)
    if n_pad == 0:
        return ge, slot, val_out, mask
    err = _lib()(start_e.data_ptr(), row_start.data_ptr(), hval.data_ptr(),
                 total_ptr, h, total_host, w_per, num_tiles, span, n_pad,
                 int(distribution == "blocked"), ge.data_ptr(),
                 slot.data_ptr(), val_out.data_ptr(), mask.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_lb_map: kernel launch failed with CUDA "
                           f"error {err}")
    build.count_launch(edge_lb_map)
    return ge, slot, val_out, mask


edge_lb_map.launches = edge_lb_map.captured = 0
