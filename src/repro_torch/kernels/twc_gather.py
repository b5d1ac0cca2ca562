"""``twc_bin_map``: the vertex-binned (TWC-analog) mapping kernel.

Port of ``repro/kernels/twc_gather.py`` (Pallas, TPU) to the CUDA C++
kernel ``csrc/twc_gather.cu``.  Expands one degree bin, for pass
``chunk``, into ``[N, W]`` tiles ``(graph_e, anchor, val, mask)``; the
gather and scatter-combine around it are in ``kernels/ops.py``.

For CPU tensors the wrapper computes the plain version
(``ref.twc_bin_map_ref``); for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import twc_bin_map_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("twc_gather")
    fn = lib.twc_bin_map_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


def twc_bin_map(vidx: torch.Tensor, deg: torch.Tensor,
                row_start: torch.Tensor, val: torch.Tensor, *, width: int,
                chunk=0, sentinel: int = 1 << 30):
    """Expand one degree bin into ``[N, width]`` tiles
    ``(graph_e, anchor, val, mask)``.

    ``vidx``/``deg``/``row_start`` are int32 ``[N]``, ``val`` int32 or
    float32 ``[N]``; ``chunk`` is a host int or a one-element int32
    tensor on the device.  ``mask`` is bool; ``val`` keeps its dtype.
    The kernel writes ``graph_e`` and ``mask``; ``anchor`` and ``val``
    are stride-0 views of ``vidx`` and ``val``.
    """
    n = vidx.shape[0]
    dev = vidx.device
    build.check_vec("twc_bin_map", "vidx", vidx, n, dev)
    build.check_vec("twc_bin_map", "deg", deg, n, dev)
    build.check_vec("twc_bin_map", "row_start", row_start, n, dev)
    build.check_vec("twc_bin_map", "val", val, n, dev,
                    ("int32", "float32"))
    if dev.type == "cpu":
        return twc_bin_map_ref(vidx, deg, row_start, val, width=width,
                               chunk=chunk, sentinel=sentinel)
    if dev.type != "cuda":
        raise ValueError(f"twc_bin_map runs on cuda or cpu, not {dev}")
    chunk_ptr, chunk_host = build.scalar_arg("twc_bin_map", "chunk", chunk,
                                             dev)
    ge = torch.empty((n, width), dtype=torch.int32, device=dev)
    mask = torch.empty((n, width), dtype=torch.bool, device=dev)
    # constant along each row: stride-0 views, as in the plain version
    anchor = vidx[:, None].expand(n, width)
    val_out = val[:, None].expand(n, width)
    if n * width == 0:
        return ge, anchor, val_out, mask
    err = _lib()(vidx.data_ptr(), deg.data_ptr(), row_start.data_ptr(),
                 chunk_ptr, chunk_host, n, width, int(sentinel),
                 ge.data_ptr(), mask.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"twc_bin_map: kernel launch failed with CUDA "
                           f"error {err}")
    build.count_launch(twc_bin_map)
    return ge, anchor, val_out, mask


twc_bin_map.launches = twc_bin_map.captured = 0
