"""``positions_in_expert``: arrival rank of each MoE token slot within
its expert (the position half of the MoE dispatch plan).

Port of ``repro/kernels/moe_dispatch.py`` (Pallas, TPU) to the CUDA C++
kernel ``csrc/moe_dispatch.cu``.  ``pos[i]`` is the number of earlier
slots routed to the same expert: the exclusive prefix sum that the
graph LB executor builds over vertex degrees, applied to token routing.
The TPU kernel carries per-expert counters from one grid step to the
next; the CUDA kernel is order-free (per-tile stable ranks, a scan of
the per-tile counts over tiles, an add), so it needs no ordering of
blocks.  Ids outside ``[0, num_experts)`` get 0 and are not counted.

For CPU tensors the wrapper computes the plain version
(``ref.positions_in_expert_ref``); for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import positions_in_expert_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
#: tile of the CUDA kernel: one block of 1024 threads ranks 1024 slots
TILE = 1024
#: most experts the kernel takes (its shared-memory counts per warp);
#: ``csrc/moe_dispatch.cu`` reports the same through
#: ``positions_in_expert_max_experts``
MAX_EXPERTS = 256


@functools.cache
def _lib():
    lib = build.load("moe_dispatch")
    fn = lib.positions_in_expert_launch
    fn.argtypes = [_P, _I, _I, _P, _P, _P]
    fn.restype = _I
    lib.positions_in_expert_max_experts.restype = _I
    if lib.positions_in_expert_max_experts() != MAX_EXPERTS:
        raise RuntimeError("moe_dispatch.cu and moe_dispatch.py disagree "
                           "on the most experts the kernel takes")
    return fn


def positions_in_expert(flat_expert: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """flat_expert: int32 ``[N]`` (N >= 0) -> pos: int32 ``[N]``, the
    arrival rank of each slot within its expert."""
    if not 1 <= num_experts <= MAX_EXPERTS:
        raise ValueError(f"positions_in_expert: num_experts must be in "
                         f"[1, {MAX_EXPERTS}], got {num_experts}")
    if flat_expert.ndim != 1:
        raise ValueError(f"positions_in_expert: flat_expert must be 1-D, "
                         f"got {tuple(flat_expert.shape)}")
    n = flat_expert.shape[0]
    dev = flat_expert.device
    build.check_vec("positions_in_expert", "flat_expert", flat_expert, n,
                    dev)
    if dev.type == "cpu":
        return positions_in_expert_ref(flat_expert, num_experts)
    if dev.type != "cuda":
        raise ValueError(f"positions_in_expert runs on cuda or cpu, not "
                         f"{dev}")
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return pos
    tiles = -(-n // TILE)
    hist = torch.empty((num_experts * tiles if tiles > 1 else 0,),
                       dtype=torch.int32, device=dev)
    err = _lib()(flat_expert.data_ptr(), n, num_experts, pos.data_ptr(),
                 hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"positions_in_expert: kernel launch failed "
                           f"with CUDA error {err}")
    positions_in_expert.launches += 1
    return pos


positions_in_expert.launches = 0
