"""``moe_plan``: the whole MoE dispatch plan of one layer in one launch.

The hand-written CUDA C++ kernel ``csrc/moe_plan.cu`` computes, for each
of ``groups`` groups of ``probs``, what ``models.moe.dispatch_plan``
computes: the stable top-k, the normalized gates, the arrival rank of
each slot within its expert, the ALB rebalance of the overflow slots
(``adaptive``) and ``keep = pos < cap``.  It replaces, on the main path,
the Pallas TPU kernel ``positions_in_expert_kernel`` together with the
torch ops of the plan around it (``moe_dispatch.positions_in_expert``
stays as that kernel's counterpart, off the main path).  Each group is
one thread block cluster of 1 to ``MAX_CLUSTER`` CTAs, by its slot
count (:func:`cluster_size`), and every group goes in one launch.

For CPU tensors the wrapper computes the plain version
(``ref.moe_plan_ref``, with ``ref.positions_in_expert_ref``) and counts
no launch; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import moe_plan_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
#: limits of the kernel (its shared-memory tables and a lane's registers);
#: ``csrc/moe_plan.cu`` reports the same through ``moe_plan_max_*``
MAX_EXPERTS = 256
MAX_TOP_K = 16
MAX_CLUSTER = 8
#: slots a CTA of a cluster owns, at most, before the cluster grows
SLOTS_PER_CTA = 2048


def cluster_size(slots: int) -> int:
    """CTAs in the cluster of a group of ``slots`` slots: 1 at decode, up
    to ``MAX_CLUSTER`` (prefill's 24,576 slots)."""
    return min(MAX_CLUSTER, max(1, -(-slots // SLOTS_PER_CTA)))


@functools.cache
def _lib():
    lib = build.load("moe_plan")
    fn = lib.moe_plan_launch
    fn.argtypes = [_P] + [_I] * 7 + [_P] * 5
    fn.restype = _I
    for name, want in (("experts", MAX_EXPERTS), ("top_k", MAX_TOP_K),
                       ("cluster", MAX_CLUSTER)):
        getter = getattr(lib, f"moe_plan_max_{name}")
        getter.restype = _I
        if getter() != want:
            raise RuntimeError(f"moe_plan.cu and moe_plan.py disagree on "
                               f"the most {name}")
    return fn


def moe_plan(probs: torch.Tensor, *, top_k: int, cap: int, groups: int,
             adaptive: bool):
    """probs: float32 ``[G, Tg, E]`` (contiguous, ``G == groups``) ->
    ``(flat_expert, pos, gate_flat, keep)``, each ``[G, Tg*top_k]``:
    int32, int32, float32, bool.  ``1 <= E <= 256``, ``1 <= top_k <=
    min(E, 16)``, ``cap >= 0``."""
    if probs.dtype != torch.float32:
        raise TypeError(f"moe_plan: probs must be float32, got "
                        f"{probs.dtype}")
    if probs.ndim != 3 or probs.shape[0] != groups or groups < 1 or \
            not probs.is_contiguous():
        raise ValueError(f"moe_plan: probs must be a contiguous [groups="
                         f"{groups}, Tg, E] tensor; got "
                         f"{tuple(probs.shape)}")
    g, tg, e = probs.shape
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_plan: E must be in [1, {MAX_EXPERTS}], "
                         f"got {e}")
    if not 1 <= top_k <= min(e, MAX_TOP_K):
        raise ValueError(f"moe_plan: top_k must be in [1, min(E, "
                         f"{MAX_TOP_K})], got {top_k} with E = {e}")
    if not 0 <= cap < 1 << 31 or g * tg * max(e, top_k) >= 1 << 31:
        raise ValueError(f"moe_plan: cap {cap} or the shape "
                         f"{tuple(probs.shape)} exceed int32")
    dev = probs.device
    if dev.type == "cpu":
        return moe_plan_ref(probs, top_k=top_k, cap=cap, groups=groups,
                            adaptive=adaptive)
    if dev.type != "cuda":
        raise ValueError(f"moe_plan runs on cuda or cpu, not {dev}")
    n = tg * top_k
    fe = torch.empty((g, n), dtype=torch.int32, device=dev)
    pos = torch.empty_like(fe)
    gate = torch.empty((g, n), dtype=torch.float32, device=dev)
    keep = torch.empty((g, n), dtype=torch.bool, device=dev)
    if n == 0:
        return fe, pos, gate, keep
    c = cluster_size(n)
    err = _lib()(probs.data_ptr(), g, tg, e, top_k, cap, int(adaptive), c,
                 fe.data_ptr(), pos.data_ptr(), gate.data_ptr(),
                 keep.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_plan: kernel launch failed with CUDA "
                           f"error {err}")
    moe_plan.launches += 1
    moe_plan.launches_by_cluster[c] += 1
    return fe, pos, gate, keep


moe_plan.launches = 0
#: launches by cluster size (CTAs per group)
moe_plan.launches_by_cluster = dict.fromkeys(range(1, MAX_CLUSTER + 1), 0)
