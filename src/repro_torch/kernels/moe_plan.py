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

Under autograd the plan is a ``torch.autograd.Function``: its forward is
the one launch (or the plain version on the CPU), and its backward
(:func:`gate_grad`, torch ops) gives ``probs`` the gradient of the
gates.  The integer outputs and ``keep`` take none.  The Pallas kernel
this replaces is integer-only and has no VJP; JAX differentiates the
gates with XLA's own ops.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import _row_sum, _top_k, moe_plan_ref

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
    min(E, 16)``, ``cap >= 0``.  ``gate_flat`` carries the gradient back
    to ``probs`` (:func:`gate_grad`)."""
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
    if probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_plan runs on cuda or cpu, not {probs.device}")
    return _MoePlan.apply(probs, top_k, cap, groups, adaptive)


def _plan(probs, top_k: int, cap: int, groups: int, adaptive: bool):
    """The plan of validated ``probs``: the plain version on the CPU, one
    launch of the kernel on the card."""
    dev = probs.device
    if dev.type == "cpu":
        return moe_plan_ref(probs, top_k=top_k, cap=cap, groups=groups,
                            adaptive=adaptive)
    g, tg, e = probs.shape
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


class _MoePlan(torch.autograd.Function):
    """The plan with the gates' gradient: forward :func:`_plan`, backward
    :func:`gate_grad`."""

    @staticmethod
    def forward(ctx, probs, top_k, cap, groups, adaptive):
        fe, pos, gate, keep = _plan(probs, top_k, cap, groups, adaptive)
        ctx.mark_non_differentiable(fe, pos, keep)
        ctx.save_for_backward(probs, fe)
        ctx.top_k = top_k
        return fe, pos, gate, keep

    @staticmethod
    def backward(ctx, _fe, _pos, grad_gate, _keep):
        probs, fe = ctx.saved_tensors
        return gate_grad(probs, fe, grad_gate, ctx.top_k), \
            None, None, None, None


def gate_grad(probs: torch.Tensor, flat_expert: torch.Tensor,
              grad_gate: torch.Tensor, top_k: int) -> torch.Tensor:
    """The gradient of ``sum(grad_gate * gate_flat)`` with respect to
    ``probs`` (``[G, Tg, E]``), from the plan's ``flat_expert``.

    Per token, with its stable top-k values ``v_1..v_K`` (experts
    ``e_1..e_K``), ``S = v_1 + ... + v_K`` and ``D = max(S, 1e-9)``: a
    slot that kept its top-k expert has gate ``v_k / D``; a slot the ALB
    rebalance moved has gate ``probs[t, j]``, ``j`` the expert it landed
    on.  A moved slot is one whose ``flat_expert`` differs from its
    top-k expert: the rebalance only moves a slot that overflowed its
    expert, whose free capacity is then 0, so it never lands there.
    The top-k is recomputed (``ref._top_k``); the plan is not."""
    g, tg, e = probs.shape
    vals, idx = _top_k(probs.detach(), top_k)             # [G, Tg, K]
    fe = flat_expert.reshape(g, tg, top_k)
    gk = grad_gate.reshape(g, tg, top_k).to(torch.float32)
    moved = fe != idx
    kept_g = torch.where(moved, 0.0, gk)
    s = _row_sum(vals)
    d = torch.clamp(s, min=1e-9)
    # d(v_k / D) / dv_m = [k == m] / D - v_k / D^2 (while S >= 1e-9)
    coef = torch.where(s >= 1e-9, (kept_g * vals).sum(-1) / (d * d), 0.0)
    dv = kept_g / d[..., None] - coef[..., None]
    out = torch.zeros_like(probs, dtype=torch.float32)
    out.scatter_add_(2, idx.long(), dv)
    out.scatter_add_(2, fe.long(), torch.where(moved, gk, 0.0))
    return out


moe_plan.launches = 0
#: launches by cluster size (CTAs per group)
moe_plan.launches_by_cluster = dict.fromkeys(range(1, MAX_CLUSTER + 1), 0)
