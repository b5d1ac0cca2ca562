"""Mixture-of-Experts layer with ALB-adaptive dispatch (PyTorch).

Port of ``repro/models/moe.py``.  The router's tokens-per-expert
histogram is the LM-stack analogue of the paper's edges-per-vertex
distribution, and the dispatch applies the paper's inspector-executor
split to it:

* inspector: the per-step expert load; slots past an expert's capacity
  overflow;
* executor: overflow slots are re-dealt over the free capacity of all
  experts by an exclusive prefix sum plus ``searchsorted`` -- the
  edge-balanced renumbering of the graph LB kernel (``edge_lb_map``).

Where the JAX package runs the executor under ``lax.cond(any(overflow))``,
the port runs it unconditionally: it is the identity when nothing
overflows (``fits`` is all false), so the plan is bitwise the same and
no device-to-host sync is made per layer.

``dispatch_plan(use_pallas_dispatch=True)`` computes the whole plan
(top-k, gates, arrival ranks, rebalance, ``keep``) in ONE launch of the
hand-written kernel ``kernels.moe_plan.moe_plan`` (on CUDA tensors; its
plain version on CPU tensors); ``False`` runs the plain version
``kernels.ref.moe_plan_ref``, whose ranks are the one-hot cumsum.
Grouped dispatch plans every group in that one launch.  The expert FFNs
are plain batched matrix products.

``moe_apply`` is differentiable end to end: the gradient reaches the
router through the gates (``moe_plan``'s backward, or autograd through
the plain version) and the Switch aux loss, and reaches the experts,
the shared MLP and ``x``.  The plan itself is integer and takes none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.moe_plan import moe_plan
from ..kernels.ref import moe_plan_ref, positions_in_expert_ref
from .layers import COMPUTE_DTYPE, MLP, _c, _matrix


class MoE(nn.Module):
    """``router [d, E]``; stacked expert FFNs ``w_gate``/``w_up [E, d,
    f]``, ``w_down [E, f, d]``; an optional shared SwiGLU MLP of width
    ``f * num_shared_experts`` (``moe.moe_init``).  All of ``dtype``."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        m, d = cfg.moe, cfg.d_model
        shapes = {"router": (d, m.num_experts),
                  "w_gate": (m.num_experts, d, m.d_expert),
                  "w_up": (m.num_experts, d, m.d_expert),
                  "w_down": (m.num_experts, m.d_expert, d)}
        for name, shape in shapes.items():
            setattr(self, name, _matrix(shape, generator, device,
                                        dtype=dtype))
        self.shared = (MLP(d, m.d_expert * m.num_shared_experts, "silu",
                           generator=generator, device=device, dtype=dtype)
                       if m.num_shared_experts else None)

    def forward(self, x, *, use_pallas_dispatch: bool = False):
        return moe_apply(self, x, self.cfg,
                         use_pallas_dispatch=use_pallas_dispatch)


def _positions_in_expert(expert_of, num_experts):
    """pos[i] = rank of assignment i within its expert (arrival order):
    the one-hot cumsum, the plain version of the kernel."""
    return positions_in_expert_ref(expert_of, num_experts)


def dispatch_plan(probs, m, t, *, use_pallas_dispatch: bool = False):
    """Routing plan: (flat_expert, pos, gate_flat, keep, cap).

    probs: float32 ``[T, E]``.  ``flat_expert`` and ``pos`` are int32
    ``[T*K]``, ``gate_flat`` float32, ``keep`` bool; ``cap`` a host int.
    """
    cap = _cap_of(m, t)
    plan = moe_plan if use_pallas_dispatch else moe_plan_ref
    flat_expert, pos, gate_flat, keep = plan(
        probs[None], top_k=m.top_k, cap=cap, groups=1, adaptive=m.adaptive)
    return flat_expert[0], pos[0], gate_flat[0], keep[0], cap


def router_probs(p, xf):
    """Softmax of the router logits in float32: ``xf [T, d]`` (bf16)
    -> ``[T, E]``."""
    logits = (xf @ _c(p.router)).float()
    return torch.softmax(logits, dim=-1)


def moe_apply(p, x, cfg, *, use_pallas_dispatch: bool = False):
    """x: [B, S, D] -> (out, aux_loss).

    Grouped (GShard-style) dispatch when ``m.dispatch_groups > 1``:
    positions, capacity and the ALB rebalance are computed per group of
    ``T / G`` tokens, all groups in one ``moe_plan`` call.
    """
    m = cfg.moe
    bsz, s, d = x.shape
    t = bsz * s
    g = m.dispatch_groups
    if t % g:
        raise ValueError(f"moe_apply: {t} tokens do not split into {g} "
                         f"dispatch groups")
    tg = t // g
    e, k = m.num_experts, m.top_k
    xf = x.reshape(t, d).to(COMPUTE_DTYPE)
    probs = router_probs(p, xf)                           # [T, E]

    # aux load-balancing loss (Switch-style); one-hot by comparison, as
    # F.one_hot checks its range with a device-to-host sync
    top1 = torch.argmax(probs, dim=-1)
    experts = torch.arange(e, device=x.device)
    me = probs.mean(dim=0)
    ce = (top1[:, None] == experts[None, :]).float().mean(dim=0)
    aux = m.router_aux_weight * e * torch.sum(me * ce)

    if g > 1:
        cap = _cap_of(m, tg)
        plan = moe_plan if use_pallas_dispatch else moe_plan_ref
        flat_expert, pos, gate_flat, keep = plan(
            probs.reshape(g, tg, e), top_k=k, cap=cap, groups=g,
            adaptive=m.adaptive)
    else:
        flat_expert, pos, gate_flat, keep, cap = dispatch_plan(
            probs, m, t, use_pallas_dispatch=use_pallas_dispatch)
        flat_expert, pos = flat_expert[None], pos[None]
        gate_flat, keep = gate_flat[None], keep[None]

    # ---- dispatch: [G, E, C, D] buffers ----------------------------------
    # Kept slots have unique (expert, pos) in their group, so a plain
    # (non-accumulating) store of each kept row gives the buffer that
    # JAX's scatter-add builds; dropped slots (which add zeros there) go
    # to one scratch row past the buffer, which is discarded.
    xk = xf.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(g * tg * k, d)
    grp = torch.arange(g, device=x.device)[:, None]
    slot = (grp * e + flat_expert) * cap + pos
    scratch = g * e * cap
    slot = torch.where(keep, slot, scratch).reshape(-1)
    buf = torch.zeros((scratch + 1, d), dtype=COMPUTE_DTYPE, device=x.device)
    buf[slot] = xk
    buf = buf[:scratch].view(g, e, cap, d)

    # ---- expert FFNs: batched over experts -------------------------------
    gate = F.silu(torch.matmul(buf, _c(p.w_gate)))
    up = torch.matmul(buf, _c(p.w_up))
    eout = torch.matmul(gate * up, _c(p.w_down))          # [G, E, C, D]

    # ---- combine: gather expert outputs back to token slots ---------------
    pos_c = torch.where(keep, pos, 0)
    tok_out = eout.reshape(g * e * cap, d)[
        ((grp * e + flat_expert) * cap + pos_c).reshape(-1)]
    tok_out = torch.where(keep.reshape(-1, 1), tok_out, 0)
    w = gate_flat.reshape(-1, 1).to(COMPUTE_DTYPE)
    combined = (tok_out * w).reshape(t, k, d).sum(dim=1)

    if p.shared is not None:
        combined = combined + p.shared(xf)
    return combined.reshape(bsz, s, d).to(x.dtype), aux


def _cap_of(m, t):
    return max(int(m.capacity_factor * t * m.top_k / m.num_experts), 4)
