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

On DTensors (a sharded step, ``launch.sharding``) the plan runs on
replicated probabilities (``models.dist.replicated_call``: every rank
plans every token of its group, as GSPMD all-gathers them), and the
scatter into the ``[G, E, C, D]`` buffers, the expert FFNs and the
gather back are local to each rank's experts (experts over ``model``):
a rank's gather gives the rows of its own experts and zeros elsewhere,
summed over the model axis.  ``_cap_of`` sees the global token count.
``shard_fn`` is called at JAX's points (``"moe_tok"``, ``"moe_buf"``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.moe_plan import moe_plan
from ..kernels.ref import moe_plan_ref, positions_in_expert_ref
from . import dist as D
from .layers import COMPUTE_DTYPE, MLP, _c, _matrix

_IDENT = lambda name, x: x


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

    def forward(self, x, *, use_pallas_dispatch: bool = False,
                shard_fn=_IDENT):
        return moe_apply(self, x, self.cfg,
                         use_pallas_dispatch=use_pallas_dispatch,
                         shard_fn=shard_fn)


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
    flat_expert, pos, gate_flat, keep = _plan(
        probs[None], m, cap, 1, use_pallas_dispatch)
    return flat_expert[0], pos[0], gate_flat[0], keep[0], cap


def _plan(probs, m, cap, groups, use_pallas_dispatch):
    """``moe_plan`` (or its plain version) of ``probs [G, Tg, E]``; on
    a DTensor, on the replicated probabilities."""
    plan = moe_plan if use_pallas_dispatch else moe_plan_ref
    return D.replicated_call(
        lambda pr: plan(pr, top_k=m.top_k, cap=cap, groups=groups,
                        adaptive=m.adaptive), 4, probs)


def router_probs(p, xf):
    """Softmax of the router logits in float32: ``xf [T, d]`` (bf16)
    -> ``[T, E]``."""
    logits = (xf @ _c(p.router)).float()
    return torch.softmax(logits, dim=-1)


def moe_apply(p, x, cfg, *, use_pallas_dispatch: bool = False,
              shard_fn=_IDENT):
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
    # replicated on a mesh: the plan needs every token of its group
    probs = D.replicate(router_probs(p, xf))              # [T, E]

    # aux load-balancing loss (Switch-style); one-hot by comparison, as
    # F.one_hot checks its range with a device-to-host sync
    top1 = torch.argmax(probs, dim=-1)
    experts = torch.arange(e, device=x.device)
    me = probs.mean(dim=0)
    ce = (top1[:, None] == experts[None, :]).float().mean(dim=0)
    aux = m.router_aux_weight * e * torch.sum(me * ce)

    if g > 1:
        cap = _cap_of(m, tg)
        flat_expert, pos, gate_flat, keep = _plan(
            probs.reshape(g, tg, e), m, cap, g, use_pallas_dispatch)
    else:
        flat_expert, pos, gate_flat, keep, cap = dispatch_plan(
            probs, m, t, use_pallas_dispatch=use_pallas_dispatch)
        flat_expert, pos = flat_expert[None], pos[None]
        gate_flat, keep = gate_flat[None], keep[None]

    # ---- dispatch, expert FFNs, combine ---------------------------------
    xg = shard_fn("moe_tok", xf.reshape(g, tg, d))
    buf = shard_fn("moe_buf", _dispatch(xg, flat_expert, pos, keep, e, cap,
                                        k))
    eout = shard_fn("moe_buf", _experts(p, buf))          # [G, E, C, D]
    tok_out = shard_fn("moe_tok", _combine(eout, flat_expert, pos, keep, e))
    combined = _weigh(tok_out, gate_flat, k)               # [T, D]

    if p.shared is not None:
        combined = combined + p.shared(xf)
    return combined.reshape(bsz, s, d).to(x.dtype), aux


def _slots(flat_expert, pos, keep, e0: int, el: int, cap: int):
    """Each slot's row of a ``[G, el, C]`` buffer of experts ``e0 ..
    e0 + el``, or ``G * el * C`` (one scratch row past it) for a slot
    that was dropped or belongs to another rank's experts."""
    g = flat_expert.shape[0]
    grp = torch.arange(g, device=flat_expert.device)[:, None]
    local = flat_expert - e0
    mine = keep & (local >= 0) & (local < el)
    slot = (grp * el + local) * cap + pos
    return torch.where(mine, slot, g * el * cap).reshape(-1), mine


def _expert_range(x, e: int):
    """``(e0, el)``: the experts this rank holds (all without a mesh)."""
    if not D.is_dtensor(x):
        return 0, e
    pl = D.expert_placements(x, e, 1)
    if all(not isinstance(q, D.Shard) for q in pl):
        return 0, e
    el = e // D.model_size(x.device_mesh)
    return D.model_rank(x.device_mesh) * el, el


def _dispatch(xg, flat_expert, pos, keep, e: int, cap: int, k: int):
    """The ``[G, E, C, D]`` buffers: kept slots have unique (expert,
    pos) in their group, so a plain (non-accumulating) store of each kept
    row gives the buffer that JAX's scatter-add builds; other slots
    (which add zeros there) go to one scratch row, which is discarded.
    On DTensors each rank fills its own experts' rows."""
    g, tg, d = xg.shape
    e0, el = _expert_range(xg, e)

    def local(xg, flat_expert, pos, keep):
        xk = xg.reshape(g, tg, 1, d).expand(g, tg, k, d) \
            .reshape(g * tg * k, d)
        slot, _ = _slots(flat_expert, pos, keep, e0, el, cap)
        scratch = g * el * cap
        buf = torch.zeros((scratch + 1, d), dtype=COMPUTE_DTYPE,
                          device=xg.device)
        buf[slot] = xk
        return buf[:scratch].view(g, el, cap, d)

    if not D.is_dtensor(xg):
        return local(xg, flat_expert, pos, keep)
    mesh = xg.device_mesh
    rep = D.replicated(mesh)
    pl = D.expert_placements(xg, e, 1)
    # a rank's gradient of the tokens comes from its own experts' rows:
    # a share of the sum over the model axis
    grad = D.partial_over_model(pl, mesh.mesh_dim_names)
    return D.run_local(local, pl, (rep,) * 4, xg, flat_expert, pos, keep,
                       in_grad_placements=(grad, rep, rep, rep))


def _experts(p, buf):
    """The expert FFNs, batched over experts: ``[G, E, C, D]``; on
    DTensors on each rank's experts (its expert weights gathered over
    the data axes, as FSDP gathers them)."""
    def local(buf, w_gate, w_up, w_down):
        gate = F.silu(torch.matmul(buf, _c(w_gate)))
        up = torch.matmul(buf, _c(w_up))
        return torch.matmul(gate * up, _c(w_down))

    if not D.is_dtensor(buf):
        return local(buf, p.w_gate, p.w_up, p.w_down)
    e = buf.shape[1]
    pl = D.expert_placements(buf, e, 1)
    wpl = D.expert_placements(buf, e, 0)
    return D.run_local(local, pl, (pl, wpl, wpl, wpl), buf, p.w_gate,
                       p.w_up, p.w_down)


def _combine(eout, flat_expert, pos, keep, e: int):
    """Each slot's expert output, ``[G, Tg*K, D]`` (zeros for dropped
    slots).  On DTensors each rank gathers its own experts' rows and the
    rows are summed over the model axis (one non-zero term each)."""
    g, _, cap, d = eout.shape
    e0, el = _expert_range(eout, e)

    def local(eout, flat_expert, pos, keep):
        slot, mine = _slots(flat_expert, pos, keep, e0, el, cap)
        slot = torch.where(mine.reshape(-1), slot, 0)
        rows = eout.reshape(g * el * cap, d)[slot]
        return torch.where(mine.reshape(-1, 1), rows, 0) \
            .reshape(g, -1, d)

    if not D.is_dtensor(eout):
        return local(eout, flat_expert, pos, keep)
    mesh = eout.device_mesh
    pl = D.expert_placements(eout, e, 1)
    rep = D.replicated(mesh)
    return D.run_local(local, D.partial_over_model(pl, mesh.mesh_dim_names),
                       (pl, rep, rep, rep), eout, flat_expert, pos, keep)


def _weigh(tok_out, gate_flat, k: int):
    """Each token's slots weighted by their gates and summed: ``[G, Tg*K,
    D]`` -> ``[G*Tg, D]``.  On DTensors on the local rows, in the slots'
    layout (groups on the data axes, or each rank's share of the sum
    over the model axis), as DTensor cannot split a sharded token dim
    into groups."""
    def local(rows, gates):
        g, n, d = rows.shape
        w = gates.reshape(g, n, 1).to(COMPUTE_DTYPE)
        return (rows * w).reshape(-1, k, d).sum(dim=1)

    if not D.is_dtensor(tok_out):
        return local(tok_out, gate_flat)
    pl = tok_out.placements
    gpl = tuple(q if isinstance(q, D.Shard) else D.Replicate() for q in pl)
    # a share of the sum takes the whole gradient, and gives the gates a
    # share of theirs
    grads = (tuple(D.Replicate() if q.is_partial() else q for q in pl),
             tuple(D.Partial() if q.is_partial() else r
                   for q, r in zip(pl, gpl)))
    return D.run_local(local, pl, (pl, gpl), tok_out, gate_flat,
                       in_grad_placements=grads)


def _cap_of(m, t):
    return max(int(m.capacity_factor * t * m.top_k / m.num_experts), 4)
