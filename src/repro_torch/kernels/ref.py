"""Plain PyTorch versions of the kernels.

Same output contract as ``repro/kernels/ref.py`` (and the CUDA kernels):
four outputs ``(graph_e, anchor_or_slot, val, mask)`` for the mapping
kernels, three for the merge-path map ``(graph_e, slot_j, mask)``; the
labels combined in place for the fused relax kernels
(``twc_bin_relax_ref``, ``edge_lb_relax_ref``, ``merge_path_relax_ref``:
the index map above plus the torch epilogue ``slot_epilogue``); each
degree bin's member list of a static round for ``twc_bin_list_ref``; a
fused round's turn and census for ``round_turn_ref``; the arrival rank
for
``positions_in_expert_ref``; the whole MoE dispatch plan for
``moe_plan_ref``; the attention output for ``flash_attention_ref``.
The kernel wrappers call these for CPU tensors, and the CUDA kernels
are held against them on the card.  The
differences from the JAX oracles: ``twc_bin_map_ref`` returns exactly
``[N, W]`` (no padding of N to a TPU vertex tile), and
``positions_in_expert_ref`` gives 0 to an out-of-range expert id, as the
TPU kernel does (the JAX oracle's ``take_along_axis`` fills INT32_MIN).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.frontier import compact, count, frontier_meta
from repro_torch.core.scatter import scatter_combine


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
    max(1, ceil(ecap / tile_edges)) * tile_edges`` (``total_edges`` an
    int or a one-element int32 tensor, as in every oracle here that
    takes a total); ``j`` is the last
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


def slot_epilogue(col_idx, edge_w, values, labels, fmask, src, ge, mask,
                  op):
    """The torch epilogue of an index map: flat, batch-shared slots, each
    with its enumerated vertex ``src``, CSR edge ``ge`` and ``mask``.
    Push gathers value and activity at ``src`` and combines at
    ``col_idx[ge]``; pull (over the reverse CSR) gathers them at
    ``col_idx[ge]``, the in-neighbour, and combines at ``src``.  Returns
    fresh ``[B, V]`` labels (``scatter.scatter_combine``)."""
    v = labels.shape[-1]
    dst = col_idx[ge]
    w = edge_w[ge]
    if op.direction == "push":
        ssafe = torch.where(src < v, src, 0)
        live = fmask[:, ssafe]                           # [B, n]
        cand = op.msg(values[:, ssafe], w[None])
        return scatter_combine(labels, dst, cand, mask, live, op.combine)
    live = fmask[:, dst]                                 # [B, n]
    cand = op.msg(values[:, dst], w[None])
    return scatter_combine(labels, src, cand, mask, live, op.combine)


def twc_bin_relax_ref(values, labels, fmask, col_idx, edge_w, vidx, deg,
                      row_start, op, *, width: int, chunk=0, passes=1,
                      rows=None):
    """Oracle for relax.twc_bin_relax: for each pass ``c`` in ``chunk ..
    chunk + passes - 1`` (ints, or one-element int32 tensors, read on
    the host), ``twc_bin_map_ref`` over the rows with an edge in that
    pass, in bin order, then :func:`slot_epilogue`, written into
    ``labels``.  Rows at or past ``rows`` (when given) are empty.
    Leaving out the rows without an edge drops only masked slots, which
    combine nothing: the static round's V-row bins cost what their
    members need."""
    v = labels.shape[-1]
    member = vidx < v
    if rows is not None:
        member &= torch.arange(vidx.shape[0], device=vidx.device) < rows
    first = int(chunk)
    for c in range(first, first + int(passes)):
        at = torch.nonzero(member & (deg > c * width)).reshape(-1)
        ge, anchor, _, mask = twc_bin_map_ref(vidx[at], deg[at],
                                              row_start[at], vidx[at],
                                              width=width, chunk=c,
                                              sentinel=v)
        labels.copy_(slot_epilogue(col_idx, edge_w, values, labels, fmask,
                                   anchor.reshape(-1), ge.reshape(-1),
                                   mask.reshape(-1), op))
    return labels


class BinLists(NamedTuple):
    """Each bin's members of a static round, in vertex order (the order
    the compacted frontier lists them in): ``vidx`` / ``deg`` /
    ``row_start`` int32 ``[nbins, V]``, whose rows ``[0, count[b])`` are
    bin ``b``'s members (the plain version pads the rest with the
    sentinel ``V``, deg 0 and row 0; the kernel leaves them unwritten);
    ``count`` and ``max_deg`` int32 ``[nbins]``, the members and their
    largest degree (0 for an empty bin).  When the last bin is the
    plan's edge-balanced (LB) bin, ``start_e`` (int32 ``[V]``) is the
    exclusive prefix of its members' degrees in list order (the plain
    version pads it with the total) and ``total`` (a 0-d int32) their
    sum; else both are None."""
    vidx: torch.Tensor
    deg: torch.Tensor
    row_start: torch.Tensor
    count: torch.Tensor
    max_deg: torch.Tensor
    start_e: Optional[torch.Tensor] = None
    total: Optional[torch.Tensor] = None


def twc_bin_list_ref(mask, row_ptr, bounds, *, lb: bool = False) -> BinLists:
    """Oracle for relax.twc_bin_list: the vertices ``mask`` (bool ``[R,
    V]``) lists in any of its rows, in the layout the static round
    builds without the kernel, then each bin of it.  The union over the
    R rows is compacted at capacity V (``core.frontier.compact``), each
    row takes its degree and row start from ``row_ptr`` (int32 ``[V +
    1]``) by ``core.frontier.frontier_meta`` (deg 0 and row 0 at the
    sentinel ``V``), as the static round does, and each bin ``(lo, hi)`` of ``bounds`` is
    compacted over the rows with ``lo < deg`` and, unless ``hi`` is
    None, ``deg <= hi``: the rows the V-row layout marks for that bin,
    in the same order.  With ``lb`` the last bin's degrees, padded with
    0, give ``start_e`` (their exclusive cumsum, so the padding holds
    the total, as the host round's bucketed gather pads) and
    ``total``."""
    n = mask.shape[-1]
    dev = mask.device
    fidx = compact(mask.any(dim=0), n)
    deg, row_start, valid = frontier_meta(row_ptr, fidx)
    cols = {k: [] for k in BinLists._fields[:5]}
    for lo, hi in bounds:
        m = valid & (deg > lo)
        if hi is not None:
            m = m & (deg <= hi)
        sel = compact(m, n)
        take = sel < n
        safe = torch.where(take, sel, 0)
        cols["vidx"].append(torch.where(take, fidx[safe], n))
        cols["deg"].append(torch.where(take, deg[safe], 0))
        cols["row_start"].append(torch.where(take, row_start[safe], 0))
        cols["count"].append(count(m))
        cols["max_deg"].append(torch.where(m, deg, 0).amax() if n else
                               torch.zeros((), dtype=torch.int32,
                                           device=dev))
    lists = BinLists(**{k: torch.stack(v) for k, v in cols.items()})
    if not lb:
        return lists
    d = lists.deg[-1]
    return lists._replace(
        start_e=torch.cumsum(d, 0, dtype=torch.int32) - d,
        total=d.sum(dtype=torch.int32))


def _row_bound(start_e, total_edges, rows):
    """A slot list bounded to its first ``rows`` slots (an int or a
    one-element int32 tensor; None keeps every slot): ``start_e`` past
    the bound reads as the int32 maximum, so no id lands there, and with
    no slot the total is 0, so no id is live."""
    if rows is None:
        return start_e, total_edges
    keep = torch.arange(start_e.shape[0], device=start_e.device) < rows
    return (torch.where(keep, start_e, torch.iinfo(torch.int32).max),
            torch.where(keep[0], torch.as_tensor(total_edges,
                                                 device=keep.device), 0))


def edge_lb_relax_ref(values, labels, fmask, col_idx, edge_w, hvidx,
                      start_e, row_start, total_edges, n_enum, op, *,
                      tile_edges: int = 2048, distribution: str = "cyclic",
                      num_tiles: int = 64, rows=None):
    """Oracle for relax.edge_lb_relax: ``edge_lb_map_ref`` over the huge
    bin, then :func:`slot_epilogue` with ``src = hvidx[slot]``, written
    into ``labels``.  ``rows`` (an int or a one-element int32 tensor),
    when given, bounds the slots to ``[0, rows)`` (:func:`_row_bound`)."""
    start_e, total_edges = _row_bound(start_e, total_edges, rows)
    ge, j, _, mask = edge_lb_map_ref(start_e, row_start, start_e,
                                     total_edges, n_enum,
                                     tile_edges=tile_edges,
                                     distribution=distribution,
                                     num_tiles=num_tiles)
    out = slot_epilogue(col_idx, edge_w, values, labels, fmask, hvidx[j],
                        ge, mask, op)
    return labels.copy_(out)


def merge_path_relax_ref(values, labels, fmask, col_idx, edge_w, hvidx,
                         start_e, row_start, total_edges, ecap: int, op, *,
                         tile_edges: int = 2048, rows=None):
    """Oracle for relax.merge_path_relax: ``merge_path_map_ref`` over the
    slots, then :func:`slot_epilogue` with ``src = hvidx[slot]``, written
    into ``labels`` (the JAX package's ``merge_path_apply_static``).
    ``rows``, when given, bounds the slots to ``[0, rows)``
    (:func:`_row_bound`)."""
    start_e, total_edges = _row_bound(start_e, total_edges, rows)
    ge, j, mask = merge_path_map_ref(start_e, row_start, total_edges, ecap,
                                     tile_edges=tile_edges)
    out = slot_epilogue(col_idx, edge_w, values, labels, fmask, hvidx[j],
                        ge, mask, op)
    return labels.copy_(out)


def round_turn_ref(labels, new, row_ptr, frontier, census):
    """Plain version of ``relax.round_turn``: with ``labels`` (and
    ``new``), ``frontier = new < labels`` and ``labels = new``, in place;
    then ``census[0]`` = the vertices set in any row of ``frontier`` (its
    union over the batch) and ``census[1]`` = their out-degrees from
    ``row_ptr``, summed in int32.  ``census[2:]`` is left as it is.
    Returns ``census``."""
    if labels is not None:
        torch.lt(new, labels, out=frontier)
        labels.copy_(new)
    union = frontier.any(dim=0) if frontier.ndim == 2 else frontier
    deg = row_ptr[1:] - row_ptr[:-1]
    census[0] = count(union)
    census[1] = torch.where(union, deg, 0).sum(dtype=torch.int32)
    return census


def positions_in_expert_ref(flat_expert, num_experts: int):
    """Oracle for moe_dispatch.positions_in_expert: ``pos[i]`` = number
    of earlier slots routed to the same expert (one-hot exclusive
    cumsum, int32).  Ids outside ``[0, num_experts)`` count for nothing
    and get 0."""
    experts = torch.arange(num_experts, dtype=torch.int32,
                           device=flat_expert.device)
    onehot = (flat_expert[:, None] == experts[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    valid = (flat_expert >= 0) & (flat_expert < num_experts)
    idx = torch.where(valid, flat_expert, 0).to(torch.int64)
    got = torch.gather(pos, 1, idx[:, None])[:, 0]
    return torch.where(valid, got, 0)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties broken
    towards the lower index (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _row_sum(x):
    """Sum over the last axis, left to right, as XLA reduces the k gate
    values: the normalized gates then equal JAX's bitwise."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _rebalance(probs, top_k: int, cap: int, flat_e, pos, gate):
    """The ALB executor, per group (``probs [G, Tg, E]``; the rest
    ``[G, Tg*K]``): deal the overflow slots (``pos >= cap``) in order
    over the free capacity of all experts by exclusive prefix sum +
    searchsorted (side right: where experts have no free slot, the
    repeated ``start`` values resolve to the last of them).  Rerouted
    slots take the router's probability of the expert they land on.
    Identity when nothing overflows."""
    g, _, e = probs.shape
    overflow = pos >= cap
    kept1 = (~overflow).to(torch.int32)
    load = torch.zeros((g, e), dtype=torch.int32, device=pos.device) \
        .scatter_add_(1, flat_e.long(), kept1)
    free = cap - load                                     # >= 0
    start = torch.cumsum(free, 1, dtype=torch.int32) - free   # exclusive
    total_free = free.sum(1, keepdim=True, dtype=torch.int32)
    ovf_rank = torch.cumsum(overflow.to(torch.int32), 1,
                            dtype=torch.int32) - 1
    j = torch.searchsorted(start, ovf_rank, right=True, out_int32=True) - 1
    j = torch.clamp(j, 0, e - 1)
    jl = j.long()
    fits = overflow & (ovf_rank < total_free)
    new_e = torch.where(fits, j, flat_e)
    new_pos = torch.where(fits, load.gather(1, jl) + (ovf_rank -
                                                      start.gather(1, jl)),
                          pos)
    grp = torch.arange(g, device=pos.device)[:, None]
    tok = torch.arange(flat_e.shape[1], device=pos.device) // top_k
    new_gate = torch.where(fits, probs[grp, tok, jl].to(gate.dtype), gate)
    return new_e, new_pos, new_gate


def moe_plan_ref(probs, *, top_k: int, cap: int, groups: int,
                 adaptive: bool, positions=positions_in_expert_ref):
    """Oracle for moe_plan.moe_plan: the dispatch plan of each of
    ``groups`` groups of ``probs`` (float32 ``[G, Tg, E]``) ->
    ``(flat_expert, pos, gate_flat, keep)``, each ``[G, Tg*K]``: the
    stable top-k, the gates over their left-to-right sum (clamped at
    1e-9), the arrival ranks (``positions``, one call per group), the
    ALB rebalance when ``adaptive``, then ``keep = pos < cap``: the
    math of ``_top_k``, ``_row_sum`` and ``_rebalance``, which
    ``models.moe`` shares."""
    g, tg, e = probs.shape
    if g != groups:
        raise ValueError(f"moe_plan_ref: probs has {g} groups, not "
                         f"{groups}")
    vals, idx = _top_k(probs, top_k)                      # [G, Tg, K]
    vals = vals / torch.clamp(_row_sum(vals)[..., None], min=1e-9)
    flat_expert = idx.reshape(g, tg * top_k)
    pos = torch.stack([positions(fe, e) for fe in flat_expert])
    gate_flat = vals.reshape(g, tg * top_k)
    if adaptive:
        flat_expert, pos, gate_flat = _rebalance(probs, top_k, cap,
                                                 flat_expert, pos,
                                                 gate_flat)
    return flat_expert, pos, gate_flat, pos < cap


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Oracle for flash_attention: plain softmax attention in float32.
    q: [B, S, H, hd]; k/v: [B, S, Hkv, hd] (query head i reads KV head
    i // (H // Hkv)); returns [B, S, H, hd] in ``q.dtype``."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, s, hkv, g, hd) / math.sqrt(hd)
    sc = torch.einsum("bqkgd,bckd->bqkgc", qf, k.float())
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
