"""The kernel executor pairs: CUDA mapping kernels + torch epilogue.

Port of ``repro/kernels/ops.py`` (host-driven entries).  The mapping —
tile expansion of a degree bin, edge-balanced renumbering of the huge
bin, the merge-path backend's equal-work tiles — runs in the
hand-written kernels; the gather of ``col_idx`` / ``edge_w``,
``op.msg``, the per-query ``fmask`` gather and the scatter-combine stay
in torch ops, as the JAX package leaves them to XLA.  (Fusing them into
the kernels is later work: ROADMAP Queue 2.)

Entries are batched: ``values`` / ``labels`` / ``fmask`` are ``[B, V]``
while the enumeration is batch-shared, so each kernel runs ONCE per
round for the whole batch and the epilogue re-gathers per-query values
and activity.  The kernels' own ``val`` output is a single query's view
(batch row 0) and is ignored here; it and the ``hval`` gather feeding
``edge_lb_map`` go away when the epilogue is fused into the kernels.

Every entry has a push and a pull epilogue.  Push gathers value and
activity at the enumerated vertex and scatters at ``col_idx``; pull
(over the reverse CSR) gathers them at ``col_idx`` — the in-neighbour —
and scatters at the enumerated vertex: ``twc_bin_map``'s ``anchor``, or
``hvidx[slot]`` on the edge-balanced and merge-path entries.
"""
from __future__ import annotations

import torch

# balancer imports this module only lazily (get_executor), so sharing
# its batched scatter-combine epilogue creates no import cycle
from repro_torch.core.balancer import _apply

from . import edge_lb as _edge_lb
from . import merge_path as _merge_path
from . import twc_gather as _twc


def _slot_apply(g, values, labels, fmask, hvidx, ge, j, mask, op):
    """Epilogue of the edge-enumerating entries: id -> (slot ``j``,
    CSR edge ``ge``), both flat and batch-shared."""
    v = labels.shape[-1]
    dst = g.col_idx[ge]
    w = g.edge_w[ge]
    src = hvidx[j.clamp(0, hvidx.shape[0] - 1)]
    if op.direction == "push":
        ssafe = torch.where(src < v, src, 0)
        live = fmask[:, ssafe]                           # [B, n]
        cand = op.msg(values[:, ssafe], w[None])
        return _apply(labels, dst, cand, mask, live, op.combine)
    live = fmask[:, dst]                                 # [B, n]
    cand = op.msg(values[:, dst], w[None])
    return _apply(labels, src, cand, mask, live, op.combine)


def edge_lb_apply(g, values, labels, fmask, hvidx, hdeg, hrow, total,
                  ecap: int, op, distribution: str, num_tiles: int,
                  tile_edges: int):
    """Host-driven LB entry."""
    v = labels.shape[-1]
    start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    vsafe = torch.where(hvidx < v, hvidx, 0)
    hval = values[0, vsafe]            # kernel value plumbing: batch 0
    ge, j, _, mask = _edge_lb.edge_lb_map(
        start_e, hrow, hval, total, ecap,
        tile_edges=tile_edges, distribution=distribution,
        num_tiles=num_tiles)
    return _slot_apply(g, values, labels, fmask, hvidx, ge, j, mask, op)


def merge_path_apply(g, values, labels, fmask, hvidx, hdeg, hrow, total,
                     ecap: int, op, distribution: str, num_tiles: int,
                     tile_edges: int):
    """Host-driven merge-path entry, signature-compatible with the LB
    entries (``effective_plan`` routes the whole frontier here).  The
    equal-work deal is contiguous by construction, so ``distribution``
    and ``num_tiles`` do not apply."""
    del distribution, num_tiles
    start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    ge, j, mask = _merge_path.merge_path_map(start_e, hrow, total, ecap,
                                             tile_edges=tile_edges)
    return _slot_apply(g, values, labels, fmask, hvidx, ge, j, mask, op)


def merge_path_no_bins(*_args, **_kwargs):
    """Bin entry of the merge-path pair: its plan has no degree bins
    (``effective_plan``), so reaching this is a planner bug."""
    raise RuntimeError("merge_path backend plans no degree bins; "
                       "its bin executor entries are unreachable")


def twc_bin_apply(g, values, labels, fmask, bvidx, bdeg, brow,
                  width: int, op, chunk):
    """Host-driven bin entry."""
    v = labels.shape[-1]
    vsafe = torch.where(bvidx < v, bvidx, 0)
    val = values[:, vsafe]                               # [B, N]
    # the kernel's anchor / val outputs are views of bvidx / val[0]
    ge, anchor, _, mask = _twc.twc_bin_map(
        bvidx, bdeg, brow, val[0], width=width, chunk=chunk, sentinel=v)
    dst = g.col_idx[ge]
    w = g.edge_w[ge]
    if op.direction == "push":
        live = fmask[:, vsafe][:, :, None]               # [B, N, 1]
        cand = op.msg(val[:, :, None], w[None])
        return _apply(labels, dst, cand, mask, live, op.combine)
    live = fmask[:, dst]                                 # [B, N, W]
    cand = op.msg(values[:, dst], w[None])
    return _apply(labels, anchor, cand, mask, live, op.combine)
