"""The ``"pallas"`` executor pair: CUDA mapping kernels + torch epilogue.

Port of ``repro/kernels/ops.py`` (host-driven entries).  The mapping —
tile expansion of a degree bin, edge-balanced renumbering of the huge
bin — runs in the hand-written kernels; the gather of ``col_idx`` /
``edge_w``, ``op.msg``, the per-query ``fmask`` gather and the
scatter-combine stay in torch ops, as the JAX package leaves them to
XLA.  (Fusing them into the kernels is later work: ROADMAP Queue 2.)

Entries are batched: ``values`` / ``labels`` / ``fmask`` are ``[B, V]``
while the enumeration is batch-shared, so each kernel runs ONCE per
round for the whole batch and the epilogue re-gathers per-query values
and activity.  The kernels' own ``val`` output is a single query's view
(batch row 0) and is ignored here; it and the ``hval`` gather feeding
``edge_lb_map`` go away when the epilogue is fused into the kernels.
"""
from __future__ import annotations

import torch

# balancer imports this module only lazily (get_executor), so sharing
# its batched scatter-combine epilogue creates no import cycle
from repro_torch.core.balancer import _apply

from . import edge_lb as _edge_lb
from . import twc_gather as _twc


def edge_lb_apply(g, values, labels, fmask, hvidx, hdeg, hrow, total,
                  ecap: int, op, distribution: str, num_tiles: int,
                  tile_edges: int):
    """Host-driven LB entry (push direction)."""
    v = labels.shape[-1]
    start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    vsafe = torch.where(hvidx < v, hvidx, 0)
    hval = values[0, vsafe]            # kernel value plumbing: batch 0
    ge, j, _, mask = _edge_lb.edge_lb_map(
        start_e, hrow, hval, total, ecap,
        tile_edges=tile_edges, distribution=distribution,
        num_tiles=num_tiles)
    dst = g.col_idx[ge]
    w = g.edge_w[ge]
    src = hvidx[j.clamp(0, hvidx.shape[0] - 1)]
    ssafe = torch.where(src < v, src, 0)
    live = fmask[:, ssafe]                               # [B, n]
    cand = op.msg(values[:, ssafe], w[None])
    return _apply(labels, dst, cand, mask, live, op.combine)


def twc_bin_apply(g, values, labels, fmask, bvidx, bdeg, brow,
                  width: int, op, chunk):
    """Host-driven bin entry (push direction)."""
    v = labels.shape[-1]
    vsafe = torch.where(bvidx < v, bvidx, 0)
    val = values[:, vsafe]                               # [B, N]
    # the kernel's anchor / val outputs are views of bvidx / val[0]
    ge, _, _, mask = _twc.twc_bin_map(
        bvidx, bdeg, brow, val[0], width=width, chunk=chunk, sentinel=v)
    dst = g.col_idx[ge]
    w = g.edge_w[ge]
    live = fmask[:, vsafe][:, :, None]                   # [B, N, 1]
    cand = op.msg(val[:, :, None], w[None])
    return _apply(labels, dst, cand, mask, live, op.combine)
