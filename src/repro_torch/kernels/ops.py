"""The kernel executor pairs of ``core.balancer``.

Port of ``repro/kernels/ops.py`` (host-driven entries), where the
Pallas mapping kernels emit index tiles and XLA does the gather, the
``msg`` and the scatter-combine.  That split is a TPU choice; on this
card the index tiles would make a round trip through device memory, so
both kernel pairs fuse the map with its epilogue:

* ``pallas`` — ``twc_bin_apply`` / ``edge_lb_apply``: ONE fused kernel
  launch per pass (``relax.twc_bin_relax`` / ``relax.edge_lb_relax``),
  which maps slots to edges in registers, gathers, applies ``op.msg``
  and combines into ``labels`` with atomics.  The pair is registered
  ``in_place``: its entries write ``labels`` and return it, and the
  round hands them a private copy, once per round.  An operator the
  fused kernels do not take (``relax.takes``: a ``msg`` outside
  ``operators.msg_kind``'s table, or a combine on a label dtype they do
  not reduce, such as float32 min) takes the JAX pair's route instead:
  the index-map kernel (``twc_gather.twc_bin_map`` /
  ``edge_lb.edge_lb_map``), then the torch epilogue
  ``ref.slot_epilogue``, copied into ``labels``.  The operator chooses
  the route before any launch; ``unfused_passes`` counts the passes
  that took it.
* ``merge_path`` — ``merge_path_apply``: ONE fused kernel launch per
  pass (``relax.merge_path_relax``), which cuts the frontier's edges
  into equal-work tiles, maps each id to its slot and edge in registers
  and combines into ``labels`` with atomics.  The pair is registered
  ``in_place`` too.  An operator the kernel does not take runs the JAX
  pair's route: the index-map kernel ``merge_path.merge_path_map``, then
  ``ref.slot_epilogue``, copied into ``labels`` and counted in
  ``unfused_passes``.

Each entry serves the host round and the static round (``relax_spmd``,
``run_fused``) alike, as the registry's ``bin_host`` and ``lb_host``:
the pass count and the huge-bin total may be device int32 tensors that
the kernels read on the card, so a captured round never reads them on
the host.  They stand for the JAX package's
``twc_bin_apply_static`` / ``edge_lb_apply_static`` /
``merge_path_apply_static`` too.  Both pairs' static round first lists
each bin's members once, and the LB bin's with their edge prefix and
total, straight from the dense frontier and ``row_ptr`` (``list_bins``,
the registry's ``bin_list``: one ``relax.twc_bin_list`` launch; the
merge-path plan's one bin is its LB-all bin), where JAX compacts the
frontier, lays every bin over V rows and the merge-path map enumerates
all E ids.

Entries are batched: ``values`` / ``labels`` / ``fmask`` are ``[B, V]``
while the enumeration is batch-shared, so each kernel runs ONCE per
pass for the whole batch and reads per-query values and activity
itself.  Every entry has a push and a pull direction.  Push gathers
value and activity at the enumerated vertex and combines at
``col_idx``; pull (over the reverse CSR) gathers them at ``col_idx`` —
the in-neighbour — and combines at the enumerated vertex.
"""
from __future__ import annotations

import torch

from repro_torch.core import graph_loop

from . import edge_lb as _edge_lb
from . import merge_path as _merge_path
from . import relax as _relax
from . import twc_gather as _twc
from .ref import slot_epilogue

#: passes of the kernel pairs that took the unfused route because the
#: fused kernels do not take their operator (``kernels.reset_launch_counts``
#: resets it)
unfused_passes = 0


def _unfused(g, values, labels, fmask, src, ge, mask, op):
    """The unfused route's epilogue, written into ``labels`` (the pair
    is ``in_place``)."""
    global unfused_passes
    unfused_passes += 1
    return labels.copy_(slot_epilogue(g.col_idx, g.edge_w, values, labels,
                                      fmask, src, ge, mask, op))


def edge_lb_apply(g, values, labels, fmask, hvidx, hdeg, hrow, total,
                  ecap: int, op, distribution: str, num_tiles: int,
                  tile_edges: int, start_e=None, rows=None):
    """LB entry of both rounds: one ``edge_lb_relax`` launch, combined
    into ``labels`` in place (or the unfused route, for an operator the
    kernel does not take).  ``total`` is a host int or, in the static
    round, a device int32 the kernels read on the card.  The static
    round's LB list (:func:`list_bins`) comes with its degree prefix
    ``start_e`` and its device member count ``rows``; otherwise the
    prefix is taken here over ``hdeg``."""
    if start_e is None:
        start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    if not _relax.takes(op, labels.dtype):
        ge, j, _, mask = _edge_lb.edge_lb_map(
            start_e, hrow, start_e, total, ecap, tile_edges=tile_edges,
            distribution=distribution, num_tiles=num_tiles)
        return _unfused(g, values, labels, fmask, hvidx[j], ge, mask, op)
    return _relax.edge_lb_relax(
        values, labels, fmask, g.col_idx, g.edge_w, hvidx, start_e, hrow,
        total, ecap, op, tile_edges=tile_edges, distribution=distribution,
        num_tiles=num_tiles, rows=rows)


def merge_path_apply(g, values, labels, fmask, hvidx, hdeg, hrow, total,
                     ecap: int, op, distribution: str, num_tiles: int,
                     tile_edges: int, start_e=None, rows=None):
    """Merge-path entry of both rounds, signature-compatible with the LB
    entries (``effective_plan`` routes the whole frontier here): one
    ``merge_path_relax`` launch, combined into ``labels`` in place (or
    the unfused route, for an operator the kernel does not take).
    ``total`` is a host int or, in the static round, a device int32; the
    static round's LB-all list comes with its degree prefix ``start_e``
    and device member count ``rows``, as for :func:`edge_lb_apply`.  The
    equal-work deal is contiguous by construction, so ``distribution``
    and ``num_tiles`` do not apply."""
    del distribution, num_tiles
    if start_e is None:
        start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    if not _relax.takes(op, labels.dtype):
        ge, j, mask = _merge_path.merge_path_map(start_e, hrow, total, ecap,
                                                 tile_edges=tile_edges)
        return _unfused(g, values, labels, fmask, hvidx[j], ge, mask, op)
    return _relax.merge_path_relax(
        values, labels, fmask, g.col_idx, g.edge_w, hvidx, start_e, hrow,
        total, ecap, op, tile_edges=tile_edges, rows=rows)


def merge_path_no_bins(*_args, **_kwargs):
    """Bin entry of the merge-path pair: its plan has no degree bins
    (``effective_plan``), so reaching this is a planner bug."""
    raise RuntimeError("merge_path backend plans no degree bins; "
                       "its bin executor entries are unreachable")


def list_bins(g, mask, bounds, op, labels_dtype, lb: bool = False):
    """The kernel pairs' bin listing of the static round: one
    ``twc_bin_list`` launch over the dense ``mask`` (bool ``[R, V]``:
    the round's frontier, or a pull round's ``emask[None]``) and
    ``g.row_ptr``, each bin ``(lo, hi)`` of ``bounds`` compacted in
    vertex order (a ``ref.BinLists``), for :func:`twc_bin_apply` with
    ``rows`` its member count; with ``lb`` the last bin is the LB bin,
    listed with its edge prefix and total for :func:`edge_lb_apply` or
    :func:`merge_path_apply`.
    None for an operator the fused kernels do not take: its unfused
    route keeps the round's V-row layout."""
    if not _relax.takes(op, labels_dtype):
        return None
    return _relax.twc_bin_list(mask, g.row_ptr, bounds, lb=lb)


def twc_bin_apply(g, values, labels, fmask, bvidx, bdeg, brow,
                  width: int, op, chunk, passes=1, rows=None):
    """Bin entry of both rounds: passes ``chunk .. chunk + passes - 1``
    (host ints, or a device int32 ``passes``: an unbounded bin of the
    static round) in one ``twc_bin_relax`` launch, combined into
    ``labels`` in place; ``rows`` (in the static round a device int32:
    a bin list's member count from :func:`list_bins`) bounds the rows
    the kernel takes.  An operator the kernel does not take runs the
    passes one by one through the unfused route (a ``graph_loop.while_``
    over them for a device count)."""
    if not _relax.takes(op, labels.dtype):
        def one(lab, c):
            ge, anchor, _, mask = _twc.twc_bin_map(
                bvidx, bdeg, brow, bvidx, width=width, chunk=c,
                sentinel=labels.shape[-1])
            return _unfused(g, values, lab, fmask, anchor.reshape(-1),
                            ge.reshape(-1), mask.reshape(-1), op)
        return graph_loop.repeat(one, labels, chunk, passes)
    return _relax.twc_bin_relax(values, labels, fmask, g.col_idx,
                                g.edge_w, bvidx, bdeg, brow, op,
                                width=width, chunk=chunk, passes=passes,
                                rows=rows)
