"""Adaptive Load Balancer (ALB) — the paper's core contribution, on Hopper.

Port of ``repro/core/balancer.py``: the planner, the executor registry
and the single-device, host-driven round (``relax``) in push, pull and
adaptive direction.

Four strategies (Section 3 + 4 of the paper): ``vertex`` (one unit of
work per active vertex), ``twc`` (degree bins with an unbounded large
bin), ``edge_lb`` (every frontier edge renumbered by prefix sum and
dealt evenly) and ``alb`` (TWC bins below ``threshold`` plus a huge bin
that the edge-balanced executor serves only when the inspector finds it
non-empty).

A strategy is *planned* once (:func:`make_plan`) and *executed* by one
of three interchangeable executor pairs:

* ``xla``        — plain torch ops (``_bin_pass_impl`` / ``_lb_pass_impl``);
* ``pallas``     — the hand-written fused CUDA kernels ``twc_bin_relax``
  and ``edge_lb_relax``: one launch per pass, combined into the labels
  with atomics;
* ``merge_path`` — no bins and no inspector: every frontier edge goes
  through the co-ranked equal-work kernel ``merge_path_relax``, fused
  the same way, one launch a round.

The registry names are kept from the JAX package for config parity:
one ``BalancerConfig`` value selects the same path in both packages.

Every executor entry is batched (``[B, V]`` values, labels and
frontier mask): bins, the inspector and the LB deal are planned once on
the union frontier, and per-query activity is re-gathered per edge.

No round updates its input labels in place.  The torch-ops entries
scatter into a fresh labels tensor (``scatter.scatter_combine``) in every
pass; a pair registered ``in_place`` (``pallas``, ``merge_path``)
combines into the labels it is given, so the round clones the labels
once and every pass combines into that copy (the fused min loop keeps
that copy across rounds instead, and :func:`run_fused`'s turn brings it
level with the labels).  Either way the round-entry ``values`` (which
alias the app loop's labels) and the loop's ``old`` labels stay intact.

A pull round (``direction="pull"``, or ``"adaptive"`` resolving to
pull) runs the operator's pull twin over the cached reverse CSR: every
vertex with in-edges is enumerated (binned by in-degree, cached per
graph by :func:`_pull_enum`), and the executors gather value and
activity at each in-edge's source and combine at the anchor.

The static-shape round (:func:`relax_spmd`, ``mode="spmd"`` in the
drivers) runs the same plan at capacities fixed by the graph (V rows a
bin, E ids for the LB span) through the same executor entries, given
the pass count and the huge-bin total as device int32s that they read
on the device; :func:`relax_fused_round` adds the direction
choice on the device, and :func:`run_fused` runs a whole min-combine
traversal as one loop (``mode="fused"``).  Their branches and loops go
through ``core.graph_loop``: eager Python on CPU tensors, CUDA graph
conditional nodes on CUDA tensors, so on the card a static round is one
captured graph and a fused traversal one graph launch, with no host
read between the dispatch and the caller's fetch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import graph_loop, spans
from .graph import Graph
from .frontier import (next_bucket, compact, count, dirty_mask,
                       frontier_meta, rows_active, union_frontier)
from .operators import Operator, as_pull
from .scatter import scatter_combine
from .wire import validate_wire
# re-exported here, where ``repro.core.balancer`` defines it
from .scatter import combine_neutral  # noqa: F401


@dataclasses.dataclass(frozen=True)
class BalancerConfig:
    """Everything that defines a load-balancing strategy instance (same
    fields and defaults as ``repro.core.balancer.BalancerConfig``)."""
    strategy: str = "alb"            # vertex | twc | edge_lb | alb
    threshold: int = 1024            # paper: #threads launched
    small_width: int = 8             # thread-level bin
    medium_width: int = 128          # warp-level bin
    large_width: int = 1024          # CTA chunk width (per pass)
    distribution: str = "cyclic"     # cyclic | blocked (Section 4.1)
    num_tiles: int = 64              # "thread blocks" for stats/kernels
    # name kept for config parity: True selects the CUDA kernel pair
    use_pallas: bool = False
    lb_tile_edges: int = 2048        # edge tile of the LB enumeration
    direction: str = "push"          # push | pull | adaptive
    pull_alpha: int = 14             # adaptive: pull when m_f*alpha >= E
    pull_beta: int = 24              # adaptive: pull when n_f*beta >= V
    backend: Optional[str] = None    # xla | pallas | merge_path | None
    wire: str = "identity"           # sync wire codec (core/wire.py)

    def __post_init__(self):
        if self.strategy not in ("vertex", "twc", "edge_lb", "alb"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.distribution not in ("cyclic", "blocked"):
            raise ValueError(f"unknown distribution {self.distribution!r}")
        if self.direction not in ("push", "pull", "adaptive"):
            raise ValueError(f"unknown direction {self.direction!r}")
        if self.backend not in (None, "xla", "pallas", "merge_path"):
            raise ValueError(f"unknown backend {self.backend!r}")
        validate_wire(self.wire)

    @property
    def executor(self) -> str:
        """Registry name of the backend this config routes through."""
        if self.backend is not None:
            return self.backend
        return "pallas" if self.use_pallas else "xla"


# ---------------------------------------------------------------------------
# round planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BinSpec:
    """One degree bin: a frontier vertex is a member when ``lo < deg``
    and (if ``hi`` is set) ``deg <= hi``; ``cap`` bounds the degree of
    any member (None: unbounded, a data-dependent number of passes)."""
    name: str
    width: int
    lo: int
    hi: Optional[int] = None
    cap: Optional[int] = None

    def mask(self, deg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        m = valid & (deg > self.lo)
        if self.hi is not None:
            m = m & (deg <= self.hi)
        return m

    def static_passes(self) -> Optional[int]:
        if self.cap is None:
            return None
        return max(1, -(-self.cap // self.width))


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Bins + LB mode (``none`` | ``all`` | ``huge``) for one strategy."""
    bins: tuple
    lb: str
    direction: str = "push"

    def lb_mask(self, deg, valid, cfg: BalancerConfig):
        """Which frontier vertices the edge-balanced path serves."""
        if self.lb == "all":
            return valid & (deg > 0)
        if self.lb == "huge":
            return valid & (deg >= cfg.threshold)
        raise ValueError(self.lb)

    def lb_bound(self, cfg: BalancerConfig) -> tuple:
        """:meth:`lb_mask`'s degree range as a bin's ``(lo, hi)``: ``lo
        < deg``, no cap (the static round lists the LB bin with its
        degree bins)."""
        if self.lb == "all":
            return (0, None)
        if self.lb == "huge":
            return (cfg.threshold - 1, None)
        raise ValueError(self.lb)


def make_plan(cfg: BalancerConfig) -> RoundPlan:
    """Turn a config into the degree bins + LB mode of its strategy."""
    s, sw, mw, lw, th = (cfg.strategy, cfg.small_width, cfg.medium_width,
                         cfg.large_width, cfg.threshold)
    d = cfg.direction
    if s == "vertex":
        return RoundPlan((BinSpec("vertex", lw, 0),), "none", d)
    if s == "twc":
        return RoundPlan((BinSpec("small", sw, 0, sw, sw),
                          BinSpec("medium", mw, sw, mw, mw),
                          # CTA bin: UNBOUNDED — the paper's culprit
                          BinSpec("large", lw, mw)), "none", d)
    if s == "edge_lb":
        return RoundPlan((), "all", d)
    # alb: bins must be DISJOINT with the huge bin or add-combine
    # operators double-count (min-combine would mask the bug)
    return RoundPlan((BinSpec("small", sw, 0, min(sw, th - 1), sw),
                      BinSpec("medium", mw, sw, min(mw, th - 1), mw),
                      BinSpec("large", lw, mw, th - 1, th)), "huge", d)


def effective_plan(cfg: BalancerConfig) -> RoundPlan:
    """The plan a round executes: :func:`make_plan`'s bins, or LB-all
    under the ``merge_path`` backend."""
    if cfg.executor == "merge_path":
        return RoundPlan((), "all", cfg.direction)
    return make_plan(cfg)


def resolve_direction(cfg: BalancerConfig, frontier_size: int,
                      frontier_edges: int, num_vertices: int,
                      num_edges: int) -> str:
    """Per-round traversal-direction choice (Beamer-style thresholds on
    the union frontier; fixed for ``push`` / ``pull`` configs)."""
    if cfg.direction != "adaptive":
        return cfg.direction
    if frontier_size * cfg.pull_beta >= num_vertices:
        return "pull"
    if frontier_edges * cfg.pull_alpha >= num_edges:
        return "pull"
    return "push"


def resolve_direction_device(cfg: BalancerConfig, frontier_size,
                             frontier_edges, num_vertices: int,
                             num_edges: int) -> torch.Tensor:
    """:func:`resolve_direction` over device int32 scalars: a bool scalar
    on their device (True = pull), the branch selector of the fused
    round.  The same integer thresholds, so the device choice equals
    the host one (int32 counts, as in the JAX package)."""
    dev = frontier_size.device
    if cfg.direction != "adaptive":
        return torch.full((), cfg.direction == "pull", dtype=torch.bool,
                          device=dev)
    return ((frontier_size * cfg.pull_beta >= num_vertices)
            | (frontier_edges * cfg.pull_alpha >= num_edges))


# ---------------------------------------------------------------------------
# host-sync accounting
# ---------------------------------------------------------------------------

_HOST_TRANSFERS = [0]


def _note_host_transfer(n: int = 1) -> None:
    """Record ``n`` blocking per-round device->host sync points."""
    _HOST_TRANSFERS[0] += n


def host_transfer_count() -> int:
    """Monotonic process-wide count of per-round device->host sync
    points; a traversal's syncs are the delta across it."""
    return _HOST_TRANSFERS[0]


# ---------------------------------------------------------------------------
# executor registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutorPair:
    """One backend's implementations of the bin + LB paths.  Each entry
    serves the host round and the static round alike.

    bin_host: (g, values, labels, fmask, bvidx, bdeg, brow, width, op,
               chunk, passes=1, rows=None) -> labels: passes ``chunk ..
               chunk + passes - 1``; ``chunk`` and ``passes`` are host
               ints or, in the static round, device int32s (an unbounded
               bin's pass count), and ``rows``, given by the static
               round, a device int32 past which every row is empty (an
               entry may skip them)
    lb_host:  (g, values, labels, fmask, hvidx, hdeg, hrow, total, ecap,
               op, distribution, num_tiles, tile_edges, start_e=None,
               rows=None) -> labels; ``total`` a host int (host round)
               or a device int32 (static round), and a total of 0
               changes nothing; ``start_e`` and ``rows`` (a device
               int32), given by the static round with a ``bin_list``,
               are the LB list's degree prefix and member count
    bin_list: optional, the static round's bin listing: (g, mask,
               bounds, op, labels_dtype, lb) -> ``kernels.ref.BinLists``
               | None: each bin ``(lo, hi)`` of ``bounds``'s members
               among the vertices the dense ``mask`` (bool ``[R, V]``,
               its rows OR-ed: the round's frontier, or a pull round's
               ``emask[None]``) lists, degrees from ``g.row_ptr``, once
               a round, in vertex order, with their device counts and
               largest degrees, and with ``lb`` the last bin, the LB
               bin's, with its degree prefix and device total; None for
               an operator the pair lists no bins for.  Without it (or
               on None) the static round compacts the frontier and lays
               every bin and the LB bin over V rows, as the JAX package
               does

    ``values`` / ``labels`` / ``fmask`` are ``[B, V]``; the enumeration
    arguments are batch-shared (union frontier).  With ``in_place`` the
    entries combine into ``labels`` and return it: the round hands them
    a private buffer, never the caller's labels: a copy made once per
    round, or the fused min loop's shadow of its labels.
    Given device scalars, an entry never reads them on the host, so a
    captured round (``core.graph_loop``) can run it.  The JAX package
    keeps a second, jit-traced entry of each (``bin_jit`` / ``lb_jit``,
    the ``*_apply_static`` kernels); here one entry takes either kind
    of scalar, so the pair needs no second one.
    """
    name: str
    bin_host: Callable
    lb_host: Callable
    in_place: bool = False
    bin_list: Optional[Callable] = None


_REGISTRY: dict = {}


def register_executor(pair: ExecutorPair) -> None:
    """Install (or replace) a named backend in the executor registry."""
    _REGISTRY[pair.name] = pair  # repro: allow[jit-purity] -- idempotent registry write: a capture that makes the first lookup records nothing of it, and a replay needs none


def get_executor(name: str) -> ExecutorPair:
    """Look up a backend by name (``"xla"`` | ``"pallas"`` |
    ``"merge_path"``); the two kernel pairs are registered on first
    use.  ``merge_path``'s plan has no bins (:func:`effective_plan`), so
    its bin entry is unreachable and raises if ever called; its static
    round lists the LB-all bin as the ``pallas`` pair lists its LB
    bin."""
    if name not in _REGISTRY and name in ("pallas", "merge_path"):
        from repro_torch.kernels import ops as kops   # lazy: import cycle
        register_executor(ExecutorPair(
            "pallas", bin_host=kops.twc_bin_apply,
            lb_host=kops.edge_lb_apply, in_place=True,
            bin_list=kops.list_bins))
        register_executor(ExecutorPair(
            "merge_path", bin_host=kops.merge_path_no_bins,
            lb_host=kops.merge_path_apply, in_place=True,
            bin_list=kops.list_bins))
    return _REGISTRY[name]


class RoundStats(NamedTuple):
    """Per-round instrumentation (host values); the same fields as
    ``repro.core.balancer.RoundStats``."""
    frontier_size: int
    edges_twc: int
    edges_lb: int
    lb_invoked: bool
    tile_loads_twc: np.ndarray
    tile_loads_lb: np.ndarray
    mirrors_synced: int = 0
    bytes_synced: int = 0
    bytes_wire: int = 0
    frontier_per_query: Optional[np.ndarray] = None
    direction: str = "push"
    frontier_edges: int = 0
    host_transfers: int = 0

    @classmethod
    def from_device(cls, s: "RoundStatsDev") -> "RoundStats":
        """Host values of a :class:`RoundStatsDev` (CPU tensors: the
        callers fetch once, then convert)."""
        return cls(frontier_size=int(s.frontier_size),
                   edges_twc=int(s.edges_twc), edges_lb=int(s.edges_lb),
                   lb_invoked=bool(s.lb_invoked),
                   tile_loads_twc=np.asarray(s.tile_loads_twc,
                                             dtype=np.int64),
                   tile_loads_lb=np.asarray(s.tile_loads_lb,
                                            dtype=np.int64),
                   mirrors_synced=int(s.mirrors_synced),
                   bytes_synced=int(s.bytes_synced),
                   bytes_wire=int(s.bytes_wire),
                   frontier_per_query=np.asarray(s.frontier_per_query,
                                                 dtype=np.int64),
                   direction="pull" if bool(s.is_pull) else "push",
                   frontier_edges=int(s.frontier_edges))


class RoundStatsDev(NamedTuple):
    """:class:`RoundStats` as device tensors (int32 scalars, bool
    ``lb_invoked`` / ``is_pull``, int32 ``[num_tiles]`` tile loads and
    ``[B]`` per-query frontier sizes): what a static round reports
    without a host read.  The fused loop keeps one row per round in a
    packed buffer (:func:`_fused_stats_init`); views of it have a
    leading round axis and int32 flags."""
    frontier_size: torch.Tensor
    edges_twc: torch.Tensor
    edges_lb: torch.Tensor
    lb_invoked: torch.Tensor
    tile_loads_twc: torch.Tensor
    tile_loads_lb: torch.Tensor
    mirrors_synced: torch.Tensor
    bytes_synced: torch.Tensor
    bytes_wire: torch.Tensor
    frontier_per_query: torch.Tensor
    frontier_edges: torch.Tensor
    is_pull: torch.Tensor


# the scalar fields of RoundStatsDev, in the packed layout's order; the
# two [num_tiles] tile loads and the [B] frontier sizes follow
_STAT_SCALARS = ("frontier_size", "edges_twc", "edges_lb", "lb_invoked",
                 "mirrors_synced", "bytes_synced", "bytes_wire",
                 "frontier_edges", "is_pull")


def _pack_stats(st: RoundStatsDev) -> torch.Tensor:
    """One int32 vector of a round's stats (``[..., K]`` for fields with
    a leading round axis), so that a fetch is one transfer and the fused
    loop writes one row a round."""
    lead = st.frontier_size.shape
    cols = [getattr(st, f).to(torch.int32).reshape(*lead, 1)
            for f in _STAT_SCALARS]
    return torch.cat(cols + [st.tile_loads_twc, st.tile_loads_lb,
                             st.frontier_per_query], dim=-1)


def _unpack_stats(p: torch.Tensor, num_tiles: int) -> RoundStatsDev:
    """Views of a :func:`_pack_stats` vector (or ``[R, K]`` rows) as a
    :class:`RoundStatsDev`."""
    k = len(_STAT_SCALARS)
    fields = {f: p[..., i] for i, f in enumerate(_STAT_SCALARS)}
    return RoundStatsDev(tile_loads_twc=p[..., k:k + num_tiles],
                         tile_loads_lb=p[..., k + num_tiles:
                                         k + 2 * num_tiles],
                         frontier_per_query=p[..., k + 2 * num_tiles:],
                         **fields)


# ---------------------------------------------------------------------------
# torch-ops building blocks (the "xla" executor)
# ---------------------------------------------------------------------------

def _bin_pass_impl(g: Graph, values, labels, fmask, vidx, deg, row_start,
                   width: int, op: Operator, chunk, passes=1, rows=None):
    """Process one degree bin: each vertex in ``vidx`` contributes its
    edges [c*width, c*width + width) as an [N, width] tile shared by the
    whole batch, for ``c`` in ``chunk .. chunk + passes - 1``: a Python
    loop for a host int ``passes``, a :func:`graph_loop.while_` over the
    chunks for a device int32 (an unbounded bin of the static round).
    ``chunk`` is a host int or a 0-dim int32 tensor, used as a tensor
    (never read on the host).  The tile spans all N rows, so ``rows``
    goes unused."""
    del rows
    return graph_loop.repeat(
        lambda lab, c: _bin_chunk(g, values, lab, fmask, vidx, deg,
                                  row_start, width, op, c),
        labels, chunk, passes)


def _bin_chunk(g: Graph, values, labels, fmask, vidx, deg, row_start,
               width: int, op: Operator, chunk):
    """One pass ``chunk`` of :func:`_bin_pass_impl`."""
    v = labels.shape[-1]
    off = (chunk * width
           + torch.arange(width, dtype=torch.int32,
                          device=vidx.device)[None, :])           # [1,W]
    emask = off < deg[:, None]                                     # [N,W]
    graph_e = torch.where(emask, row_start[:, None] + off, 0)
    dst = g.col_idx[graph_e]
    w = g.edge_w[graph_e]
    if op.direction == "push":
        vsafe = torch.where(vidx < v, vidx, 0)
        live = fmask[:, vsafe][:, :, None]                         # [B,N,1]
        val = values[:, vsafe][:, :, None]                         # [B,N,1]
        cand = op.msg(val, w[None])
        return scatter_combine(labels, dst, cand, emask, live, op.combine)
    # pull: value AND activity gathered at the in-neighbour (``dst`` in
    # the reverse CSR), candidate scattered at the anchor
    live = fmask[:, dst]                                           # [B,N,W]
    cand = op.msg(values[:, dst], w[None])
    anchor = vidx[:, None].expand(emask.shape)
    return scatter_combine(labels, anchor, cand, emask, live, op.combine)


def _lb_pass_impl(g: Graph, values, labels, fmask, hidx, hdeg, hrow_start,
                  total_edges, ecap: int, op: Operator,
                  distribution: str, num_tiles: int, tile_edges: int = 0):
    """The LB executor (Figure 3, SSSP_LB): edges of the huge vertices
    get ids 0..total_edges-1 by an exclusive prefix sum over their
    degrees; each id maps back to (src, graph edge) by binary search.
    ``total_edges`` is a host int or a 0-dim int32 tensor (the static
    round's), compared as a tensor.
    ``distribution`` sets the id -> lane order (cyclic: contiguous;
    blocked: strided by ``w_per``).  ``tile_edges`` is unused here
    (kept for executor signature parity with the kernel pair)."""
    v = labels.shape[-1]
    dev = hidx.device
    start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    # enumerate a multiple of num_tiles so the blocked permutation below
    # is a bijection of [0, n_enum) and cannot miss edges
    w_per = -(-ecap // num_tiles)
    n_enum = w_per * num_tiles
    eid = torch.arange(n_enum, dtype=torch.int32, device=dev)
    if distribution == "blocked":
        eid = (eid % num_tiles) * w_per + eid // num_tiles
    emask = eid < total_edges
    eid_c = torch.where(emask, eid, 0)
    j = torch.searchsorted(start_e, eid_c, right=True, out_int32=True) - 1
    j = j.clamp(0, hidx.shape[0] - 1)
    graph_e = torch.where(emask, hrow_start[j] + (eid_c - start_e[j]), 0)
    src = hidx[j]
    dst = g.col_idx[graph_e]
    w = g.edge_w[graph_e]
    if op.direction == "push":
        ssafe = torch.where(src < v, src, 0)
        live = fmask[:, ssafe]                            # [B, n_enum]
        cand = op.msg(values[:, ssafe], w[None])
        return scatter_combine(labels, dst, cand, emask, live, op.combine)
    # pull: liveness comes from the in-neighbour (``dst`` of the reverse
    # CSR), the anchor ``src`` receives the candidate
    live = fmask[:, dst]                                  # [B, n_enum]
    cand = op.msg(values[:, dst], w[None])
    return scatter_combine(labels, src, cand, emask, live, op.combine)


register_executor(ExecutorPair("xla", bin_host=_bin_pass_impl,
                               lb_host=_lb_pass_impl))


def _tile_loads(deg, valid, num_tiles: int):
    """Per-tile edge counts when frontier vertices are dealt to tiles in
    compacted order (Fig 1/5 instrumentation): slot i goes to tile
    ``i * num_tiles // f``, so tile t holds the contiguous slots from
    ``ceil(t * f / num_tiles)`` on, and its load is a difference of one
    prefix sum (a scatter-add onto 64 addresses would serialize the
    static round's V slots on them)."""
    f = deg.shape[0]
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64,
                          device=deg.device) * f
    first = (bounds + num_tiles - 1) // num_tiles         # [T + 1]
    csum = torch.zeros((f + 1,), dtype=torch.int64, device=deg.device)
    csum[1:] = torch.cumsum(torch.where(valid, deg, 0), 0)
    return (csum[first[1:]] - csum[first[:-1]]).to(torch.int32)


def _lb_tile_loads(total, num_tiles: int):
    """Edge-balanced deal: per-tile loads differ by at most one edge.
    Host arithmetic (int64 numpy) for a host ``total``; int32 on its
    device for a tensor one."""
    if not isinstance(total, torch.Tensor):
        return (total // num_tiles + (np.arange(num_tiles)
                                      < total % num_tiles)).astype(np.int64)
    tiles = torch.arange(num_tiles, dtype=torch.int32, device=total.device)
    return (total // num_tiles
            + (tiles < total % num_tiles).to(torch.int32))


# ---------------------------------------------------------------------------
# host-driven round
# ---------------------------------------------------------------------------

def _gather_bin(mask, fidx, deg, row_start, cap: int, fcap: int, v: int):
    """Compact a bin mask into (vidx, deg, row) at capacity ``cap``
    (slots past the bin size become out-of-range sentinels).  The
    counterpart of JAX's ``_gather_bin_impl`` (its jit cache front
    ``_gather_bin`` has nothing to cache here)."""
    sel = compact(mask, cap)                       # slots into fidx
    take = sel < fcap
    sel_safe = torch.where(take, sel, 0)
    return (torch.where(take, fidx[sel_safe], v),
            torch.where(take, deg[sel_safe], 0),
            torch.where(take, row_start[sel_safe], 0))


def _host_round_counts(g: Graph, frontier: torch.Tensor,
                       cfg: BalancerConfig):
    """Every host-side decision scalar of one round, fused into a single
    int32 vector so ``relax`` pays ONE device->host transfer per round.

    Layout: ``[union_frontier_count,
               (bin_count, bin_max_deg, bin_edge_sum) per plan bin...,
               huge_count, huge_edge_sum (when the plan has an LB path),
               per-query frontier counts (B entries, batched input only)]``

    Returns the device vector and the union mask.
    """
    deg = g.out_degrees()
    union = union_frontier(frontier)
    plan = effective_plan(cfg)
    vals = [count(union)]
    for spec in plan.bins:
        m = spec.mask(deg, union)
        md = torch.where(m, deg, 0)
        vals += [count(m), md.max(), md.sum(dtype=torch.int32)]
    if plan.lb != "none":
        hm = plan.lb_mask(deg, union, cfg)
        vals += [count(hm), torch.where(hm, deg, 0).sum(dtype=torch.int32)]
    head = torch.stack(vals)
    if frontier.ndim == 1:
        return head, union
    return torch.cat([head, frontier.sum(dim=1, dtype=torch.int32)]), union


def _counts_frontier_edges(cnt: np.ndarray, plan: RoundPlan) -> int:
    """Union-frontier out-edge total, reassembled from the fused host
    count layout of :func:`_host_round_counts`."""
    k, total = 1, 0
    for _ in plan.bins:
        total += int(cnt[k + 2])
        k += 3
    if plan.lb != "none":
        total += int(cnt[k + 1])
    return total


def _assemble_bins(cnt: np.ndarray, plan: RoundPlan,
                   cfg: BalancerConfig, fidx, deg, row_start, valid,
                   fcap: int, v: int):
    """Gather the bin / LB member arrays named by the fused host count
    vector.  Returns ``(bins, lb)`` in the :func:`_run_plan_host`
    format."""
    bins, k = [], 1
    for spec in plan.bins:
        n, max_d, edge_sum = int(cnt[k]), int(cnt[k + 1]), int(cnt[k + 2])
        k += 3
        if n == 0:
            bins.append(None)
            continue
        mask = spec.mask(deg, valid)
        bvidx, bdeg, brow = _gather_bin(mask, fidx, deg, row_start,
                                        next_bucket(n), fcap, v)
        bins.append((max_d, edge_sum, bvidx, bdeg, brow))
    lb = None
    if plan.lb != "none":
        # ---- inspector (Section 4.1): is the huge bin non-empty? ----
        n_huge, total = int(cnt[k]), int(cnt[k + 1])
        if n_huge > 0 and total > 0:
            hmask = plan.lb_mask(deg, valid, cfg)
            hvidx, hdeg, hrow = _gather_bin(hmask, fidx, deg, row_start,
                                            next_bucket(n_huge), fcap, v)
            lb = (total, hvidx, hdeg, hrow)
    return tuple(bins), lb


class _PullEnum(NamedTuple):
    """Frontier-independent pull-side enumeration of one (graph, plan):
    the reverse CSR plus the bin / LB member arrays over every vertex
    with in-edges, binned by in-degree.  A pull round gathers at each
    in-edge's source, so its work set never depends on the frontier: it
    is built once per graph and plan (one transfer, not a per-round one)
    and cached on the Graph."""
    rg: Graph
    emask: torch.Tensor  # bool[V]: in-degree > 0 (the enumeration set)
    bins: tuple          # per plan bin: None | (max_d, edge_sum,
    #                      bvidx, bdeg, brow) at bucketed capacity
    lb: Optional[tuple]  # None | (total, hvidx, hdeg, hrow)


def _pull_plan_key(cfg: BalancerConfig) -> tuple:
    """The cfg fields a pull enumeration depends on (the plan's bins and
    LB mask).  Direction and deal fields are left out so push / adaptive
    variants share an entry; ``merge_path`` replaces the plan
    (:func:`effective_plan`), so it is keyed apart."""
    return (cfg.strategy, cfg.threshold, cfg.small_width,
            cfg.medium_width, cfg.large_width,
            cfg.executor == "merge_path")


def _build_pull_enum(g: Graph, cfg: BalancerConfig) -> _PullEnum:
    """Materialize the pull-side enumeration (see :class:`_PullEnum`)."""
    rg = g.reverse()
    v = rg.num_vertices
    emask = rg.out_degrees() > 0
    cnt, union = _host_round_counts(rg, emask, cfg)
    cnt = cnt.cpu().numpy()  # repro: allow[host-sync] -- one-time set-up, cached per graph and config, not per round
    fcap = next_bucket(int(cnt[0]))
    fidx = compact(union, fcap)
    deg, row_start, valid = frontier_meta(rg.row_ptr, fidx)
    bins, lb = _assemble_bins(cnt, effective_plan(cfg), cfg, fidx, deg,
                              row_start, valid, fcap, v)
    return _PullEnum(rg, emask, bins, lb)


def _pull_enum(g: Graph, cfg: BalancerConfig) -> _PullEnum:
    """Cached :func:`_build_pull_enum`, on the Graph object, keyed by
    ``g.version`` plus :func:`_pull_plan_key`; entries of an older
    version are dropped when a new one is built."""
    cache = g.__dict__.get("_pull_enum_cache")
    if cache is None:
        cache = {}
        object.__setattr__(g, "_pull_enum_cache", cache)
    key = (g.version,) + _pull_plan_key(cfg)
    if key not in cache:
        for stale in [k for k in cache if k[0] != g.version]:
            del cache[stale]
        cache[key] = _build_pull_enum(g, cfg)
    return cache[key]


def _run_plan_host(gr: Graph, values, labels, fmask, plan: RoundPlan,
                   cfg: BalancerConfig, op: Operator, ex: ExecutorPair,
                   bins, lb, stats) -> torch.Tensor:
    """Drive one host round's executor launches from pre-gathered
    bin/LB member arrays.  Every pass reads the round-entry ``values``;
    an ``in_place`` pair's passes combine into one private copy of
    ``labels``.  ``stats`` is the mutable RoundStats dict or None."""
    v = labels.shape[-1]
    if ex.in_place:
        labels = labels.clone(memory_format=torch.contiguous_format)
    for spec, entry in zip(plan.bins, bins):
        if entry is None:
            continue
        max_d, edge_sum, bvidx, bdeg, brow = entry
        passes = max(1, -(-max_d // spec.width))
        for c in range(passes):
            labels = ex.bin_host(gr, values, labels, fmask, bvidx,
                                 bdeg, brow, spec.width, op, c)
        if stats is not None:
            stats["edges_twc"] += edge_sum
            loads = _tile_loads(bdeg, bvidx < v, cfg.num_tiles)
            stats["tile_loads_twc"] += loads.cpu().numpy()  # repro: allow[host-sync] -- collect_stats only: the JAX package's host round makes this fetch uncounted too
    if lb is not None:
        total, hvidx, hdeg, hrow = lb
        ecap = next_bucket(total, minimum=cfg.lb_tile_edges)
        labels = ex.lb_host(gr, values, labels, fmask, hvidx, hdeg,
                            hrow, total, ecap, op, cfg.distribution,
                            cfg.num_tiles, cfg.lb_tile_edges)
        if stats is not None:
            stats["edges_lb"] = total
            stats["lb_invoked"] = True
            stats["tile_loads_lb"] = _lb_tile_loads(total, cfg.num_tiles)
    return labels


def relax(g: Graph, values: torch.Tensor, labels: torch.Tensor,
          frontier: torch.Tensor, cfg: BalancerConfig, op: Operator,
          collect_stats: bool = False, return_active: bool = False):
    """One round: apply ``op`` along all edges of active vertices.

    Returns (new_labels, RoundStats|None), plus a host ``bool[B]``
    (``bool[1]`` un-batched) of rows that entered the round with a
    non-empty frontier when ``return_active=True``.  ``values`` is the
    per-vertex quantity being propagated (may alias ``labels``);
    neither is written.  Accepts ``[V]`` or batched ``[B, V]`` state.
    The round pays exactly one blocking device->host transfer: the
    fused count vector of :func:`_host_round_counts`.

    With ``cfg.direction="pull"`` (or ``"adaptive"`` resolving to pull
    for this round by :func:`resolve_direction` over the same counts)
    the round runs ``as_pull(op)`` over the cached reverse CSR; only
    push min-combine operators may be flipped, and the labels are
    bitwise those of the push round.
    """
    batched = labels.ndim == 2
    if not batched:
        values, labels, frontier = (values[None], labels[None],
                                    frontier[None])
    b, v = labels.shape
    plan = effective_plan(cfg)
    # validate direction x operator up front, even when adaptive ends
    # up resolving to push every round
    pull_op = as_pull(op) if cfg.direction != "push" else None
    cnt, union = _host_round_counts(g, frontier, cfg)
    cnt = cnt.cpu().numpy()
    _note_host_transfer()              # THE per-round host sync point
    nf = int(cnt[0])                                   # union size
    active = cnt[-b:] > 0
    if nf == 0:
        out = ((labels if batched else labels[0]), None)
        return out + (active,) if return_active else out
    m_f = _counts_frontier_edges(cnt, plan)
    direction = resolve_direction(cfg, nf, m_f, v, g.num_edges)

    ex = get_executor(cfg.executor)
    stats = dict(frontier_size=nf, edges_twc=0, edges_lb=0,
                 lb_invoked=False,
                 tile_loads_twc=np.zeros(cfg.num_tiles, np.int64),
                 tile_loads_lb=np.zeros(cfg.num_tiles, np.int64),
                 frontier_per_query=cnt[-b:].astype(np.int64),
                 direction=direction,
                 frontier_edges=m_f,
                 host_transfers=1) if collect_stats else None

    if direction == "pull":
        pe = _pull_enum(g, cfg)
        labels = _run_plan_host(pe.rg, values, labels, frontier, plan,
                                cfg, pull_op, ex, pe.bins, pe.lb, stats)
    else:
        fcap = next_bucket(nf)
        fidx = compact(union, fcap)
        deg, row_start, valid = frontier_meta(g.row_ptr, fidx)
        bins, lb = _assemble_bins(cnt, plan, cfg, fidx, deg, row_start,
                                  valid, fcap, v)
        labels = _run_plan_host(g, values, labels, frontier, plan, cfg,
                                op, ex, bins, lb, stats)
    labels = labels if batched else labels[0]
    out = (labels, RoundStats(**stats) if stats is not None else None)
    return out + (active,) if return_active else out


# ---------------------------------------------------------------------------
# static-shape round (the ``spmd`` mode)
# ---------------------------------------------------------------------------

def _relax_spmd_impl(g: Graph, values, labels, frontier,
                     cfg: BalancerConfig, op: Operator,
                     collect_stats: bool = False, return_dirty: bool = False,
                     emask: Optional[torch.Tensor] = None,
                     owned: bool = False, inspect: tuple = ()):
    """Static-shape ALB round: through a pair with a ``bin_list`` hook,
    each bin's members and the LB bin's listed once, straight from the
    dense frontier (or ``emask``) and ``row_ptr``, with device counts
    (the LB bin also with its degree prefix and device total); else
    (no hook, or an operator the hook lists nothing for) bins over
    ``compact(union or emask, V)`` at capacity V (sentinel ``V`` for
    non-members), the frontier layout that ``collect_stats``' V-row
    masks read too; the LB span at E ids;
    a bounded bin runs its static passes, an unbounded one (twc's large
    bin, the vertex strategy) its pass count ``ceil(max_deg / W)``
    computed on the device, and the LB path always runs with the device
    total, which is 0 when the huge bin is empty (so it changes
    nothing, and the stats take ``torch.where`` on ``n_huge > 0``: the
    JAX package's ``lax.cond`` inspector).  No device value is read on
    the host, so ``core.graph_loop`` can capture it.

    Returns ``labels``, extended to ``(labels, RoundStatsDev)`` with
    ``collect_stats`` and/or ``(..., dirty)`` with ``return_dirty``.
    ``tile_loads_twc`` deals the static V slots to tiles, so it differs
    from the host round's bucketed deal.  Accepts ``[V]`` or ``[B, V]``
    state, and a frontier of any strides or dtype (the pair's hooks are
    handed it as a contiguous bool).  ``emask`` (a pull round over the
    reverse CSR) enumerates
    the vertices it marks instead of the union frontier.  ``owned``:
    ``labels`` is a private buffer that an ``in_place`` pair may combine
    into (the fused round's direction branches share one).  Inside a
    stamped loop's round (``core.spans``) it stamps the listing's start
    with the ``inspect`` counts (the fused round's ``n_f``, ``m_f``), its
    end with each bin's members and the LB total, and each pass's end."""
    batched = labels.ndim == 2
    if not batched:
        values, labels, frontier = (values[None], labels[None],
                                    frontier[None])
    # the kernels take a contiguous bool frontier and copy nothing: a
    # view or a non-bool mask is made one here (free when it is one)
    frontier = frontier.to(torch.bool).contiguous()
    labels_in = labels
    v = labels.shape[-1]
    dev = labels.device
    ex = get_executor(cfg.executor)
    plan = effective_plan(cfg)
    if ex.in_place and not owned:
        labels = labels.clone(memory_format=torch.contiguous_format)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    edges_twc, tl_twc = zeros(), zeros(cfg.num_tiles)
    # a pair with a listing hook lists each bin's members and the LB
    # bin's once, from the dense frontier, and each launch takes its
    # list and count; else every bin spans the V-row frontier layout
    has_lb = plan.lb != "none"
    bounds = tuple((s.lo, s.hi) for s in plan.bins) + \
        ((plan.lb_bound(cfg),) if has_lb else ())
    lists = None
    spans.stamp(spans.LIST, *inspect)
    if bounds and ex.bin_list is not None:
        lists = ex.bin_list(g, frontier if emask is None else emask[None],
                            bounds, op, labels.dtype, has_lb)
    if lists is None or collect_stats:
        union = union_frontier(frontier)
        listed = union if emask is None else emask
        fidx = compact(listed, v)
        n_listed = count(listed)       # bin rows past it are all empty
        deg, row_start, valid = frontier_meta(g.row_ptr, fidx)
    spans.stamp(spans.LISTED, *(() if lists is None
                                else (lists.count, lists.total)))
    for i, spec in enumerate(plan.bins):
        mask = None
        if lists is not None:
            bvidx, bdeg, brow = (lists.vidx[i], lists.deg[i],
                                 lists.row_start[i])
            rows, max_deg = lists.count[i:i + 1], lists.max_deg[i]
        else:
            mask = spec.mask(deg, valid)
            bvidx = torch.where(mask, fidx, v)
            bdeg = torch.where(mask, deg, 0)
            brow = torch.where(mask, row_start, 0)
            rows, max_deg = n_listed, None
        passes = spec.static_passes()
        if passes is None:
            # unbounded bin: a data-dependent pass count (0 when empty)
            if max_deg is None:
                max_deg = bdeg.max()
            passes = (max_deg + (spec.width - 1)) // spec.width
        labels = ex.bin_host(g, values, labels, frontier, bvidx, bdeg, brow,
                            spec.width, op, 0, passes, rows)
        spans.stamp(spans.BIN + i)
        if collect_stats:
            if mask is None:
                mask = spec.mask(deg, valid)
                bdeg = torch.where(mask, deg, 0)
            edges_twc = edges_twc + bdeg.sum(dtype=torch.int32)
            tl_twc = tl_twc + _tile_loads(bdeg, mask, cfg.num_tiles)

    edges_lb, tl_lb = zeros(), zeros(cfg.num_tiles)
    lb_invoked = zeros(dtype=torch.bool)
    if has_lb:
        if lists is not None:
            k = len(plan.bins)
            total = lists.total
            labels = ex.lb_host(g, values, labels, frontier, lists.vidx[k],
                                lists.deg[k], lists.row_start[k], total,
                                g.num_edges, op, cfg.distribution,
                                cfg.num_tiles, cfg.lb_tile_edges,
                                start_e=lists.start_e,
                                rows=lists.count[k:k + 1])
            lb_invoked = lists.count[k] > 0
        else:
            hmask = plan.lb_mask(deg, valid, cfg)
            hdeg = torch.where(hmask, deg, 0)
            total = hdeg.sum(dtype=torch.int32)
            labels = ex.lb_host(g, values, labels, frontier,
                                torch.where(hmask, fidx, v), hdeg,
                                torch.where(hmask, row_start, 0), total,
                                g.num_edges, op, cfg.distribution,
                                cfg.num_tiles, cfg.lb_tile_edges)
            lb_invoked = count(hmask) > 0
        spans.stamp(spans.LB, total)
        edges_lb = torch.where(lb_invoked, total, 0)
        tl_lb = torch.where(lb_invoked,
                            _lb_tile_loads(total, cfg.num_tiles), 0)

    outs = (labels if batched else labels[0],)
    if collect_stats:
        outs += (RoundStatsDev(
            frontier_size=count(union), edges_twc=edges_twc,
            edges_lb=edges_lb, lb_invoked=lb_invoked,
            tile_loads_twc=tl_twc, tile_loads_lb=tl_lb,
            mirrors_synced=zeros(), bytes_synced=zeros(),
            bytes_wire=zeros(),
            frontier_per_query=frontier.sum(dim=1, dtype=torch.int32),
            frontier_edges=zeros(), is_pull=zeros(dtype=torch.bool)),)
    if return_dirty:
        dirty = dirty_mask(labels_in, labels)
        outs += (dirty if batched else dirty[0],)
    return outs[0] if len(outs) == 1 else outs


def relax_spmd(g: Graph, values: torch.Tensor, labels: torch.Tensor,
               frontier: torch.Tensor, cfg: BalancerConfig, op: Operator,
               collect_stats: bool = False, return_dirty: bool = False,
               emask: Optional[torch.Tensor] = None):
    """:func:`_relax_spmd_impl` as a whole: eagerly on CPU tensors; on
    CUDA tensors one replay of its captured graph (``core.graph_loop``),
    cached on ``g`` per version, config, operator, outputs asked for and
    input shapes.  Results are the caller's own tensors, on the device."""
    ins = (values, labels, frontier) + (() if emask is None else (emask,))

    def round_(values, labels, frontier, *em):
        return _relax_spmd_impl(g, values, labels, frontier, cfg, op,
                                collect_stats, return_dirty,
                                em[0] if em else None)

    return graph_loop.run(g, ("spmd", cfg, op, collect_stats, return_dirty,
                              emask is not None), round_, *ins)


# ---------------------------------------------------------------------------
# device-resident planning: the direction chosen on the device, whole
# traversals as one device loop
# ---------------------------------------------------------------------------

def relax_fused_round(g: Graph, rg: Optional[Graph],
                      emask: Optional[torch.Tensor], values, labels,
                      frontier, cfg: BalancerConfig, op: Operator,
                      pull_op: Optional[Operator] = None,
                      collect_stats: bool = False,
                      census: Optional[torch.Tensor] = None,
                      owned: bool = False):
    """One round with the whole inspector on the device: ``n_f`` and
    ``m_f`` are device scalars, the Beamer rule
    (:func:`resolve_direction_device`) picks the branch with
    :func:`graph_loop.cond` (two IF nodes on the card; never both
    branches merged, since the kernel pair combines into its labels),
    and each branch is the static round, push on ``g`` or pull on the
    reverse CSR ``rg`` over its in-degree ``emask``.

    ``n_f`` and ``m_f`` are read from ``census`` (``census[0]``,
    ``census[1]``: the fused min loop's, which ``kernels.relax.
    round_turn`` took of this frontier) when it is given, else computed
    here over V (the union frontier and its out-degrees).  ``owned``:
    ``labels`` is a private buffer that an ``in_place`` pair combines
    into (the fused min loop's shadow of its labels); else such a pair
    gets a copy, made here once.

    Inputs are batched ``[B, V]``; ``rg`` / ``emask`` / ``pull_op`` may
    be None for ``push`` configs.  Returns ``(labels, is_pull, n_f,
    m_f, stats)``, all on the device; ``stats`` is a
    :class:`RoundStatsDev` with ``frontier_edges`` / ``is_pull`` filled
    in (None unless ``collect_stats``)."""
    v = labels.shape[-1]
    if census is None:
        deg = g.out_degrees()
        union = union_frontier(frontier)
        nf = count(union)
        m_f = torch.where(union, deg, 0).sum(dtype=torch.int32)
    else:
        nf, m_f = census[0], census[1]
    is_pull = resolve_direction_device(cfg, nf, m_f, v, g.num_edges)
    seen = (nf, m_f)        # stamped with the listing's start
    # an in_place pair: every branch combines into one private buffer
    in_place = get_executor(cfg.executor).in_place
    if in_place and not owned:
        labels = labels.clone(memory_format=torch.contiguous_format)
    if cfg.direction == "push":
        out = _relax_spmd_impl(g, values, labels, frontier, cfg, op,
                               collect_stats=collect_stats, owned=in_place,
                               inspect=seen)
    elif cfg.direction == "pull":
        out = _relax_spmd_impl(rg, values, labels, frontier, cfg, pull_op,
                               collect_stats=collect_stats, emask=emask,
                               owned=in_place, inspect=seen)
    else:
        out = graph_loop.cond(
            is_pull,
            lambda: _relax_spmd_impl(rg, values, labels, frontier, cfg,
                                     pull_op, collect_stats=collect_stats,
                                     emask=emask, owned=in_place,
                                     inspect=seen),
            lambda: _relax_spmd_impl(g, values, labels, frontier, cfg, op,
                                     collect_stats=collect_stats,
                                     owned=in_place, inspect=seen))
    if collect_stats:
        labels_out, st = out
        st = st._replace(frontier_edges=m_f, is_pull=is_pull)
    else:
        labels_out, st = out, None
    return labels_out, is_pull, nf, m_f, st


def _pull_side(g: Graph, cfg: BalancerConfig, op: Operator):
    """``(pull_op, rg, emask)`` of a direction-aware round: None for push
    configs, else the pull twin (which validates the operator) and the
    cached reverse CSR with its in-degree mask (one-time set-up)."""
    if cfg.direction == "push":
        return None, None, None
    pull_op = as_pull(op)
    pe = _pull_enum(g, cfg)
    return pull_op, pe.rg, pe.emask


def _directed_round(g, rg, emask, values, labels, frontier, cfg, op,
                    pull_op, collect_stats):
    """One device-directed round, plus what a host loop observes packed
    in one int32 vector: each row's entering liveness, then the packed
    stats (with ``collect_stats``)."""
    labels_out, _, _, _, st = relax_fused_round(
        g, rg, emask, values, labels, frontier, cfg, op, pull_op,
        collect_stats)
    seen = [rows_active(frontier).to(torch.int32)]
    if collect_stats:
        seen.append(_pack_stats(st))
    return labels_out, torch.cat(seen)


def relax_spmd_directed(g: Graph, values, labels, frontier,
                        cfg: BalancerConfig, op: Operator,
                        collect_stats: bool = False,
                        return_active: bool = False):
    """Direction-aware static round: the round primitive of
    ``mode="spmd"`` in the drivers.  The direction is chosen on the
    device (:func:`relax_fused_round`), so deciding costs no transfer;
    the caller pays ONE counted fetch a round, and only when it asks to
    observe liveness or stats.  On CUDA tensors the round is one replay
    of its captured graph.

    Returns ``(labels, RoundStats|None)``, plus a host ``bool[B]``
    liveness vector (``bool[1]`` un-batched) with ``return_active``."""
    batched = labels.ndim == 2
    if not batched:
        values, labels, frontier = (values[None], labels[None],
                                    frontier[None])
    pull_op, rg, emask = _pull_side(g, cfg, op)
    labels_out, seen = graph_loop.run(
        g, ("directed", cfg, op, collect_stats),
        lambda val, lab, fr: _directed_round(g, rg, emask, val, lab, fr,
                                             cfg, op, pull_op,
                                             collect_stats),
        values, labels, frontier)
    st = active = None
    if collect_stats or return_active:
        b = labels.shape[0]
        seen = seen.cpu()              # ONE blocking sync for the loop
        _note_host_transfer()
        active = seen[:b].numpy() > 0
        if collect_stats:
            st = RoundStats.from_device(_unpack_stats(
                seen[b:], cfg.num_tiles))._replace(host_transfers=1)
    labels_out = labels_out if batched else labels_out[0]
    result = (labels_out, st)
    return result + (active,) if return_active else result


def _fused_stats_init(max_rounds: int, b: int, num_tiles: int,
                      device) -> torch.Tensor:
    """Zeroed per-round stat rows of a fused traversal: one int32
    ``[max_rounds, K]`` buffer in the :func:`_pack_stats` layout (the
    JAX package's ``RoundStatsDev`` of ``[max_rounds]`` buffers;
    :func:`_unpack_stats` gives it that shape as views)."""
    return torch.zeros((max_rounds, len(_STAT_SCALARS) + 2 * num_tiles + b),
                       dtype=torch.int32, device=device)


def _put_row(rows: torch.Tensor, r: torch.Tensor,
             st: RoundStatsDev) -> torch.Tensor:
    """Write round ``r``'s stats (``r`` a device scalar) into ``rows``,
    in place; returns ``rows``."""
    return rows.index_copy_(0, r.reshape(1).long(), _pack_stats(st)[None])  # repro: allow[scatter-determinism] -- one index, round r: no duplicate targets


def _arm_spans(device, cfg: BalancerConfig) -> None:
    """:func:`core.spans.arm` for a stamped loop of ``cfg``'s plan,
    before its dispatch."""
    plan = effective_plan(cfg)
    spans.arm(device, tuple(s.name for s in plan.bins)
              + (("lb",) if plan.lb != "none" else ()))


def _stamped_while(cond_fn, body_fn, carry):
    """:func:`graph_loop.while_` over a carry whose first element is the
    round index ``r``, stamped (``core.spans``): the loop's start and
    end (with the final ``r``) and each round's start; the round's other
    points are stamped where it reaches them.  The caller arms the
    device's ring first (:func:`_arm_spans`)."""
    spans.stamp_loop(spans.LOOP_START, carry[0])

    def body(r, *rest):
        with spans.round_(r):
            return body_fn(r, *rest)

    out = graph_loop.while_(cond_fn, body, carry)
    spans.stamp_loop(spans.LOOP_END, out[0], out[0])
    return out


def _run_fused_loop(g: Graph, rg, emask, labels, frontier,
                    cfg: BalancerConfig, op: Operator, pull_op,
                    max_rounds: int, collect_stats: bool):
    """The fused min-combine loop: ONE :func:`graph_loop.while_` whose
    body is :func:`relax_fused_round` and the turn
    (``kernels.relax.round_turn``, one launch over the labels: the next
    frontier ``new < old``, the labels brought level with ``new``, and
    the next round's census ``n_f``, ``m_f``), writing stats row ``r``
    on the device; the condition ``(r < max_rounds) & (n_f > 0)``, which
    is ``any(frontier)``, is evaluated on the device.  The census of the
    first frontier is taken before the loop, by the same kernel.

    An ``in_place`` pair relaxes each round into a second buffer of the
    carry, ``N``, equal to the labels at every round's start, reading the
    labels as the round-entry values: no round copies the labels, and
    the turn writes back only the labels that changed.  ``N`` is a
    temporary of the loop, never returned, so a captured program keeps
    no buffer for it beyond its pool.  The ``xla`` pair's rounds return
    fresh labels, which the turn takes as ``new``.  Each round is
    stamped (:func:`_stamped_while`).
    Returns ``(r, labels, frontier)`` plus the stat rows with
    ``collect_stats``."""
    from repro_torch.kernels import relax as krelax   # lazy: import cycle
    census = krelax.round_turn(None, None, g.row_ptr, frontier,
                               krelax.census_buffer(labels.device))
    shadow = get_executor(cfg.executor).in_place
    carry = (torch.zeros((), dtype=torch.int32, device=labels.device),
             labels, frontier, census) + ((labels,) if shadow else ())
    if collect_stats:
        carry += (_fused_stats_init(max_rounds, labels.shape[0],
                                    cfg.num_tiles, labels.device),)

    def cond(r, lab, fr, census, *rest):
        return (r < max_rounds) & (census[0] > 0)

    def body(r, lab, fr, census, *rest):
        shade, rows = (rest[0], rest[1:]) if shadow else (lab, rest)
        new, _, _, _, st = relax_fused_round(
            g, rg, emask, lab, shade, fr, cfg, op, pull_op, collect_stats,
            census=census, owned=shadow)
        if collect_stats:      # before the turn: st reads the census
            rows = (_put_row(rows[0], r, st),)
        krelax.round_turn(lab, new.contiguous(), g.row_ptr, fr, census)
        return (r + 1, lab, fr, census) + ((new,) if shadow else ()) + rows

    r, lab, fr, _, *rest = _stamped_while(cond, body, carry)
    return (r, lab, fr) + tuple(rest[1:] if shadow else rest)


def run_fused(g: Graph, labels: torch.Tensor, frontier: torch.Tensor,
              cfg: BalancerConfig, op: Operator, max_rounds: int = 10_000,
              collect_stats: bool = False):
    """A whole min-combine traversal as ONE device loop, with zero
    per-round host syncs: bins, the inspector and the direction rule
    run on the device (:func:`relax_fused_round`).  On CUDA tensors the
    loop is one launch of a captured graph whose WHILE node turns on the
    card; the only transfers are the dispatch and whatever the caller
    fetches.  Accepts ``[V]`` or ``[B, V]`` state.  The one-time pull
    enumeration is built before dispatch and cached on ``g``.

    Returns ``(labels, frontier, rounds, stats)``: ``rounds`` a device
    scalar, ``stats`` the device stat rows as a :class:`RoundStatsDev`
    of ``[max_rounds, ...]`` views (None unless ``collect_stats``);
    materialize them with :func:`fused_stats_host`."""
    if op.combine != "min":
        raise ValueError(f"run_fused drives min-combine loops; got "
                         f"{op.name} (combine={op.combine!r})")
    batched = labels.ndim == 2
    lab = labels if batched else labels[None]
    fr = (frontier if batched else frontier[None]).to(torch.bool).contiguous()
    pull_op, rg, emask = _pull_side(g, cfg, op)
    max_rounds = int(max_rounds)
    _arm_spans(lab.device, cfg)
    r, lab, fr, *rows = graph_loop.run(
        g, ("fused", cfg, op, max_rounds, collect_stats),
        lambda la, f: _run_fused_loop(g, rg, emask, la, f, cfg, op,
                                      pull_op, max_rounds, collect_stats),
        lab, fr)
    st = _unpack_stats(rows[0], cfg.num_tiles) if collect_stats else None
    if not batched:
        lab, fr = lab[0], fr[0]
    return lab, fr, r, st


def fused_stats_host(st: Optional[RoundStatsDev], rounds: int):
    """A fused traversal's stat rows as the usual ``List[RoundStats]``:
    ONE transfer for the whole traversal, after it converged.
    ``rounds`` selects the filled rows; fused rounds report
    ``host_transfers=0``."""
    if st is None:
        return None
    rows = _pack_stats(st)[:rounds].cpu()  # repro: allow[host-sync] -- once per fused traversal, after it converged; fused rounds count no transfer, as in the JAX package
    t = st.tile_loads_twc.shape[-1]
    return [RoundStats.from_device(_unpack_stats(row, t)) for row in rows]
