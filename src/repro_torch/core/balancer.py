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
  through the co-ranked equal-work kernel ``merge_path_map``.

The registry names are kept from the JAX package for config parity:
one ``BalancerConfig`` value selects the same path in both packages.

Every executor entry is batched (``[B, V]`` values, labels and
frontier mask): bins, the inspector and the LB deal are planned once on
the union frontier, and per-query activity is re-gathered per edge.

No round updates its input labels in place.  The torch-ops entries
scatter into a fresh labels tensor (``scatter.scatter_combine``) in every
pass; a pair registered ``in_place`` (``pallas``) combines into the
labels it is given, so the round clones the labels once and every pass
combines into that copy.  Either way the round-entry ``values`` (which
alias the app loop's labels) and the loop's ``old`` labels stay intact.

A pull round (``direction="pull"``, or ``"adaptive"`` resolving to
pull) runs the operator's pull twin over the cached reverse CSR: every
vertex with in-edges is enumerated (binned by in-degree, cached per
graph by :func:`_pull_enum`), and the executors gather value and
activity at each in-edge's source and combine at the anchor.

The static-shape and fused round modes arrive with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .graph import Graph
from .frontier import next_bucket, compact, count, union_frontier
from .operators import Operator, as_pull
from .scatter import scatter_combine

_WIRE_NAMES = ("identity", "delta", "bitmap")
_WIRE_NARROW = ("int8", "uint8", "int16", "uint16")


def validate_wire(wire: str) -> None:
    """Config-syntax check of ``BalancerConfig.wire``: ``identity |
    delta | bitmap | quantize[:<dtype>]`` (the codecs themselves arrive
    with the distributed slice)."""
    if wire in _WIRE_NAMES:
        return
    base, _, req = wire.partition(":")
    if base != "quantize":
        raise ValueError(
            f"unknown wire codec {wire!r} (expected one of "
            f"{_WIRE_NAMES + ('quantize',)} or 'quantize:<dtype>')")
    if req and req not in _WIRE_NARROW:
        raise ValueError(
            f"wire codec {wire!r}: {req!r} is not a supported "
            f"narrow dtype ({sorted(_WIRE_NARROW)})")


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
    wire: str = "identity"           # sync wire codec (syntax only here)

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
    """One backend's host-round implementations of the bin + LB paths.

    bin_host: (g, values, labels, fmask, bvidx, bdeg, brow, width, op,
               chunk) -> labels
    lb_host:  (g, values, labels, fmask, hvidx, hdeg, hrow, total, ecap,
               op, distribution, num_tiles, tile_edges) -> labels

    ``values`` / ``labels`` / ``fmask`` are ``[B, V]``; the enumeration
    arguments are batch-shared (union frontier).  With ``in_place`` the
    entries combine into ``labels`` and return it: the round hands them
    a private copy, made once per round, never the caller's labels.
    The static-shape entries of the JAX pairs arrive with the spmd/fused
    slice.
    """
    name: str
    bin_host: Callable
    lb_host: Callable
    in_place: bool = False


_REGISTRY: dict = {}


def register_executor(pair: ExecutorPair) -> None:
    """Install (or replace) a named backend in the executor registry."""
    _REGISTRY[pair.name] = pair


def get_executor(name: str) -> ExecutorPair:
    """Look up a backend by name (``"xla"`` | ``"pallas"`` |
    ``"merge_path"``); the two kernel pairs are registered on first
    use.  ``merge_path``'s plan has no bins (:func:`effective_plan`), so
    its bin entry is unreachable and raises if ever called."""
    if name not in _REGISTRY and name in ("pallas", "merge_path"):
        from repro_torch.kernels import ops as kops   # lazy: import cycle
        register_executor(ExecutorPair(
            "pallas", bin_host=kops.twc_bin_apply,
            lb_host=kops.edge_lb_apply, in_place=True))
        register_executor(ExecutorPair(
            "merge_path", bin_host=kops.merge_path_no_bins,
            lb_host=kops.merge_path_apply))
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


# ---------------------------------------------------------------------------
# torch-ops building blocks (the "xla" executor)
# ---------------------------------------------------------------------------

def _frontier_meta(g: Graph, frontier_idx: torch.Tensor):
    """degree / row start / validity for a compacted frontier."""
    v = g.num_vertices
    valid = frontier_idx < v
    safe = torch.where(valid, frontier_idx, 0)
    lo = g.row_ptr[safe]
    deg = torch.where(valid, g.row_ptr[safe + 1] - lo, 0)
    row_start = torch.where(valid, lo, 0)
    return deg, row_start, valid


def _bin_pass_impl(g: Graph, values, labels, fmask, vidx, deg, row_start,
                   width: int, op: Operator, chunk):
    """Process one degree bin: each vertex in ``vidx`` contributes its
    edges [chunk*width, chunk*width + width) as an [N, width] tile
    shared by the whole batch."""
    v = labels.shape[-1]
    off = (int(chunk) * width
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
                  total_edges: int, ecap: int, op: Operator,
                  distribution: str, num_tiles: int, tile_edges: int = 0):
    """The LB executor (Figure 3, SSSP_LB): edges of the huge vertices
    get ids 0..total_edges-1 by an exclusive prefix sum over their
    degrees; each id maps back to (src, graph edge) by binary search.
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
    compacted order (Fig 1/5 instrumentation)."""
    f = deg.shape[0]
    tile = (torch.arange(f, dtype=torch.int32, device=deg.device)
            * num_tiles) // max(f, 1)
    return torch.zeros((num_tiles,), dtype=torch.int32,
                       device=deg.device).index_add_(
        0, tile, torch.where(valid, deg, 0))


def _lb_tile_loads(total: int, num_tiles: int) -> np.ndarray:
    """Edge-balanced deal: per-tile loads differ by at most one edge
    (host arithmetic: ``total`` is already on the host)."""
    return (total // num_tiles
            + (np.arange(num_tiles) < total % num_tiles)).astype(np.int64)


# ---------------------------------------------------------------------------
# host-driven round
# ---------------------------------------------------------------------------

def _gather_bin(mask, fidx, deg, row_start, cap: int, fcap: int, v: int):
    """Compact a bin mask into (vidx, deg, row) at capacity ``cap``
    (slots past the bin size become out-of-range sentinels)."""
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
    cnt = cnt.cpu().numpy()            # one-time set-up, not per round
    fcap = next_bucket(int(cnt[0]))
    fidx = compact(union, fcap)
    deg, row_start, valid = _frontier_meta(rg, fidx)
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
            stats["tile_loads_twc"] += _tile_loads(
                bdeg, bvidx < v, cfg.num_tiles).cpu().numpy()
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
        deg, row_start, valid = _frontier_meta(g, fidx)
        bins, lb = _assemble_bins(cnt, plan, cfg, fidx, deg, row_start,
                                  valid, fcap, v)
        labels = _run_plan_host(g, values, labels, frontier, plan, cfg,
                                op, ex, bins, lb, stats)
    labels = labels if batched else labels[0]
    out = (labels, RoundStats(**stats) if stats is not None else None)
    return out + (active,) if return_active else out
