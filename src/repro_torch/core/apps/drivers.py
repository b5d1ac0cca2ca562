"""The paper's five applications: bfs, sssp, cc, kcore, pagerank.

Port of ``repro/core/apps/drivers.py``.  Each driver runs the
data-driven round structure of Section 2.1 of the paper: process the
current worklist, collect the next worklist from label changes, repeat
until it is empty.  ``mode`` selects the round:

* ``"host"`` — ``balancer.relax``: one blocking device->host transfer a
  round, on which the empty-frontier probe rides, so a min-combine
  traversal (bfs, sssp, cc) or kcore of ``r`` rounds reports
  ``host_transfers == r + 1``; pagerank also blocks on its residual, 2
  transfers a round;
* ``"spmd"`` — ``balancer.relax_spmd_directed``: the static-shape round,
  its direction chosen on the device; the loop still fetches liveness
  (and stats) once a round, counted as in host mode;
* ``"fused"`` — the whole traversal as one device loop
  (``balancer.run_fused``, and kcore's and pagerank's own loops here):
  ``host_transfers == 0``.  On the card it is one launch of a captured
  graph (``core.graph_loop``).

Labels, rounds and per-round stats of ``spmd`` and ``fused`` are
bitwise those of ``host`` (pagerank's float add on the card aside: the
huge bin combines with atomics).  The min-combine drivers,
``resume_loop`` and ``step_batch`` take ``direction="push" | "pull" |
"adaptive"``; every driver takes any ``BalancerConfig.backend``.
Drivers follow the graph's device.

A driver called while a ``torch.profiler`` is recording is traced
(``core.spans``): its ``AppResult.spans`` holds its host spans
(``repro.<app>``, ``repro.init``, the program's ``repro.graph.*``,
``repro.fetch``) and, in fused mode, its loop and each round's phases
as the card stamped them; untraced, it is None.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import graph_loop, spans
from ..graph import Graph, INF
from ..frontier import full_frontier, single_source, multi_source_state
from ..balancer import (BalancerConfig, RoundStats, relax,
                        relax_spmd_directed, relax_fused_round, run_fused,
                        fused_stats_host, host_transfer_count,
                        _arm_spans, _fused_stats_init, _note_host_transfer,
                        _put_row, _stamped_while, _unpack_stats)
from .. import operators as ops


@dataclasses.dataclass
class AppResult:
    """Final labels, round count, wall-clock seconds, per-round
    :class:`RoundStats` (with ``collect_stats=True``), the number of
    blocking device->host sync points of the round loop, and, for a
    call traced under a profiler, its ``core.spans.Traversal``."""
    labels: torch.Tensor
    rounds: int
    seconds: float
    stats: Optional[List[RoundStats]] = None
    host_transfers: int = 0
    spans: Optional[spans.Traversal] = None


#: executors whose LB or merge-path edge tile must be a multiple of this
#: (the TPU kernels' lane width: ``repro/kernels/edge_lb.py`` and
#: ``merge_path.py`` assert it)
TILE_LANES = 128


def check_tile(cfg: BalancerConfig) -> None:
    """Refuse a ``lb_tile_edges`` that is not a positive multiple of
    :data:`TILE_LANES` for the ``pallas`` and ``merge_path`` executors,
    in every mode.  The JAX package refuses it (an ``assert``) whenever
    it traces ``edge_lb_map`` or ``merge_path_map``: always in spmd and
    fused mode, in host mode on the first round that reaches one.  The
    port's kernels would run such a tile, so every driver checks once,
    on entry, whether or not a round would reach a kernel.  ``xla``
    takes any tile, as in JAX."""
    t = cfg.lb_tile_edges
    if cfg.executor in ("pallas", "merge_path") and (t <= 0 or
                                                     t % TILE_LANES):
        raise ValueError(f"lb_tile_edges={t}: the {cfg.executor} executor "
                         f"takes a positive multiple of {TILE_LANES}")


def relax_round(g, values, labels, frontier, cfg, op,
                collect_stats=False, mode="host", return_active=False):
    """One balancer round in ``mode`` ``"host"`` | ``"spmd"``; returns
    (labels, RoundStats|None) and, with ``return_active=True``, the host
    ``bool[B]`` liveness of the rows that entered the round.  Both
    modes honour ``cfg.direction``."""
    if mode == "host":
        return relax(g, values, labels, frontier, cfg, op,
                     collect_stats=collect_stats,
                     return_active=return_active)
    if mode != "spmd":
        raise ValueError(f"unknown round mode {mode!r} (host|spmd — "
                         f"'fused' is a loop-level mode, not a "
                         f"single-round one)")
    return relax_spmd_directed(g, values, labels, frontier, cfg, op,
                               collect_stats=collect_stats,
                               return_active=return_active)


def step_batch(g, labels, frontier, cfg, op, mode="host",
               collect_stats=False):
    """One serving step over ``[B, V]`` slot state: a balancer round
    followed by the min-combine frontier update (a vertex re-enters its
    query's worklist exactly when its label improved).  Returns
    ``(labels, next_frontier, RoundStats|None)``; only ``min``-combine
    operators (the apps of :data:`QUERY_APPS`) are valid."""
    if op.combine != "min":
        raise ValueError(f"step_batch serves min-combine point queries; "
                         f"got {op.name} (combine={op.combine!r})")
    check_tile(cfg)
    old = labels
    labels, st = relax_round(g, labels, labels, frontier, cfg, op,
                             collect_stats=collect_stats, mode=mode)
    return labels, labels < old, st


# the point-query applications a serving deployment admits: name ->
# (operator, label fill value)
QUERY_APPS = {
    "bfs": (ops.BFS_HOP, INF),
    "sssp": (ops.SSSP_RELAX, INF),
}


@spans.traced("resume_loop")
def resume_loop(g, labels, frontier, cfg, op, max_rounds: int = 10_000,
                collect_stats: bool = False, mode: str = "host",
                direction: Optional[str] = None) -> "AppResult":
    """Continue a min-combine data-driven loop from explicit
    labels/frontier state until the worklist drains (the incremental
    repair entry point).  Only ``min``-combine operators are monotone
    under resumption, so others are rejected."""
    if op.combine != "min":
        raise ValueError(f"resume_loop repairs min-combine fixpoints; "
                         f"got {op.name} (combine={op.combine!r})")
    cfg = _with_direction(cfg, direction)
    return AppResult(*_loop(g, _identity, labels, frontier, cfg, op,
                            max_rounds, collect_stats, _min_changed,
                            mode=mode))


def _identity(labels):
    return labels


def _min_changed(old, new, frontier):
    """Next worklist of a min-combine loop: the labels that improved."""
    return new < old


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)  # repro: allow[host-sync] -- timing fence (the JAX package's block_until_ready): waits, moves no value


def _fused_result(t_sync: int, t0: float, labels, r, st) -> tuple:
    """``_loop``'s tuple for a fused traversal: after the loop, the
    caller's fetch (the round count, the stat rows in one transfer and,
    traced, the stamp rows in one more)."""
    _sync(labels)
    secs = time.perf_counter() - t0
    with spans.span("repro.fetch"):
        rounds = int(r)
        spans.fetch(labels.device, rounds)
        stats = fused_stats_host(st, rounds)
    return (labels, rounds, secs, stats, host_transfer_count() - t_sync)


def _loop(g: Graph, values_of, labels, frontier, cfg, op,
          max_rounds: int, collect_stats: bool, next_frontier,
          mode: str = "host"):
    """Generic data-driven loop over ``[V]`` or ``[B, V]`` state with
    explicit current/next worklists: each round propagates
    ``values_of(labels)``, then ``next_frontier(old, new, frontier)``
    names the next worklist.  In host/spmd mode convergence is read from
    the round's own ``return_active`` liveness (a slice of the one
    transfer the round pays); ``mode="fused"`` hands the whole loop to
    ``balancer.run_fused`` (min-combine: ``new < old``).  Returns
    ``(labels, rounds, seconds, stats, host_transfers)``."""
    check_tile(cfg)
    t_sync = host_transfer_count()
    if mode == "fused":
        t0 = time.perf_counter()
        labels, _, r, st = run_fused(g, labels, frontier, cfg, op,
                                     max_rounds, collect_stats)
        return _fused_result(t_sync, t0, labels, r, st)
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    rounds = 0
    while rounds < max_rounds:
        old = labels
        new, st, active = relax_round(g, values_of(labels), labels,
                                      frontier, cfg, op, collect_stats,
                                      mode, return_active=True)
        if not bool(np.any(active)):
            break                      # frontier empty: converged
        labels = new
        frontier = next_frontier(old, labels, frontier)
        if collect_stats and st is not None:
            stats.append(st)
        rounds += 1
    _sync(labels)
    return (labels, rounds, time.perf_counter() - t0, stats,
            host_transfer_count() - t_sync)


def _with_direction(cfg: BalancerConfig, direction) -> BalancerConfig:
    """Per-call ``direction=`` override (None keeps ``cfg.direction``)."""
    if direction is None:
        return cfg
    return dataclasses.replace(cfg, direction=direction)


def _single(g: Graph, source: int, cfg, op, max_rounds, collect_stats,
            mode) -> AppResult:
    with spans.span("repro.init"):
        labels = torch.full((g.num_vertices,), int(INF), dtype=torch.int32,
                            device=g.device)
        labels[source] = 0
        frontier = single_source(g.num_vertices, source, g.device)
    return AppResult(*_loop(g, _identity, labels, frontier, cfg, op,
                            max_rounds, collect_stats, _min_changed,
                            mode=mode))


@spans.traced("sssp")
def sssp(g: Graph, source: int, cfg: BalancerConfig = BalancerConfig(),
         max_rounds: int = 10_000, collect_stats: bool = False,
         mode: str = "host", direction: Optional[str] = None) -> AppResult:
    """Bellman-Ford style data-driven SSSP (min-combine relaxation)."""
    return _single(g, source, _with_direction(cfg, direction),
                   ops.SSSP_RELAX, max_rounds, collect_stats, mode)


@spans.traced("bfs")
def bfs(g: Graph, source: int, cfg: BalancerConfig = BalancerConfig(),
        max_rounds: int = 10_000, collect_stats: bool = False,
        mode: str = "host", direction: Optional[str] = None) -> AppResult:
    """Data-driven BFS: hop-count labels via min-combine rounds."""
    return _single(g, source, _with_direction(cfg, direction),
                   ops.BFS_HOP, max_rounds, collect_stats, mode)


# ---- batched multi-source queries ------------------------------------------

def _batch_loop(g: Graph, sources, cfg, op, max_rounds, collect_stats,
                mode) -> AppResult:
    """One convergence loop for B sources over ``[B, V]`` state: each
    round is ONE balancer invocation serving the whole batch, and a
    query whose frontier row empties stops contributing to the union."""
    with spans.span("repro.init"):
        labels, frontier = multi_source_state(g.num_vertices, sources, INF,
                                              g.device)
    return AppResult(*_loop(g, _identity, labels, frontier, cfg, op,
                            max_rounds, collect_stats, _min_changed,
                            mode=mode))


@spans.traced("sssp_batch")
def sssp_batch(g: Graph, sources, cfg: BalancerConfig = BalancerConfig(),
               max_rounds: int = 10_000, collect_stats: bool = False,
               mode: str = "host",
               direction: Optional[str] = None) -> AppResult:
    """Batched multi-source SSSP: ``labels[b]`` equals (bitwise) the
    single-source :func:`sssp` labels for ``sources[b]``."""
    return _batch_loop(g, sources, _with_direction(cfg, direction),
                       ops.SSSP_RELAX, max_rounds, collect_stats, mode)


@spans.traced("bfs_batch")
def bfs_batch(g: Graph, sources, cfg: BalancerConfig = BalancerConfig(),
              max_rounds: int = 10_000, collect_stats: bool = False,
              mode: str = "host",
              direction: Optional[str] = None) -> AppResult:
    """Batched multi-source BFS (see :func:`sssp_batch`)."""
    return _batch_loop(g, sources, _with_direction(cfg, direction),
                       ops.BFS_HOP, max_rounds, collect_stats, mode)


@spans.traced("cc")
def cc(g: Graph, cfg: BalancerConfig = BalancerConfig(),
       max_rounds: int = 10_000, collect_stats: bool = False,
       mode: str = "host", direction: Optional[str] = None) -> AppResult:
    """Connected components by min-label propagation (weakly connected
    components when ``g`` is symmetrized).  On cc's dense early
    frontiers, adaptive rounds run as pulls."""
    cfg = _with_direction(cfg, direction)
    with spans.span("repro.init"):
        comp = torch.arange(g.num_vertices, dtype=torch.int32,
                            device=g.device)
        frontier = full_frontier(g.num_vertices, g.device)
    return AppResult(*_loop(g, _identity, comp, frontier, cfg, ops.CC_MIN,
                            max_rounds, collect_stats, _min_changed,
                            mode=mode))


def _kcore_loop(g: Graph, deg, frontier, dead_acc, k: int,
                cfg: BalancerConfig, max_rounds: int, collect_stats: bool):
    """kcore's whole peeling loop as ONE :func:`graph_loop.while_`: the
    round is the device-resident ``balancer.relax_fused_round`` and the
    newly-dead bookkeeping of the host loop moves into the body.
    Returns ``(in_core, rounds)`` plus the stat rows."""
    carry = (torch.zeros((), dtype=torch.int32, device=deg.device), deg,
             dead_acc, frontier)
    if collect_stats:
        carry += (_fused_stats_init(max_rounds, 1, cfg.num_tiles,
                                    deg.device),)

    def cond(r, deg, dead, fr, *rows):
        return (r < max_rounds) & fr.any()

    def body(r, deg, dead, fr, *rows):
        new_deg, _, _, _, st = relax_fused_round(
            g, None, None, deg[None], deg[None], fr[None], cfg,
            ops.KCORE_DEC, None, collect_stats)
        new_deg = new_deg[0]
        newly_dead = (new_deg < k) & ~dead
        if collect_stats:
            rows = (_put_row(rows[0], r, st),)
        return (r + 1, new_deg, dead | newly_dead, newly_dead) + rows

    r, _, dead, _, *rows = _stamped_while(cond, body, carry)
    return ((~dead).to(torch.int32), r, *rows)


def _kcore_fused(g: Graph, deg, frontier, dead_acc, k: int,
                 cfg: BalancerConfig, max_rounds: int, collect_stats: bool):
    """:func:`_kcore_loop` as one program (one graph launch on the card):
    ``(in_core, rounds, stats)`` on the device, ``stats`` a
    ``RoundStatsDev`` of the round rows or None."""
    _arm_spans(deg.device, cfg)
    in_core, r, *rows = graph_loop.run(
        g, ("kcore", k, cfg, max_rounds, collect_stats),
        lambda d, f, da: _kcore_loop(g, d, f, da, k, cfg, max_rounds,
                                     collect_stats),
        deg, frontier, dead_acc)
    return in_core, r, (_unpack_stats(rows[0], cfg.num_tiles) if rows
                        else None)


@spans.traced("kcore")
def kcore(g: Graph, k: int, cfg: BalancerConfig = BalancerConfig(),
          max_rounds: int = 10_000, collect_stats: bool = False,
          mode: str = "host") -> AppResult:
    """k-core decomposition: ``labels[v] = 1`` if v is in the k-core.

    Push formulation (integer add): when a vertex dies its neighbours
    lose one degree.  Expects a symmetrized graph."""
    check_tile(cfg)
    deg = g.out_degrees()
    alive = deg >= k
    frontier = ~alive & (deg > 0)          # initially-dead vertices push
    dead_acc = frontier | ~alive
    t_sync = host_transfer_count()
    if mode == "fused":
        # validate direction x operator as the per-round modes do
        if cfg.direction != "push":
            ops.as_pull(ops.KCORE_DEC)     # raises: add-combine op
        t0 = time.perf_counter()
        in_core, r, st = _kcore_fused(g, deg, frontier, dead_acc, int(k),
                                      cfg, max_rounds, collect_stats)
        return AppResult(*_fused_result(t_sync, t0, in_core, r, st))
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    rounds = 0
    while rounds < max_rounds:
        new_deg, st, active = relax_round(g, deg, deg, frontier, cfg,
                                          ops.KCORE_DEC, collect_stats,
                                          mode, return_active=True)
        if not bool(np.any(active)):
            break                      # no vertex died last round
        deg = new_deg
        newly_dead = (deg < k) & ~dead_acc
        dead_acc = dead_acc | newly_dead
        frontier = newly_dead
        if collect_stats and st is not None:
            stats.append(st)
        rounds += 1
    in_core = (~dead_acc).to(torch.int32)
    _sync(in_core)
    return AppResult(in_core, rounds, time.perf_counter() - t0, stats,
                     host_transfer_count() - t_sync)


def _pr_round_math(rank, inv_out, sink, acc, damping: float):
    """The float32 arithmetic around PageRank's round, in the operation
    order of ``repro.core.apps.drivers._pr_round_math``.  With
    ``acc=None``: the pre-round ``(contrib, dangling)``; with the
    scattered ``acc``: the post-round ``(new_rank, delta)``."""
    n = rank.shape[0]
    if acc is None:
        contrib = rank * inv_out
        dangling = torch.where(sink, rank, 0.0).sum()
        return contrib, dangling
    dangling = torch.where(sink, rank, 0.0).sum()
    new_rank = (1.0 - damping) / n + damping * (acc + dangling / n)
    delta = (new_rank - rank).abs().max()
    return new_rank, delta


def _pagerank_loop(rg: Graph, inv_out, sink, damping: float, tol: float,
                    cfg: BalancerConfig, max_rounds: int,
                    collect_stats: bool):
    """PageRank's whole power iteration as ONE :func:`graph_loop.while_`:
    the residual check that blocks the host loop every round becomes
    part of the loop condition on the device.  The arithmetic around the
    round is :func:`_pr_round_math`, the host loop's, so both modes
    round alike.  Returns ``(rank, rounds)`` plus the stat rows."""
    n, dev = inv_out.shape[0], inv_out.device
    frontier = full_frontier(n, dev)
    carry = (torch.zeros((), dtype=torch.int32, device=dev),
             torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev),
             torch.full((), float("inf"), dtype=torch.float32, device=dev))
    if collect_stats:
        carry += (_fused_stats_init(max_rounds, 1, cfg.num_tiles, dev),)

    def cond(r, rank, delta, *rows):
        return (r < max_rounds) & (delta >= tol)

    def body(r, rank, delta, *rows):
        contrib, _ = _pr_round_math(rank, inv_out, sink, None, damping)
        acc = torch.zeros((n,), dtype=torch.float32, device=dev)
        # pull: gather contrib at in-neighbours, scatter-add at anchor
        acc, _, _, _, st = relax_fused_round(
            rg, None, None, contrib[None], acc[None], frontier[None], cfg,
            ops.PR_PULL, None, collect_stats)
        new_rank, delta = _pr_round_math(rank, inv_out, sink, acc[0],
                                         damping)
        if collect_stats:
            rows = (_put_row(rows[0], r, st),)
        return (r + 1, new_rank, delta) + rows

    r, rank, _, *rows = _stamped_while(cond, body, carry)
    return (rank, r, *rows)


def _pagerank_fused(rg: Graph, inv_out, sink, damping: float, tol: float,
                    cfg: BalancerConfig, max_rounds: int,
                    collect_stats: bool):
    """:func:`_pagerank_loop` as one program, cached on ``rg``, the graph
    it reads: ``(rank, rounds, stats)`` on the device."""
    _arm_spans(inv_out.device, cfg)
    rank, r, *rows = graph_loop.run(
        rg, ("pagerank", damping, tol, cfg, max_rounds, collect_stats),
        lambda io, sk: _pagerank_loop(rg, io, sk, damping, tol, cfg,
                                      max_rounds, collect_stats),
        inv_out, sink)
    return rank, r, (_unpack_stats(rows[0], cfg.num_tiles) if rows
                     else None)


@spans.traced("pagerank")
def pagerank(g: Graph, damping: float = 0.85, tol: float = 1e-6,
             cfg: BalancerConfig = BalancerConfig(),
             max_rounds: int = 1000, collect_stats: bool = False,
             rg: Optional[Graph] = None, mode: str = "host") -> AppResult:
    """Pull-style topology-driven PageRank (residual tolerance).

    Each round scatter-adds ``rank * inv_out`` of the in-neighbours at
    every vertex over the reverse CSR (float32 add), and dangling
    vertices (out-degree 0) redistribute their mass uniformly, so
    ``sum(rank) == 1`` holds on graphs with sinks.  Host and spmd mode
    pay two counted transfers a round (the round's, the residual
    check); fused mode none.

    Against ``repro.core.apps.drivers.pagerank`` on the same graph the
    bound is: rounds within one of JAX's, and ranks within ``tol``
    absolute.  The arithmetic follows JAX's operation order, but XLA
    contracts the update into an FMA and sums in another order, so a
    rank may sit an ulp or two away and ``delta`` carries about 1e-8 of
    noise; when the residual lands that close to ``tol``, one package
    stops a round before the other (``rtol`` 2e-6 holds only when the
    rounds agree)."""
    check_tile(cfg)
    n = g.num_vertices
    if rg is None:
        rg = g.reverse()                   # pull traverses in-edges
    outdeg = g.out_degrees().to(torch.float32)
    inv_out = torch.where(outdeg > 0, 1.0 / torch.clamp(outdeg, min=1.0),
                          0.0)
    sink = outdeg == 0
    t_sync = host_transfer_count()
    if mode == "fused":
        if cfg.direction != "push":
            ops.as_pull(ops.PR_PULL)       # raises: not a push-min op
        t0 = time.perf_counter()
        rank, r, st = _pagerank_fused(rg, inv_out, sink, float(damping),
                                      float(tol), cfg, max_rounds,
                                      collect_stats)
        return AppResult(*_fused_result(t_sync, t0, rank, r, st))
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
    frontier = full_frontier(n, g.device)
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    rounds = 0
    while rounds < max_rounds:
        contrib, _ = _pr_round_math(rank, inv_out, sink, None,
                                    float(damping))
        acc = torch.zeros((n,), dtype=torch.float32, device=g.device)
        # pull: gather contrib at in-neighbours, scatter-add at anchor
        acc, st = relax_round(rg, contrib, acc, frontier, cfg,
                              ops.PR_PULL, collect_stats, mode)
        new_rank, delta_dev = _pr_round_math(rank, inv_out, sink, acc,
                                             float(damping))
        delta = float(delta_dev)
        _note_host_transfer()          # the residual check blocks
        rank = new_rank
        if collect_stats and st is not None:
            stats.append(st)
        rounds += 1
        if delta < tol:
            break
    _sync(rank)
    return AppResult(rank, rounds, time.perf_counter() - t0, stats,
                     host_transfer_count() - t_sync)
