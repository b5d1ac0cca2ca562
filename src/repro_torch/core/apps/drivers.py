"""Application drivers: bfs and sssp, single-source and batched.

Port of the host-mode drivers of ``repro/core/apps/drivers.py``.  Each
driver runs the data-driven round structure of Section 2.1 of the
paper: process the current worklist, collect the next worklist from
label changes (``new < old``), repeat until it is empty.  Every round is
one ``balancer.relax`` call, which pays exactly one blocking
device->host transfer; the empty-frontier probe rides on it, so a
traversal of ``r`` rounds reports ``host_transfers == r + 1``.

Drivers follow the graph's device.  ``mode="spmd"`` / ``"fused"`` (the
static-shape and fused round modes) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..graph import Graph, INF
from ..frontier import single_source, multi_source_state
from ..balancer import (BalancerConfig, RoundStats, relax,
                        host_transfer_count)
from .. import operators as ops


@dataclasses.dataclass
class AppResult:
    """Final labels, round count, wall-clock seconds, per-round
    :class:`RoundStats` (with ``collect_stats=True``) and the number of
    blocking device->host sync points of the round loop."""
    labels: torch.Tensor
    rounds: int
    seconds: float
    stats: Optional[List[RoundStats]] = None
    host_transfers: int = 0


def _host_mode(mode: str) -> None:
    if mode in ("spmd", "fused"):
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP Queue 1 item 5, "
            f"static-shape and fused round modes)")
    if mode != "host":
        raise ValueError(f"unknown round mode {mode!r}")


def relax_round(g, values, labels, frontier, cfg, op,
                collect_stats=False, mode="host", return_active=False):
    """One balancer round; returns (labels, RoundStats|None) and, with
    ``return_active=True``, the host ``bool[B]`` liveness of the rows
    that entered the round."""
    _host_mode(mode)
    return relax(g, values, labels, frontier, cfg, op,
                 collect_stats=collect_stats, return_active=return_active)


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _loop(g: Graph, labels, frontier, cfg, op, max_rounds: int,
          collect_stats: bool, mode: str = "host"):
    """The min-combine data-driven loop over ``[V]`` or ``[B, V]``
    state.  Convergence is read from the round's own ``return_active``
    liveness (a slice of the one transfer the round pays).  Returns
    ``(labels, rounds, seconds, stats, host_transfers)``."""
    _host_mode(mode)
    t_sync = host_transfer_count()
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    rounds = 0
    while rounds < max_rounds:
        old = labels
        new, st, active = relax_round(g, labels, labels, frontier, cfg,
                                      op, collect_stats, mode,
                                      return_active=True)
        if not bool(np.any(active)):
            break                      # frontier empty: converged
        labels = new
        frontier = labels < old
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
    labels = torch.full((g.num_vertices,), int(INF), dtype=torch.int32,
                        device=g.device)
    labels[source] = 0
    frontier = single_source(g.num_vertices, source, g.device)
    return AppResult(*_loop(g, labels, frontier, cfg, op, max_rounds,
                            collect_stats, mode))


def sssp(g: Graph, source: int, cfg: BalancerConfig = BalancerConfig(),
         max_rounds: int = 10_000, collect_stats: bool = False,
         mode: str = "host", direction: Optional[str] = None) -> AppResult:
    """Bellman-Ford style data-driven SSSP (min-combine relaxation)."""
    return _single(g, source, _with_direction(cfg, direction),
                   ops.SSSP_RELAX, max_rounds, collect_stats, mode)


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
    labels, frontier = multi_source_state(g.num_vertices, sources, INF,
                                          g.device)
    return AppResult(*_loop(g, labels, frontier, cfg, op, max_rounds,
                            collect_stats, mode))


def sssp_batch(g: Graph, sources, cfg: BalancerConfig = BalancerConfig(),
               max_rounds: int = 10_000, collect_stats: bool = False,
               mode: str = "host",
               direction: Optional[str] = None) -> AppResult:
    """Batched multi-source SSSP: ``labels[b]`` equals (bitwise) the
    single-source :func:`sssp` labels for ``sources[b]``."""
    return _batch_loop(g, sources, _with_direction(cfg, direction),
                       ops.SSSP_RELAX, max_rounds, collect_stats, mode)


def bfs_batch(g: Graph, sources, cfg: BalancerConfig = BalancerConfig(),
              max_rounds: int = 10_000, collect_stats: bool = False,
              mode: str = "host",
              direction: Optional[str] = None) -> AppResult:
    """Batched multi-source BFS (see :func:`sssp_batch`)."""
    return _batch_loop(g, sources, _with_direction(cfg, direction),
                       ops.BFS_HOP, max_rounds, collect_stats, mode)
