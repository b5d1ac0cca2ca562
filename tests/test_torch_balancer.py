"""Port parity: the ALB planner and the host-driven round
(``repro_torch.core.balancer``) against the JAX package, on the same
numpy state.  Exact: labels, the liveness vector and every
``RoundStats`` field must be equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops

STRATEGIES = ["vertex", "twc", "edge_lb", "alb"]


@pytest.fixture(scope="module")
def graphs():
    gj = jg.rmat(9, 8, seed=3)
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                             device="cpu")
    return gj, gt


def assert_stats_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)
        else:
            assert x == y, (f, x, y)


def round_state(v, b, seed):
    """Labels (finite and INF), values aliasing them, a random frontier
    that always holds the hub (vertex 0 of this rmat)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 500, (b, v)).astype(np.int32)
    labels[rng.random((b, v)) < 0.3] = jg.INF
    frontier = rng.random((b, v)) < 0.25
    frontier[:, 0] = True
    return labels, frontier


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("batch", [None, 3])
def test_relax_matches_jax(graphs, strategy, distribution, batch):
    gj, gt = graphs
    labels, frontier = round_state(gj.num_vertices, batch or 1, 17)
    if batch is None:
        labels, frontier = labels[0], frontier[0]
    kw = dict(strategy=strategy, distribution=distribution, threshold=64)
    out_j = jb.relax(gj, jnp.asarray(labels), jnp.asarray(labels),
                     jnp.asarray(frontier), jb.BalancerConfig(**kw),
                     jops.SSSP_RELAX, collect_stats=True,
                     return_active=True)
    lt = torch.from_numpy(labels.copy())
    out_t = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                     tb.BalancerConfig(**kw), tops.SSSP_RELAX,
                     collect_stats=True, return_active=True)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert_stats_equal(out_j[1], out_t[1])
    np.testing.assert_array_equal(out_t[2], out_j[2])
    # the round wrote neither its input labels nor its values
    np.testing.assert_array_equal(lt.numpy(), labels)
    if strategy in ("edge_lb", "alb"):
        assert out_t[1].lb_invoked


@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("op", ["BFS_HOP", "KCORE_DEC"])
def test_relax_kernel_pair_matches_jax_pallas(graphs, distribution, op):
    """``use_pallas=True`` on both sides: the port's CUDA pair (its plain
    versions on CPU tensors) against the Pallas pair (interpret mode),
    for a min-combine and an add-combine operator."""
    gj, gt = graphs
    labels, frontier = round_state(gj.num_vertices, 2, 5)
    if op == "KCORE_DEC":
        labels = np.minimum(labels, 1000)
    kw = dict(strategy="alb", distribution=distribution, threshold=64,
              use_pallas=True)
    out_j = jb.relax(gj, jnp.asarray(labels), jnp.asarray(labels),
                     jnp.asarray(frontier), jb.BalancerConfig(**kw),
                     getattr(jops, op), collect_stats=True)
    lt = torch.from_numpy(labels.copy())
    out_t = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                     tb.BalancerConfig(**kw), getattr(tops, op),
                     collect_stats=True)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert_stats_equal(out_j[1], out_t[1])


def test_relax_empty_frontier_counts_one_transfer(graphs):
    _, gt = graphs
    lab = torch.zeros(gt.num_vertices, dtype=torch.int32)
    before = tb.host_transfer_count()
    out, st, active = tb.relax(gt, lab, lab, torch.zeros_like(lab,
                                                             dtype=bool),
                               tb.BalancerConfig(), tops.BFS_HOP,
                               collect_stats=True, return_active=True)
    assert torch.equal(out, lab) and st is None and not active.any()
    assert tb.host_transfer_count() - before == 1


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("threshold", [64, 1024, 100])
def test_make_plan_matches(strategy, threshold):
    pj = jb.make_plan(jb.BalancerConfig(strategy=strategy,
                                        threshold=threshold))
    pt = tb.make_plan(tb.BalancerConfig(strategy=strategy,
                                        threshold=threshold))
    assert [dataclasses.astuple(s) for s in pj.bins] == \
        [dataclasses.astuple(s) for s in pt.bins]
    assert (pj.lb, pj.direction) == (pt.lb, pt.direction)
    assert [s.static_passes() for s in pj.bins] == \
        [s.static_passes() for s in pt.bins]


def test_config_fields_and_defaults_match():
    fj = {f.name: f.default for f in dataclasses.fields(jb.BalancerConfig)}
    ft = {f.name: f.default for f in dataclasses.fields(tb.BalancerConfig)}
    assert fj == ft
    for kw in ({}, {"use_pallas": True}, {"backend": "merge_path"},
               {"backend": "xla", "use_pallas": True}):
        assert jb.BalancerConfig(**kw).executor == \
            tb.BalancerConfig(**kw).executor


@pytest.mark.parametrize("wire", ["identity", "delta", "bitmap", "quantize",
                                  "quantize:uint16", "quantize:int8",
                                  "quantize:float16", "zstd", "quantize:",
                                  "identity:x"])
def test_wire_syntax_matches(wire):
    def ok(make):
        try:
            make(wire=wire)
            return True
        except ValueError:
            return False
    assert ok(jb.BalancerConfig) == ok(tb.BalancerConfig)


def test_resolve_direction_matches():
    for d in ("push", "pull", "adaptive"):
        cj, ct = jb.BalancerConfig(direction=d), tb.BalancerConfig(direction=d)
        for nf, mf in ((1, 1), (100, 10), (5, 5000), (1000, 100000)):
            assert jb.resolve_direction(cj, nf, mf, 2000, 16000) == \
                tb.resolve_direction(ct, nf, mf, 2000, 16000)


def test_later_slices_raise_not_implemented(graphs):
    """relax_round runs host and spmd rounds; "fused" is a loop-level
    mode and any other name is unknown: both raise ValueError."""
    from repro_torch.core.apps import drivers as td
    _, gt = graphs
    lab = torch.zeros((1, gt.num_vertices), dtype=torch.int32)
    fr = torch.ones_like(lab, dtype=torch.bool)
    for mode in ("fused", "warp"):
        with pytest.raises(ValueError, match="unknown round mode"):
            td.relax_round(gt, lab, lab, fr, tb.BalancerConfig(),
                           tops.BFS_HOP, mode=mode)
    host = td.relax_round(gt, lab, lab, fr, tb.BalancerConfig(),
                          tops.BFS_HOP, mode="host")
    spmd = td.relax_round(gt, lab, lab, fr, tb.BalancerConfig(),
                          tops.BFS_HOP, mode="spmd")
    assert torch.equal(host[0], spmd[0])


# ---- direction x backend ---------------------------------------------------

BACKENDS = ["xla", "pallas", "merge_path"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", ["push", "pull", "adaptive"])
@pytest.mark.parametrize("batch", [None, 3])
def test_relax_directions_match_jax(graphs, backend, direction, batch):
    """Labels, liveness and every RoundStats field (``direction``
    included) equal to JAX; the pull round also equals the push round."""
    gj, gt = graphs
    labels, frontier = round_state(gj.num_vertices, batch or 1, 23)
    if batch is None:
        labels, frontier = labels[0], frontier[0]
    kw = dict(strategy="alb", threshold=64, backend=backend,
              direction=direction)
    out_j = jb.relax(gj, jnp.asarray(labels), jnp.asarray(labels),
                     jnp.asarray(frontier), jb.BalancerConfig(**kw),
                     jops.SSSP_RELAX, collect_stats=True,
                     return_active=True)
    lt = torch.from_numpy(labels.copy())
    out_t = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                     tb.BalancerConfig(**kw), tops.SSSP_RELAX,
                     collect_stats=True, return_active=True)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    assert_stats_equal(out_j[1], out_t[1])
    np.testing.assert_array_equal(out_t[2], out_j[2])
    np.testing.assert_array_equal(lt.numpy(), labels)
    if direction == "pull":
        assert out_t[1].direction == "pull"
    push = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                    tb.BalancerConfig(strategy="alb", threshold=64),
                    tops.SSSP_RELAX)
    assert torch.equal(out_t[0], push[0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_relax_pull_operator_add_matches_jax(graphs, backend):
    """pagerank's round: the pull operator ``PR_PULL`` (float add) over
    the reverse CSR with a full frontier."""
    gj, gt = graphs
    rng = np.random.default_rng(8)
    contrib = (rng.random(gj.num_vertices) * 1e-3).astype(np.float32)
    acc = np.zeros(gj.num_vertices, np.float32)
    fr = np.ones(gj.num_vertices, bool)
    kw = dict(strategy="alb", threshold=64, backend=backend)
    rgj = gj.reverse()
    out_j = jb.relax(rgj, jnp.asarray(contrib), jnp.asarray(acc),
                     jnp.asarray(fr), jb.BalancerConfig(**kw),
                     jops.PR_PULL, collect_stats=True)
    out_t = tb.relax(gt.reverse(), torch.from_numpy(contrib),
                     torch.from_numpy(acc), torch.from_numpy(fr),
                     tb.BalancerConfig(**kw), tops.PR_PULL,
                     collect_stats=True)
    # float32 sums, scattered in one order on both sides here
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-6, atol=0)
    assert_stats_equal(out_j[1], out_t[1])


@pytest.mark.parametrize("direction", ["pull", "adaptive"])
def test_direction_needs_push_min_operator(graphs, direction):
    gj, gt = graphs
    lab = np.zeros((1, gj.num_vertices), np.int32)
    fr = np.ones_like(lab, dtype=bool)
    with pytest.raises(ValueError):
        jb.relax(gj, jnp.asarray(lab), jnp.asarray(lab), jnp.asarray(fr),
                 jb.BalancerConfig(direction=direction), jops.KCORE_DEC)
    with pytest.raises(ValueError, match="push min-combine"):
        tb.relax(gt, torch.from_numpy(lab), torch.from_numpy(lab),
                 torch.from_numpy(fr), tb.BalancerConfig(direction=direction),
                 tops.KCORE_DEC)


def test_pull_enum_cache_keys_and_version():
    gt = tg.rmat(8, 8, seed=1, device="cpu")
    pe = tb._pull_enum(gt, tb.BalancerConfig(direction="pull"))
    # direction and deal fields share the entry; merge_path is apart
    assert tb._pull_enum(gt, tb.BalancerConfig(
        direction="adaptive", distribution="blocked")) is pe
    mp = tb._pull_enum(gt, tb.BalancerConfig(backend="merge_path"))
    assert mp is not pe and mp.bins == () and mp.lb is not None
    assert pe.rg is gt.reverse()
    before = tb.host_transfer_count()
    gt.bump_version()
    pe2 = tb._pull_enum(gt, tb.BalancerConfig(direction="pull"))
    assert pe2 is not pe and pe2.rg is gt.reverse()
    assert len(gt.__dict__["_pull_enum_cache"]) == 1
    # the enumeration's one transfer is set-up, not a per-round one
    assert tb.host_transfer_count() == before
    np.testing.assert_array_equal(
        pe2.emask.numpy(), np.diff(gt.reverse().row_ptr.numpy()) > 0)
