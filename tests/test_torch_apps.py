"""Port parity: the bfs / sssp drivers of ``repro_torch`` (single-source
and batched ``[B, V]``) against the JAX drivers, on the same CSR.

Exact: labels, round counts, every per-round ``RoundStats`` field and
``host_transfers`` (== rounds + 1: one counted transfer per round plus
the empty-frontier probe).  The sweep covers the 4 strategies x both
deals through the torch-ops / ``xla`` pair; the ``alb`` cases also run
``use_pallas=True`` on both sides (the port's CUDA pair computes its
plain versions on CPU tensors; the Pallas pair runs in interpret
mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core.apps import drivers as jd
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core.apps import drivers as td

STRATEGIES = ["vertex", "twc", "edge_lb", "alb"]
APPS = ["sssp", "bfs", "sssp_batch", "bfs_batch"]


@pytest.fixture(scope="module")
def rmat_pair():
    gj = jg.rmat(9, 8, seed=3)
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                             device="cpu")
    src = jg.highest_out_degree_vertex(gj)
    return gj, gt, src


def run_both(gj, gt, app, source, **kw):
    arg = source if not app.endswith("_batch") else \
        [source, 1, 2, gj.num_vertices - 1]
    rj = getattr(jd, app)(gj, arg, jb.BalancerConfig(**kw),
                          collect_stats=True)
    rt = getattr(td, app)(gt, arg, tb.BalancerConfig(**kw),
                          collect_stats=True)
    return rj, rt


def assert_results_equal(rj, rt):
    assert rt.labels.dtype == torch.int32
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))
    assert rt.rounds == rj.rounds
    assert rt.host_transfers == rj.host_transfers == rt.rounds + 1
    assert len(rt.stats) == len(rj.stats) == rt.rounds
    for sj, st in zip(rj.stats, rt.stats):
        for f in sj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          np.asarray(getattr(sj, f)),
                                          err_msg=f)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_drivers_match_jax(rmat_pair, app, strategy, distribution):
    gj, gt, src = rmat_pair
    rj, rt = run_both(gj, gt, app, src, strategy=strategy,
                      distribution=distribution, threshold=64)
    assert_results_equal(rj, rt)


@pytest.mark.parametrize("app", ["sssp", "bfs_batch"])
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_alb_kernel_pair_matches_jax_pallas(rmat_pair, app, distribution):
    gj, gt, src = rmat_pair
    rj, rt = run_both(gj, gt, app, src, strategy="alb",
                      distribution=distribution, threshold=64,
                      use_pallas=True)
    assert_results_equal(rj, rt)
    assert any(s.lb_invoked for s in rt.stats)


@pytest.mark.parametrize("app,strategy", [("sssp", "alb"),
                                          ("bfs_batch", "twc")])
def test_drivers_match_jax_on_road_grid(app, strategy):
    """A high-diameter, low-degree input: many rounds, no huge bin."""
    gj = jg.road_grid(12)
    gt = tg.road_grid(12, device="cpu")
    rj, rt = run_both(gj, gt, app, 0, strategy=strategy)
    assert_results_equal(rj, rt)
    assert rt.rounds > 20


def test_batch_rows_equal_single_source_runs(rmat_pair):
    _, gt, src = rmat_pair
    cfg = tb.BalancerConfig(strategy="alb", threshold=64, use_pallas=True)
    sources = [src, 5, 77]
    batch = td.sssp_batch(gt, sources, cfg)
    for b, s in enumerate(sources):
        assert torch.equal(batch.labels[b], td.sssp(gt, s, cfg).labels)


def test_labels_match_independent_oracle(rmat_pair):
    """sssp against scipy's Dijkstra, bfs against its unweighted form."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    _, gt, src = rmat_pair
    v = gt.num_vertices
    m = csr_matrix((gt.edge_w.numpy().astype(np.float64),
                    gt.col_idx.numpy(), gt.row_ptr.numpy()), shape=(v, v))
    cfg = tb.BalancerConfig(use_pallas=True, threshold=64)
    for app, unweighted in ((td.sssp, False), (td.bfs, True)):
        d = shortest_path(m, method="D", unweighted=unweighted,
                          indices=src)
        want = np.where(np.isinf(d), 1 << 30, d).astype(np.int64)
        np.testing.assert_array_equal(app(gt, src, cfg).labels.numpy(),
                                      want)


def test_driver_modes_of_later_slices_raise(rmat_pair):
    """Every driver raises ValueError on a mode it does not know; the
    static-shape and fused modes of the later slice run."""
    _, gt, src = rmat_pair
    for mode in ("warp", "Fused", ""):
        for run in (lambda: td.sssp(gt, src, mode=mode),
                    lambda: td.bfs(gt, src, mode=mode),
                    lambda: td.cc(gt, mode=mode),
                    lambda: td.kcore(gt, 3, mode=mode),
                    lambda: td.pagerank(gt, mode=mode, max_rounds=2)):
            with pytest.raises(ValueError, match="unknown round mode"):
                run()
    for mode in ("spmd", "fused"):
        assert td.bfs(gt, src, mode=mode).rounds > 0
