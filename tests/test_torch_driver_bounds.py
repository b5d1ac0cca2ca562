"""Two driver contracts of the port against ``repro.core.apps.drivers``:

* pagerank's bound: rounds within one of JAX's and ranks within ``tol``
  absolute (XLA's FMA and summation order move a rank by an ulp or two,
  and a residual that lands within that noise of ``tol`` stops one
  package a round before the other: seed 64 below does, 20 rounds in
  JAX and 19 in the port);
* the edge tile: ``lb_tile_edges`` that is not a multiple of 128 is
  refused with ``ValueError`` on entry to every driver, for the
  ``pallas`` and ``merge_path`` executors in every mode, where JAX's
  kernels assert; ``xla`` takes it, as in JAX.  JAX asserts only when a
  round traces ``edge_lb_map`` or ``merge_path_map``, so where it
  reaches neither (host-mode ``pallas`` with no huge bin, ``kcore``
  with no round outside fused mode) it runs and the port refuses: a
  standing difference, held by
  ``test_tile_refused_where_jax_reaches_no_kernel``.
"""
import numpy as np
import pytest

from hypothesis import given, settings, strategies as st

from repro.core import graph as jg
from repro.core.apps import drivers as jd
from repro.core.balancer import BalancerConfig as JConfig
from repro_torch.core import graph as tg
from repro_torch.core.apps import drivers as td
from repro_torch.core.balancer import BalancerConfig as TConfig

TOL = 1e-6                       # pagerank's default residual tolerance


def pagerank_pair(src, dst, n):
    rj = jd.pagerank(jg.from_edge_list(src, dst, n))
    rt = td.pagerank(tg.from_edge_list(src, dst, n, device="cpu"))
    return rj, rt


def test_pagerank_seed64_stops_a_round_apart_within_tol():
    """The case that found the bound: 20 rounds in JAX, 19 in the port,
    ranks within ``tol`` absolute (measured 6.8e-7)."""
    rng = np.random.default_rng(64)
    src, dst = rng.integers(0, 30, 64), rng.integers(0, 30, 64)
    rj, rt = pagerank_pair(src, dst, 30)
    assert (rj.rounds, rt.rounds) == (20, 19)
    np.testing.assert_allclose(rt.labels.numpy(), np.asarray(rj.labels),
                               rtol=0, atol=TOL)


@st.composite
def edge_lists(draw):
    n = draw(st.integers(4, 48))
    m = draw(st.integers(1, 3 * n))
    src = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
    dst = draw(st.lists(st.integers(0, n - 1), min_size=m, max_size=m))
    return np.asarray(src, np.int64), np.asarray(dst, np.int64), n


@settings(max_examples=20, deadline=None)
@given(edges=edge_lists())
def test_pagerank_bound_on_random_graphs(edges):
    """Property: on any small graph (sinks, self loops, parallel edges)
    the port's pagerank stops within one round of JAX's, with ranks
    within ``tol`` absolute (400 seeded graphs of this kind: at most
    8.6e-7 when the rounds differ, 2.4e-7 when they agree)."""
    rj, rt = pagerank_pair(*edges)
    assert abs(rj.rounds - rt.rounds) <= 1
    np.testing.assert_allclose(rt.labels.numpy(), np.asarray(rj.labels),
                               rtol=0, atol=TOL)


# ---- the edge tile ------------------------------------------------------------

def hub_edges():
    """Vertex 0 with 40 out-edges (the huge bin at ``threshold=16``) and
    a sparse rest."""
    rng = np.random.default_rng(0)
    n = 48
    src = np.concatenate([np.zeros(40, np.int64), rng.integers(0, n, 40)])
    dst = np.concatenate([np.arange(1, 41), rng.integers(0, n, 40)])
    return src, dst, n


def port_apps(g, sym, cfg, mode):
    """Every driver of the port, one call each."""
    return {
        "sssp": lambda: td.sssp(g, 0, cfg, mode=mode),
        "bfs": lambda: td.bfs(g, 0, cfg, mode=mode),
        "sssp_batch": lambda: td.sssp_batch(g, [0, 1], cfg, mode=mode),
        "bfs_batch": lambda: td.bfs_batch(g, [0, 1], cfg, mode=mode),
        "cc": lambda: td.cc(sym, cfg, mode=mode),
        "kcore": lambda: td.kcore(sym, 2, cfg, mode=mode),
        "kcore_no_rounds": lambda: td.kcore(sym, 2, cfg, mode=mode,
                                            max_rounds=0),
        "pagerank": lambda: td.pagerank(g, cfg=cfg, mode=mode),
    }


@pytest.mark.parametrize("mode", ["host", "spmd", "fused"])
@pytest.mark.parametrize("backend", ["pallas", "merge_path"])
def test_tile_not_a_multiple_of_128_is_refused(backend, mode):
    """JAX asserts (sssp on a graph whose huge bin is non-empty); every
    driver of the port raises ``ValueError`` on entry, also kcore with
    no round to run; ``step_batch`` and ``resume_loop`` too."""
    src, dst, n = hub_edges()
    with pytest.raises(AssertionError):
        jd.sssp(jg.from_edge_list(src, dst, n), 0,
                JConfig(backend=backend, threshold=16, lb_tile_edges=16),
                mode=mode)
    g = tg.from_edge_list(src, dst, n, device="cpu")
    sym = tg.symmetrized(g)
    for t in (16, 0, 200):
        cfg = TConfig(backend=backend, threshold=16, lb_tile_edges=t)
        for name, run in port_apps(g, sym, cfg, mode).items():
            with pytest.raises(ValueError, match="lb_tile_edges"):
                run()
                pytest.fail(f"{name} ran with lb_tile_edges={t}")
    cfg = TConfig(backend=backend, threshold=16, lb_tile_edges=16)
    labels = td.sssp(g, 0, TConfig(threshold=16)).labels
    frontier = labels < labels.max()
    if mode != "fused":
        with pytest.raises(ValueError, match="lb_tile_edges"):
            td.step_batch(g, labels[None], frontier[None], cfg,
                          td.QUERY_APPS["sssp"][0], mode=mode)
    with pytest.raises(ValueError, match="lb_tile_edges"):
        td.resume_loop(g, labels, frontier, cfg, td.QUERY_APPS["sssp"][0],
                       mode=mode)


def sparse_edges():
    """48 vertices, 80 random edges: every degree under ``threshold=16``,
    so the huge bin is empty."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 48, 80), rng.integers(0, 48, 80), 48


@pytest.mark.parametrize("backend,mode,app", [
    ("pallas", "host", "sssp"), ("pallas", "host", "kcore_no_rounds"),
    ("pallas", "spmd", "kcore_no_rounds"),
    ("merge_path", "host", "kcore_no_rounds"),
    ("merge_path", "spmd", "kcore_no_rounds")])
def test_tile_refused_where_jax_reaches_no_kernel(backend, mode, app):
    """The standing difference: JAX runs these cases at
    ``lb_tile_edges=16`` (no round traces a tile kernel), the port
    refuses them on entry, as it refuses every case JAX asserts on."""
    src, dst, n = sparse_edges()
    jgr = jg.from_edge_list(src, dst, n)
    jcfg = JConfig(backend=backend, threshold=16, lb_tile_edges=16)
    if app == "sssp":
        jd.sssp(jgr, 0, jcfg, mode=mode)
    else:
        jd.kcore(jg.symmetrized(jgr), 2, jcfg, mode=mode, max_rounds=0)
    g = tg.from_edge_list(src, dst, n, device="cpu")
    cfg = TConfig(backend=backend, threshold=16, lb_tile_edges=16)
    with pytest.raises(ValueError, match="lb_tile_edges"):
        port_apps(g, tg.symmetrized(g), cfg, mode)[app]()


@pytest.mark.parametrize("mode", ["host", "spmd", "fused"])
def test_xla_executor_takes_any_tile(mode):
    """The torch-ops pair has no tile constraint, nor has JAX's: both
    run sssp at ``lb_tile_edges=16`` to the same labels."""
    src, dst, n = hub_edges()
    rj = jd.sssp(jg.from_edge_list(src, dst, n), 0,
                 JConfig(backend="xla", threshold=16, lb_tile_edges=16),
                 mode=mode)
    rt = td.sssp(tg.from_edge_list(src, dst, n, device="cpu"), 0,
                 TConfig(backend="xla", threshold=16, lb_tile_edges=16),
                 mode=mode)
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))
    assert rt.rounds == rj.rounds
