"""Port parity of the drivers' ``spmd`` and ``fused`` modes: every driver
against the JAX package's same mode on the same numpy CSR and sources
(labels, rounds, every per-round ``RoundStats`` field and
``host_transfers``, bitwise; pagerank's ranks at rtol 2e-6, ROADMAP
Queue 3), the port's fused mode against its own host mode bitwise
(pagerank included), and the zero-sync property of fused mode with the
host-path round entries poisoned."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro.core.apps import drivers as jd
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops
from repro_torch.core.apps import drivers as td

PR_RTOL = 2e-6


def _port(gj):
    return tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                               device="cpu")


@pytest.fixture(scope="module")
def graphs():
    uni = jg.uniform_random(200, 6, seed=3)
    out = {"uniform": uni, "uniform_sym": jg.symmetrized(uni),
           "road": jg.road_grid(8), "rmat": jg.rmat(9, 8, seed=3)}
    return {k: (gj, _port(gj)) for k, gj in out.items()}


def _cfgs(**kw):
    return jb.BalancerConfig(**kw), tb.BalancerConfig(**kw)


def _assert_stats_equal(sj, st):
    assert (sj is None) == (st is None)
    if sj is None:
        return
    assert len(sj) == len(st)
    for a, b in zip(sj, st):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)


def _assert_same_run(rj, rt, rtol=None):
    if rtol is None:
        np.testing.assert_array_equal(np.asarray(rj.labels),
                                      rt.labels.numpy())
    else:
        np.testing.assert_allclose(rt.labels.numpy(), np.asarray(rj.labels),
                                   rtol=rtol, atol=0)
    assert (rj.rounds, rj.host_transfers) == (rt.rounds, rt.host_transfers)
    _assert_stats_equal(rj.stats, rt.stats)


# (app, graph, BalancerConfig fields, driver call): every driver, on
# every test graph, through every backend, in every direction
CASES = {
    "sssp-road-adaptive": ("road", dict(direction="adaptive"),
                           lambda d, g, c, m: d.sssp(g, 0, c, mode=m,
                                                     collect_stats=True)),
    "sssp-rmat-twc-pallas": ("rmat", dict(strategy="twc",
                                          backend="pallas"),
                             lambda d, g, c, m: d.sssp(g, 0, c, mode=m,
                                                       collect_stats=True)),
    "bfs-uniform-pull-merge_path": (
        "uniform", dict(direction="pull", backend="merge_path"),
        lambda d, g, c, m: d.bfs(g, 5, c, mode=m, collect_stats=True)),
    "sssp_batch-rmat-adaptive-pallas": (
        "rmat", dict(direction="adaptive", backend="pallas"),
        lambda d, g, c, m: d.sssp_batch(g, [0, 5, 99, 150], c, mode=m,
                                        collect_stats=True)),
    "bfs_batch-uniform-vertex": (
        "uniform", dict(strategy="vertex", direction="adaptive"),
        lambda d, g, c, m: d.bfs_batch(g, [0, 7, 21], c, mode=m,
                                       collect_stats=True)),
    "cc-uniform_sym-adaptive-edge_lb": (
        "uniform_sym", dict(strategy="edge_lb", direction="adaptive"),
        lambda d, g, c, m: d.cc(g, c, mode=m, collect_stats=True)),
    "kcore-uniform_sym-pallas": (
        "uniform_sym", dict(backend="pallas"),
        lambda d, g, c, m: d.kcore(g, 9, c, mode=m, collect_stats=True)),
    "kcore-road-merge_path": (
        "road", dict(backend="merge_path"),
        lambda d, g, c, m: d.kcore(g, 3, c, mode=m, collect_stats=True)),
}


@pytest.mark.parametrize("mode", ["spmd", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_matches_jax(graphs, case, mode):
    name, kw, run = CASES[case]
    gj, gt = graphs[name]
    cj, ct = _cfgs(threshold=16, **kw)
    _assert_same_run(run(jd, gj, cj, mode), run(td, gt, ct, mode))


@pytest.mark.parametrize("mode", ["spmd", "fused"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_pagerank_matches_jax(graphs, mode, backend):
    """Ranks at PR_RTOL (XLA contracts the update into an FMA, ROADMAP
    Queue 3); rounds, stats and transfers exactly."""
    gj, gt = graphs["rmat"]
    cj, ct = _cfgs(threshold=64, backend=backend)
    rj = jd.pagerank(gj, cfg=cj, mode=mode, max_rounds=15,
                     collect_stats=True)
    rt = td.pagerank(gt, cfg=ct, mode=mode, max_rounds=15,
                     collect_stats=True)
    _assert_same_run(rj, rt, rtol=PR_RTOL)


@pytest.mark.parametrize("mode", ["spmd", "fused"])
def test_resume_loop_matches_jax(graphs, mode):
    """Resume from half-converged labels with a seeded frontier."""
    gj, gt = graphs["rmat"]
    cj, ct = _cfgs(threshold=64, direction="adaptive")
    v = gj.num_vertices
    rng = np.random.default_rng(9)
    labels = np.array(jd.sssp(gj, 0, cj, max_rounds=2).labels)
    frontier = rng.random(v) < 0.1
    rj = jd.resume_loop(gj, jnp.asarray(labels), jnp.asarray(frontier), cj,
                        jops.SSSP_RELAX, mode=mode, collect_stats=True)
    rt = td.resume_loop(gt, torch.from_numpy(labels),
                        torch.from_numpy(frontier), ct, tops.SSSP_RELAX,
                        mode=mode, collect_stats=True)
    _assert_same_run(rj, rt)


@pytest.mark.parametrize("collect_stats", [False, True])
def test_step_batch_spmd_matches_jax(graphs, collect_stats):
    gj, gt = graphs["uniform"]
    cj, ct = _cfgs(threshold=16, direction="adaptive")
    v = gj.num_vertices
    lab = np.full((3, v), jg.INF, np.int32)
    lab[[0, 1, 2], [0, 50, 199]] = 0
    fr = lab == 0
    lj, fj, lt, ft = (jnp.asarray(lab), jnp.asarray(fr),
                      torch.from_numpy(lab), torch.from_numpy(fr))
    for _ in range(4):
        tj0, tt0 = jb.host_transfer_count(), tb.host_transfer_count()
        lj, fj, sj = jd.step_batch(gj, lj, fj, cj, jops.SSSP_RELAX,
                                   mode="spmd", collect_stats=collect_stats)
        lt, ft, st = td.step_batch(gt, lt, ft, ct, tops.SSSP_RELAX,
                                   mode="spmd", collect_stats=collect_stats)
        assert (jb.host_transfer_count() - tj0
                == tb.host_transfer_count() - tt0)
        np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
        np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
        _assert_stats_equal(None if sj is None else [sj],
                            None if st is None else [st])


@pytest.mark.parametrize("backend", ["xla", "pallas", "merge_path"])
def test_port_fused_matches_port_host(graphs, backend):
    """Bitwise, pagerank too: the same float32 arithmetic in both modes,
    and every anchor sums its in-edges in one order."""
    gt = graphs["road"][1]
    gs = graphs["uniform_sym"][1]
    cfg = tb.BalancerConfig(threshold=16, backend=backend,
                            direction="adaptive")
    push = tb.BalancerConfig(threshold=16, backend=backend)
    runs = [lambda m: td.sssp(gt, 3, cfg, mode=m, collect_stats=True),
            lambda m: td.bfs_batch(gt, [0, 9, 63], cfg, mode=m,
                                   collect_stats=True),
            lambda m: td.cc(gs, cfg, mode=m, collect_stats=True),
            lambda m: td.kcore(gs, 9, push, mode=m, collect_stats=True),
            lambda m: td.pagerank(gt, cfg=push, mode=m, max_rounds=25)]
    for run in runs:
        host, fused = run("host"), run("fused")
        assert torch.equal(host.labels, fused.labels)
        assert host.rounds == fused.rounds > 0
        assert fused.host_transfers == 0 < host.host_transfers
        if host.stats is not None:
            for a, b in zip(host.stats, fused.stats):
                assert (a.frontier_size, a.frontier_edges, a.direction,
                        a.edges_twc + a.edges_lb) == \
                    (b.frontier_size, b.frontier_edges, b.direction,
                     b.edges_twc + b.edges_lb)
                assert b.host_transfers == 0


STATIC_RUNS = {
    "sssp-alb": (dict(), lambda g, s, c, m: td.sssp(g, 0, c, mode=m)),
    "sssp-twc": (dict(strategy="twc"),
                 lambda g, s, c, m: td.sssp(g, 0, c, mode=m)),
    "sssp-merge_path": (dict(backend="merge_path"),
                        lambda g, s, c, m: td.sssp(g, 0, c, mode=m)),
    "sssp_batch-adaptive": (
        dict(direction="adaptive"),
        lambda g, s, c, m: td.sssp_batch(g, [0, 5, 99], c, mode=m)),
    "cc-adaptive": (dict(direction="adaptive"),
                    lambda g, s, c, m: td.cc(s, c, mode=m)),
    "kcore": (dict(), lambda g, s, c, m: td.kcore(s, 9, c, mode=m)),
    "pagerank": (dict(), lambda g, s, c, m: td.pagerank(g, cfg=c, mode=m,
                                                        max_rounds=12)),
}


@pytest.mark.parametrize("mode", ["spmd", "fused"])
@pytest.mark.parametrize("case", sorted(STATIC_RUNS))
def test_static_round_launches_each_kernel_once_a_round(graphs, monkeypatch,
                                                        case, mode):
    """Through the kernel pairs, a static round calls the bin kernel once
    for every bin of the plan (an unbounded bin too: its pass count is
    the kernel's own loop), the pair's listing of the bins and the LB
    bin once, and the huge-bin kernel once (with a device total of 0
    when the bin is empty), whatever the direction: so a traversal
    launches them rounds x bins, rounds and rounds times, which
    chip_smoke.py holds the card's own launch counts against.  The
    merge-path pair lists its LB-all bin and launches
    ``merge_path_relax`` once a round, and ``merge_path_map`` never.  In
    spmd
    mode a loop that converges learns it from the liveness of the round
    it ran, so it runs one round on an empty frontier past its count
    (pagerank stops on its round limit)."""
    from repro_torch.kernels import merge_path as tmp
    from repro_torch.kernels import relax as trelax
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, call)
    counted(trelax, "twc_bin_relax")
    counted(trelax, "edge_lb_relax")
    counted(trelax, "twc_bin_list")
    counted(tmp, "merge_path_map")
    counted(trelax, "merge_path_relax")
    kw, run = STATIC_RUNS[case]
    cfg = tb.BalancerConfig(**{"threshold": 16, "use_pallas": True, **kw})
    out = run(graphs["uniform"][1], graphs["uniform_sym"][1], cfg, mode)
    assert out.rounds > 1
    ran = out.rounds + (mode == "spmd" and case != "pagerank")
    plan = tb.effective_plan(cfg)
    if cfg.executor == "merge_path":
        want = {"merge_path_relax": ran, "twc_bin_list": ran}
    else:
        want = {"twc_bin_relax": ran * len(plan.bins),
                "twc_bin_list": ran * (len(plan.bins) > 0
                                       or plan.lb != "none"),
                "edge_lb_relax": ran * (plan.lb != "none")}
    assert calls == {k: n for k, n in want.items() if n}


def _poison(name):
    def fn(*a, **k):
        raise AssertionError(f"fused mode reached the host-path round "
                             f"entry {name}")
    return fn


def test_fused_mode_never_touches_host_round_path(graphs, monkeypatch):
    """Between dispatch and the final fetch a fused traversal performs
    ZERO counted transfers: the host-path round entries are poisoned,
    and kcore's and pagerank's loops too."""
    gt = graphs["uniform"][1]
    gs = graphs["uniform_sym"][1]
    monkeypatch.setattr(td, "relax", _poison("relax"))
    monkeypatch.setattr(td, "relax_spmd_directed",
                        _poison("relax_spmd_directed"))
    monkeypatch.setattr(tb, "_note_host_transfer",
                        _poison("_note_host_transfer"))
    monkeypatch.setattr(td, "_note_host_transfer",
                        _poison("_note_host_transfer"))
    cfg = tb.BalancerConfig(strategy="alb", threshold=64,
                            direction="adaptive")
    out = td.bfs(gt, 0, cfg=cfg, mode="fused", collect_stats=True)
    assert out.host_transfers == 0
    assert out.rounds > 1 and len(out.stats) == out.rounds
    push = tb.BalancerConfig(threshold=16)
    for out in (td.kcore(gs, 9, push, mode="fused", collect_stats=True),
                td.pagerank(gt, cfg=push, mode="fused", max_rounds=10)):
        assert out.host_transfers == 0 and out.rounds > 1


def test_fused_rejects_non_min_combine(graphs):
    gt = graphs["uniform"][1]
    v = gt.num_vertices
    with pytest.raises(ValueError, match="min-combine"):
        tb.run_fused(gt, torch.zeros((v,), dtype=torch.float32),
                     torch.ones((v,), dtype=torch.bool), tb.BalancerConfig(),
                     tops.PR_PULL)


def test_fused_rejects_pull_of_add_operators(graphs):
    """kcore and pagerank are push drivers in every mode, as in JAX."""
    gt = graphs["uniform_sym"][1]
    pull = tb.BalancerConfig(direction="pull")
    for mode in ("host", "spmd", "fused"):
        with pytest.raises(ValueError, match="push min-combine"):
            td.kcore(gt, 3, pull, mode=mode)
        with pytest.raises(ValueError, match="push min-combine"):
            td.pagerank(gt, cfg=pull, mode=mode)
