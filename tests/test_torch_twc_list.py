"""The static round's bin listing (``kernels.relax.twc_bin_list``) and the
list-fed static round of the ``pallas`` pair, on the CPU.

* The plain listing (``ref.twc_bin_list_ref``, what the wrapper runs on
  CPU tensors) against the V-row layout the static round builds without
  it: per bin, the members in frontier order, their count and their
  largest degree, exactly; the LB bin's also with its degree prefix and
  edge total (``cumsum(hdeg) - hdeg`` at the members, ``hdeg.sum()``).
* The static round through the ``pallas`` pair (plain listing, then
  ``twc_bin_relax_ref`` over each list with ``rows`` its count, and
  ``edge_lb_relax_ref`` over the LB list with its count, prefix and
  total) against the JAX package's ``relax_spmd`` (Pallas in interpret
  mode) and the port's host round, on the same numpy state: labels
  bitwise for the int32 operators and within ``PR_RTOL`` for pagerank's
  float32 add, every ``RoundStatsDev`` field equal.

The CUDA listing kernel is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro_torch import kernels as tk
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops
from repro_torch.core.frontier import compact, count
from repro_torch.kernels import ref as tref
from repro_torch.kernels import relax as trelax

STRATEGIES = ["vertex", "twc", "edge_lb", "alb"]
PR_RTOL = 2e-6        # as tests/test_torch_pull_apps.py holds pagerank
# two-pass bins on rmat(9, 8), as tests/test_torch_spmd.py runs them
TWO_PASS = dict(threshold=140, large_width=128)


def _port(gj):
    return tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                               device="cpu")


@pytest.fixture(scope="module")
def graphs():
    rm = jg.rmat(9, 8, seed=3)
    out = {"rmat": rm, "rmat_sym": jg.symmetrized(rm),
           "hubs": jg.rmat(10, 12, seed=7)}
    return {k: (gj, _port(gj)) for k, gj in out.items()}


def _bounds(cfg):
    return tuple((s.lo, s.hi) for s in tb.make_plan(cfg).bins)


def _layout(gt, frontier):
    """The static round's frontier layout of a ``[B, V]`` frontier."""
    v = gt.num_vertices
    listed = torch.from_numpy(frontier).any(dim=0)
    fidx = compact(listed, v)
    deg, row_start, valid = tb._frontier_meta(gt, fidx)
    return fidx, deg, row_start, valid, count(listed)


def _frontier(v, b, case, seed):
    rng = np.random.default_rng(seed)
    if case == "empty":
        return np.zeros((b, v), bool)
    if case == "all":
        return np.ones((b, v), bool)
    fr = rng.random((b, v)) < {"sparse": 0.02, "dense": 0.4}[case]
    fr[:, 0] = True                                # the hub
    return fr


@pytest.mark.parametrize("case", ["empty", "sparse", "dense", "all"])
@pytest.mark.parametrize("strategy", ["vertex", "twc", "alb"])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("graph", ["rmat", "hubs"])
def test_plain_listing_matches_v_row_layout(graphs, graph, b, strategy,
                                            case):
    """Each bin's list, count and largest degree against the V-row
    layout (``where(mask, fidx, V)`` over every listed row) that the
    round builds without the hook: an empty frontier, a sparse and a
    dense one with the hub, and every vertex listed (n_listed = V);
    batched frontiers list their union."""
    _, gt = graphs[graph]
    cfg = tb.BalancerConfig(strategy=strategy, threshold=256)
    fr = _frontier(gt.num_vertices, b, case, b + len(case))
    fidx, deg, row_start, valid, n_listed = _layout(gt, fr)
    lists = trelax.twc_bin_list(fidx, deg, row_start, n_listed,
                                _bounds(cfg))
    v = gt.num_vertices
    for i, spec in enumerate(tb.make_plan(cfg).bins):
        mask = spec.mask(deg, valid)
        n = int(mask.sum())
        assert int(lists.count[i]) == n
        assert int(lists.max_deg[i]) == int(torch.where(mask, deg, 0).max())
        for got, layout in ((lists.vidx[i], torch.where(mask, fidx, v)),
                            (lists.deg[i], torch.where(mask, deg, 0)),
                            (lists.row_start[i],
                             torch.where(mask, row_start, 0))):
            assert torch.equal(got[:n], layout[mask])
        assert bool((lists.vidx[i][n:] == v).all())
    if case == "all":
        assert int(n_listed) == v


def test_plain_listing_keeps_empty_bins_and_the_row_bound(graphs):
    """A bin whose range holds no listed degree lists nothing (count 0,
    largest degree 0); rows at or past ``n_listed`` are never members,
    whatever they hold; a host int bound equals a tensor one."""
    _, gt = graphs["rmat"]
    fr = _frontier(gt.num_vertices, 1, "dense", 3)
    fidx, deg, row_start, _, n_listed = _layout(gt, fr)
    top = int(deg.max())
    bounds = ((0, 8), (top, None), (8, top))
    lists = trelax.twc_bin_list(fidx, deg, row_start, n_listed, bounds)
    assert int(lists.count[1]) == 0 and int(lists.max_deg[1]) == 0
    assert int(lists.count.sum()) == int(((deg > 0)
                                          & (fidx < len(fidx))).sum())
    cut = int(n_listed) // 2
    below = torch.arange(len(fidx)) < cut
    for bound in (cut, torch.tensor([cut], dtype=torch.int32)):
        part = trelax.twc_bin_list(fidx, deg, row_start, bound, bounds)
        for i, (lo, hi) in enumerate(bounds):
            m = below & (deg > lo) & (deg <= (top if hi is None else hi))
            k = int(m.sum())
            assert int(part.count[i]) == k
            assert torch.equal(part.vidx[i][:k], fidx[m])
            assert torch.equal(part.deg[i][:k], deg[m])
            assert torch.equal(part.row_start[i][:k], row_start[m])


def test_listing_wrapper_checks_and_counts_nothing_on_cpu(graphs):
    _, gt = graphs["rmat"]
    fidx, deg, row_start, _, n_listed = _layout(
        gt, _frontier(gt.num_vertices, 1, "sparse", 1))
    tk.reset_launch_counts()
    trelax.twc_bin_list(fidx, deg, row_start, n_listed, ((0, 8),))
    assert tk.launch_counts()["twc_bin_list"] == 0
    with pytest.raises(ValueError, match="1 to 4 bins"):
        trelax.twc_bin_list(fidx, deg, row_start, n_listed, ())
    with pytest.raises(ValueError, match="1 to 4 bins"):
        trelax.twc_bin_list(fidx, deg, row_start, n_listed,
                            ((0, 1),) * 5)
    with pytest.raises(TypeError, match="deg"):
        trelax.twc_bin_list(fidx, deg.long(), row_start, n_listed,
                            ((0, 8),))
    with pytest.raises(ValueError, match="contiguous"):
        trelax.twc_bin_list(fidx, deg[:-1], row_start, n_listed, ((0, 8),))


def _count_calls(monkeypatch):
    """Count the listing's calls, and record the ``rows`` of each
    ``twc_bin_relax`` call and of each ``edge_lb_relax`` call."""
    seen = {"list": 0, "rows": [], "lb_rows": []}
    lst, rel, lb = (trelax.twc_bin_list, trelax.twc_bin_relax,
                    trelax.edge_lb_relax)

    def listing(*a, **k):
        seen["list"] += 1
        return lst(*a, **k)

    def relax(*a, **k):
        seen["rows"].append(k.get("rows"))
        return rel(*a, **k)

    def lb_relax(*a, **k):
        seen["lb_rows"].append(k.get("rows"))
        return lb(*a, **k)
    monkeypatch.setattr(trelax, "twc_bin_list", listing)
    monkeypatch.setattr(trelax, "twc_bin_relax", relax)
    monkeypatch.setattr(trelax, "edge_lb_relax", lb_relax)
    return seen


def _lists_once(plan) -> int:
    """The listing's calls a static round of ``plan`` makes through the
    ``pallas`` pair: one when it has bins or an LB path."""
    return int(bool(plan.bins) or plan.lb != "none")


APPS = {"sssp": (jops.SSSP_RELAX, tops.SSSP_RELAX, "rmat"),
        "bfs": (jops.BFS_HOP, tops.BFS_HOP, "rmat"),
        "cc": (jops.CC_MIN, tops.CC_MIN, "rmat_sym")}


@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_listed_static_round_matches_jax_and_host(graphs, monkeypatch,
                                                  strategy, app,
                                                  direction):
    """One static round of the ``pallas`` pair, B = 3, two-pass bins:
    the listing runs once (when the plan has bins or an LB path) and
    every bin launch and the LB launch take their list's count as
    ``rows``; labels and every stats field equal JAX's ``relax_spmd``,
    and labels equal the host round's."""
    jop, top, graph = APPS[app]
    gj, gt = graphs[graph]
    cj, ct = (jb.BalancerConfig(strategy=strategy, use_pallas=True,
                                **TWO_PASS),
              tb.BalancerConfig(strategy=strategy, use_pallas=True,
                                **TWO_PASS))
    v = gj.num_vertices
    rng = np.random.default_rng(len(app) + len(strategy))
    labels = rng.integers(0, 500, (3, v)).astype(np.int32)
    labels[rng.random((3, v)) < 0.3] = jg.INF
    if app == "cc":
        labels = np.tile(np.arange(v, dtype=np.int32), (3, 1))
    frontier = rng.random((3, v)) < 0.25
    frontier[:, 0] = True
    gjr, gtr, kj, kt = gj, gt, {}, {}
    jop_r, top_r = jop, top
    if direction == "pull":
        pj, pt = jb._pull_enum(gj, cj), tb._pull_enum(gt, ct)
        gjr, gtr = pj.rg, pt.rg
        jop_r, top_r = jops.as_pull(jop), tops.as_pull(top)
        kj, kt = dict(emask=pj.emask), dict(emask=pt.emask)
    lj, sj = jb.relax_spmd(gjr, jnp.asarray(labels), jnp.asarray(labels),
                           jnp.asarray(frontier), cj, jop_r,
                           collect_stats=True, **kj)
    seen = _count_calls(monkeypatch)
    lt, st = tb.relax_spmd(gtr, torch.from_numpy(labels),
                           torch.from_numpy(labels),
                           torch.from_numpy(frontier), ct, top_r,
                           collect_stats=True, **kt)
    plan = tb.make_plan(ct)
    assert seen["list"] == _lists_once(plan)
    assert len(seen["rows"]) == len(plan.bins)
    assert len(seen["lb_rows"]) == (plan.lb != "none")
    assert all(r is not None and r.numel() == 1
               for r in seen["rows"] + seen["lb_rows"])
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    host_cfg = tb.BalancerConfig(strategy=strategy, use_pallas=True,
                                 direction=direction, **TWO_PASS)
    lh, _ = tb.relax(gt, torch.from_numpy(labels), torch.from_numpy(labels),
                     torch.from_numpy(frontier), host_cfg, top)
    assert torch.equal(lt, lh)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_listed_static_round_pagerank_matches_jax_and_host(graphs,
                                                           monkeypatch,
                                                           strategy):
    """Pagerank's round (float32 add of ``rank / outdeg`` over the
    reverse CSR, every vertex listed): within ``PR_RTOL`` of JAX's
    ``relax_spmd`` and the host round, stats equal."""
    gj, gt = graphs["hubs"]
    cj, ct = (jb.BalancerConfig(strategy=strategy, use_pallas=True),
              tb.BalancerConfig(strategy=strategy, use_pallas=True))
    rgj, rgt = gj.reverse(), gt.reverse()
    v = gj.num_vertices
    rng = np.random.default_rng(5)
    contrib = (rng.random((1, v)) * 1e-3).astype(np.float32)
    acc = np.zeros((1, v), np.float32)
    frontier = np.ones((1, v), bool)
    lj, sj = jb.relax_spmd(rgj, jnp.asarray(contrib), jnp.asarray(acc),
                           jnp.asarray(frontier), cj, jops.PR_PULL,
                           collect_stats=True)
    seen = _count_calls(monkeypatch)
    lt, st = tb.relax_spmd(rgt, torch.from_numpy(contrib),
                           torch.from_numpy(acc), torch.from_numpy(frontier),
                           ct, tops.PR_PULL, collect_stats=True)
    assert seen["list"] == _lists_once(tb.make_plan(ct))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=PR_RTOL,
                               atol=0)
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    lh, _ = tb.relax(rgt, torch.from_numpy(contrib), torch.from_numpy(acc),
                     torch.from_numpy(frontier), ct, tops.PR_PULL)
    np.testing.assert_allclose(lt.numpy(), lh.numpy(), rtol=PR_RTOL, atol=0)


def test_unfused_operator_keeps_the_v_row_layout(graphs, monkeypatch):
    """An operator the fused kernels do not take: the pair's hook lists
    nothing (the merge-path pair's too), and the bins keep the V-row
    layout with the frontier count as their row bound (the unfused
    route's index maps take every row)."""
    _, gt = graphs["rmat"]
    op = tops.Operator("v_plus_2w", "push", "min", lambda v, w: v + 2 * w)
    cfg = tb.BalancerConfig(strategy="alb", use_pallas=True, **TWO_PASS)
    seen = _count_calls(monkeypatch)
    v = gt.num_vertices
    lab = torch.zeros((1, v), dtype=torch.int32)
    fr = torch.from_numpy(_frontier(v, 1, "dense", 4))
    tb.relax_spmd(gt, lab, lab, fr, cfg, op)
    assert seen["list"] == 0 and seen["rows"] == []
    assert tb.get_executor("pallas").bin_list(
        *_layout(gt, fr.numpy())[:3], 5, ((0, 8),), op, torch.int32) is None
    assert tb.get_executor("xla").bin_list is None
    assert tb.get_executor("merge_path").bin_list(
        *_layout(gt, fr.numpy())[:3], 5, ((0, None),), op, torch.int32,
        True) is None


# ---- the LB bin, listed in the same launch -------------------------------

LB_STRATEGIES = ["alb", "edge_lb"]


def _lb_bounds(cfg):
    plan = tb.make_plan(cfg)
    return tuple((s.lo, s.hi) for s in plan.bins) + (plan.lb_bound(cfg),)


@pytest.mark.parametrize("layout", ["push-empty", "push-sparse",
                                    "push-dense", "push-all", "pull"])
@pytest.mark.parametrize("strategy", LB_STRATEGIES)
def test_plain_lb_list_matches_v_row_layout(graphs, strategy, layout):
    """The LB bin listed last, with its degree prefix and total, against
    the static round's V-row layout of the LB path (``hmask`` over every
    listed row): members in frontier order, count, ``start_e`` =
    ``cumsum(hdeg) - hdeg`` at the members, ``total`` = ``hdeg.sum()``
    (a 0-d int32); padded rows deg 0 and ``start_e`` the total; the
    degree bins as listed without it.  Push lists a frontier's union
    (B = 2), pull every vertex with in-edges of the reverse CSR."""
    gj, gt = graphs["hubs"]
    cfg = tb.BalancerConfig(strategy=strategy, threshold=64)
    plan = tb.make_plan(cfg)
    if layout == "pull":
        pe = tb._pull_enum(gt, cfg)
        fidx = compact(pe.emask, gt.num_vertices)
        deg, row_start, valid = tb._frontier_meta(pe.rg, fidx)
        n_listed = count(pe.emask)
    else:
        case = layout.split("-")[1]
        fidx, deg, row_start, valid, n_listed = _layout(
            gt, _frontier(gt.num_vertices, 2, case, 11))
    bounds = _lb_bounds(cfg)
    lists = trelax.twc_bin_list(fidx, deg, row_start, n_listed, bounds,
                                lb=True)
    k = len(plan.bins)
    hmask = plan.lb_mask(deg, valid, cfg)
    hdeg = torch.where(hmask, deg, 0)
    start_e = torch.cumsum(hdeg, 0, dtype=torch.int32) - hdeg
    n = int(hmask.sum())
    assert int(lists.count[k]) == n
    for got, want in ((lists.vidx[k], fidx), (lists.deg[k], deg),
                      (lists.row_start[k], row_start),
                      (lists.start_e, start_e)):
        assert torch.equal(got[:n], want[hmask])
    assert lists.total.dtype == torch.int32 and lists.total.ndim == 0
    assert int(lists.total) == int(hdeg.sum(dtype=torch.int32))
    assert bool((lists.deg[k][n:] == 0).all())
    assert bool((lists.start_e[n:] == lists.total).all())
    if k:
        bins = trelax.twc_bin_list(fidx, deg, row_start, n_listed,
                                   bounds[:-1])
        assert bins.start_e is None and bins.total is None
        for got, want in zip(lists[:5], bins[:5]):
            assert torch.equal(got[:k], want)
    if layout == "push-empty":
        assert n == 0 and int(lists.total) == 0
    elif layout != "push-sparse" or strategy == "edge_lb":
        assert n > 0


def test_plain_edge_lb_relax_respects_the_row_bound(graphs):
    """``edge_lb_relax`` (its plain version on the CPU) over an LB list
    whose rows past the count hold junk, as the kernel leaves them: with
    ``rows`` the count (a host int or a device-style tensor) it equals
    the clean padded list's pass; with ``rows`` 0 it changes nothing."""
    _, gt = graphs["hubs"]
    cfg = tb.BalancerConfig(strategy="alb", threshold=64)
    fidx, deg, row_start, _, n_listed = _layout(
        gt, _frontier(gt.num_vertices, 1, "dense", 2))
    lists = trelax.twc_bin_list(fidx, deg, row_start, n_listed,
                                _lb_bounds(cfg), lb=True)
    k = len(tb.make_plan(cfg).bins)
    n = int(lists.count[k])
    assert n > 0
    rng = np.random.default_rng(0)
    v = gt.num_vertices
    junk = [t.clone() for t in (lists.vidx[k], lists.start_e,
                                lists.row_start[k])]
    for t in junk:
        t[n:] = torch.from_numpy(rng.integers(0, v, v - n).astype(np.int32))
    val = torch.from_numpy(rng.integers(0, 50, (2, v)).astype(np.int32))
    lab = torch.from_numpy(rng.integers(0, 90, (2, v)).astype(np.int32))
    fm = torch.from_numpy(rng.random((2, v)) < 0.5)
    args = (gt.col_idx, gt.edge_w)
    for dist in ("cyclic", "blocked"):
        kw = dict(distribution=dist, num_tiles=7)
        want = tref.edge_lb_relax_ref(
            val, lab.clone(), fm, *args, lists.vidx[k], lists.start_e,
            lists.row_start[k], lists.total, gt.num_edges, tops.SSSP_RELAX,
            **kw)
        assert not torch.equal(want, lab)
        for rows in (n, lists.count[k:k + 1]):
            got = trelax.edge_lb_relax(
                val, lab.clone(), fm, *args, *junk, lists.total,
                gt.num_edges, tops.SSSP_RELAX, rows=rows, **kw)
            assert torch.equal(got, want)
        none = trelax.edge_lb_relax(
            val, lab.clone(), fm, *args, *junk, lists.total, gt.num_edges,
            tops.SSSP_RELAX, rows=torch.zeros(1, dtype=torch.int32), **kw)
        assert torch.equal(none, lab)


def _lb_frontier(gt, cfg, b, case):
    """A ``[B, V]`` frontier with the hub (``"hub"``: the LB path has
    members) or with no vertex the LB path takes (``"no_lb"``: alb's
    huge bin empty, edge_lb's frontier all zero-degree vertices)."""
    v = gt.num_vertices
    rng = np.random.default_rng(b + len(case))
    fr = rng.random((b, v)) < 0.25
    deg = gt.out_degrees().numpy()
    if case == "hub":
        fr[:, int(np.argmax(deg))] = True
    else:
        fr &= deg[None] < (cfg.threshold if cfg.strategy == "alb" else 1)
        fr[:, int(np.argmin(deg))] = True
    return fr


@pytest.mark.parametrize("case", ["hub", "no_lb"])
@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("strategy", LB_STRATEGIES)
def test_listed_lb_round_matches_jax_and_host(graphs, monkeypatch, strategy,
                                              distribution, b, direction,
                                              case):
    """A static sssp round of the ``pallas`` pair whose LB launch takes
    the LB list (its count as ``rows``, its prefix and device total):
    labels bitwise and every ``RoundStatsDev`` field equal to JAX's
    ``relax_spmd``, labels equal to the host round's, for both deals,
    B in {1, 3}, push and pull; a push round with no LB member has
    ``lb_invoked`` False, ``edges_lb`` 0, and one with the hub True."""
    gj, gt = graphs["rmat"]
    kw = dict(strategy=strategy, use_pallas=True, distribution=distribution,
              direction=direction, **TWO_PASS)
    cj, ct = jb.BalancerConfig(**kw), tb.BalancerConfig(**kw)
    v = gj.num_vertices
    rng = np.random.default_rng(b + len(strategy))
    labels = rng.integers(0, 500, (b, v)).astype(np.int32)
    labels[rng.random((b, v)) < 0.3] = jg.INF
    frontier = _lb_frontier(gt, ct, b, case)
    gjr, gtr, kj, kt = gj, gt, {}, {}
    jop, top = jops.SSSP_RELAX, tops.SSSP_RELAX
    if direction == "pull":
        pj, pt = jb._pull_enum(gj, cj), tb._pull_enum(gt, ct)
        gjr, gtr = pj.rg, pt.rg
        jop, top = jops.as_pull(jop), tops.as_pull(top)
        kj, kt = dict(emask=pj.emask), dict(emask=pt.emask)
    lj, sj = jb.relax_spmd(gjr, jnp.asarray(labels), jnp.asarray(labels),
                           jnp.asarray(frontier), cj, jop,
                           collect_stats=True, **kj)
    seen = _count_calls(monkeypatch)
    lt, st = tb.relax_spmd(gtr, torch.from_numpy(labels),
                           torch.from_numpy(labels),
                           torch.from_numpy(frontier), ct, top,
                           collect_stats=True, **kt)
    assert seen["list"] == 1
    assert len(seen["lb_rows"]) == 1 and seen["lb_rows"][0].numel() == 1
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    if direction == "push":
        assert bool(st.lb_invoked) == (case == "hub")
        assert (int(st.edges_lb) > 0) == (case == "hub")
    lh, _ = tb.relax(gt, torch.from_numpy(labels), torch.from_numpy(labels),
                     torch.from_numpy(frontier), ct, tops.SSSP_RELAX)
    assert torch.equal(lt, lh)


@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("strategy", LB_STRATEGIES)
def test_listed_lb_round_kcore_matches_jax(graphs, strategy, distribution):
    """kcore's int32 add (``msg`` -1) through the LB list, a dense
    frontier of the symmetrized graph with its hub: labels bitwise and
    every stats field equal to JAX's ``relax_spmd``."""
    gj, gt = graphs["rmat_sym"]
    kw = dict(strategy=strategy, use_pallas=True, distribution=distribution,
              **TWO_PASS)
    cj, ct = jb.BalancerConfig(**kw), tb.BalancerConfig(**kw)
    v = gj.num_vertices
    rng = np.random.default_rng(9)
    values = rng.integers(0, 40, (1, v)).astype(np.int32)
    frontier = rng.random((1, v)) < 0.6
    frontier[:, int(np.argmax(gt.out_degrees().numpy()))] = True
    lj, sj = jb.relax_spmd(gj, jnp.asarray(values), jnp.asarray(values),
                           jnp.asarray(frontier), cj, jops.KCORE_DEC,
                           collect_stats=True)
    lt, st = tb.relax_spmd(gt, torch.from_numpy(values),
                           torch.from_numpy(values),
                           torch.from_numpy(frontier), ct, tops.KCORE_DEC,
                           collect_stats=True)
    assert bool(st.lb_invoked)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)


@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("strategy", LB_STRATEGIES)
def test_listed_lb_round_pagerank_matches_jax_and_host(graphs, monkeypatch,
                                                       strategy,
                                                       distribution):
    """Pagerank's round over the reverse CSR, every vertex listed, with
    a huge bin (threshold 64): the LB list's pass within ``PR_RTOL`` of
    JAX's ``relax_spmd`` and of the host round, stats equal."""
    gj, gt = graphs["hubs"]
    kw = dict(strategy=strategy, use_pallas=True, distribution=distribution,
              threshold=64)
    cj, ct = jb.BalancerConfig(**kw), tb.BalancerConfig(**kw)
    rgj, rgt = gj.reverse(), gt.reverse()
    v = gj.num_vertices
    rng = np.random.default_rng(6)
    contrib = (rng.random((1, v)) * 1e-3).astype(np.float32)
    acc = np.zeros((1, v), np.float32)
    frontier = np.ones((1, v), bool)
    lj, sj = jb.relax_spmd(rgj, jnp.asarray(contrib), jnp.asarray(acc),
                           jnp.asarray(frontier), cj, jops.PR_PULL,
                           collect_stats=True)
    seen = _count_calls(monkeypatch)
    lt, st = tb.relax_spmd(rgt, torch.from_numpy(contrib),
                           torch.from_numpy(acc), torch.from_numpy(frontier),
                           ct, tops.PR_PULL, collect_stats=True)
    assert seen["list"] == 1 and len(seen["lb_rows"]) == 1
    assert int(st.edges_lb) > 0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=PR_RTOL,
                               atol=0)
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    lh, _ = tb.relax(rgt, torch.from_numpy(contrib), torch.from_numpy(acc),
                     torch.from_numpy(frontier), ct, tops.PR_PULL)
    np.testing.assert_allclose(lt.numpy(), lh.numpy(), rtol=PR_RTOL, atol=0)
