"""The static round's bin listing (``kernels.relax.twc_bin_list``) and the
list-fed static round of the ``pallas`` pair, on the CPU.

* The plain listing (``ref.twc_bin_list_ref``, what the wrapper runs on
  CPU tensors), which reads the dense ``[R, V]`` frontier mask and
  ``row_ptr``, against the V-row layout the static round builds without
  it: per bin, the members in vertex order, their count and their
  largest degree, exactly; the LB bin's also with its degree prefix and
  edge total (``cumsum(hdeg) - hdeg`` at the members, ``hdeg.sum()``);
  and bitwise, every field and its padding, against the composition it
  stands for: ``compact`` + each row's degree and row start (``_meta``
  below, from ``row_ptr`` in numpy) + the listing of that layout's rows
  (``_layout_listing`` below).
* With a kernel pair, no stats and an operator the kernels take, the
  static round builds no V-row frontier layout (no ``compact``, no
  ``frontier_meta``); the ``xla`` pair, an unfused operator and
  ``collect_stats`` still build it.
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


def _meta(row_ptr, fidx):
    """Each compacted frontier row's degree and row start from
    ``row_ptr``, and whether it holds a vertex (deg 0 and row 0 at the
    sentinel V), computed in numpy: what ``frontier_meta`` must give."""
    rp = row_ptr.numpy().astype(np.int64)
    f = fidx.numpy().astype(np.int64)
    valid = f < len(rp) - 1
    safe = np.where(valid, f, 0)
    deg = np.where(valid, rp[safe + 1] - rp[safe], 0)
    row_start = np.where(valid, rp[safe], 0)
    return (torch.from_numpy(deg.astype(np.int32)),
            torch.from_numpy(row_start.astype(np.int32)),
            torch.from_numpy(valid))


def _layout(gt, frontier):
    """The static round's frontier layout of a ``[B, V]`` frontier."""
    v = gt.num_vertices
    listed = torch.from_numpy(frontier).any(dim=0)
    fidx = compact(listed, v)
    deg, row_start, valid = _meta(gt.row_ptr, fidx)
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


def _mask(fr):
    """A numpy ``[R, V]`` frontier as the listing's bool mask."""
    return torch.from_numpy(np.ascontiguousarray(fr))


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
    lists = trelax.twc_bin_list(_mask(fr), gt.row_ptr, _bounds(cfg))
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
    largest degree 0); a vertex the mask does not list is never a
    member, whatever its degree (the mask cut to the vertices below a
    bound lists the layout's members below it); a mask whose rows split
    one frontier lists what its union lists."""
    _, gt = graphs["rmat"]
    v = gt.num_vertices
    fr = _frontier(v, 1, "dense", 3)
    fidx, deg, row_start, _, n_listed = _layout(gt, fr)
    top = int(deg.max())
    bounds = ((0, 8), (top, None), (8, top))
    lists = trelax.twc_bin_list(_mask(fr), gt.row_ptr, bounds)
    assert int(lists.count[1]) == 0 and int(lists.max_deg[1]) == 0
    assert int(lists.count.sum()) == int(((deg > 0)
                                          & (fidx < len(fidx))).sum())
    cut = int(fidx[int(n_listed) // 2])
    below = fidx < cut
    part = trelax.twc_bin_list(_mask(fr & (np.arange(v) < cut)),
                               gt.row_ptr, bounds)
    rows = np.zeros((3, v), bool)                 # fr's vertices, dealt
    rows[np.arange(v) % 3, np.arange(v)] = fr[0]
    split = trelax.twc_bin_list(_mask(rows), gt.row_ptr, bounds)
    for i, (lo, hi) in enumerate(bounds):
        m = below & (deg > lo) & (deg <= (top if hi is None else hi))
        k = int(m.sum())
        assert int(part.count[i]) == k
        assert torch.equal(part.vidx[i][:k], fidx[m])
        assert torch.equal(part.deg[i][:k], deg[m])
        assert torch.equal(part.row_start[i][:k], row_start[m])
    for got, want in zip(split[:5], lists[:5]):
        assert torch.equal(got, want)


def test_listing_wrapper_checks_and_counts_nothing_on_cpu(graphs):
    """The plain version runs on CPU tensors and counts no launch; the
    wrapper raises on a bin count outside 1..4, a mask that is not a
    contiguous bool ``[R, V]`` (never copied or converted), and a
    ``row_ptr`` that is not int32 ``[V + 1]``."""
    _, gt = graphs["rmat"]
    v = gt.num_vertices
    mask = _mask(_frontier(v, 2, "sparse", 1))
    tk.reset_launch_counts()
    trelax.twc_bin_list(mask, gt.row_ptr, ((0, 8),))
    assert tk.launch_counts()["twc_bin_list"] == 0
    with pytest.raises(ValueError, match="1 to 4 bins"):
        trelax.twc_bin_list(mask, gt.row_ptr, ())
    with pytest.raises(ValueError, match="1 to 4 bins"):
        trelax.twc_bin_list(mask, gt.row_ptr, ((0, 1),) * 5)
    with pytest.raises(TypeError, match="mask must be torch.bool"):
        trelax.twc_bin_list(mask.to(torch.uint8), gt.row_ptr, ((0, 8),))
    for bad in (mask[0], mask[None], mask.new_zeros((0, v)),
                mask.t().contiguous().t(), mask[:, ::2]):
        with pytest.raises(ValueError, match="contiguous bool"):
            trelax.twc_bin_list(bad, gt.row_ptr, ((0, 8),))
    with pytest.raises(TypeError, match="row_ptr"):
        trelax.twc_bin_list(mask, gt.row_ptr.long(), ((0, 8),))
    with pytest.raises(ValueError, match="contiguous"):
        trelax.twc_bin_list(mask, gt.row_ptr[:-1], ((0, 8),))
    with pytest.raises(ValueError, match="contiguous"):
        trelax.twc_bin_list(mask[:, :-1].contiguous(), gt.row_ptr,
                            ((0, 8),))


def _layout_listing(fidx, deg, row_start, n_listed, bounds, lb=False):
    """The listing of a frontier layout's rows ``[0, n_listed)`` as the
    port ran it before the listing read the mask: each bin compacted
    over its mask ``lo < deg <= hi`` in frontier order, the rest padded
    (sentinel ``N``, deg 0, row 0); with ``lb`` the last bin's exclusive
    degree prefix (padded with the total) and total."""
    n = fidx.shape[0]
    valid = (fidx < n) & (torch.arange(n) < n_listed)
    cols = {k: [] for k in tref.BinLists._fields[:5]}
    for lo, hi in bounds:
        m = valid & (deg > lo)
        if hi is not None:
            m = m & (deg <= hi)
        sel = compact(m, n)
        take = sel < n
        safe = torch.where(take, sel, 0)
        cols["vidx"].append(torch.where(take, fidx[safe], n))
        cols["deg"].append(torch.where(take, deg[safe], 0))
        cols["row_start"].append(torch.where(take, row_start[safe], 0))
        cols["count"].append(count(m))
        cols["max_deg"].append(torch.where(m, deg, 0).amax())
    lists = tref.BinLists(**{k: torch.stack(v) for k, v in cols.items()})
    if not lb:
        return lists
    d = lists.deg[-1]
    return lists._replace(start_e=torch.cumsum(d, 0, dtype=torch.int32) - d,
                          total=d.sum(dtype=torch.int32))


# bound sets of the plans: alb's, twc's and vertex's bins, then listed
# with their LB bin (alb's huge bin, edge_lb's LB-all)
COMPOSED_BOUNDS = {"alb": (((0, 8), (8, 128), (128, 255)), False),
                   "twc": (((0, 8), (8, 128), (128, None)), False),
                   "vertex": (((0, None),), False),
                   "alb+lb": (((0, 8), (8, 128), (128, 255),
                               (255, None)), True),
                   "edge_lb": (((0, None),), True)}


@pytest.mark.parametrize("bset", sorted(COMPOSED_BOUNDS))
@pytest.mark.parametrize("case", ["r1", "r3", "r8", "pull", "empty",
                                  "all"])
def test_plain_listing_is_the_layout_composition(graphs, case, bset):
    """``twc_bin_list_ref`` over the dense mask and ``row_ptr`` equals,
    in every ``BinLists`` field and its padding, ``compact`` over the
    mask's union + each row's degree and row start (``_meta``) + the
    layout's listing:
    random masks of R = 1, 3 and 8 rows, the reverse CSR's in-degree
    ``emask`` (R = 1), an empty mask and an all-set one."""
    _, gt = graphs["hubs"]
    v = gt.num_vertices
    bounds, lb = COMPOSED_BOUNDS[bset]
    g = gt
    if case == "pull":
        pe = tb._pull_enum(gt, tb.BalancerConfig(direction="pull"))
        g, mask = pe.rg, pe.emask[None].contiguous()
    elif case in ("empty", "all"):
        mask = _mask(_frontier(v, 3, case, 0))
    else:
        r = int(case[1:])
        rng = np.random.default_rng(r + len(bset))
        mask = _mask(rng.random((r, v)) < 0.3 / r)
    got = tref.twc_bin_list_ref(mask, g.row_ptr, bounds, lb=lb)
    listed = mask.any(dim=0)
    fidx = compact(listed, v)
    deg, row_start, _ = _meta(g.row_ptr, fidx)
    want = _layout_listing(fidx, deg, row_start, count(listed), bounds, lb)
    for f in tref.BinLists._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None) == (f in ("start_e", "total")
                                              and not lb), f
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), f
    if case == "all" and bset != "alb":          # bins that cover deg > 0
        assert int(got.count.sum()) == int((gt.out_degrees() > 0).sum())


def _layout_calls(monkeypatch):
    """Count the static round's calls of ``compact`` and
    ``frontier_meta`` (the V-row frontier layout)."""
    seen = {"compact": 0, "meta": 0}
    comp, meta = tb.compact, tb.frontier_meta

    def compact_(*a, **k):
        seen["compact"] += 1
        return comp(*a, **k)

    def meta_(*a, **k):
        seen["meta"] += 1
        return meta(*a, **k)
    monkeypatch.setattr(tb, "compact", compact_)
    monkeypatch.setattr(tb, "frontier_meta", meta_)
    return seen


@pytest.mark.parametrize("route", ["pallas", "merge_path", "xla",
                                   "unfused", "stats"])
@pytest.mark.parametrize("direction", ["push", "pull"])
def test_static_round_builds_the_layout_only_where_needed(
        graphs, monkeypatch, route, direction):
    """A static round of the ``pallas`` or ``merge_path`` pair with an
    operator the kernels take and no stats lists its bins from the mask
    and calls neither ``compact`` nor ``frontier_meta``; the ``xla``
    pair, an operator the kernels do not take and ``collect_stats``
    build the V-row layout once (one ``compact``, one
    ``frontier_meta``).  Labels equal the ``xla`` pair's either way."""
    _, gt = graphs["rmat"]
    v = gt.num_vertices
    kw = dict(strategy="alb", direction=direction, **TWO_PASS)
    cfg = tb.BalancerConfig(
        **kw, backend={"merge_path": "merge_path", "xla": "xla"}.get(
            route, "pallas"))
    op = tops.SSSP_RELAX
    if route == "unfused":
        op = tops.Operator("v_plus_2w", "push", "min",
                           lambda a, w: a + 2 * w)
    g, extra = gt, {}
    if direction == "pull":
        pe = tb._pull_enum(gt, cfg)
        g, op, extra = pe.rg, tops.as_pull(op), dict(emask=pe.emask)
    rng = np.random.default_rng(2)
    lab = torch.from_numpy(rng.integers(0, 500, (2, v)).astype(np.int32))
    fr = torch.from_numpy(_frontier(v, 2, "dense", 6))
    seen = _layout_calls(monkeypatch)
    out = tb.relax_spmd(g, lab, lab, fr, cfg, op,
                        collect_stats=route == "stats", **extra)
    built = int(route not in ("pallas", "merge_path"))
    assert seen == {"compact": built, "meta": built}
    monkeypatch.undo()
    want = tb.relax_spmd(g, lab, lab, fr,
                         tb.BalancerConfig(**kw, backend="xla"), op,
                         **extra)
    got = out[0] if route == "stats" else out
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["view", "uint8"])
@pytest.mark.parametrize("route", ["pallas", "merge_path"])
def test_static_round_takes_any_frontier_layout(graphs, route, kind):
    """The static round hands its kernels a contiguous bool frontier: a
    kernel pair's round over a strided view of a ``[B, V]`` frontier, or
    over a uint8 one, gives the ``xla`` pair's labels on its contiguous
    bool copy."""
    _, gt = graphs["rmat"]
    v = gt.num_vertices
    rng = np.random.default_rng(4)
    lab = torch.from_numpy(rng.integers(0, 500, (2, v)).astype(np.int32))
    fr = torch.from_numpy(rng.random((2, 2 * v)) < 0.4)[:, ::2]
    assert not fr.is_contiguous()
    kw = dict(strategy="alb", **TWO_PASS)
    want = tb.relax_spmd(gt, lab, lab, fr.contiguous(),
                         tb.BalancerConfig(**kw, backend="xla"),
                         tops.SSSP_RELAX)
    got = tb.relax_spmd(gt, lab, lab,
                        fr if kind == "view" else fr.to(torch.uint8),
                        tb.BalancerConfig(**kw, backend=route),
                        tops.SSSP_RELAX)
    assert torch.equal(got, want)


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
        gt, fr, ((0, 8),), op, torch.int32) is None
    assert tb.get_executor("xla").bin_list is None
    assert tb.get_executor("merge_path").bin_list(
        gt, fr, ((0, None),), op, torch.int32, True) is None


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
        g, mask = pe.rg, pe.emask[None]
        fidx = compact(pe.emask, gt.num_vertices)
        deg, row_start, valid = _meta(pe.rg.row_ptr, fidx)
    else:
        case = layout.split("-")[1]
        fr = _frontier(gt.num_vertices, 2, case, 11)
        g, mask = gt, _mask(fr)
        fidx, deg, row_start, valid, _ = _layout(gt, fr)
    bounds = _lb_bounds(cfg)
    lists = trelax.twc_bin_list(mask, g.row_ptr, bounds, lb=True)
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
        bins = trelax.twc_bin_list(mask, g.row_ptr, bounds[:-1])
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
    lists = trelax.twc_bin_list(
        _mask(_frontier(gt.num_vertices, 1, "dense", 2)), gt.row_ptr,
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
