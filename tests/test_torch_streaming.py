"""Port parity: the streaming layer (``repro_torch.core.streaming``)
against the JAX package's (``repro.core.streaming``) on the same seeded
mutation traces, plus the frontier and padding helpers it brings
(``seed_from_edges``, ``pad_graph``).

The differential matrix is ``tests/test_streaming.py``'s: 3 apps x 4
strategies x the ``xla`` / ``pallas`` pairs, here in the port's three
modes (host, spmd, fused), plus the pull and adaptive directions.
After every batch the port's labels, ``UpdateReport``, ``NetDelta``
and CSR arrays are held bitwise against JAX's ``stream_update`` (run
once per configuration, in host mode: JAX's own tests hold its modes
equal) and against a copy of that file's numpy oracle, which shares no
code with either package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import frontier as JF
from repro.core import streaming as JS
from repro.core.balancer import BalancerConfig as JCfg
from repro_torch.core import graph as TG
from repro_torch.core import frontier as TF
from repro_torch.core import streaming as TS
from repro_torch.core.apps import drivers as TD
from repro_torch.core.balancer import BalancerConfig as TCfg
from repro_torch.serve import QueryService

INF = int(JG.INF)
STRATS = ["vertex", "twc", "edge_lb", "alb"]
MODES = ["host", "spmd", "fused"]
CAP = 16                      # one batch capacity for every trace
CPU = "cpu"


# ---------------------------------------------------------------------------
# The oracle (a copy of tests/test_streaming.py's): an independent host
# fixpoint over an edge dict, sharing no code with either package.
# ---------------------------------------------------------------------------

def oracle_apply(edges, updates):
    """Replay raw update tuples into an edge dict: insert keeps the min
    of duplicates, delete of an absent edge is a no-op, reweight only
    touches existing edges."""
    for t in updates:
        kind, u, v = t[0], t[1], t[2]
        if kind == "insert":
            w = t[3]
            edges[(u, v)] = min(edges.get((u, v), w), w)
        elif kind == "delete":
            edges.pop((u, v), None)
        elif kind == "reweight":
            if (u, v) in edges:
                edges[(u, v)] = t[3]
        else:                                          # pragma: no cover
            raise AssertionError(t)
    return edges


def oracle_labels(edges, nv, app, source=None):
    """From-scratch min-combine fixpoint on the host (int64 labels,
    dense sweeps via ``np.minimum.at``)."""
    if app == "cc":
        lab = np.arange(nv, dtype=np.int64)
    else:
        lab = np.full(nv, INF, np.int64)
        lab[source] = 0
    if not edges:
        return lab
    es = np.array([k[0] for k in edges], np.int64)
    ed = np.array([k[1] for k in edges], np.int64)
    ew = np.array(list(edges.values()), np.int64)
    while True:
        if app == "bfs":
            msg = np.where(lab[es] < INF, lab[es] + 1, INF)
        elif app == "sssp":
            msg = np.where(lab[es] < INF, lab[es] + ew, INF)
        else:
            msg = lab[es]
        new = lab.copy()
        np.minimum.at(new, ed, msg)
        if np.array_equal(new, lab):
            return lab
        lab = new


def random_trace(rng, edges0, nv, n_batches, max_updates=12):
    """tests/test_streaming.py's seeded trace: inserts, deletes,
    reweights, semantic no-ops and in-batch duplicates, every batch
    under its capacity so padding slots are exercised."""
    edges = dict(edges0)
    trace = []
    for _ in range(n_batches):
        ups = []
        for _ in range(int(rng.integers(1, max_updates + 1))):
            r = float(rng.random())
            keys = list(edges)
            if r < 0.40 or not keys:
                u, v = int(rng.integers(nv)), int(rng.integers(nv))
                ups.append(("insert", u, v, int(rng.integers(1, 20))))
            elif r < 0.60:
                u, v = keys[int(rng.integers(len(keys)))]
                ups.append(("delete", u, v))
            elif r < 0.75:
                u, v = keys[int(rng.integers(len(keys)))]
                ups.append(("reweight", u, v, int(rng.integers(1, 20))))
            elif r < 0.85:
                u, v = int(rng.integers(nv)), int(rng.integers(nv))
                if (u, v) in edges:
                    continue
                kind = "delete" if rng.random() < 0.5 else "reweight"
                ups.append((kind, u, v) if kind == "delete"
                           else (kind, u, v, int(rng.integers(1, 20))))
            else:
                if ups:
                    prev = ups[-1]
                    ups.append(("insert", prev[1], prev[2],
                                int(rng.integers(1, 20))))
        edges = oracle_apply(edges, ups)
        trace.append(ups)
    return trace


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def to_torch(gj) -> TG.Graph:
    return TG.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                               device=CPU)


def csr(g):
    if isinstance(g, TG.Graph):
        return tuple(t.numpy().tobytes()
                     for t in (g.row_ptr, g.col_idx, g.edge_w))
    return tuple(np.asarray(a).tobytes()
                 for a in (g.row_ptr, g.col_idx, g.edge_w))


def delta_of(d):
    return (d.added, d.removed, d.reweighted)


def report_of(r):
    return (r.rounds, r.full_recompute, r.seeds, r.version)


def cfgs(**kw):
    return JCfg(threshold=64, **kw), TCfg(threshold=64, **kw)


def source_of(gj, app):
    return None if app == "cc" else JG.highest_out_degree_vertex(gj)


@dataclasses.dataclass
class JaxRun:
    init: np.ndarray
    batches: list       # per batch: (delta, report, labels, csr)


def jax_run(gj0, app, cfg, trace) -> JaxRun:
    """JAX's ``stream_update`` over ``trace`` (host mode), recording
    what the port is held to after every batch."""
    st = JS.stream_init(JS.streaming_graph(gj0), app,
                        source=source_of(gj0, app), cfg=cfg)
    out = JaxRun(st.real_labels.copy(), [])
    for ups in trace:
        batch = JS.make_batch(ups, capacity=CAP)
        delta = delta_of(JS.diff_batch(st.g, batch))
        rep = report_of(JS.stream_update(st, batch))
        out.batches.append((delta, rep, st.real_labels.copy(), csr(st.g)))
    return out


@pytest.fixture(scope="module")
def base_graph():
    return JG.rmat(5, 3, seed=7)          # 32 vertices, ~60 edges


def app_graph(base_graph, app):
    return JG.symmetrized(base_graph) if app == "cc" else base_graph


@pytest.fixture(scope="module")
def traces(base_graph):
    """One fixed trace per app (tests/test_streaming.py's seeds)."""
    out = {}
    for i, app in enumerate(JS.STREAM_APPS):
        g = app_graph(base_graph, app)
        rng = np.random.default_rng(100 + i)
        out[app] = random_trace(rng, JS.edge_map(g), g.num_vertices,
                                n_batches=3)
    return out


@pytest.fixture(scope="module")
def jax_side(base_graph, traces):
    """JAX's run per (app, cfg fields), computed once per module."""
    memo = {}

    def get(app, **kw):
        key = (app,) + tuple(sorted(kw.items()))
        if key not in memo:
            memo[key] = jax_run(app_graph(base_graph, app), app,
                                cfgs(**kw)[0], traces[app])
        return memo[key]
    return get


def replay_and_check(gj0, app, cfg, mode, trace, want: JaxRun):
    """The differential core: the port's stream_update over ``trace``,
    held after every batch against JAX (labels, NetDelta, UpdateReport,
    CSR), the numpy oracle, and a from-scratch port run on the mutated
    graph."""
    nv = gj0.num_vertices
    source = source_of(gj0, app)
    st = TS.stream_init(TS.streaming_graph(to_torch(gj0)), app,
                        source=source, cfg=cfg, mode=mode)
    np.testing.assert_array_equal(st.real_labels, want.init)
    edges = dict(TS.edge_map(st.g))
    for ups, (delta, rep, labels, arrays) in zip(trace, want.batches):
        batch = TS.make_batch(ups, capacity=CAP)
        assert delta_of(TS.diff_batch(st.g, batch)) == delta
        assert report_of(TS.stream_update(st, batch)) == rep
        np.testing.assert_array_equal(st.real_labels, labels)
        assert csr(st.g) == arrays
        edges = oracle_apply(edges, ups)
        np.testing.assert_array_equal(st.real_labels.astype(np.int64),
                                      oracle_labels(edges, nv, app, source))
        ref = TS._full_compute(st.g, app, source, cfg, mode).labels
        np.testing.assert_array_equal(st.real_labels, ref[:nv].numpy())


# ---------------------------------------------------------------------------
# The differential matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("strategy", STRATS)
@pytest.mark.parametrize("app", sorted(JS.STREAM_APPS))
def test_differential_matrix(base_graph, traces, jax_side, app, strategy,
                             use_pallas, mode):
    want = jax_side(app, strategy=strategy, use_pallas=use_pallas)
    _, cfg = cfgs(strategy=strategy, use_pallas=use_pallas)
    replay_and_check(app_graph(base_graph, app), app, cfg, mode,
                     traces[app], want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", ["pull", "adaptive"])
@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_differential_directions(base_graph, traces, jax_side, app,
                                 direction, mode):
    """Repair rounds under pull / adaptive traversal: the version-keyed
    reverse CSR and pull enumerations must rebuild per mutation."""
    want = jax_side(app, direction=direction)
    _, cfg = cfgs(direction=direction)
    replay_and_check(base_graph, app, cfg, mode, traces[app], want)


# ---------------------------------------------------------------------------
# Directed cases, each run through both packages
# ---------------------------------------------------------------------------

def both_init(gj, app, source, **kw):
    jcfg, tcfg = cfgs(**kw)
    sj = JS.stream_init(JS.streaming_graph(gj), app, source=source,
                        cfg=jcfg)
    st = TS.stream_init(TS.streaming_graph(to_torch(gj)), app,
                        source=source, cfg=tcfg)
    return sj, st


def both_update(sj, st, ups, **kw):
    rj = JS.stream_update(sj, JS.make_batch(ups, capacity=CAP), **kw)
    rt = TS.stream_update(st, TS.make_batch(ups, capacity=CAP), **kw)
    assert report_of(rt) == report_of(rj)
    np.testing.assert_array_equal(st.real_labels, sj.real_labels)
    assert csr(st.g) == csr(sj.g)
    return rt


def test_empty_batch_is_zero_rounds(base_graph):
    sj, st = both_init(base_graph, "bfs", 0)
    v0 = st.version
    before = st.real_labels.copy()
    rep = both_update(sj, st, [])
    assert rep.rounds == 0 and rep.seeds == 0 and not rep.full_recompute
    assert st.version == v0 + 1           # version still advances
    np.testing.assert_array_equal(st.real_labels, before)


def test_noop_batch_is_zero_rounds(base_graph):
    sj, st = both_init(base_graph, "sssp", 0)
    em = TS.edge_map(st.g)
    assert em == JS.edge_map(sj.g)
    (u, v), w = next(iter(em.items()))
    absent = next((a, b) for a in range(st.g.num_vertices)
                  for b in range(st.g.num_vertices)
                  if (a, b) not in em)
    rep = both_update(sj, st, [
        ("insert", u, v, w + 5),          # worse duplicate: min keeps w
        ("delete", absent[0], absent[1]),  # absent: no-op
        ("reweight", absent[0], absent[1], 3),
    ])
    assert rep.rounds == 0 and rep.seeds == 0 and not rep.full_recompute
    assert TS.diff_batch(st.g, TS.make_batch([])).is_empty()


def test_reweight_is_noop_for_weight_blind_apps(base_graph):
    g = JG.symmetrized(base_graph)
    for app, source in (("bfs", 0), ("cc", None)):
        sj, st = both_init(g, app, source)
        (u, v), w = next(iter(TS.edge_map(st.g).items()))
        rep = both_update(sj, st, [("reweight", u, v, w + 17)])
        assert rep.rounds == 0 and not rep.full_recompute, app


def test_tight_delete_forces_full_recompute(base_graph):
    src = JG.highest_out_degree_vertex(base_graph)
    sj, st = both_init(base_graph, "sssp", src)
    lab = st.real_labels
    tight = next((u, v) for (u, v), w in TS.edge_map(st.g).items()
                 if lab[u] < INF and lab[u] + w == lab[v])
    rep = both_update(sj, st, [("delete", tight[0], tight[1])])
    assert rep.full_recompute
    ref = TD.sssp(st.g, src, cfgs()[1]).labels
    np.testing.assert_array_equal(
        st.real_labels, ref[:base_graph.num_vertices].numpy())


def test_slack_delete_stays_incremental(base_graph):
    src = JG.highest_out_degree_vertex(base_graph)
    sj, st = both_init(base_graph, "sssp", src)
    lab = st.real_labels
    slack = next((u, v) for (u, v), w in TS.edge_map(st.g).items()
                 if not (lab[u] < INF and lab[u] + w == lab[v]))
    rep = both_update(sj, st, [("delete", slack[0], slack[1])])
    assert not rep.full_recompute and rep.rounds == 0
    ref = TD.sssp(st.g, src, cfgs()[1]).labels
    np.testing.assert_array_equal(
        st.real_labels, ref[:base_graph.num_vertices].numpy())


def test_sssp_reweight_up_and_down(base_graph):
    """A weight increase on a tight edge falls back; a decrease seeds
    the repair: both as JAX classifies them, with the seed count."""
    src = JG.highest_out_degree_vertex(base_graph)
    sj, st = both_init(base_graph, "sssp", src)
    lab = st.real_labels
    em = TS.edge_map(st.g)
    tight = next(((u, v), w) for (u, v), w in em.items()
                 if lab[u] < INF and lab[u] + w == lab[v])
    slack = next(((u, v), w) for (u, v), w in em.items()
                 if w > 2 and not (lab[u] < INF and lab[u] + w == lab[v]))
    rep = both_update(sj, st, [("reweight", *slack[0], slack[1] - 1),
                               ("reweight", *tight[0], tight[1] + 50)])
    assert rep.full_recompute
    rep = both_update(sj, st, [("reweight", *slack[0], 1)])
    assert not rep.full_recompute and rep.seeds == 1


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_update_validation(base_graph):
    gj = JS.streaming_graph(base_graph)
    gt = TS.streaming_graph(to_torch(base_graph))
    nv_real = TS.real_vertices(gt)
    assert nv_real == JS.real_vertices(gj)
    bad = [[("insert", 0, nv_real, 1)], [("insert", -1, 1, 1)],
           [("insert", 0, 1, 0)], [("reweight", 0, 1, INF)],
           [("delete", 0, 1), ("insert", 2, 3, 5), ("insert", 0, 1, -4)]]
    for ups in bad:
        msg = _error(lambda: TS.apply_updates(gt, TS.make_batch(ups)))
        assert msg == _error(
            lambda: JS.apply_updates(gj, JS.make_batch(ups)))
    for ups, match in ((bad[0], "out of range"), (bad[2], "weight")):
        with pytest.raises(ValueError, match=match):
            TS.diff_batch(gt, TS.make_batch(ups))
    weird = TS.make_batch([("insert", 0, 1, 1)])
    weird.op[0] = 7
    assert _error(lambda: TS.apply_updates(gt, weird)) == _error(
        lambda: JS.apply_updates(gj, JS.UpdateBatch(*weird)))
    with pytest.raises(ValueError, match="streaming-enabled"):
        TS.apply_updates(to_torch(base_graph),
                         TS.make_batch([("insert", 0, 1, 1)]))
    with pytest.raises(ValueError, match="capacity"):
        TS.make_batch([("insert", 0, 1, 1)] * 5, capacity=4)
    with pytest.raises(ValueError, match="unknown update kind"):
        TS.make_batch([("upsert", 0, 1, 1)])
    with pytest.raises(ValueError, match="needs"):
        TS.make_batch([("insert", 0, 1)])
    with pytest.raises(ValueError, match="edge_capacity"):
        TS.streaming_graph(to_torch(base_graph), edge_capacity=3)
    with pytest.raises(ValueError, match="require a source"):
        TS.stream_init(gt, "cc", source=0)
    with pytest.raises(ValueError, match="unknown streaming app"):
        TS.stream_init(gt, "pagerank", source=0)


def test_make_batch_matches_jax():
    ups = [("insert", 3, 4, 9), ("delete", 1, 2), ("reweight", 5, 6, 7)]
    for cap in (None, 3, 32):
        bj, bt = JS.make_batch(ups, capacity=cap), TS.make_batch(
            ups, capacity=cap)
        for a, b in zip(bj, bt):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert (bt.capacity, bt.num_updates) == (bj.capacity,
                                                 bj.num_updates)


def test_in_place_update_bumps_version_and_repairs(base_graph):
    """in_place=True mutates the SAME Graph object: every reference
    observes the new topology and the bumped version."""
    sj, st = both_init(base_graph, "bfs", 0)
    g_ref = st.g
    v0 = g_ref.version
    far = int(np.argmax(st.real_labels))  # worst-reached vertex
    both_update(sj, st, [("insert", 0, far, 1)], in_place=True)
    assert st.g is g_ref and g_ref.version == v0 + 1
    assert st.real_labels[far] == 1
    ref = TD.bfs(g_ref, 0, cfgs()[1]).labels
    np.testing.assert_array_equal(
        st.real_labels, ref[:base_graph.num_vertices].numpy())
    assert TS.edge_map(g_ref) == JS.edge_map(sj.g)


def test_capacity_overflow_grows_edge_array():
    gj0 = JG.uniform_random(64, avg_degree=4, seed=3)
    gj, gt = JS.streaming_graph(gj0), TS.streaming_graph(to_torch(gj0))
    assert csr(gt) == csr(gj)
    ecap0 = gt.num_edges
    nv = TS.real_vertices(gt)
    rng = np.random.default_rng(3)
    ups = []
    seen = set(TS.edge_map(gt))
    while len(seen) < ecap0 + 1:                 # force past capacity
        u, v = int(rng.integers(nv)), int(rng.integers(nv))
        if (u, v) not in seen:
            seen.add((u, v))
            ups.append(("insert", u, v, 1))
    gt2 = TS.apply_updates(gt, TS.make_batch(ups))
    assert gt2.num_edges > ecap0
    assert len(TS.edge_map(gt2)) == len(seen)
    assert csr(gt2) == csr(JS.apply_updates(gj, JS.make_batch(ups)))


@pytest.mark.parametrize("capacity", [None, 5000])
def test_streaming_graph_and_unpadded_match_jax(base_graph, traces,
                                                capacity):
    gj = JS.streaming_graph(base_graph, edge_capacity=capacity)
    gt = TS.streaming_graph(to_torch(base_graph), edge_capacity=capacity)
    assert csr(gt) == csr(gj)
    for ups in traces["sssp"]:
        gj = JS.apply_updates(gj, JS.make_batch(ups, capacity=CAP))
        gt = TS.apply_updates(gt, TS.make_batch(ups, capacity=CAP))
    assert gt.version == gj.version == 3
    assert TS.edge_map(gt) == JS.edge_map(gj)
    assert csr(TS.unpadded(gt)) == csr(JS.unpadded(gj))
    assert csr(gt.reverse()) == csr(gj.reverse())
    assert TS.real_vertices(gt.reverse()) == base_graph.num_vertices


def test_parallel_edges_keep_the_last_weight():
    """A graph with parallel edges (dedup=False): the edge set keeps the
    last weight in CSR order, as JAX's dict does."""
    src = np.array([0, 0, 0, 2, 1, 1])
    dst = np.array([1, 1, 2, 0, 2, 2])
    w = np.array([5, 3, 7, 1, 9, 4])
    gj = JG.from_edge_list(src, dst, 4, weights=w, dedup=False)
    gt = to_torch(gj)
    assert TS.edge_map(gt) == JS.edge_map(gj)
    assert csr(TS.streaming_graph(gt)) == csr(JS.streaming_graph(gj))


def test_hypothesis_random_updates(base_graph):
    hyp = pytest.importorskip(
        "hypothesis", reason="hypothesis not installed")
    from hypothesis import given, settings, strategies as hst
    del hyp

    nv = base_graph.num_vertices
    update = hst.one_of(
        hst.tuples(hst.just("insert"), hst.integers(0, nv - 1),
                   hst.integers(0, nv - 1), hst.integers(1, 30)),
        hst.tuples(hst.just("delete"), hst.integers(0, nv - 1),
                   hst.integers(0, nv - 1)),
        hst.tuples(hst.just("reweight"), hst.integers(0, nv - 1),
                   hst.integers(0, nv - 1), hst.integers(1, 30)))
    g0 = TS.streaming_graph(to_torch(base_graph))

    @settings(max_examples=20, deadline=None)
    @given(hst.lists(hst.lists(update, max_size=CAP), max_size=3))
    def check(trace):
        st = TS.stream_init(g0, "sssp", source=0, cfg=cfgs()[1])
        edges = dict(TS.edge_map(st.g))
        for ups in trace:
            TS.stream_update(st, TS.make_batch(ups, capacity=CAP))
            edges = oracle_apply(edges, ups)
            np.testing.assert_array_equal(
                st.real_labels.astype(np.int64),
                oracle_labels(edges, nv, "sssp", 0))

    check()


# ---------------------------------------------------------------------------
# The update path stays off the all-edges dict
# ---------------------------------------------------------------------------

def test_update_path_never_builds_the_edge_dict(base_graph, traces,
                                                monkeypatch):
    """``edge_map`` / ``unpadded`` raise here, and every lookup's key
    count is recorded: ``stream_update``, ``apply_updates``,
    ``diff_batch`` and ``QueryService.apply_updates`` run without the
    dict and look up only the keys a batch touches."""
    g = TS.streaming_graph(to_torch(base_graph))
    st = TS.stream_init(g, "sssp", source=0, cfg=cfgs()[1])
    svc = QueryService(num_slots=2, cfg=cfgs()[1])
    svc.register_graph("g", g)
    qid = svc.submit("g", "sssp", 0)
    svc.step()                                   # in flight: a stale bank

    def forbidden(*a, **k):
        raise AssertionError("the update path built the edge dict")

    looked_up = []
    real_lookup = TS._lookup

    def lookup(g, tkeys):
        looked_up.append(len(tkeys))
        return real_lookup(g, tkeys)

    monkeypatch.setattr(TS, "edge_map", forbidden)
    monkeypatch.setattr(TS, "unpadded", forbidden)
    monkeypatch.setattr(TS, "_lookup", lookup)
    for ups in traces["sssp"]:
        touched = len({(u, v) for _, u, v, *_ in ups})
        batch = TS.make_batch(ups, capacity=CAP)
        TS.diff_batch(st.g, batch)
        TS.apply_updates(st.g, batch)
        TS.stream_update(st, batch)
        svc.apply_updates("g", batch)
        assert looked_up[-5:] == [touched] * 5   # the engine replays twice
    svc.run()
    assert svc.poll(qid).status == "done"


# ---------------------------------------------------------------------------
# frontier.seed_from_edges and graph.pad_graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_from_edges_matches_jax(seed):
    """Masked slots, out-of-range ids (both ends) and negative ids
    (counted from the end) are treated as JAX's ``mode="drop"`` scatter
    treats them."""
    rng = np.random.default_rng(seed)
    v, k = 20, 16
    src = rng.integers(-25, 25, k).astype(np.int32)
    dst = rng.integers(-25, 25, k).astype(np.int32)
    mask = rng.random(k) < 0.6
    want = np.asarray(JF.seed_from_edges(src, dst, mask, v))
    got = TF.seed_from_edges(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(mask), v)
    assert got.dtype == torch.bool and got.shape == (v,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vm,em", [(8, 1024), (8, 1), (1, 1024), (16, 64),
                                   (1, 1)])
def test_pad_graph_matches_jax(vm, em):
    for gj in (JG.rmat(6, 4, seed=1), JG.road_grid(5),
               JG.from_edge_list(np.array([0]), np.array([1]), 8)):
        pj = JG.pad_graph(gj, v_multiple=vm, e_multiple=em)
        pt = TG.pad_graph(to_torch(gj), v_multiple=vm, e_multiple=em)
        assert csr(pt) == csr(pj)
        if pt.num_edges > int(pt.row_ptr[-1]):   # the padding invariant
            assert pt.num_vertices > gj.num_vertices
            assert (pt.col_idx[int(pt.row_ptr[-1]):] ==
                    pt.num_vertices - 1).all()
            assert int(pt.out_degrees()[-1]) == 0


def test_edge_map_is_in_key_order(base_graph, traces):
    """A standing difference: the port's ``edge_map`` iterates in
    ascending ``(u, v)`` order, built from the sorted device keys; JAX's
    dict iterates in insertion order, so after updates its new edges
    come last.  The two dicts are equal."""
    gj = JS.streaming_graph(base_graph)
    gt = TS.streaming_graph(to_torch(base_graph))
    for ups in traces["sssp"]:
        gj = JS.apply_updates(gj, JS.make_batch(ups, capacity=CAP))
        gt = TS.apply_updates(gt, TS.make_batch(ups, capacity=CAP))
    em_j, em_t = JS.edge_map(gj), TS.edge_map(gt)
    assert em_t == em_j
    assert list(em_t) == sorted(em_t)
    assert list(em_j) != sorted(em_j)
