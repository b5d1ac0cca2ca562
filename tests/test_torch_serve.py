"""Port parity: the continuous-batching query service
(``repro_torch.serve``) against the JAX package's (``repro.serve``).

Every case of ``tests/test_serve.py`` has a counterpart here.  A case
is a scenario written once against a *side* (the JAX package or the
port) and run on both with the same graphs, submissions and update
batches; what the two services observably did is then held equal:
each query's labels (bitwise), status, ``from_cache``, rounds-in-system,
preemptions and bound graph version, the ``admission_log``, every
``ServiceStats`` counter (``host_transfers`` included) and the cache's
counters.  The main scenarios run in each of the port's three modes
(host, spmd, fused) against JAX's same mode; the port's results are
also held against its own standalone ``bfs`` / ``sssp`` runs.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import graph as JG
from repro.core import frontier as JF
from repro.core import streaming as JS
from repro.core.apps import bfs as jbfs, sssp as jsssp
from repro.core.balancer import BalancerConfig as JCfg, relax as jrelax
from repro.core.apps.drivers import QUERY_APPS as JAPPS
from repro.serve import QueryService as JService
from repro_torch.core import graph as TG
from repro_torch.core import frontier as TF
from repro_torch.core import operators as TOPS
from repro_torch.core import streaming as TS
from repro_torch.core.apps import drivers as TD
from repro_torch.core.balancer import BalancerConfig as TCfg, relax as trelax
from repro_torch.serve import (QueryService as TService, ResultCache,
                               Scheduler, SlotView, QUEUED, DONE)

MODES = ["host", "spmd", "fused"]
CPU = "cpu"


class JaxSide:
    """The JAX package: graphs as built, results as numpy."""
    S = JS
    Cfg = JCfg

    def __init__(self, mode="host"):
        self.mode = mode

    def graph(self, gj):
        return gj

    def streaming(self, gj):
        return JS.streaming_graph(gj)

    def service(self, **kw):
        return JService(mode=self.mode, **kw)

    def standalone(self, app, g, s, cfg):
        fn = jbfs if app == "bfs" else jsssp
        return np.asarray(fn(g, s, cfg).labels)


class TorchSide(JaxSide):
    """The port, on the CPU: the same graphs copied into torch."""
    S = TS
    Cfg = TCfg

    def graph(self, gj):
        return TG.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                                   device=CPU)

    def streaming(self, gj):
        return TS.streaming_graph(self.graph(gj))

    def service(self, **kw):
        return TService(mode=self.mode, **kw)

    def standalone(self, app, g, s, cfg):
        fn = TD.bfs if app == "bfs" else TD.sssp
        return fn(g, s, cfg).labels.numpy()


def observe(svc, qids) -> dict:
    """What a service observably did for ``qids``."""
    qs = [svc.poll(q) for q in qids]
    return dict(
        results=[None if q.result is None else
                 (q.result.dtype.str, q.result.tobytes()) for q in qs],
        status=[q.status for q in qs],
        from_cache=[q.from_cache for q in qs],
        rounds=[q.rounds_in_system for q in qs],
        preemptions=[q.preemptions for q in qs],
        version=[q.version for q in qs],
        admission_log=list(svc.admission_log),
        stats=dataclasses.asdict(svc.stats),
        cache=(len(svc.cache), svc.cache.hits, svc.cache.misses))


def both(scenario, mode="host", **kw):
    """Run ``scenario`` on both sides; assert they observed the same;
    return the port's ``(svc, qids, extra)``."""
    got = scenario(TorchSide(mode), **kw)
    want = scenario(JaxSide(mode), **kw)
    assert observe(got[0], got[1]) == observe(want[0], want[1])
    assert got[2:] == want[2:]
    return got


@pytest.fixture(scope="module")
def rmat_g():
    return JG.rmat(8, 8, seed=3)


@pytest.fixture(scope="module")
def path_star_g():
    """An 80-hop path (the giant-diameter query) and a star."""
    n_path, hub, leaves = 80, 80, range(82, 90)
    src = list(range(n_path)) + [hub] * len(list(leaves))
    dst = list(range(1, n_path + 1)) + list(leaves)
    return JG.from_edge_list(np.asarray(src), np.asarray(dst), 90)


def _sources(g, n, seed=0):
    deg = np.asarray(g.out_degrees())
    cand = np.flatnonzero(deg > 0)
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.choice(cand, size=n, replace=False)]


def check_standalone(x, svc, qids, apps_sources, g, cfg):
    for qid, (app, s) in zip(qids, apps_sources):
        np.testing.assert_array_equal(svc.poll(qid).result,
                                      x.standalone(app, g, s, cfg))


# ---------------------------------------------------------------------------
# lifecycle primitives
# ---------------------------------------------------------------------------

def test_rows_active_and_refill(rmat_g):
    v = rmat_g.num_vertices
    jl, jf = JF.multi_source_state(v, [1, 2, 3], JG.INF)
    tl, tf = TF.multi_source_state(v, [1, 2, 3], JG.INF, CPU)
    assert TF.rows_active(tf).tolist() == [True, True, True]
    # slot 1 refilled with source 5; 3 == B and 7 are dropped; -1 is
    # slot 2; the source -4 is clipped to 0, 10**6 to V - 1
    slots = np.array([1, 3, 7, -1, 0], np.int32)
    srcs = np.array([5, 0, 0, -4, 10 ** 6], np.int32)
    jl2, jf2 = JF.refill_rows(jl, jf, jnp.asarray(slots),
                              jnp.asarray(srcs), JG.INF)
    tl2, tf2 = TF.refill_rows(tl, tf, slots, srcs, JG.INF)
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl2))
    np.testing.assert_array_equal(tf2.numpy(), np.asarray(jf2))
    ref_l, ref_f = TF.multi_source_state(v, [1, 5, 0], JG.INF, CPU)
    np.testing.assert_array_equal(tl2[1].numpy(), ref_l[1].numpy())
    np.testing.assert_array_equal(tf2[1].numpy(), ref_f[1].numpy())
    assert torch.equal(tl, TF.multi_source_state(v, [1, 2, 3], JG.INF,
                                                 CPU)[0])  # not written


def test_load_rows_restores_snapshot(rmat_g):
    v = rmat_g.num_vertices
    labels, frontier = TF.multi_source_state(v, [1, 2], JG.INF, CPU)
    snap_l, snap_f = labels[0].numpy().copy(), frontier[0].numpy().copy()
    labels2, frontier2 = TF.refill_rows(labels, frontier, [0, 2], [7, 0],
                                        JG.INF)
    b = labels.shape[0]
    rows_l, rows_f = np.stack([snap_l, snap_l]), np.stack([snap_f, snap_f])
    labels3, frontier3 = TF.load_rows(labels2, frontier2, [0, b], rows_l,
                                      rows_f)
    assert torch.equal(labels3, labels) and torch.equal(frontier3, frontier)
    jl3, jf3 = JF.load_rows(jnp.asarray(labels2.numpy()),
                            jnp.asarray(frontier2.numpy()),
                            jnp.asarray([0, b], jnp.int32),
                            jnp.asarray(rows_l), jnp.asarray(rows_f))
    np.testing.assert_array_equal(labels3.numpy(), np.asarray(jl3))
    np.testing.assert_array_equal(frontier3.numpy(), np.asarray(jf3))


def test_relax_return_active(rmat_g):
    g = TorchSide().graph(rmat_g)
    cfg = TCfg(strategy="alb", threshold=32)
    op, fill = TD.QUERY_APPS["bfs"]
    labels, frontier = TF.multi_source_state(g.num_vertices, [1, 2], fill,
                                             CPU)
    frontier[1] = False                            # row 1 retired
    _, _, active = trelax(g, labels, labels, frontier, cfg, op,
                          return_active=True)
    assert active.tolist() == [True, False]
    jl, jf = JF.multi_source_state(rmat_g.num_vertices, [1, 2], fill)
    _, _, jact = jrelax(rmat_g, jl, jl, jf.at[1].set(False),
                        JCfg(strategy="alb", threshold=32), JAPPS["bfs"][0],
                        return_active=True)
    assert active.tolist() == jact.tolist()
    _, _, active = trelax(g, labels, labels, torch.zeros_like(frontier),
                          cfg, op, return_active=True)
    assert active.tolist() == [False, False]


def test_step_batch_rejects_non_min_ops(rmat_g):
    g = TorchSide().graph(rmat_g)
    labels, frontier = TF.multi_source_state(g.num_vertices, [1], JG.INF,
                                             CPU)
    with pytest.raises(ValueError, match="min-combine"):
        TD.step_batch(g, labels, frontier, TCfg(), TOPS.KCORE_DEC)


def test_service_validation(rmat_g):
    with pytest.raises(ValueError, match="num_slots"):
        TService(num_slots=0)
    with pytest.raises(ValueError, match="fused_rounds"):
        TService(mode="fused", fused_rounds=0)
    with pytest.raises(ValueError, match="round_budget"):
        TService(round_budget=0)
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=-1)


# ---------------------------------------------------------------------------
# mid-loop refill parity
# ---------------------------------------------------------------------------

def sc_served(x, g0, app, strategy, slots, n, seed):
    g = x.graph(g0)
    cfg = x.Cfg(strategy=strategy, threshold=32)
    svc = x.service(num_slots=slots, cfg=cfg)
    svc.register_graph("g", g)
    sources = _sources(g0, n, seed=seed)
    qids = [svc.submit("g", app, s) for s in sources]
    svc.run()
    return svc, qids, sources


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app,strategy,slots,n,seed", [
    ("bfs", "alb", 3, 10, 1), ("sssp", "alb", 3, 10, 1),
    ("bfs", "twc", 3, 10, 1), ("sssp", "twc", 3, 10, 1),
    ("bfs", "alb", 2, 5, 2)])
def test_served_queries_match_standalone(rmat_g, mode, app, strategy,
                                         slots, n, seed):
    """More queries than slots: refills mid-loop; every result bitwise
    equal to JAX's service and to the port's standalone run."""
    x = TorchSide(mode)
    svc, qids, sources = both(sc_served, mode, g0=rmat_g, app=app,
                              strategy=strategy, slots=slots, n=n,
                              seed=seed)
    check_standalone(x, svc, qids, [(app, s) for s in sources],
                     x.graph(rmat_g), TCfg(strategy=strategy, threshold=32))
    assert len(svc.admission_log) == n
    assert svc.stats.queries_served == n


def sc_mixed(x, g0):
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.graph(g0))
    sources = _sources(g0, 4, seed=3)
    qids = [svc.submit("g", "bfs", s) for s in sources]
    qids += [svc.submit("g", "sssp", s) for s in sources]
    svc.run()
    return svc, qids, sources


@pytest.mark.parametrize("mode", MODES)
def test_mixed_apps_one_service(rmat_g, mode):
    x = TorchSide(mode)
    svc, qids, sources = both(sc_mixed, mode, g0=rmat_g)
    check_standalone(x, svc, qids,
                     [("bfs", s) for s in sources]
                     + [("sssp", s) for s in sources],
                     x.graph(rmat_g), TCfg(strategy="alb", threshold=32))


def sc_zero_out(x, g0):
    deg = np.asarray(g0.out_degrees())
    s = int(np.flatnonzero(deg == 0)[0])
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.graph(g0))
    qid = svc.submit("g", "bfs", s)
    svc.run()
    return svc, [qid], s


def test_zero_out_degree_source(rmat_g):
    svc, qids, s = both(sc_zero_out, g0=rmat_g)
    x = TorchSide()
    check_standalone(x, svc, qids, [("bfs", s)], x.graph(rmat_g),
                     TCfg(strategy="alb", threshold=32))


# ---------------------------------------------------------------------------
# fairness
# ---------------------------------------------------------------------------

def sc_budget(x, g0, budget):
    svc = x.service(num_slots=1, cfg=x.Cfg(strategy="alb", threshold=32),
                    round_budget=budget)
    svc.register_graph("p", x.graph(g0))
    qids = [svc.submit("p", "bfs", s) for s in [0, 80, 82, 83]]
    svc.run()
    return svc, qids


@pytest.mark.parametrize("mode", MODES)
def test_round_budget_prevents_starvation(path_star_g, mode):
    svc, qids = both(sc_budget, mode, g0=path_star_g, budget=None)
    starved = [svc.poll(q).rounds_in_system for q in qids[1:]]
    assert svc.stats.preemptions == 0
    svc, qids = both(sc_budget, mode, g0=path_star_g, budget=5)
    fair = [svc.poll(q).rounds_in_system for q in qids[1:]]
    assert max(fair) < min(starved)
    if mode != "fused":                   # a fused step runs 8 rounds
        assert min(starved) > 70 and max(fair) <= 15
    assert svc.poll(qids[0]).preemptions >= 1
    x = TorchSide(mode)
    check_standalone(x, svc, qids[:1], [("bfs", 0)], x.graph(path_star_g),
                     TCfg(strategy="alb", threshold=32))


def sc_preempt(x, g0, sources):
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32),
                    round_budget=4)
    svc.register_graph("p", x.graph(g0))
    qids = [svc.submit("p", "bfs", s) for s in sources]
    svc.run()
    return svc, qids


@pytest.mark.parametrize("mode", MODES)
def test_preempt_resume_parity_multislot(path_star_g, mode):
    sources = [0, 10, 80, 82, 83, 84, 20]
    svc, qids = both(sc_preempt, mode, g0=path_star_g, sources=sources)
    assert svc.stats.preemptions >= 1
    x = TorchSide(mode)
    check_standalone(x, svc, qids, [("bfs", s) for s in sources],
                     x.graph(path_star_g),
                     TCfg(strategy="alb", threshold=32))


def test_scheduler_plan_is_pure_and_bounded():
    sch = Scheduler(round_budget=3)
    slots = [SlotView(0, qid=7, slot_rounds=5),
             SlotView(1, qid=8, slot_rounds=9),
             SlotView(2, qid=None, slot_rounds=0)]
    d = sch.plan(slots, pending=1)
    assert d.preempt == () and d.admit == (2,)
    d = sch.plan(slots, pending=2)
    assert d.preempt == (1,) and d.admit == (1, 2)
    d = sch.plan(slots, pending=3)
    assert d.preempt == (1, 0) and d.admit == (0, 1, 2)
    d = sch.plan(slots, pending=0)
    assert d.preempt == () and d.admit == ()
    d = Scheduler(round_budget=None).plan(slots, pending=5)
    assert d.preempt == () and d.admit == (2,)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def sc_reregister(x, g0, g1):
    s = _sources(g0, 1, seed=4)[0]
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.graph(g0))
    q1 = svc.submit("g", "bfs", s)
    svc.run()
    q2 = svc.submit("g", "bfs", s)
    svc.register_graph("g", x.graph(g1))
    q3 = svc.submit("g", "bfs", s)
    status3 = svc.poll(q3).status
    svc.run()
    return svc, [q1, q2, q3], status3, s


def test_cache_hit_and_invalidation_on_reregistration(rmat_g):
    g2 = JG.rmat(8, 8, seed=99)
    svc, (q1, q2, q3), status3, s = both(sc_reregister, g0=rmat_g, g1=g2)
    r1, r2, r3 = svc.poll(q1), svc.poll(q2), svc.poll(q3)
    assert not r1.from_cache and r2.from_cache
    assert r2.status == DONE and r2.rounds_in_system == 0
    assert status3 == QUEUED and not r3.from_cache
    x = TorchSide()
    np.testing.assert_array_equal(
        r3.result, x.standalone("bfs", x.graph(g2), s,
                                TCfg(strategy="alb", threshold=32)))


def sc_single_flight(x, g0):
    s = _sources(g0, 1, seed=8)[0]
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.graph(g0))
    qids = [svc.submit("g", "bfs", s) for _ in range(4)]
    qids.append(svc.submit("g", "bfs", _sources(g0, 2, seed=9)[1]))
    svc.run()
    return svc, qids


@pytest.mark.parametrize("mode", MODES)
def test_single_flight_coalescing(rmat_g, mode):
    svc, qids = both(sc_single_flight, mode, g0=rmat_g)
    followers = [svc.poll(q) for q in qids[1:4]]
    assert all(f.from_cache for f in followers)
    assert {qid for _, qid, _ in svc.admission_log} == {qids[0], qids[4]}
    assert svc.stats.cache_hits == 3 and svc.stats.cache_misses == 2


def test_reregistration_rejected_while_in_flight(path_star_g):
    for x in (TorchSide(), JaxSide()):
        svc = x.service(num_slots=1)
        g = x.graph(path_star_g)
        svc.register_graph("p", g)
        svc.submit("p", "bfs", 0)
        with pytest.raises(ValueError, match="in flight"):
            svc.register_graph("p", g)


def test_cache_keyed_by_strategy(rmat_g):
    s = _sources(rmat_g, 1, seed=5)[0]
    cfg = TCfg(strategy="alb", threshold=32)
    svc = TService(num_slots=2, cfg=cfg)
    svc.register_graph("g", TorchSide().graph(rmat_g))
    svc.submit("g", "bfs", s)
    svc.run()
    assert svc.cache.get("g", "bfs", s, TCfg(strategy="twc")) is None
    assert svc.cache.get("g", "bfs", s, cfg) is not None
    rewired = dataclasses.replace(cfg, wire="delta")
    assert rewired != cfg
    assert svc.cache.get("g", "bfs", s, rewired) is None


def test_result_cache_lru_eviction():
    c = ResultCache(capacity=2)
    c.put("g", "bfs", 0, "a", np.zeros(1))
    c.put("g", "bfs", 1, "a", np.ones(1))
    assert c.get("g", "bfs", 0, "a") is not None
    c.put("g", "bfs", 2, "a", np.ones(1))          # evicts 1
    assert c.get("g", "bfs", 1, "a") is None
    assert c.get("g", "bfs", 0, "a") is not None
    assert len(c) == 2 and c.hit_rate == pytest.approx(2 / 3)
    assert c.invalidate_graph("g") == 2 and len(c) == 0
    disabled = ResultCache(capacity=0)
    disabled.put("g", "bfs", 0, "a", np.zeros(1))
    assert disabled.get("g", "bfs", 0, "a") is None


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def sc_order(x, g0):
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32),
                    round_budget=4)
    svc.register_graph("p", x.graph(g0))
    qids = [svc.submit("p", "bfs", s) for s in [0, 80, 10, 82, 83, 20]]
    svc.run()
    return svc, qids


def test_deterministic_scheduler_order(path_star_g):
    a, qa = both(sc_order, g0=path_star_g)
    b, qb = sc_order(TorchSide(), path_star_g)
    assert observe(a, qa) == observe(b, qb)


def sc_fifo(x, g0):
    svc = x.service(num_slots=2, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.graph(g0))
    qids = [svc.submit("g", "bfs", s) for s in _sources(g0, 6, 6)]
    svc.run()
    return svc, qids


def test_fifo_admission_order(rmat_g):
    svc, qids = both(sc_fifo, g0=rmat_g)
    admitted = [qid for _, qid, _ in svc.admission_log]
    assert admitted == sorted(admitted) == qids


# ---------------------------------------------------------------------------
# submit validation + stats
# ---------------------------------------------------------------------------

def test_submit_validation(rmat_g):
    msgs = []
    for x in (TorchSide(), JaxSide()):
        svc = x.service(num_slots=1)
        svc.register_graph("g", x.graph(rmat_g))
        got = []
        for args in (("nope", "bfs", 0), ("g", "pagerank", 0),
                     ("g", "bfs", rmat_g.num_vertices)):
            with pytest.raises(ValueError) as e:
                svc.submit(*args)
            got.append(str(e.value))
        with pytest.raises(ValueError, match="unknown graph"):
            svc.apply_updates("nope", x.S.make_batch([]))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def sc_stats(x, g0):
    svc = x.service(num_slots=4, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.graph(g0))
    sources = _sources(g0, 6, seed=7)
    qids = [svc.submit("g", "bfs", s) for s in sources]
    svc.run()
    qids.append(svc.submit("g", "bfs", sources[0]))   # one cache hit
    return svc, qids, svc.stats.summary()


@pytest.mark.parametrize("mode", MODES)
def test_service_stats_accounting(rmat_g, mode):
    svc, _, summary = both(sc_stats, mode, g0=rmat_g)
    st = svc.stats
    assert st.queries_served == 7
    assert st.cache_hits == 1 and st.cache_misses == 6
    assert 0 < st.occupancy <= 1
    assert st.latency_percentile(50) <= st.latency_percentile(95)
    assert summary["cache_hit_rate"] == pytest.approx(1 / 7, abs=1e-4)
    assert st.host_transfers > 0


# ---------------------------------------------------------------------------
# published results are read-only shared state
# ---------------------------------------------------------------------------

def test_published_results_are_readonly(rmat_g):
    svc = TService(num_slots=2, cfg=TCfg(strategy="alb", threshold=32))
    svc.register_graph("g", TorchSide().graph(rmat_g))
    src = _sources(rmat_g, 1, seed=11)[0]
    qid = svc.submit("g", "bfs", src)
    svc.run()
    res = svc.poll(qid).result
    expected = res.copy()
    with pytest.raises(ValueError):
        res[0] = -1
    np.testing.assert_array_equal(svc.poll(qid).result, expected)
    hit = svc.poll(svc.submit("g", "bfs", src))
    assert hit.from_cache
    np.testing.assert_array_equal(hit.result, expected)
    with pytest.raises(ValueError):
        hit.result[:] = 0


def test_cache_put_freezes_array():
    cache = ResultCache(capacity=4)
    arr = np.arange(5, dtype=np.int32)
    cfg = TCfg(strategy="alb", threshold=32)
    cache.put("g", "bfs", 0, cfg, arr)
    got = cache.get("g", "bfs", 0, cfg)
    assert got is arr
    with pytest.raises(ValueError):
        got[0] = 99


def test_follower_results_are_readonly(rmat_g):
    svc = TService(num_slots=1, cfg=TCfg(strategy="alb", threshold=32))
    svc.register_graph("g", TorchSide().graph(rmat_g))
    src = _sources(rmat_g, 1, seed=13)[0]
    qid1 = svc.submit("g", "bfs", src)
    qid2 = svc.submit("g", "bfs", src)
    svc.run()
    r1, r2 = svc.poll(qid1).result, svc.poll(qid2).result
    assert r1 is r2
    with pytest.raises(ValueError):
        r2[0] = 1


# ---------------------------------------------------------------------------
# traversal direction through the serving engine
# ---------------------------------------------------------------------------

def sc_adaptive(x, g0):
    cfg = x.Cfg(strategy="alb", threshold=32, direction="adaptive")
    svc = x.service(num_slots=2, cfg=cfg)
    svc.register_graph("g", x.graph(g0))
    sources = _sources(g0, 3, seed=17)
    qids = [svc.submit("g", "bfs", s) for s in sources]
    svc.run()
    return svc, qids, sources


@pytest.mark.parametrize("mode", MODES)
def test_served_query_matches_standalone_adaptive_direction(rmat_g, mode):
    x = TorchSide(mode)
    svc, qids, sources = both(sc_adaptive, mode, g0=rmat_g)
    check_standalone(x, svc, qids, [("bfs", s) for s in sources],
                     x.graph(rmat_g), TCfg(strategy="alb", threshold=32))
    cfg = TCfg(strategy="alb", threshold=32)
    assert svc.cache.key("g", "bfs", 0, svc.cfg) != svc.cache.key(
        "g", "bfs", 0, cfg)


# ---------------------------------------------------------------------------
# streaming updates through the service
# ---------------------------------------------------------------------------

def _two_components():
    """Two disjoint 10-vertex cycles."""
    src, dst = [], []
    for base in (0, 10):
        for i in range(10):
            src.append(base + i)
            dst.append(base + (i + 1) % 10)
    return JG.from_edge_list(np.asarray(src), np.asarray(dst), 20)


def sc_region(x):
    svc = x.service(num_slots=4, cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", x.streaming(_two_components()))
    qids = [svc.submit("g", "bfs", 0), svc.submit("g", "bfs", 10)]
    svc.run()
    evicted = svc.apply_updates("g", x.S.make_batch([("insert", 15, 17,
                                                      1)]))
    left = len(svc.cache)
    qids += [svc.submit("g", "bfs", 0), svc.submit("g", "bfs", 10)]
    svc.run()
    return svc, qids, evicted, left


@pytest.mark.parametrize("mode", MODES)
def test_region_tagged_eviction_preserves_hit_rate_floor(mode):
    svc, qids, evicted, left = both(sc_region, mode)
    assert evicted == 1 and left == 1
    assert svc.poll(qids[2]).from_cache and not svc.poll(qids[3]).from_cache
    assert svc.poll(qids[2]).result is svc.poll(qids[0]).result
    g2 = svc._graphs["g"]
    nv = TS.real_vertices(g2)
    for qid, s in ((qids[2], 0), (qids[3], 10)):
        np.testing.assert_array_equal(
            svc.poll(qid).result[:nv],
            TD.bfs(g2, s, svc.cfg).labels[:nv].numpy())


def test_untagged_entries_evicted_conservatively():
    cache = ResultCache(capacity=8)
    cfg = TCfg(strategy="alb", threshold=32)
    cache.put("g", "bfs", 0, cfg, np.zeros(20, np.int32))
    cache.put("g", "bfs", 1, cfg, np.ones(20, np.int32),
              region=np.zeros(20, bool))
    assert cache.invalidate_delta("g", [5]) == 1
    assert cache.get("g", "bfs", 1, cfg) is not None


# the cases below act between two steps of a query: a fused step of
# one round keeps its query in flight there, as a host step does

def sc_version_flight(x):
    g = x.streaming(JG.rmat(6, 4, seed=2))
    svc = x.service(fused_rounds=1, num_slots=2,
                    cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", g)
    qa = svc.submit("g", "sssp", 0)
    qa2 = svc.submit("g", "sssp", 0)
    svc.step()
    snapshot = svc._banks[("g", "sssp")].g
    svc.apply_updates("g", x.S.make_batch([("insert", 0, 9, 1)]))
    qb = svc.submit("g", "sssp", 0)
    svc.run()
    return svc, [qa, qa2, qb], snapshot.version


@pytest.mark.parametrize("mode", MODES)
def test_single_flight_keys_on_graph_version(mode):
    svc, (qa, qa2, qb), _ = both(sc_version_flight, mode)
    assert svc.poll(qb).version == svc._graphs["g"].version
    assert svc.poll(qb).version != svc.poll(qa).version
    assert svc.poll(qa2).from_cache and not svc.poll(qb).from_cache
    assert svc.poll(qa2).result is svc.poll(qa).result
    new = svc._graphs["g"]
    nv = TS.real_vertices(new)
    np.testing.assert_array_equal(
        svc.poll(qb).result[:nv],
        TD.sssp(new, 0, svc.cfg).labels[:nv].numpy())
    assert not np.array_equal(svc.poll(qa).result[:nv],
                              svc.poll(qb).result[:nv])


def sc_stale_bank(x):
    g = x.streaming(JG.rmat(6, 4, seed=2))
    svc = x.service(fused_rounds=1, num_slots=1,
                    cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", g)
    qids = [svc.submit("g", "bfs", 0), svc.submit("g", "bfs", 1)]
    svc.step()
    svc.apply_updates("g", x.S.make_batch([("insert", 1, 2, 1)]))
    bank = svc._banks[("g", "bfs")]
    stale = (bank.stale, bank.busy())
    svc.run()
    cached = (svc.cache.get("g", "bfs", 1, svc.cfg) is not None,
              svc.cache.get("g", "bfs", 0, svc.cfg) is not None)
    bound = svc._banks[("g", "bfs")].g.version
    return svc, qids, stale, cached, bound


@pytest.mark.parametrize("mode", MODES)
def test_stale_bank_drains_and_is_replaced(mode):
    svc, qids, stale, cached, bound = both(sc_stale_bank, mode)
    assert stale == (True, 1)
    assert [svc.poll(q).status for q in qids] == [DONE, DONE]
    assert cached == (True, False)
    assert bound == svc._graphs["g"].version


def sc_rebind(x):
    g = x.streaming(JG.rmat(6, 4, seed=2))
    svc = x.service(fused_rounds=1, num_slots=1,
                    cfg=x.Cfg(strategy="alb", threshold=32))
    svc.register_graph("g", g)
    qids = [svc.submit("g", "bfs", 0), svc.submit("g", "bfs", 3)]
    svc.step()
    svc.apply_updates("g", x.S.make_batch([("insert", 3, 5, 1)]))
    svc.run()
    qids.append(svc.submit("g", "bfs", 3))
    return svc, qids


@pytest.mark.parametrize("mode", MODES)
def test_queued_query_rebinds_to_new_version_at_admission(mode):
    svc, (qa, qb, qc) = both(sc_rebind, mode)
    new = svc._graphs["g"]
    assert svc.poll(qb).version == new.version
    nv = TS.real_vertices(new)
    np.testing.assert_array_equal(
        svc.poll(qb).result[:nv],
        TD.bfs(new, 3, svc.cfg).labels[:nv].numpy())
    assert svc.poll(qc).from_cache


def sc_cancel_mid_update(x):
    """Cancel a running query on a stale bank, and a preempted one."""
    g = x.streaming(JG.rmat(6, 4, seed=2))
    svc = x.service(fused_rounds=1, num_slots=2,
                    cfg=x.Cfg(strategy="alb", threshold=32), round_budget=1)
    svc.register_graph("g", g)
    qids = [svc.submit("g", "sssp", s) for s in (0, 1, 2, 3)]
    svc.step()
    svc.apply_updates("g", x.S.make_batch([("delete", 0, 1),
                                           ("insert", 2, 7, 3)]))
    cancelled = [svc.cancel(qids[0]), svc.cancel(qids[2])]
    svc.run()
    return svc, qids, cancelled


@pytest.mark.parametrize("mode", MODES)
def test_cancel_across_an_update(mode):
    svc, qids, cancelled = both(sc_cancel_mid_update, mode)
    assert cancelled == [True, True]
    assert svc.stats.cancellations == 2
