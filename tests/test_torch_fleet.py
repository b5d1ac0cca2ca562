"""Port parity: the serving fleet (``repro_torch.serve.fleet``) against
the JAX package's (``repro.serve.fleet``).

Every case of ``tests/test_fleet.py`` has a counterpart here.  The pure
policy (rendezvous order, ``decide``, the load ceiling, the feedback
controller, the hedge predicate) is held equal on the same inputs.
Each fleet case is a scenario run on both packages with the same graph
and traffic: the port's ``RoutingTrace`` rows equal the JAX fleet's
field for field, replay with no divergence, and every published result
is bitwise equal to JAX's and to the port's standalone run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.balancer import BalancerConfig as JCfg
from repro.serve import fleet as JFL
from repro_torch.core import graph as TG
from repro_torch.core.apps import drivers as TD
from repro_torch.core.balancer import BalancerConfig as TCfg
from repro_torch.serve import QueryService, CANCELLED, DONE, RUNNING
from repro_torch.serve import fleet as TFL
from repro_torch.serve.fleet import (Fleet, FleetQuery, RouterConfig,
                                     decide,
                                     rendezvous_order, load_ceiling,
                                     FeedbackController, HedgePolicy,
                                     hedgeable, TraceRow, replay,
                                     ceiling_violations)

CPU = "cpu"


class JaxSide:
    FL = JFL
    Cfg = JCfg

    def graph(self, gj):
        return gj


class TorchSide(JaxSide):
    FL = TFL
    Cfg = TCfg

    def graph(self, gj):
        return TG.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                                   device=CPU)


def rows_of(fleet):
    """A trace's rows as plain tuples (the two packages' classes)."""
    return [dataclasses.astuple(r) for r in fleet.trace.rows]


def observe(fleet, fqids) -> dict:
    recs = [fleet.poll(f) for f in fqids]
    return dict(
        trace=rows_of(fleet),
        results=[None if r.result is None else r.result.tobytes()
                 for r in recs],
        status=[r.status for r in recs],
        winner=[r.winner for r in recs],
        hedges=[r.hedges for r in recs],
        from_cache=[r.from_cache for r in recs],
        steps=[r.steps_in_system for r in recs],
        submissions=[r.submissions for r in recs],
        summary=fleet.summary())


def both(scenario, **kw):
    """Run ``scenario`` on both packages; assert the same observations;
    return the port's ``(fleet, fqids, traffic)``."""
    got = scenario(TorchSide(), **kw)
    want = scenario(JaxSide(), **kw)
    assert observe(got[0], got[1]) == observe(want[0], want[1])
    assert replay(got[0].trace.rows) == []
    return got


@pytest.fixture(scope="module")
def rmat_g():
    return JG.rmat(8, 8, seed=3)


def _sources(g, n, seed=0):
    deg = np.asarray(g.out_degrees())
    cand = np.flatnonzero(deg > 0)
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.choice(cand, size=n, replace=False)]


def _zipf_traffic(sources, n, seed=7):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(sources) + 1, dtype=np.float64)
    p = (1.0 / ranks) / np.sum(1.0 / ranks)
    return [sources[i] for i in rng.choice(len(sources), size=n, p=p)]


def _fleet(x, n=3, slots=4, cache=64, seed=1, **router_kw):
    return x.FL.Fleet(num_replicas=n,
                      cfg=x.Cfg(strategy="alb", threshold=32),
                      num_slots=slots, cache_capacity=cache, seed=seed,
                      router=x.FL.RouterConfig(**router_kw))


def standalone(g0, s):
    g = TorchSide().graph(g0)
    return TD.bfs(g, s, TCfg(strategy="alb", threshold=32)).labels.numpy()


# ---------------------------------------------------------------------------
# rendezvous hashing and decide(): the same answers as JAX's
# ---------------------------------------------------------------------------

def _keys(n):
    return [("g", "bfs", i) for i in range(n)]


def test_rendezvous_order_matches_jax():
    for n in (1, 2, 3, 5, 8):
        for key in _keys(60):
            order = rendezvous_order(key, n)
            assert sorted(order) == list(range(n))
            assert order == JFL.rendezvous_order(key, n)


def test_rendezvous_removal_remaps_only_removed_keys():
    for key in _keys(200):
        before = rendezvous_order(key, 5)[0]
        after = rendezvous_order(key, 4)[0]
        if before != 4:
            assert after == before
        else:
            assert after != 4


def test_rendezvous_addition_steals_about_one_nth():
    keys = _keys(2000)
    moved = 0
    for key in keys:
        before = rendezvous_order(key, 4)[0]
        after = rendezvous_order(key, 5)[0]
        if after != before:
            assert after == 4
            moved += 1
    assert 0.1 < moved / len(keys) < 0.3


def _inputs(fl, loads, key=("g", "bfs", 0), kind="route", pair=None,
            scores=None, affinity=True, c=1.25, exclude=(), seq=0,
            fqid=0):
    n = len(loads)
    return fl.DecisionInputs(
        seq=seq, fqid=fqid, kind=kind, key=key, loads=tuple(loads),
        scores=tuple(scores if scores is not None else loads),
        order=fl.rendezvous_order(key, n),
        pair=tuple(pair if pair is not None else range(min(2, n))),
        capacity_factor=c, affinity=affinity, exclude=tuple(exclude))


def decide_both(**kw):
    got = decide(_inputs(TFL, **kw))
    assert got == JFL.decide(_inputs(JFL, **kw))
    return got


def test_affinity_wins_under_ceiling():
    inp = _inputs(TFL, [0, 0, 0])
    assert decide_both(loads=[0, 0, 0]) == (inp.order[0], "affinity")


def test_overloaded_affinity_spills():
    key = ("g", "bfs", 0)
    aff = rendezvous_order(key, 3)[0]
    loads = [0, 0, 0]
    loads[aff] = 10
    others = [r for r in range(3) if r != aff]
    choice, reason = decide_both(loads=loads, key=key, pair=others)
    assert reason == "spill" and choice != aff


def test_p2c_picks_lower_scored_of_pair():
    assert decide_both(loads=[1, 1, 1], affinity=False, pair=(0, 2),
                       scores=(9.0, 0.0, 3.0)) == (2, "p2c")


def test_decision_never_exceeds_ceiling():
    inp = _inputs(TFL, [9, 9, 0], affinity=False, pair=(0, 1),
                  scores=(1.0, 2.0, 50.0))
    choice, _ = decide_both(loads=[9, 9, 0], affinity=False, pair=(0, 1),
                            scores=(1.0, 2.0, 50.0))
    assert inp.loads[choice] + 1 <= load_ceiling(inp.loads,
                                                 inp.capacity_factor)
    assert choice == 2


def test_hedge_respects_exclusions():
    choice, reason = decide_both(loads=[1, 1, 1], kind="hedge",
                                 pair=(0, 1), exclude=(0,))
    assert reason == "hedge" and choice != 0


def test_decide_matches_jax_on_random_inputs():
    """The property tests' cases, on seeded draws: bounded load, the
    lower-scored P2C candidate, and the same decision as JAX's."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(2, 9))
        loads = [int(x) for x in rng.integers(0, 21, n)]
        pair = sorted({int(x) for x in rng.integers(0, n, 2)})
        scores = [float(x) for x in rng.uniform(0, 100, n)]
        kw = dict(loads=loads, key=("g", "bfs", int(rng.integers(1000))),
                  pair=pair, scores=scores,
                  affinity=bool(rng.integers(2)),
                  c=float(rng.uniform(1.0, 2.0)))
        choice, reason = decide_both(**kw)
        assert loads[choice] + 1 <= load_ceiling(loads, kw["c"])
        best = min(pair, key=lambda r: (scores[r], r))
        if not kw["affinity"] and loads[best] + 1 <= load_ceiling(
                loads, kw["c"]):
            assert (choice, reason) == (best, "p2c")


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

def sc_drained(x, g0, n_queries=30, seed=2, **kw):
    fleet = _fleet(x, seed=seed, **kw)
    fleet.register_graph("g", x.graph(g0))
    traffic = _zipf_traffic(_sources(g0, 8), n_queries, seed=seed)
    fqids = [fleet.submit("g", "bfs", s) for s in traffic]
    fleet.run()
    return fleet, fqids, traffic


def test_trace_replays_exactly(rmat_g):
    fleet, _, _ = both(sc_drained, g0=rmat_g)
    assert len(fleet.trace) >= 30
    assert ceiling_violations(fleet.trace.rows) == []


def test_trace_deterministic_across_runs(rmat_g):
    a, _, _ = both(sc_drained, g0=rmat_g, seed=5)
    b, _, _ = sc_drained(TorchSide(), rmat_g, seed=5)
    assert a.trace.rows == b.trace.rows


def test_replay_reports_corruption(rmat_g):
    fleet, _, _ = sc_drained(TorchSide(), rmat_g)
    rows = list(fleet.trace.rows)
    tampered = rows[3]
    wrong = (tampered.choice + 1) % len(tampered.inputs.loads)
    rows[3] = TraceRow(inputs=tampered.inputs, choice=wrong,
                       reason=tampered.reason)
    divs = replay(rows)
    assert [d.seq for d in divs] == [rows[3].inputs.seq]
    assert divs[0].recorded[0] == wrong
    assert divs[0].derived == (tampered.choice, tampered.reason)
    rows[3] = TraceRow(inputs=tampered.inputs, choice=tampered.choice,
                       reason="spill" if tampered.reason != "spill"
                       else "p2c")
    assert [d.seq for d in replay(rows)] == [rows[3].inputs.seq]
    heavy = dataclasses.replace(
        rows[5].inputs, loads=tuple(
            40 if r == rows[5].choice else 0
            for r in range(len(rows[5].inputs.loads))))
    assert ceiling_violations(
        [TraceRow(inputs=heavy, choice=rows[5].choice,
                  reason=rows[5].reason)]) == [heavy.seq]


def test_hedge_decisions_are_traced(rmat_g):
    fleet, _, _ = both(sc_drained, g0=rmat_g, n_queries=16, seed=3,
                       cache=0, hedge_after=2)
    kinds = {row.inputs.kind for row in fleet.trace.rows}
    assert "route" in kinds
    for row in fleet.trace.rows:
        if row.inputs.kind == "hedge":
            assert row.choice not in row.inputs.exclude
            assert row.reason == "hedge"


# ---------------------------------------------------------------------------
# hedge race: parity, single publication, cancellation
# ---------------------------------------------------------------------------

def sc_race(x, g0, throttles=(4, 4, 4)):
    fleet = _fleet(x, cache=0, seed=4, hedge_after=2)
    fleet.register_graph("g", x.graph(g0))
    for rep, t in zip(fleet.replicas, throttles):
        rep.throttle = t
    srcs = _sources(g0, 10, seed=1)
    fqids = [fleet.submit("g", "bfs", s) for s in srcs]
    fleet.run()
    return fleet, fqids, srcs


def test_hedge_race_parity_and_single_freeze(rmat_g, monkeypatch):
    import repro_torch.serve.fleet.fleet as fleet_mod
    calls = []
    real_freeze = fleet_mod.freeze

    def spy(arr):
        calls.append(id(arr))
        return real_freeze(arr)

    monkeypatch.setattr(fleet_mod, "freeze", spy)
    fleet, fqids, srcs = both(sc_race, g0=rmat_g)
    summary = fleet.summary()
    assert summary["hedges_launched"] > 0
    assert len(calls) == len(fqids)
    assert summary["queries_served"] == len(fqids)
    for fqid, s in zip(fqids, srcs):
        rec = fleet.poll(fqid)
        assert rec.status == DONE and rec.winner is not None
        np.testing.assert_array_equal(rec.result, standalone(rmat_g, s))
        assert not rec.result.flags.writeable
        for rid, rqid in rec.submissions:
            q = fleet.replicas[rid].svc.poll(rqid)
            assert q.status in (DONE, CANCELLED)
            if rid != rec.winner:
                assert q.status == CANCELLED
    assert summary["device_computations"] >= len(fqids)


def test_straggler_throttle_fires_hedges(rmat_g):
    """One slow replica (throttle 2) among fast ones: hedges fire and
    the trace still equals JAX's."""
    fleet, fqids, srcs = both(sc_race, g0=rmat_g, throttles=(1, 2, 1))
    for fqid, s in zip(fqids, srcs):
        np.testing.assert_array_equal(fleet.poll(fqid).result,
                                      standalone(rmat_g, s))


def test_hedges_skipped_when_fleet_saturated(rmat_g):
    fleet, _, _ = both(sc_drained, g0=rmat_g, n_queries=40, seed=6,
                       cache=0, hedge_after=1)
    assert ceiling_violations(fleet.trace.rows) == []


# ---------------------------------------------------------------------------
# engine cancellation (the serve-layer hook hedging relies on)
# ---------------------------------------------------------------------------

def _svc(g0, slots=2, cache=0):
    svc = QueryService(num_slots=slots,
                       cfg=TCfg(strategy="alb", threshold=32),
                       cache_capacity=cache)
    svc.register_graph("g", TorchSide().graph(g0))
    return svc


def test_cancel_queued_query(rmat_g):
    svc = _svc(rmat_g, slots=1)
    a = svc.submit("g", "bfs", _sources(rmat_g, 2)[0])
    b = svc.submit("g", "bfs", _sources(rmat_g, 2)[1])
    svc.step()
    assert svc.cancel(b)
    assert svc.poll(b).status == CANCELLED
    svc.run()
    assert svc.poll(a).status == DONE
    assert not svc.cancel(a)
    assert not svc.cancel(b)


def test_cancel_running_query_frees_slot(rmat_g):
    svc = _svc(rmat_g, slots=1)
    srcs = _sources(rmat_g, 2)
    a = svc.submit("g", "bfs", srcs[0])
    b = svc.submit("g", "bfs", srcs[1])
    svc.step()
    assert svc.poll(a).status == RUNNING
    assert svc.cancel(a)
    assert svc.poll(a).status == CANCELLED
    svc.run()
    qb = svc.poll(b)
    assert qb.status == DONE
    np.testing.assert_array_equal(qb.result, standalone(rmat_g, srcs[1]))
    assert svc.stats.cancellations == 1


def test_cancel_follower_detaches_from_primary(rmat_g):
    s = _sources(rmat_g, 1)[0]
    svc = _svc(rmat_g, slots=2)
    primary = svc.submit("g", "bfs", s)
    follower = svc.submit("g", "bfs", s)
    assert svc.cancel(follower)
    svc.run()
    assert svc.poll(primary).status == DONE
    assert svc.poll(follower).status == CANCELLED
    assert svc.poll(follower).result is None


def test_cancel_primary_promotes_follower(rmat_g):
    s = _sources(rmat_g, 1)[0]
    svc = _svc(rmat_g, slots=2)
    primary = svc.submit("g", "bfs", s)
    follower = svc.submit("g", "bfs", s)
    assert svc.cancel(primary)
    svc.run()
    assert svc.poll(primary).status == CANCELLED
    qf = svc.poll(follower)
    assert qf.status == DONE
    np.testing.assert_array_equal(qf.result, standalone(rmat_g, s))


def test_cancelled_key_can_resubmit(rmat_g):
    s = _sources(rmat_g, 1)[0]
    svc = _svc(rmat_g, slots=2)
    a = svc.submit("g", "bfs", s)
    assert svc.cancel(a)
    b = svc.submit("g", "bfs", s)
    svc.run()
    assert svc.poll(b).status == DONE
    np.testing.assert_array_equal(svc.poll(b).result, standalone(rmat_g, s))


# ---------------------------------------------------------------------------
# stats: percentile sentinels + fleet aggregation
# ---------------------------------------------------------------------------

def test_percentile_sentinel_on_empty_window(rmat_g):
    svc = _svc(rmat_g)
    for p in (50, 95, 99):
        val = svc.stats.latency_percentile(p)
        assert val == 0.0 and isinstance(val, float)


def test_percentile_single_sample_window(rmat_g):
    svc = _svc(rmat_g)
    svc.submit("g", "bfs", _sources(rmat_g, 1)[0])
    svc.run()
    assert len(svc.stats.rounds_in_system) == 1
    r = svc.stats.rounds_in_system[0]
    for p in (50, 95, 99):
        assert svc.stats.latency_percentile(p) == float(r)


def sc_idle(x, g0):
    fleet = _fleet(x, n=3, seed=9)
    fleet.register_graph("g", x.graph(g0))
    fqids = [fleet.submit("g", "bfs", _sources(g0, 1)[0])]
    fleet.run()
    return fleet, fqids, None


def test_fleet_p95_finite_with_idle_replica(rmat_g):
    fleet, _, _ = both(sc_idle, g0=rmat_g)
    p95 = fleet.summary()["p95_rounds"]
    assert np.isfinite(p95) and p95 >= 0.0


# ---------------------------------------------------------------------------
# fleet end-to-end
# ---------------------------------------------------------------------------

def test_fleet_end_to_end_parity(rmat_g):
    fleet, fqids, traffic = both(sc_drained, g0=rmat_g, n_queries=24)
    for fqid, s in zip(fqids, traffic):
        rec = fleet.poll(fqid)
        assert rec.status == DONE
        np.testing.assert_array_equal(rec.result, standalone(rmat_g, s))
    summary = fleet.summary()
    assert summary["queries_served"] == len(fqids)
    assert summary["per_replica_load"] == (0, 0, 0)


def sc_affinity(x, g0):
    fleet = _fleet(x, seed=7)
    fleet.register_graph("g", x.graph(g0))
    s = _sources(g0, 1)[0]
    first = fleet.submit("g", "bfs", s)
    fleet.run()
    repeat = fleet.submit("g", "bfs", s)
    fleet.run()
    return fleet, [first, repeat], s


def test_affinity_routes_repeats_to_owner(rmat_g):
    fleet, (first, repeat), s = both(sc_affinity, g0=rmat_g)
    owner = rendezvous_order(("g", "bfs", s), 3)[0]
    assert fleet.poll(first).winner == owner
    rec = fleet.poll(repeat)
    assert rec.winner == owner and rec.from_cache
    assert fleet.summary()["fleet_hit_rate"] == 0.5


def test_affinity_off_is_pure_p2c(rmat_g):
    fleet, _, _ = both(sc_drained, g0=rmat_g, affinity=False)
    reasons = {row.reason for row in fleet.trace.rows}
    assert "affinity" not in reasons and "spill" not in reasons


def test_feedback_controller_tightens_and_relaxes():
    cfg = RouterConfig(p95_target=10.0, hedge_after=8)
    ctl = FeedbackController(cfg)
    jctl = JFL.FeedbackController(JFL.RouterConfig(p95_target=10.0,
                                                   hedge_after=8))
    for p95 in [100.0] * 30 + [1.0] * 200:
        ctl.update(p95)
        jctl.update(p95)
        assert (ctl.w_tail, ctl.hedge_after) == (jctl.w_tail,
                                                 jctl.hedge_after)
    assert ctl.w_tail == pytest.approx(cfg.w_tail)
    assert ctl.hedge_after == cfg.hedge_after


def test_hedgeable_predicate():
    pol = HedgePolicy(max_hedges=1)
    rec = FleetQuery(fqid=0, graph_id="g", app="bfs", source=0,
                     submit_step=0)
    assert not hedgeable(rec, 3, 12, pol)
    assert hedgeable(rec, 12, 12, pol)
    rec.hedges = 1
    assert not hedgeable(rec, 20, 12, pol)
    rec.hedges = 0
    rec.status = DONE
    assert not hedgeable(rec, 20, 12, pol)
    assert not hedgeable(
        FleetQuery(fqid=1, graph_id="g", app="bfs", source=0),
        20, 12, HedgePolicy(enabled=False))


def test_fleet_on_devices(rmat_g):
    """Replicas pinned to torch devices (here the CPU, named two ways):
    the graph is bound once per device and shared by its replicas; the
    routing and results equal the unpinned fleet's."""
    g = TorchSide().graph(rmat_g)
    out = []
    for devices in (None, [torch.device(CPU), "cpu"]):
        fleet = Fleet(num_replicas=3, cfg=TCfg(strategy="alb",
                                               threshold=32),
                      num_slots=4, cache_capacity=0, seed=1,
                      devices=devices)
        fleet.register_graph("g", g)
        assert all(r.svc._graphs["g"] is g for r in fleet.replicas)
        srcs = _sources(rmat_g, 6, seed=2)
        fqids = [fleet.submit("g", "bfs", s) for s in srcs]
        fleet.run()
        for fqid, s in zip(fqids, srcs):
            np.testing.assert_array_equal(fleet.poll(fqid).result,
                                          standalone(rmat_g, s))
        assert replay(fleet.trace.rows) == []
        out.append(observe(fleet, fqids))
    assert out[0] == out[1]


def test_to_device_keeps_version_and_real_vertices(rmat_g):
    from repro_torch.core import streaming as TS
    g = TS.streaming_graph(TorchSide().graph(rmat_g))
    g.bump_version()
    assert TG.to_device(g, "cpu") is g
    meta = torch.device("meta")
    m = TG.to_device(g, meta)
    assert m.device == meta and m.version == g.version
    assert TS.real_vertices(m) == TS.real_vertices(g)
    assert m.num_edges == g.num_edges
