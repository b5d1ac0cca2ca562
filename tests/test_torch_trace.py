"""The port's traversal spans (``repro_torch.core.spans``) on the CPU, where
a fused traversal runs eagerly and its stamps read the host clock: the
phases of each round in order and tiling the loop, the host spans nested
around it and in the profiler's own trace on its clock, the counts the
stamps carry against ``collect_stats``, nothing recorded without a
profiler, bitwise the same answers traced and untraced, the ring's
overflow, and a ``graph_loop.Program`` that outlives its module."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import graph as tg
from repro_torch.core import spans
from repro_torch.core.apps import drivers as td
from repro_torch.core.balancer import BalancerConfig, host_transfer_count

ALB_PHASES = ["inspect", "list", "bin.small", "bin.medium", "bin.large",
              "lb", "turn"]
DIRECTIONS = ["push", "pull", "adaptive"]
APPS = {"sssp": lambda g, cfg, **kw: td.sssp(g, 0, cfg, mode="fused", **kw),
        "sssp_batch": lambda g, cfg, **kw: td.sssp_batch(
            g, [0, 5, 77], cfg, mode="fused", **kw)}


@pytest.fixture(scope="module")
def g():
    # hubs past threshold 32: the LB bin is listed in most rounds
    return tg.rmat(8, 8, seed=3, device="cpu")


def _cfg(direction="push", **kw):
    kw.setdefault("use_pallas", True)
    return BalancerConfig(threshold=32, direction=direction, **kw)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    return res, prof


def _assert_tiled(rec, phases=None):
    """Each round's phases run back to back, the rounds back to back
    inside the loop, the last ending where the loop does."""
    assert rec.loop is not None and rec.rounds
    lo, hi = rec.loop
    prev_end = None
    for rnd in rec.rounds:
        names = list(rnd.phases)
        if phases is not None:
            assert names == phases
        assert names[0] == "inspect" and names[-1] == "turn"
        spans_ = list(rnd.phases.values())
        for (a0, a1), (b0, _) in zip(spans_, spans_[1:]):
            assert a0 <= a1 == b0
        if prev_end is not None:
            assert spans_[0][0] == prev_end
        prev_end = spans_[-1][1]
        assert lo <= spans_[0][0] and spans_[-1][1] <= hi
    assert prev_end == hi


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_rounds_are_stamped_in_order_and_nested(g, app, direction):
    res, _ = _traced(lambda: APPS[app](g, _cfg(direction)))
    rec = res.spans
    assert rec.app == app and rec.bins == ("small", "medium", "large", "lb")
    assert rec.total_rounds == res.rounds == len(rec.rounds)
    assert rec.overflow == 0
    assert [r.index for r in rec.rounds] == list(range(res.rounds))
    _assert_tiled(rec, ALB_PHASES)
    top = rec.host_span(f"repro.{app}")
    assert top[3] is None
    assert top[1] <= rec.loop[0] and rec.loop[1] <= top[2]
    init, fetch = rec.host_span("repro.init"), rec.host_span("repro.fetch")
    assert init[3] == fetch[3] == f"repro.{app}"
    assert init[2] <= rec.loop[0] and rec.loop[1] <= fetch[1]
    assert top[1] <= init[1] and fetch[2] <= top[2]


@pytest.mark.parametrize("strategy,backend,phases", [
    ("twc", None, ["inspect", "list", "bin.small", "bin.medium",
                   "bin.large", "turn"]),
    ("edge_lb", None, ["inspect", "list", "lb", "turn"]),
    ("vertex", None, ["inspect", "list", "bin.vertex", "turn"]),
    ("alb", "merge_path", ["inspect", "list", "lb", "turn"]),
    ("alb", "xla", ALB_PHASES)])
def test_each_plan_stamps_its_own_passes(g, strategy, backend, phases):
    cfg = _cfg(strategy=strategy, backend=backend)
    res, _ = _traced(lambda: td.sssp(g, 0, cfg, mode="fused"))
    assert len(res.spans.rounds) == res.rounds > 0
    _assert_tiled(res.spans, phases)


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_stamped_counts_equal_the_round_stats(g, app, direction):
    cfg = _cfg(direction)
    stats = APPS[app](g, cfg, collect_stats=True).stats
    res, _ = _traced(lambda: APPS[app](g, cfg))
    assert len(stats) == len(res.spans.rounds)
    listed = 0
    for st, rnd in zip(stats, res.spans.rounds):
        c = rnd.counts
        assert (c["n_f"], c["m_f"], c["lb_edges"]) == \
            (st.frontier_size, st.frontier_edges, st.edges_lb)
        assert (c["members.lb"] > 0) == st.lb_invoked
        listed += c["members.lb"]
    assert listed > 0


@pytest.mark.parametrize("mode", ["fused", "spmd", "host"])
def test_nothing_is_recorded_without_a_profiler(g, mode):
    before, t0 = spans.records(), host_transfer_count()
    res = td.sssp(g, 0, _cfg(), mode=mode)
    assert res.spans is None
    assert spans._CURRENT is None
    assert spans.records() == before
    assert host_transfer_count() - t0 == res.host_transfers
    traced, _ = _traced(lambda: td.sssp(g, 0, _cfg(), mode=mode))
    assert traced.host_transfers == res.host_transfers


def test_the_flag_off_writes_nothing(g):
    _traced(lambda: td.sssp(g, 0, _cfg(), mode="fused"))
    ring = spans._RINGS[torch.device("cpu")]
    snap = ring.buf.clone()
    assert snap.any()
    td.sssp(g, 5, _cfg(), mode="fused")
    assert not ring.on and torch.equal(ring.buf, snap)


@pytest.mark.parametrize("run", [
    lambda g, cfg: td.sssp(g, 0, cfg, mode="fused"),
    lambda g, cfg: td.sssp_batch(g, [0, 5, 77], cfg, mode="fused"),
    lambda g, cfg: td.bfs(g, 3, cfg, mode="fused"),
    lambda g, cfg: td.cc(tg.symmetrized(g), cfg, mode="fused"),
    lambda g, cfg: td.kcore(tg.symmetrized(g), 4, _cfg(), mode="fused"),
    lambda g, cfg: td.pagerank(g, cfg=_cfg(), mode="fused",
                               max_rounds=12)],
    ids=["sssp", "sssp_batch", "bfs", "cc", "kcore", "pagerank"])
@pytest.mark.parametrize("direction", ["push", "adaptive"])
def test_traced_answers_are_bitwise_the_untraced(g, run, direction):
    cfg = _cfg(direction)
    plain = run(g, cfg)
    res, _ = _traced(lambda: run(g, cfg))
    assert torch.equal(res.labels, plain.labels)
    assert res.rounds == plain.rounds == len(res.spans.rounds)
    _assert_tiled(res.spans)


def test_ring_overflow_is_counted(g, monkeypatch):
    monkeypatch.setattr(spans, "RING_ROUNDS", 3)
    monkeypatch.setattr(spans, "_RINGS", {})
    res, _ = _traced(lambda: td.sssp(g, 0, _cfg(), mode="fused"))
    rec = res.spans
    assert res.rounds > 3
    assert rec.overflow == res.rounds - 3 and len(rec.rounds) == 3
    assert [r.index for r in rec.rounds] == list(range(res.rounds - 3,
                                                       res.rounds))
    for rnd in rec.rounds:
        assert list(rnd.phases) == ALB_PHASES
    assert rec.rounds[-1].phases["turn"][1] == rec.loop[1]


def test_host_spans_are_in_the_profilers_trace_on_its_clock(g):
    res, prof = _traced(lambda: td.sssp_batch(g, [0, 1], _cfg(),
                                              mode="fused"))
    rec = res.spans
    t0 = prof.profiler.kineto_results.trace_start_ns()
    seen = {}
    for e in prof.events():
        if e.name.startswith("repro."):
            seen[e.name] = (t0 + e.time_range.start * 1e3,
                            t0 + e.time_range.end * 1e3)
    assert set(seen) == {"repro.sssp_batch", "repro.init", "repro.fetch"}
    for name, a, b, _ in rec.host:
        # the record's times lie inside the profiler's range, 1 us of
        # float rounding aside
        assert seen[name][0] - 1e3 <= a <= b <= seen[name][1] + 1e3
    assert [r.app for r in spans.records()[-1:]] == ["sssp_batch"]


def test_non_fused_modes_record_host_spans_only(g):
    res, _ = _traced(lambda: td.sssp(g, 0, _cfg(), mode="spmd"))
    assert res.spans.rounds == [] and res.spans.loop is None
    assert res.spans.host_span("repro.sssp") is not None


def test_a_program_alive_at_exit_closes_quietly():
    """A ``graph_loop.Program`` kept to interpreter exit closes through
    the library it holds, not through the module's globals."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(src)!r})
        from repro_torch.core import graph_loop

        class Lib:
            def gl_exec_destroy(self, exe):
                print("closed exec", flush=True)
            def gl_graph_destroy(self, graph):
                print("closed graph", flush=True)

        keep = object.__new__(graph_loop.Program)
        keep._exec, keep._graph, keep._gl = 1, 2, Lib()
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0
    assert "Traceback" not in out.stderr and "Exception" not in out.stderr
    assert out.stdout.split() == ["closed", "exec", "closed", "graph"]
