"""The readers of the port's own spans (``portbench/spans.py``): their
arithmetic, their ``.batch`` twins, and nothing read without spans."""
import pytest

from portbench import harness
from portbench.harness import Query, Run


def make_run(lat_ms, edges, window_s=2.0, **kw):
    qs = [Query([i], ms / 1e3, 10, e) for i, (ms, e) in
          enumerate(zip(lat_ms, edges))]
    return Run(device_name="NVIDIA H100 80GB HBM3",
               num_vertices=100, num_arcs=1000, setup_s=3.5,
               window_s=window_s, queries=qs, peak_bytes=3 * 2**30, **kw)


SPAN_METRICS = ("list_us", "bins_us", "lb_us", "control_us",
                "relax_roofline", "driver_gap_ms")


def _record(app, start, per_round, rounds, gap_ns):
    """A traversal record as the port keeps one: ``rounds`` rounds of the
    phases ``per_round`` ({name: ns}) back to back from ``start``, its
    loop around them and its driver span ``gap_ns`` longer."""
    from repro_torch.core import spans as port
    t, out = start, []
    for k in range(rounds):
        phases = {}
        for name, ns in per_round.items():
            phases[name] = (t, t + ns)
            t += ns
        out.append(port.Round(k, phases, {}))
    rec = port.Traversal(1, app, loop=(start, t), rounds=out,
                         total_rounds=rounds)
    rec.host = [(f"repro.{app}", start - gap_ns // 2, t + gap_ns // 2,
                 None)]
    return rec


def _span_run(monkeypatch, recs, rounds):
    run = make_run([100.0] * len(rounds), [1] * len(rounds),
                   work_bytes=int(3.35e12 * 0.001))
    for q, r in zip(run.queries, rounds):
        q.profiled, q.rounds = True, r
    monkeypatch.setattr("portbench.spans.spans", lambda: list(recs))
    return run


ROUND_NS = {"inspect": 1000, "list": 2000, "bin.small": 3000,
            "bin.medium": 4000, "bin.large": 5000, "lb": 6000,
            "turn": 7000}


@pytest.mark.parametrize("suffix", ["", ".batch"])
def test_span_readers_by_hand(monkeypatch, suffix):
    # an older traversal of the process first: the readers take the last
    # as many as the run profiled
    recs = [_record("sssp", 0, ROUND_NS, 9, 10**6),
            _record("sssp", 10**9, ROUND_NS, 2, 3 * 10**6),
            _record("sssp", 2 * 10**9, dict(ROUND_NS, lb=0), 3, 10**6)]
    run = _span_run(monkeypatch, recs, [2, 3])

    def read(name):
        return harness.reader(name + suffix)(run)

    assert read("list_us") == pytest.approx(2.0)
    assert read("bins_us") == pytest.approx(12.0)
    # lb: 6 us in 2 rounds, 0 in 3
    assert read("lb_us") == pytest.approx(12 / 5)
    assert read("control_us") == pytest.approx(8.0)
    kernel_s = (2 * 20000 + 3 * 14000) / 1e9
    assert read("relax_roofline") == pytest.approx(
        0.001 / kernel_s * 100)
    assert read("driver_gap_ms") == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_read_nothing_without_spans(monkeypatch, name):
    run = _span_run(monkeypatch, [], [2, 3])
    assert harness.reader(name)(run) is None
    assert harness.reader(name + ".batch")(run) is None
    # records that do not match the profiled queries' rounds
    recs = [_record("sssp", 0, ROUND_NS, 2, 0),
            _record("sssp", 10**9, ROUND_NS, 4, 0)]
    run = _span_run(monkeypatch, recs, [2, 3])
    assert harness.reader(name)(run) is None
    # a record that lost rounds to the ring
    recs[1] = _record("sssp", 10**9, ROUND_NS, 3, 0)
    recs[1].overflow = 1
    assert harness.reader(name)(run) is None


def test_span_readers_without_the_port(monkeypatch):
    """A program without ``repro_torch.core.spans`` (an older port):
    ``spans()`` is empty and every reader reads nothing."""
    import sys
    from portbench import spans
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert spans.spans() == []
    run = make_run([1.0], [1])
    run.queries[0].profiled = True
    for name in SPAN_METRICS:
        assert harness.reader(name)(run) is None


def test_traced_run_reports_the_span_metrics(tiny_root):
    """A traced run on the CPU (stamps on the host clock): the readers
    find one record a profiled query; ``relax_roofline`` reads nothing
    for a card the peaks do not hold."""
    out = harness.run("kron26-sssp", 2**31 + 3, 0.3, True, "cpu", 0.0,
                      tiny_root)
    got = out["metrics"]
    for name in ("list_us", "bins_us", "lb_us", "control_us",
                 "driver_gap_ms"):
        assert got[name]["value"] > 0 and got[name]["unit"] in ("us", "ms")
    assert "relax_roofline" not in got
