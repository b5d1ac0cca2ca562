"""The metrics' arithmetic, the trace reduction and the result line."""
import json

import pytest
import torch

from conftest import ROOT
from portbench import harness, trace
from portbench.harness import Query, Run


def make_run(lat_ms, edges, window_s=2.0, **kw):
    qs = [Query([i], ms / 1e3, 10, e) for i, (ms, e) in
          enumerate(zip(lat_ms, edges))]
    return Run(device_name="NVIDIA H100 80GB HBM3",
               num_vertices=100, num_arcs=1000, setup_s=3.5,
               window_s=window_s, queries=qs, peak_bytes=3 * 2**30, **kw)


def test_gteps_counts_every_query_over_the_window():
    run = make_run([10.0] * 4, [2e9, 2e9, 1e9, 3e9], window_s=4.0)
    assert harness.reader("gteps")(run) == pytest.approx(8e9 / 4.0 / 1e9)


def test_p95_interpolates_between_order_statistics():
    run = make_run(list(range(1, 101)), [1] * 100)
    # rank 0.95 * 99 = 94.05 past the first of 1..100 ms
    assert harness.reader("query_ms_p95")(run) == pytest.approx(95.05)
    assert harness.reader("query_ms_p95")(make_run([5.0], [1])) is None


def test_memory_and_setup():
    run = make_run([1.0], [1])
    assert harness.reader("peak_mem_gib")(run) == 3.0
    assert harness.reader("setup_s")(run) == 3.5


def test_layer_readers():
    run = make_run([100.0, 50.0], [1, 1],
                   work_bytes=int(3.35e12 * 0.015))
    for q, span in zip(run.queries, (0.099, 0.049)):
        q.profiled, q.span_s = True, span
    run.trace = trace.Trace(window_s=0.16, busy_s=0.148, spans_s=[],
                            device_ops=[], idle_gaps=[])
    assert harness.reader("host_gap_ms")(run) == pytest.approx(1.0)
    assert harness.reader("round_us")(run) == pytest.approx(
        0.148 / 20 * 1e6)
    assert harness.reader("kernel_roofline")(run) == pytest.approx(
        0.015 / 0.148 * 100)
    assert harness.reader("device_idle_pct")(run) == pytest.approx(7.5)
    run.device_name = "a card the table does not hold"
    assert harness.reader("kernel_roofline")(run) is None


def test_sample_takes_the_query_in_flight_at_each_point():
    sample = harness.Sample(3, 2**31 + 7, 3.0)
    points = list(sample.points)
    assert [int(p) for p in points] == [0, 1, 2]      # one in each third
    ends = [0.5 * i for i in range(1, 8)]             # queries end every 0.5 s
    for i, end in enumerate(ends):
        sample.offer(end, [i], torch.full((4,), i), 1)
    want = sorted({next(i for i, e in enumerate(ends) if e >= p)
                   for p in points})
    assert [s for s, _, _ in sample.items] == [[i] for i in want]
    assert all(lab.device.type == "cpu" for _, lab, _ in sample.items)
    assert sample.points == []


def test_a_split_metric_falls_back_to_its_base_reader():
    run = make_run([10.0] * 2, [1e9, 1e9], window_s=1.0)
    assert harness.reader("gteps.batch")(run) == \
        harness.reader("gteps")(run)


def test_every_metric_has_a_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_trace_summary_by_hand():
    # two queries; the profiler shows their device ranges and two kernels
    device = [("k1", 10, 20), ("k2", 130, 140)]
    host = [("cudaStreamSynchronize", 20, 94), ("aten::full", 95, 118)]
    queries = [(0, 100), (120, 200)]
    ranges = [(5, 95), (125, 190)]
    t = trace.summarize(device, host, queries, ranges)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(155e-6)
    assert t.spans_s == pytest.approx([90e-6, 65e-6])
    assert t.device_ops[0] == [trace.SPAN, pytest.approx(155e-6)]
    assert dict((n, v) for n, v in t.device_ops)["k1"] == \
        pytest.approx(10e-6)
    assert t.idle_gaps == [["aten::full", pytest.approx(30e-6)],
                           ["host: no operation", pytest.approx(15e-6)]]
    # without device ranges a span runs first to last operation
    t = trace.summarize(device, host, queries)
    assert t.spans_s == pytest.approx([10e-6, 10e-6])


def test_result_line_shape(tiny_root):
    out = harness.run("kron26-sssp", 2**31 + 11, 0.3, False, "cpu", 0.0,
                      tiny_root)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    allowed = {m["name"]: m["unit"] for m in harness.metrics_for(
        spec, "kron26-sssp", False)}
    assert set(out["metrics"]) <= set(allowed)
    assert {"gteps", "setup_s"} <= set(out["metrics"])
    for name, m in out["metrics"].items():
        assert m["unit"] == allowed[name] and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from portbench import run
    assert run.main(["--workload", "kron26-sssp", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
