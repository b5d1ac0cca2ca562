"""One run of one cell: set-up, the closed loop, the check, the result.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic mix in ``traffic/<name>.json`` and each metric's reader in
``metrics/<name>.py``.  This module holds no knowledge of any one of
them.

Order of a run: load the port's kernels (built on first use into the
checkout's ``build/``), make the graph on the card from the seed, count
each component's edges with the reference, draw the sources, capture and
warm up the cell's one shape, then the closed loop for ``seconds``.  Set-up
ends, and ``setup_s`` with it, at the first timed dispatch.  After the
window: the peak is read, the program's state freed, sampled answers
judged by the reference (``check.py``), and, with ``trace``, the
profiled queries' work counted (``work.py``) and their trace reduced
(``trace.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, gen, program, ref, trace as tr, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def load_cell(workload: str, root: Path = ROOT):
    """``(spec, cell, config, traffic)`` of ``workload``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json; "
                         f"one of {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return spec, cell, config, traffic


def metrics_for(spec: dict, workload: str, traced: bool) -> list:
    """The cell's metric entries: ``end_to_end`` untraced, ``per_layer``
    traced, less those whose ``workloads`` leave the cell out."""
    entries = spec["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``; a metric split by cells,
    ``<base>.<part>`` (``gteps.batch``), without a file of its own is
    read by ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Query:
    sources: list
    latency_s: float
    rounds: int
    edges: int              # the TEPS count of the query
    profiled: bool = False
    span_s: float | None = None   # device span, from the trace


@dataclasses.dataclass
class Run:
    """What a metric's reader is given."""
    device_name: str
    num_vertices: int
    num_arcs: int
    setup_s: float
    window_s: float
    queries: list
    peak_bytes: int
    trace: tr.Trace | None = None
    work_bytes: int | None = None   # the profiled queries' algorithm bytes

    @property
    def profiled(self) -> list:
        return [q for q in self.queries if q.profiled]


class Sample:
    """The window's answers that the check judges: ``k`` points in time
    drawn from the seed, one in each ``k``-th of the window.  The query
    in flight at a point (the last dispatched at or before it) is
    sampled, and its answer moved to the host as soon as it returns,
    outside its latency and outside the window (``held_s``), so the
    harness holds nothing on the device and the program may hand out
    one buffer for every answer."""

    def __init__(self, k: int, seed: int, seconds: float):
        rng = random.Random(f"portbench-check-{seed}")
        self.points = [(j + rng.random()) / k * seconds for j in range(k)]
        self.items, self.held_s = [], 0.0

    def offer(self, elapsed: float, sources, labels, rounds) -> None:
        """Keep the answer of a query that ended ``elapsed`` seconds into
        the window if a point falls at or before that."""
        if not self.points or self.points[0] > elapsed:
            return
        while self.points and self.points[0] <= elapsed:
            self.points.pop(0)
        t = time.perf_counter()
        self.items.append((sources, labels.to("cpu", copy=True), rounds))
        self.held_s += time.perf_counter() - t


def plan(traffic: dict, sources: list):
    """``plan(i)``: the sources of query ``i``, ``batch`` consecutive
    ones of the cycled list (none for pagerank)."""
    b = int(traffic.get("batch", 1))
    if not sources:
        return lambda i: []
    return lambda i: [sources[(i * b + j) % len(sources)] for j in range(b)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def closed_loop(call, plan_of, edges_of, seconds: float, sample: Sample,
                profile_n: int = 0):
    """One client: query ``i + 1`` is sent when query ``i``'s labels are
    synchronised.  The first ``profile_n`` queries run under the
    profiler, started before the window, each inside a
    ``portbench.query`` range.  Returns ``(queries, window_s,
    profile)``: the window runs from the first dispatch to the end of
    the last query, which is the first to end past ``seconds``, less
    the sample's copies to the host."""
    from torch.profiler import record_function
    queries, prof = [], None
    if profile_n:
        prof = _profiler()
        prof.__enter__()
    t0 = time.perf_counter()
    window_s = 0.0
    while not queries or window_s < seconds:
        i = len(queries)
        srcs = plan_of(i)
        traced = prof is not None and i < profile_n
        with record_function(tr.QUERY) if traced else \
                contextlib.nullcontext():
            t = time.perf_counter()
            labels, rounds = call(srcs)
            t_end = time.perf_counter()
        window_s = t_end - t0 - sample.held_s
        if traced and i == profile_n - 1:
            prof.__exit__(None, None, None)
        sample.offer(window_s, srcs, labels, rounds)
        del labels
        queries.append(Query(srcs, t_end - t, int(rounds),
                             edges_of(srcs, int(rounds)), profiled=traced))
    if prof is not None and len(queries) < profile_n:
        prof.__exit__(None, None, None)
    return queries, window_s, prof


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def run(workload: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, root: Path = ROOT, entry=program.entry) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``entry(traffic, csr) -> call`` is the system under test (the port's
    drivers; the control and the fault tests put another in its
    place)."""
    spec, cell, config, traffic = load_cell(workload, root)
    device = torch.device(device)
    app = traffic["app"]
    steps = {}

    def step(name, t):
        _sync(device)
        steps[name] = time.perf_counter() - t
        return time.perf_counter()

    steps["start"] = time.perf_counter() - t_start
    t = time.perf_counter()
    torch.zeros(1, device=device)
    t = step("device", t)
    if device.type == "cuda":
        program.load_kernels()
    t = step("kernels", t)
    (row_ptr, col_idx, edge_w), rng = gen.make_graph(config, seed, device)
    csr = (row_ptr, col_idx, edge_w)
    v, arcs = row_ptr.numel() - 1, col_idx.numel()
    t = step("graph", t)
    sources, per_source = [], {}
    if program.APPS[app][0] is not None:
        sources = gen.draw_sources(row_ptr, int(traffic["sources"]), rng)
        comp = ref.components(row_ptr, col_idx)
        cedges = ref.component_edges(row_ptr, comp)
        picked = torch.as_tensor(sources, device=device)
        per_source = dict(zip(sources,
                              cedges[comp[picked].long()].tolist()))
        del comp, cedges, picked
    t = step("sources", t)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def edges_of(srcs, rounds):
        if app == "pagerank":
            return arcs // 2 * rounds
        return sum(per_source[s] for s in srcs)

    call = entry(traffic, csr)
    plan_of = plan(traffic, sources)
    for i in range(int(traffic["warmup"])):
        call(plan_of(i))
    t = step("warmup", t)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"{workload} seed {seed}: V {v}, arcs {arcs}, "
        + ", ".join(f"{k} {s:.3f} s" for k, s in steps.items())
        + f"; set-up {setup_s:.3f} s")

    sample = Sample(int(traffic["check_queries"]), seed, seconds)
    queries, window_s, prof = closed_loop(
        call, plan_of, edges_of, seconds, sample,
        int(traffic["trace_queries"]) if traced else 0)
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    lats = sorted(q.latency_s for q in queries)
    log(f"{len(queries)} queries in {window_s:.3f} s; latency median "
        f"{lats[len(lats) // 2] * 1e3:.3f} ms, max {lats[-1] * 1e3:.3f} "
        f"ms; rounds {min(q.rounds for q in queries)}.."
        f"{max(q.rounds for q in queries)}; peak {peak} bytes")

    # the program's state goes before the reference runs
    del call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks, failed, records = check.judge(traffic, csr, sample.items)
    known = {tuple(a[0]): r for a, r in zip(sample.items, records)}
    log(f"checked {len(sample.items)} answers in "
        f"{time.perf_counter() - t:.3f} s (held {sample.held_s:.3f} s "
        "outside the window); reference rounds "
        + ("deltas " + str(records[0]) if app == "pagerank" and records
           else str([len(r) for r in records])))
    sample.items = []

    result = Run(device_name=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                 num_vertices=v, num_arcs=arcs, setup_s=setup_s,
                 window_s=window_s, queries=queries, peak_bytes=peak)
    breakdown = None
    if traced and prof is not None:
        result.trace = tr.summarize(*tr.collect(prof))
        for q, span in zip(result.profiled, result.trace.spans_s):
            q.span_s = span
        result.work_bytes = profiled_bytes(traffic, csr, result, known)
        breakdown = {"device_ops": result.trace.device_ops,
                     "idle_gaps": result.trace.idle_gaps}
    metrics = {}
    for m in metrics_for(spec, workload, traced):
        value = reader(m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": result.device_name, "count": int(cell["chips"]),
           "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    if result.trace is not None:
        dev["busy_s"] = result.trace.busy_s
        dev["window_s"] = result.trace.window_s
    out = {"correct": check.holds(checks) and failed == 0,
           "attempted": len(queries), "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def profiled_bytes(traffic: dict, csr, result: Run, known: dict):
    """The algorithm's bytes of the profiled queries, from the
    reference's rounds of each (``work.py``); ``known`` holds the
    reference's records of answers already judged, by sources."""
    queries = result.profiled
    if not queries:
        return None
    if traffic["app"] == "pagerank":
        deltas = known[()] if () in known else \
            check.reference(traffic, csr, [])[1]
        stop = len(deltas)
        per_round = work.pagerank_round_bytes(result.num_vertices,
                                              result.num_arcs)
        return per_round * stop * len(queries)
    weighted = program.APPS[traffic["app"]][1]
    total = 0
    for q in queries:
        recs = known.get(tuple(q.sources))
        if recs is None:
            recs = check.reference(traffic, csr, q.sources)[1]
        total += work.min_query_bytes(recs, weighted)
    return total
