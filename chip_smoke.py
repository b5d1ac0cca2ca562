#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # full size: rmat scale 22
    python3 chip_smoke.py --scale 16 # a quicker rehearsal

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (``nvidia-smi``), then an ``nvcc``
   build of every kernel source in the checkout, all in parallel;
2. each CUDA kernel against its plain PyTorch version on the card,
   exactly (tolerance 0: int32 and bit-copied outputs), over swept
   shapes;
3. the main path at full size: ALB ``sssp``, ``bfs`` and ``sssp_batch``
   (B = 8) on ``rmat(22, 16, seed=0)`` through the kernel pair, with
   launch counts reset just before and read just after; labels held
   bitwise against the torch-ops pair and against a scipy oracle;
   ``host_transfers == rounds + 1``; syncing calls per round counted
   under ``torch.cuda.set_sync_debug_mode("warn")``;
4. each kernel and its plain version timed on the card at the shapes
   the main path gave it, beside the least time the card could take;
5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
   limit line again, and last the ``{"ok": true, "device": {...}}`` line.

Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit):
# HBM3 bandwidth, and the non-tensor-core rate used for integer index
# arithmetic (the float32 rate; the integer rate is not higher)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def masked_err(kern, plain) -> int:
    """Max |kernel - plain| over the masked positions; the masks must be
    equal.  Values compare as their 32-bit words (exact)."""
    import torch
    km, pm = kern[3], plain[3]
    check(torch.equal(km, pm), "masks differ")
    err = 0
    for a, b in zip(kern[:3], plain[:3]):
        a, b = a[km], b[pm]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def kernel_vs_plain(dev) -> dict:
    import torch
    from repro_torch.kernels import edge_lb, ref, twc_gather
    from repro_torch.core.frontier import next_bucket
    rng = np.random.default_rng(0)
    errs = {"twc_bin_map": 0, "edge_lb_map": 0}
    cases = 0
    for width in (8, 128, 1024):
        for chunk in (0, 1, 3):
            for dtype in (np.int32, np.float32):
                n, v = 1000, 50_000          # ragged N (not a power of 2)
                vidx = rng.integers(0, v + 1, n).astype(np.int32)
                deg = rng.integers(0, (chunk + 2) * width, n).astype(np.int32)
                row = rng.integers(0, 1 << 24, n).astype(np.int32)
                val = rng.integers(0, 1 << 20, n).astype(dtype)
                t = [torch.from_numpy(a).to(dev)
                     for a in (vidx, deg, row, val)]
                # chunk as a host int, and as one int32 on the device
                for ch in (chunk, torch.tensor([chunk], dtype=torch.int32,
                                               device=dev)):
                    k = twc_gather.twc_bin_map(*t, width=width, chunk=ch,
                                               sentinel=v)
                    p = ref.twc_bin_map_ref(*t, width=width, chunk=chunk,
                                            sentinel=v)
                    errs["twc_bin_map"] = max(errs["twc_bin_map"],
                                              masked_err(k, p))
                    cases += 1
    for distribution in ("cyclic", "blocked"):
        for h in (8, 61, 1000, 5000):
            deg = rng.integers(1, 300, h).astype(np.int32)
            if deg.sum() % 64 == 0:          # keep total off the tiles
                deg[0] += 1
            total = int(deg.sum())
            start_e = (np.cumsum(deg) - deg).astype(np.int32)
            row = rng.integers(0, 1 << 24, h).astype(np.int32)
            val = rng.integers(0, 1 << 20, h).astype(np.int32)
            t = [torch.from_numpy(a).to(dev) for a in (start_e, row, val)]
            for n_enum in (next_bucket(total, 2048), total):
                k = edge_lb.edge_lb_map(*t, total, n_enum,
                                        distribution=distribution)
                p = ref.edge_lb_map_ref(*t, total, n_enum,
                                        distribution=distribution)
                errs["edge_lb_map"] = max(errs["edge_lb_map"],
                                          masked_err(k, p))
                cases += 1
                # every edge of every slot exactly once
                got = np.sort(k[0][k[3]].cpu().numpy())
                want = np.sort(np.concatenate(
                    [np.arange(r, r + d) for r, d in zip(row, deg)]))
                check(np.array_equal(got, want),
                      f"edge_lb_map coverage ({distribution}, H={h})")
    torch.cuda.synchronize()
    check(errs == {"twc_bin_map": 0, "edge_lb_map": 0},
          f"kernel != plain: {errs}")
    print(f"phase 2: kernel == plain on {cases} cases "
          f"(tolerance 0, masks equal): {errs}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def oracle(g, source: int, unweighted: bool) -> np.ndarray:
    """Independent labels from scipy's csgraph (INF mapped to 1 << 30)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    v = g.num_vertices
    m = csr_matrix((g.edge_w.cpu().numpy().astype(np.float64),
                    g.col_idx.cpu().numpy(), g.row_ptr.cpu().numpy()),
                   shape=(v, v))
    d = shortest_path(m, method="D", directed=True, unweighted=unweighted,
                      indices=source)
    return np.where(np.isinf(d), 1 << 30, d).astype(np.int64)


def count_syncs(fn) -> list:
    """Where ``fn`` made syncing CUDA calls (``file:line`` of each), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in seen
            if "synchroniz" in str(w.message)]


def main_path(dev, scale: int) -> dict:
    import torch
    from repro_torch import kernels
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.graph import highest_out_degree_vertex, rmat

    t0 = time.perf_counter()
    g = rmat(scale, 16, seed=0, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    src = highest_out_degree_vertex(g)
    deg = np.diff(g.row_ptr.cpu().numpy())
    rng = np.random.default_rng(0)
    sources = [src] + [int(x) for x in
                       rng.choice(np.flatnonzero(deg), 7, replace=False)]
    csr_bytes = sum(t.numel() * 4 for t in (g.row_ptr, g.col_idx, g.edge_w))
    print(f"phase 3: rmat({scale}, 16, seed=0): V={g.num_vertices} "
          f"E={g.num_edges} ({csr_bytes / 1e9:.3f} GB of CSR on the card) "
          f"max out-degree {int(deg.max())} at source {src}; "
          f"host generation + copy {gen_s:.1f} s", flush=True)

    kern = BalancerConfig(strategy="alb", use_pallas=True)
    plain = BalancerConfig(strategy="alb")
    runs = {"sssp": lambda c: drivers.sssp(g, src, c),
            "bfs": lambda c: drivers.bfs(g, src, c),
            "sssp_batch": lambda c: drivers.sssp_batch(g, sources, c)}

    kernels.reset_launch_counts()
    res = {name: run(kern) for name, run in runs.items()}
    launches = kernels.launch_counts()
    print(f"phase 3: kernel launches on the main path: {launches}",
          flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    out = {"launches": launches, "V": g.num_vertices, "E": g.num_edges,
           "source": src, "rounds": {}, "seconds": {}, "seconds_plain": {}}
    for name, r in res.items():
        check(r.host_transfers == r.rounds + 1,
              f"{name}: host_transfers {r.host_transfers} != rounds + 1")
        check(bool(torch.all(r.labels >= 0)), f"{name}: negative label")
        ref = runs[name](plain)
        check(torch.equal(r.labels, ref.labels) and r.rounds == ref.rounds,
              f"{name}: kernel pair != torch-ops pair")
        out["rounds"][name] = r.rounds
    check(torch.equal(res["sssp_batch"].labels[0], res["sssp"].labels),
          "sssp_batch row 0 != sssp")
    for name, unweighted in (("sssp", False), ("bfs", True)):
        t0 = time.perf_counter()
        want = oracle(g, src, unweighted)
        got = res[name].labels.cpu().numpy().astype(np.int64)
        check(np.array_equal(got, want), f"{name} != scipy oracle")
        print(f"phase 3: {name} == scipy oracle "
              f"({int((want < (1 << 30)).sum())} reached, "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # wall times (each ends in a device synchronize): the kernel pair
    # and the torch-ops pair in turns, k p p k k p ..., on one card
    for name, run in runs.items():
        ks, ps = [], []
        for i in range(6):
            for c in ((kern, plain) if i % 2 == 0 else (plain, kern)):
                (ks if c is kern else ps).append(run(c).seconds)
        out["seconds"][name] = ks
        out["seconds_plain"][name] = ps
    r = {}
    syncs = count_syncs(lambda: r.setdefault("x", runs["sssp"](kern)))
    out["syncs_per_round"] = len(syncs) / (r["x"].rounds + 1)
    out["sync_sites"] = {s: syncs.count(s) for s in sorted(set(syncs))}
    med = {k: {n: float(np.median(v)) for n, v in out[k].items()}
           for k in ("seconds", "seconds_plain")}
    print(f"phase 3: rounds {out['rounds']}; median wall seconds of 6 "
          f"runs each, kernel pair {med['seconds']}, torch-ops pair "
          f"{med['seconds_plain']}; sssp made {len(syncs)} syncing calls "
          f"in {r['x'].rounds + 1} rounds "
          f"({out['syncs_per_round']:.2f} per round) at "
          f"{out['sync_sites']}", flush=True)
    out["graph"], out["src"], out["sources"] = g, src, sources
    return out


# ---------------------------------------------------------------------------
# phase 4: timing at the main path's shapes
# ---------------------------------------------------------------------------

def capture_launches(g, src) -> dict:
    """The arguments of every kernel launch of one ALB sssp traversal,
    recorded by swapping the kernel modules the epilogue calls through
    for recorders that forward to the real wrappers."""
    import types
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.kernels import ops
    calls = {"twc_bin_map": [], "edge_lb_map": []}

    def recorder(name, fn):
        def rec(*a, **k):
            calls[name].append((a, k))
            return fn(*a, **k)
        return rec

    real = ops._twc, ops._edge_lb
    ops._twc = types.SimpleNamespace(
        twc_bin_map=recorder("twc_bin_map", real[0].twc_bin_map))
    ops._edge_lb = types.SimpleNamespace(
        edge_lb_map=recorder("edge_lb_map", real[1].edge_lb_map))
    try:
        drivers.sssp(g, src, BalancerConfig(strategy="alb", use_pallas=True))
    finally:
        ops._twc, ops._edge_lb = real
    return calls


def device_ms(fn, calls, reps: int = 3) -> float:
    """Mean device time per call over ``calls`` (CUDA events).  The
    stream is held busy while the host enqueues each group of ``reps``
    calls, so host overhead between launches is not counted."""
    import torch
    for a, k in calls:                   # warm-up
        fn(*a, **k)
    pairs = []
    for a, k in calls:
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn(*a, **k)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / (reps * len(calls))


def twc_work(a, k):
    """(bytes, operations) the function must do: the int32 [N] vidx, deg
    and row_start read once; per slot, the 4-byte edge id and the 1-byte
    mask written once (anchor and val are constant along each row: views
    of vidx and val, so val is never read); ~8 integer operations per
    slot."""
    n, w = a[0].shape[0], k["width"]
    return 12 * n + 5 * n * w, 8 * n * w


def lb_work(a, k):
    """(bytes, operations): 3 int32 [H] inputs; n_pad ids of 13 output
    bytes; ~8 + 4*ceil(log2(H+1)) integer operations per id."""
    h, n_enum, t = a[0].shape[0], a[4], k.get("num_tiles", 64)
    tile = k.get("tile_edges", 2048)
    n_pad = -(-(-(-n_enum // t) * t) // tile) * tile
    return 12 * h + 13 * n_pad, n_pad * (8 + 4 * (h.bit_length()))


def time_kernels(g, src, errs: dict, launches: dict) -> list:
    from repro_torch.kernels import edge_lb, ref, twc_gather
    calls = capture_launches(g, src)
    table = [("twc_bin_map", twc_gather.twc_bin_map, ref.twc_bin_map_ref,
              twc_work, "src/repro_torch/kernels/csrc/twc_gather.cu",
              "src/repro/kernels/twc_gather.py:54"),
             ("edge_lb_map", edge_lb.edge_lb_map, ref.edge_lb_map_ref,
              lb_work, "src/repro_torch/kernels/csrc/edge_lb.cu",
              "src/repro/kernels/edge_lb.py:105")]
    rows = []
    for name, fn, plain, work, source, replaces in table:
        cs = calls[name]
        check(len(cs) > 0, f"{name}: no launch captured")
        # the kernel against its plain version on the main path's inputs
        for a, k in cs:
            errs[name] = max(errs[name], masked_err(fn(*a, **k),
                                                    plain(*a, **k)))
        check(errs[name] == 0, f"{name} != plain on main-path inputs")
        b = sum(work(a, k)[0] for a, k in cs) / len(cs)
        o = sum(work(a, k)[1] for a, k in cs) / len(cs)
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, o / SCALAR_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": device_ms(fn, cs), "plain_ms": device_ms(plain, cs),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None,
            "timed_launches": len(cs), "mean_bytes": b})
    return rows


def profile_path(g, src, sources, wall_s: dict) -> dict:
    """Where the device time of one ALB traversal goes: kernels by name
    from ``torch.profiler`` (device activity only), and the device's busy
    share of ``wall_s[name]``, the median wall time of the same traversal
    run without the profiler (one stream, so kernel times do not
    overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    cfg = BalancerConfig(strategy="alb", use_pallas=True)
    out = {}
    for name, run in (("sssp", lambda: drivers.sssp(g, src, cfg)),
                      ("sssp_batch",
                       lambda: drivers.sssp_batch(g, sources, cfg))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = by_name.setdefault(e.name[:60], [0.0, 0])
                k[0] += e.time_range.elapsed_us()
                k[1] += 1
        busy_us = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        plain_wall_us = wall_s[name] * 1e6
        out[name] = {
            "profiled_wall_ms": wall_us / 1e3,
            "unprofiled_wall_ms": plain_wall_us / 1e3,
            "device_ms": busy_us / 1e3,
            "busy_share": busy_us / plain_wall_us if busy_us else None,
            "top": [[n, round(t / 1e3, 4), c] for n, (t, c) in top]}
        print(f"phase 4: profiled {name}: device busy "
              f"{busy_us / 1e3:.2f} ms of the unprofiled median wall "
              f"{plain_wall_us / 1e3:.2f} ms "
              + (f"({busy_us / plain_wall_us:.1%})" if busy_us else
                 "(profiler saw no device time: not measured)")
              + f"; profiled wall {wall_us / 1e3:.2f} ms", flush=True)
        for n, t, c in out[name]["top"]:
            print(f"phase 4:   {t:9.3f} ms {c:5d}x {n}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="rmat scale of the main path (default 22)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.load_all()
    print(f"phase 1: built {build.sources()} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in sorted(build.BUILD_LOG.items()):
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"phase 1: {name}: {' | '.join(info)}", flush=True)

    errs = kernel_vs_plain(dev)
    mp = main_path(dev, args.scale)
    g, src, sources = mp.pop("graph"), mp.pop("src"), mp.pop("sources")
    rows = time_kernels(g, src, errs, mp["launches"])
    for r in rows:
        print(f"phase 4: {r['name']}: {r['ms']:.4f} ms per launch "
              f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}) over {r['timed_launches']} launches of "
              f"one sssp; {r['launches']} launches on the main path",
              flush=True)
    mp["profile"] = profile_path(
        g, src, sources,
        {n: float(np.median(mp["seconds"][n])) for n in mp["seconds"]})
    print(json.dumps({"main_path": {"scale": args.scale, **mp}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)              # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
