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
3b. the slice-2 path on the same graph, counted the same way: the
   reverse and symmetrized CSR built on the card; sssp, bfs and
   sssp_batch under ``backend="merge_path"`` (bitwise equal to the
   kernel pair's results); adaptive sssp and bfs through the kernel pair
   and merge_path (bitwise equal to push); cc (push and adaptive),
   kcore(10) and pagerank(20 rounds) through both routes, against the
   torch-ops pair and scipy / numpy oracles; ``host_transfers`` as the
   drivers count them; median wall times;
4. each kernel and its plain version timed on the card at the shapes
   the main path gave it (one ALB sssp, one merge-path sssp), beside the
   least time the card could take; device profiles of ALB sssp,
   sssp_batch, adaptive cc and pagerank;
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
    """Max |kernel - plain| over the masked positions; the masks (the
    last output) must be equal.  Values compare as their 32-bit words
    (exact)."""
    import torch
    km, pm = kern[-1], plain[-1]
    check(torch.equal(km, pm), "masks differ")
    err = 0
    for a, b in zip(kern[:-1], plain[:-1]):
        a, b = a[km], b[pm]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def merge_path_vs_plain(dev, rng) -> tuple:
    """``merge_path_map`` against its plain version: the four cases of
    tests/test_fused.py, then H in {1, 61, 1000, 5000} x tile_edges in
    {128, 2048} x (ragged total, bucketed span), each with the coverage
    check.  Every output is compared (both write 0 where masked).
    Returns (max error, cases)."""
    import torch
    from repro_torch.kernels import merge_path, ref
    from repro_torch.core.frontier import next_bucket
    cases = [([0, 0, 0, 0], [0, 0, 0, 0], 0, 256),
             ([5000], [17], 5000, 256),
             ([100, 900, 1, 499, 1500], [0, 100, 1000, 1001, 1500], 3000,
              1024),
             ([2, 0, 0, 3, 0, 5, 0], [0, 2, 2, 2, 5, 5, 10], 10, 128)]
    for h in (1, 61, 1000, 5000):
        for tile in (128, 2048):
            deg = rng.integers(0, 300, h)
            deg[rng.random(h) < 0.3] = 0            # zero-degree runs
            if h == 1:                              # one slot >> a tile
                deg[0] = rng.integers(20_000, 50_000)
            deg[0] += 1 + (deg.sum() % tile == 0)   # total off the tiles
            cases.append((deg, rng.integers(0, 1 << 24, h), None, tile))
    err, n = 0, 0
    for deg, row, total, tile in cases:
        deg, row = np.asarray(deg, np.int32), np.asarray(row, np.int32)
        start_e = (np.cumsum(deg) - deg).astype(np.int32)
        t = [torch.from_numpy(a).to(dev) for a in (start_e, row)]
        total = int(deg.sum()) if total is None else total
        for ecap in sorted({max(total, 1), next_bucket(total, tile)}):
            k = merge_path.merge_path_map(*t, total, ecap, tile_edges=tile)
            p = ref.merge_path_map_ref(*t, total, ecap, tile_edges=tile)
            err = max(err, masked_err(k, p))
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"merge_path_map != plain off the mask (H={len(deg)})")
            n += 1
            got = np.sort(k[0][k[2]].cpu().numpy())
            want = np.sort(np.concatenate(
                [np.arange(r, r + d) for r, d in zip(row, deg)]))
            check(np.array_equal(got, want),
                  f"merge_path_map coverage (H={len(deg)}, tile={tile})")
    return err, n


def kernel_vs_plain(dev) -> dict:
    import torch
    from repro_torch.kernels import edge_lb, ref, twc_gather
    from repro_torch.core.frontier import next_bucket
    rng = np.random.default_rng(0)
    errs = {"twc_bin_map": 0, "edge_lb_map": 0, "merge_path_map": 0}
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
    errs["merge_path_map"], n = merge_path_vs_plain(dev, rng)
    cases += n
    torch.cuda.synchronize()
    check(errs == {"twc_bin_map": 0, "edge_lb_map": 0, "merge_path_map": 0},
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
    for name in ("twc_bin_map", "edge_lb_map"):
        check(launches[name] > 0, f"{name} was not launched on the main "
              f"path")

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
    out["results"] = res
    return out


# ---------------------------------------------------------------------------
# phase 3b: cc, kcore, pagerank, pull and adaptive rounds, merge_path
# ---------------------------------------------------------------------------

KCORE_K = 10
PR_ROUNDS = 20
PR_RTOL_ORACLE = 2e-4          # as tests/test_strategies.py holds pagerank
# kernel routes against the torch-ops pair, both on the card: each
# scatters with float32 atomicAdd in a run-dependent order, so a rank
# moves by a few roundings of its in-edge sum per round (see PERF.md)
PR_RTOL_PAIR = 1e-4


def cc_oracle(sym) -> np.ndarray:
    """Component labels from scipy's csgraph, mapped to the smallest
    vertex id of each component (what min-label propagation gives)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    v = sym.num_vertices
    m = csr_matrix((np.ones(sym.num_edges, np.float32),
                    sym.col_idx.cpu().numpy(), sym.row_ptr.cpu().numpy()),
                   shape=(v, v))
    _, comp = connected_components(m, directed=False)
    first = np.full(comp.max() + 1, v, np.int64)
    np.minimum.at(first, comp, np.arange(v))
    return first[comp]


def kcore_oracle(sym, k: int) -> np.ndarray:
    """Vectorised peeling: every round removes all vertices of degree
    below k and takes one degree from each of their neighbours."""
    rp = sym.row_ptr.cpu().numpy().astype(np.int64)
    ci = sym.col_idx.cpu().numpy()
    v = sym.num_vertices
    deg = np.diff(rp)
    alive = np.ones(v, bool)
    while True:
        dead = np.flatnonzero(alive & (deg < k))
        if dead.size == 0:
            return alive.astype(np.int32)
        alive[dead] = False
        lens = rp[dead + 1] - rp[dead]
        offs = (np.repeat(rp[dead] - (np.cumsum(lens) - lens), lens)
                + np.arange(lens.sum()))
        deg -= np.bincount(ci[offs], minlength=v)


def pagerank_oracle(g, damping: float, rounds: int) -> np.ndarray:
    """float64 power iteration, dangling mass spread uniformly."""
    from scipy.sparse import csr_matrix
    rp, ci = g.row_ptr.cpu().numpy(), g.col_idx.cpu().numpy()
    v = g.num_vertices
    outdeg = np.diff(rp)
    at = csr_matrix((np.ones(len(ci)), ci, rp), shape=(v, v)).T
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    rank = np.full(v, 1.0 / v)
    for _ in range(rounds):
        acc = at @ (rank * inv)
        rank = (1 - damping) / v + damping * (
            acc + rank[outdeg == 0].sum() / v)
    return rank


def directions(r) -> str:
    """Per-round direction trace: P pull, p push."""
    return "".join("P" if s.direction == "pull" else "p" for s in r.stats)


def pull_path(g, src, sources, res) -> dict:
    """The slice-2 path: merge-path, adaptive, cc, kcore and pagerank
    traversals, counted as one run (launch counts reset just before,
    read just after), then checked against the slice-1 results, the
    torch-ops pair and independent oracles."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.graph import symmetrized

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = fn()
        torch.cuda.synchronize()
        return x, time.perf_counter() - t0

    rg, rev_s = timed(g.reverse)
    sym, sym_s = timed(lambda: symmetrized(g))
    csr_gb = {n: sum(t.numel() * 4 for t in (x.row_ptr, x.col_idx,
                                              x.edge_w)) / 1e9
              for n, x in (("reverse", rg), ("sym", sym))}
    print(f"phase 3b: g.reverse() built on the card in {rev_s:.3f} s: "
          f"V={rg.num_vertices} E={rg.num_edges} ({csr_gb['reverse']:.3f} "
          f"GB); symmetrized(g) in {sym_s:.3f} s: E={sym.num_edges} "
          f"({csr_gb['sym']:.3f} GB), max degree {sym.max_out_degree()}",
          flush=True)

    cfgs = {"kernel": BalancerConfig(strategy="alb", use_pallas=True),
            "merge_path": BalancerConfig(strategy="alb",
                                         backend="merge_path"),
            "plain": BalancerConfig(strategy="alb")}
    apps = {
        "sssp": lambda c, st: drivers.sssp(g, src, c, collect_stats=st),
        "bfs": lambda c, st: drivers.bfs(g, src, c, collect_stats=st),
        "sssp_batch": lambda c, st: drivers.sssp_batch(
            g, sources, c, collect_stats=st),
        "sssp_adaptive": lambda c, st: drivers.sssp(
            g, src, c, direction="adaptive", collect_stats=st),
        "bfs_adaptive": lambda c, st: drivers.bfs(
            g, src, c, direction="adaptive", collect_stats=st),
        "cc": lambda c, st: drivers.cc(sym, c, collect_stats=st),
        "cc_adaptive": lambda c, st: drivers.cc(
            sym, c, direction="adaptive", collect_stats=st),
        "kcore": lambda c, st: drivers.kcore(sym, KCORE_K, c,
                                             collect_stats=st),
        "pagerank": lambda c, st: drivers.pagerank(
            g, cfg=c, max_rounds=PR_ROUNDS, tol=0.0, collect_stats=st),
    }
    runs = [("sssp", "merge_path"), ("bfs", "merge_path"),
            ("sssp_batch", "merge_path")]
    runs += [(a, r) for a in ("sssp_adaptive", "bfs_adaptive", "cc",
                              "cc_adaptive", "kcore", "pagerank")
             for r in ("kernel", "merge_path")]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, by_run = {}, {}
    for app, route in runs:
        before = kernels.launch_counts()
        out[app, route] = apps[app](cfgs[route], True)
        after = kernels.launch_counts()
        by_run[f"{app}/{route}"] = {k: after[k] - before[k] for k in after}
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 3b: kernel launches on the slice-2 path: {launches}; "
          f"peak device memory {peak_gb:.2f} GB", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the slice-2 path")
    # the kernel pair on pull rounds: pagerank's rounds are all pulls
    # (PR_PULL over the reverse CSR); adaptive cc's pull rounds served
    # both the bins and the huge bin
    for run in ("pagerank/kernel", "cc_adaptive/kernel"):
        check(by_run[run]["twc_bin_map"] > 0 and
              by_run[run]["edge_lb_map"] > 0,
              f"{run}: twc_bin_map / edge_lb_map not launched")
    pulls = [s for s in out["cc_adaptive", "kernel"].stats
             if s.direction == "pull"]
    check(any(s.edges_twc > 0 for s in pulls) and
          any(s.lb_invoked for s in pulls),
          "cc_adaptive: no pull round through the bins and the huge bin")

    # ---- correctness ----
    for app in ("sssp", "bfs", "sssp_batch"):
        r = out[app, "merge_path"]
        check(torch.equal(r.labels, res[app].labels) and
              r.rounds == res[app].rounds,
              f"{app}/merge_path != the ALB kernel pair")
    for app in ("sssp", "bfs"):
        for route in ("kernel", "merge_path"):
            r = out[app + "_adaptive", route]
            check(torch.equal(r.labels, res[app].labels) and
                  r.rounds == res[app].rounds,
                  f"{app}_adaptive/{route} != push")
            check("P" in directions(r), f"{app}_adaptive/{route}: no pull")
    plain = {a: apps[a](cfgs["plain"], False)
             for a in ("cc", "cc_adaptive", "kcore", "pagerank")}
    t0 = time.perf_counter()
    want = {"cc": cc_oracle(sym), "kcore": kcore_oracle(sym, KCORE_K)}
    want["cc_adaptive"] = want["cc"]
    pr_want = pagerank_oracle(g, 0.85, PR_ROUNDS)
    oracle_s = time.perf_counter() - t0
    for app in ("cc", "cc_adaptive", "kcore"):
        check(np.array_equal(plain[app].labels.cpu().numpy(), want[app]),
              f"{app}/plain != oracle")
        for route in ("kernel", "merge_path"):
            r = out[app, route]
            check(torch.equal(r.labels, plain[app].labels) and
                  r.rounds == plain[app].rounds,
                  f"{app}/{route} != the torch-ops pair")
    pr_err = {}
    for route in ("kernel", "merge_path", "plain"):
        rank = (plain["pagerank"] if route == "plain"
                else out["pagerank", route]).labels
        check(rank.shape == (g.num_vertices,) and
              bool(torch.isfinite(rank).all()), f"pagerank/{route}: shape")
        got = rank.double().cpu().numpy()
        ref = plain["pagerank"].labels.double().cpu().numpy()
        pr_err[route] = {
            "rel_vs_plain": float(np.max(np.abs(got - ref) / ref)),
            "rel_vs_oracle": float(np.max(np.abs(got - pr_want) / pr_want)),
            "mass_err": abs(float(got.sum()) - 1.0)}
        check(pr_err[route]["rel_vs_plain"] <= PR_RTOL_PAIR,
              f"pagerank/{route} != the torch-ops pair: {pr_err[route]}")
        check(pr_err[route]["rel_vs_oracle"] <= PR_RTOL_ORACLE,
              f"pagerank/{route} != float64 oracle: {pr_err[route]}")
        check(pr_err[route]["mass_err"] < 1e-4,
              f"pagerank/{route}: sum(rank) != 1: {pr_err[route]}")
    rounds, transfers, trace = {}, {}, {}
    for (app, route), r in out.items():
        per = 2 * r.rounds if app == "pagerank" else r.rounds + 1
        check(r.host_transfers == per,
              f"{app}/{route}: host_transfers {r.host_transfers} != {per}")
        rounds[f"{app}/{route}"] = r.rounds
        transfers[f"{app}/{route}"] = r.host_transfers
        if app.endswith("adaptive"):
            trace[f"{app}/{route}"] = directions(r)
    print(f"phase 3b: all labels agree: merge_path == the ALB kernel "
          f"pair; adaptive == push; cc, kcore({KCORE_K}) == torch-ops "
          f"pair == oracle; pagerank ({PR_ROUNDS} rounds) within rtol "
          f"{PR_RTOL_PAIR} of the torch-ops pair and {PR_RTOL_ORACLE} of "
          f"float64: {pr_err} (oracles {oracle_s:.1f} s)", flush=True)
    print(f"phase 3b: rounds {rounds}", flush=True)
    print(f"phase 3b: direction traces {trace}", flush=True)

    # wall times (each ends in a device synchronize), in turns
    seconds = {f"{a}/{r}": [] for a, r in runs}
    for i in range(6):
        for a, r in (runs if i % 2 == 0 else runs[::-1]):
            seconds[f"{a}/{r}"].append(apps[a](cfgs[r], False).seconds)
    med = {k: float(np.median(v)) for k, v in seconds.items()}
    print(f"phase 3b: median wall seconds of 6 runs each: {med}",
          flush=True)
    return {"launches": launches, "launches_by_run": by_run,
            "rounds": rounds, "host_transfers": transfers,
            "direction_traces": trace, "seconds": seconds,
            "build_s": {"reverse": rev_s, "symmetrized": sym_s},
            "csr_gb": csr_gb, "sym_edges": sym.num_edges,
            "peak_device_gb": peak_gb, "pagerank_err": pr_err,
            "apps": apps, "cfgs": cfgs, "median_s": med}


# ---------------------------------------------------------------------------
# phase 4: timing at the main path's shapes
# ---------------------------------------------------------------------------

def capture_launches(g, src, cfg) -> dict:
    """The arguments of every kernel launch of one sssp traversal under
    ``cfg``, recorded by swapping the kernel modules the epilogue calls
    through for recorders that forward to the real wrappers."""
    import types
    from repro_torch.core.apps import drivers
    from repro_torch.kernels import ops
    calls = {"twc_bin_map": [], "edge_lb_map": [], "merge_path_map": []}

    def recorder(name, fn):
        def rec(*a, **k):
            calls[name].append((a, k))
            return fn(*a, **k)
        return rec

    real = ops._twc, ops._edge_lb, ops._merge_path
    ops._twc = types.SimpleNamespace(
        twc_bin_map=recorder("twc_bin_map", real[0].twc_bin_map))
    ops._edge_lb = types.SimpleNamespace(
        edge_lb_map=recorder("edge_lb_map", real[1].edge_lb_map))
    ops._merge_path = types.SimpleNamespace(
        merge_path_map=recorder("merge_path_map", real[2].merge_path_map))
    try:
        drivers.sssp(g, src, cfg)
    finally:
        ops._twc, ops._edge_lb, ops._merge_path = real
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


def mp_work(a, k):
    """(bytes, operations) for these inputs: the two int32 [H] inputs
    read once, 9 bytes written per id; per live id ~8 integer operations
    plus 4 per step of its search over its tile's actual slot window,
    and per live tile two full-depth co-rank searches."""
    import torch
    start_e, total, ecap = a[0], int(a[2]), a[3]
    tile = k.get("tile_edges", 2048)
    h = start_e.shape[0]
    n_tiles = max(1, -(-ecap // tile))
    t_lo = torch.arange(n_tiles, dtype=torch.int32,
                        device=start_e.device) * tile
    live = t_lo < total
    t_hi = torch.clamp(t_lo + tile - 1, max=max(total - 1, 0))
    lo = torch.searchsorted(start_e, t_lo, right=True).clamp(1, h) - 1
    hi = torch.searchsorted(start_e, t_hi, right=True).clamp(1, h) - 1
    steps = torch.ceil(torch.log2((hi - lo + 2).double()))
    ids = torch.clamp(total - t_lo, 0, tile).double()
    ops = float((ids * (8 + 4 * steps))[live].sum()) + \
        int(live.sum()) * 2 * 4 * h.bit_length()
    return 8 * h + 9 * n_tiles * tile, ops


def time_kernels(g, src, errs: dict, launches: dict) -> list:
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.kernels import edge_lb, merge_path, ref, twc_gather
    calls = capture_launches(g, src, BalancerConfig(strategy="alb",
                                                    use_pallas=True))
    calls["merge_path_map"] = capture_launches(
        g, src, BalancerConfig(strategy="alb",
                               backend="merge_path"))["merge_path_map"]
    table = [("twc_bin_map", twc_gather.twc_bin_map, ref.twc_bin_map_ref,
              twc_work, "src/repro_torch/kernels/csrc/twc_gather.cu",
              "src/repro/kernels/twc_gather.py:54"),
             ("edge_lb_map", edge_lb.edge_lb_map, ref.edge_lb_map_ref,
              lb_work, "src/repro_torch/kernels/csrc/edge_lb.cu",
              "src/repro/kernels/edge_lb.py:105"),
             ("merge_path_map", merge_path.merge_path_map,
              ref.merge_path_map_ref, mp_work,
              "src/repro_torch/kernels/csrc/merge_path.cu",
              "src/repro/kernels/merge_path.py:107")]
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


def profile_path(runs: dict, wall_s: dict) -> dict:
    """Where the device time of each traversal of ``runs`` (name ->
    callable) goes: kernels by name from ``torch.profiler`` (device
    activity only), and the device's busy share of ``wall_s[name]``, the
    median wall time of the same traversal run without the profiler
    (one stream, so kernel times do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, run in runs.items():
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
    pp = pull_path(g, src, sources, mp.pop("results"))
    apps, cfgs = pp.pop("apps"), pp.pop("cfgs")
    launches = {k: mp["launches"].get(k, 0) + pp["launches"][k]
                for k in pp["launches"]}
    rows = time_kernels(g, src, errs, launches)
    for r in rows:
        print(f"phase 4: {r['name']}: {r['ms']:.4f} ms per launch "
              f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}) over {r['timed_launches']} launches of "
              f"one sssp; {r['launches']} launches on the two main-path "
              f"runs", flush=True)
    from repro_torch.core.apps import drivers
    kern = cfgs["kernel"]
    mp["profile"] = profile_path(
        {"sssp": lambda: drivers.sssp(g, src, kern),
         "sssp_batch": lambda: drivers.sssp_batch(g, sources, kern)},
        {n: float(np.median(mp["seconds"][n])) for n in mp["seconds"]})
    pp["profile"] = profile_path(
        {f"{a}/kernel": (lambda a=a: apps[a](kern, False))
         for a in ("cc_adaptive", "pagerank")}, pp.pop("median_s"))
    print(json.dumps({"main_path": {"scale": args.scale, **mp}}), flush=True)
    print(json.dumps({"pull_path": pp}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)              # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
