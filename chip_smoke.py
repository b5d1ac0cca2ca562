#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # full size: rmat scale 22, and
                                     # deepseek-moe-16b at 28 layers
    python3 chip_smoke.py --scale 16 # a quicker graph rehearsal

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit (``nvidia-smi``), then an ``nvcc``
   build of every kernel source in the checkout, all in parallel;
2. each CUDA kernel against its plain PyTorch version on the card over
   swept shapes: the index kernels exactly (tolerance 0: int32 and
   bit-copied outputs); the fused relax kernels ``twc_bin_relax`` and
   ``edge_lb_relax`` for every operator and pull twin, B in {1, 3, 8},
   every bin width and chunk, both deals, exactly for min and int add
   and within ``RELAX_FLOAT_RTOL`` for float add; ``flash_attention``
   within ``FLASH_TOL`` on both routes (wgmma: bf16 at head width 64
   and 128, ragged S included; simt: float32 and other widths), each
   case counted on its route; ``moe_plan`` bitwise over T x (E, K) x G
   x adaptive x (uniform, skewed, tied, NaN-row probabilities), every
   cluster size the wrapper picks; the static round's device-int32
   entries (``twc_bin_relax`` with its first chunk and pass count on the
   device, over V rows; ``edge_lb_relax``, ``merge_path_map`` and
   ``edge_lb_map`` with the total on the device, over a span far past
   it: total 0, ragged tails, both deals, pass counts 0..k) against
   their plain versions given the same ints;
3. the main path at full size: ALB ``sssp``, ``bfs`` and ``sssp_batch``
   (B = 8) on ``rmat(22, 16, seed=0)`` through the kernel pair (one
   fused ``twc_bin_relax`` / ``edge_lb_relax`` launch per pass), with
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
   drivers count them; median wall times; phases 3 and 3b assert that
   no pass of the built-in operators took the ``pallas`` pair's unfused
   route (``ops.unfused_passes``);
3c. a user operator (int32 min, ``msg = v + 2w``) through the ``pallas``
   pair's unfused route (``twc_bin_map`` / ``edge_lb_map`` and the torch
   epilogue) on the same graph: bitwise equal to the ``xla`` pair and
   to twice the sssp labels;
3d. the static-shape and fused round modes on the same two graphs:
   ALB sssp, bfs, sssp_batch, adaptive sssp, adaptive cc(sym),
   kcore(10) and pagerank(20) through the kernel pair in
   ``mode="spmd"`` (one replay of a captured round graph a round) and
   ``mode="fused"`` (one launch of a graph whose WHILE node turns on the
   card, ``core/graph_loop.py`` with ``csrc/graph_loop.cu``), sssp also
   fused through merge_path and under ``strategy="twc"`` (the unbounded
   bin); labels, rounds and per-round frontier stats held against host
   mode (pagerank at ``PR_RTOL_PAIR``), ``host_transfers`` 0 (fused) or
   as host (spmd), zero syncing calls between a fused dispatch and its
   fetch under ``set_sync_debug_mode("error")``; each run's launches
   counted on the card and held against its rounds x bins, launches
   recorded by the captures, graphs captured and their seconds, the
   condition kernel's decisions, medians of 6 walls host / spmd / fused in turns, device profiles of
   sssp and pagerank in host and spmd mode, and the device span of each
   fused traversal's one launch (CUDA events);
3e. streaming updates on the same two graphs made streaming
   (``streaming_graph``: V 4,194,312 padded, Ecap 2**27; the symmetrized
   form 2**28): sssp and bfs from the hub and cc kept by
   ``stream_update`` across two traces of 8 batches of 4096 updates
   (insert-only; mixed: inserts, deletes, reweights, no-ops) through the
   kernel pair in host and fused mode (sssp also spmd); after every
   batch the labels bitwise against a from-scratch run on the mutated
   graph (a fallback's rounds against that run's), after the mixed trace
   sssp's CSR against a numpy rebuild and its labels against scipy;
   per batch apply and repair seconds, rounds, seeds, captures, the
   kernels' launches on the card, syncing calls and peak memory; no
   capture in host mode, as many per batch after the first in spmd /
   fused mode, the last batch's peak within 10% of the first's, no
   program replayed on a superseded graph version;
3f. the query service on phase 3e's streaming graph (8 slots, a 32-entry
   cache) in host, spmd and fused mode: 64 queries (48 sssp, 16 bfs, a
   quarter repeats) with two mixed update batches applied while queries
   are in flight; every result bitwise against a standalone run on the
   graph version its query ran on, ``host_transfers`` as the JAX engine
   counts them; queries per second, rounds-in-system p50 / p95, syncing
   calls per step, captures, device busy share; then a fleet of two
   replicas on the card (one throttled, so hedges fire) serving 32
   queries, bitwise against standalone runs, its routing trace replayed
   exactly; the fused kernels' launches counted on the card in each of
   3e and 3f, and nothing built after phase 1;
4. each kernel and its plain version timed on the card at the shapes
   the main path gave it (one ALB sssp, one sssp_batch and two pagerank
   rounds for the fused kernels, which are also timed beside the unfused route they
   replaced, index-map kernel + torch epilogue, and the index-map
   kernels at the same shapes; one merge-path sssp; one prefill and one
   decode step of phase 5), beside the least time the card could take
   and, for ``flash_attention``, PyTorch's
   ``scaled_dot_product_attention``; ``moe_plan`` also beside the route
   it replaced (the torch plan with the ``positions_in_expert`` kernel)
   and ``positions_in_expert`` alone; device profiles of ALB sssp,
   sssp_batch, adaptive cc and pagerank; the static entries at phase
   3d's shapes (one static ALB, twc and merge-path sssp, run eagerly and
   recorded), and the condition kernel (a 1,000-turn WHILE loop against
   the same loop driven from the host);
5. the LM serving path, after the graph phases' tensors are freed:
   deepseek-moe-16b at its published widths and 28 layers, random bf16
   weights from a seeded generator on the card, 4 requests of 1024
   prompt tokens and 32 greedy tokens, launch counts reset just before
   and read just after (``moe_plan`` 28 x 32, by cluster size,
   ``positions_in_expert`` 0, ``flash_attention`` 28, all on its wgmma
   route); every dispatch plan bitwise equal through ``moe_plan`` and
   its plain version; prefill logits and first tokens held
   against plain attention + one-hot dispatch; a skewed request set
   (one repeated token) whose layer-0 routing the ALB rebalance must
   keep more of; median wall times, syncing calls per decode step and
   device profiles of one prefill and one decode step (kernel launches
   of each, and ``moe_plan``'s device time per layer);
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
   limit line again, and last the ``{"ok": true, "device": {...}}`` line.

Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit):
# HBM3 bandwidth, and the non-tensor-core rate used for integer index
# arithmetic (the float32 rate; the integer rate is not higher)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# the kernels the graph phases (3, 3b) launch; phase 5 runs two more,
# and the index maps twc_bin_map / edge_lb_map are on no main path
GRAPH_KERNELS = ("twc_bin_relax", "edge_lb_relax", "merge_path_map")


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


# every operator of the fused relax kernels, and the pull twins
RELAX_OPS = ("SSSP_RELAX", "BFS_HOP", "CC_MIN", "KCORE_DEC", "PR_PULL",
             "SSSP_RELAX@pull", "BFS_HOP@pull", "CC_MIN@pull")
# float32 add: the kernels sum a vertex's candidates in another order
# than the plain version's index_add_ (bins: a fixed tree; huge bin:
# atomics), as tests/test_torch_cuda.py holds them
RELAX_FLOAT_RTOL = 1e-4


def relax_op(name):
    from repro_torch.core import operators
    base, _, pull = name.partition("@")
    op = getattr(operators, base)
    return operators.as_pull(op) if pull else op


def relax_err(got, want) -> float:
    """Max |got - want| (int labels), or max |got - want| / |want|
    (float labels; 0 where both are 0)."""
    import torch
    if got.dtype.is_floating_point:
        tiny = torch.finfo(want.dtype).tiny
        return float(((got - want).abs() / want.abs().clamp_min(tiny))
                     .max())
    return float((got.long() - want.long()).abs().max())


def relax_graph(dev, rng) -> tuple:
    """A random CSR of phase 2's fused-kernel sweeps: V = 50,000,
    degrees up to 6,000.  Returns ``(V, deg, row_ptr, col_idx, edge_w)``,
    the last two on ``dev``."""
    import torch
    v = 50_000
    deg = rng.integers(0, 40, v)
    deg[:12] = [6000, 3000, 2048, 1500, 1025, 1024, 1023, 300, 129, 128, 9,
                0]
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(row_ptr[-1])
    col = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.integers(1, 101, e).astype(np.int32)).to(dev)
    return v, deg, row_ptr, col, w


def relax_state(dev, rng, opname, b, v) -> tuple:
    """``(values, labels, fmask)`` of a sweep case: int32 labels with INF
    entries (values the same), or small float32 ones for PR_PULL."""
    import torch
    fm = torch.from_numpy(rng.random((b, v)) < 0.6).to(dev)
    if opname == "PR_PULL":
        lab = torch.from_numpy(
            (rng.random((b, v)) * 1e-3).astype(np.float32)).to(dev)
        val = torch.from_numpy(
            (rng.random((b, v)) * 1e-3).astype(np.float32)).to(dev)
        return val, lab, fm
    lab = rng.integers(0, 500, (b, v)).astype(np.int32)
    lab[rng.random((b, v)) < 0.3] = 1 << 30
    lab = torch.from_numpy(lab).to(dev)
    return lab.clone(), lab, fm


def relax_vs_plain(dev) -> dict:
    """``twc_bin_relax`` and ``edge_lb_relax`` against their plain
    versions on a random CSR (V = 50,000, degrees up to 6,000): every
    operator and pull twin, B in {1, 3, 8}; bins at W in {8, 128, 1024}
    and 2048 (wider than a pull lane's register slots),
    chunk 0..2 (host int and device int32), sentinel rows and an empty
    bin; huge bins of one row (on and off a 2048-edge tile), several
    rows with sentinel slots, 2,000 rows with zero-degree slots, and a
    3,000-slot zero-degree run wider than the cyclic deal's stage, both
    deals, bucketed and ragged spans, 64 and 7 tiles.  Returns the max
    errors ``{name: {"int": abs, "float": rel}}``."""
    import torch
    from repro_torch.core.frontier import next_bucket
    from repro_torch.kernels import ref, relax
    rng = np.random.default_rng(5)
    v, deg, row_ptr, col, w = relax_graph(dev, rng)

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    vid = np.concatenate([np.arange(12), rng.integers(12, v, 500),
                          np.full(100, v)])
    rng.shuffle(vid)
    safe = np.where(vid < v, vid, 0)
    rows = [t32(vid), t32(np.where(vid < v, deg[safe], 0)),
            t32(np.where(vid < v, row_ptr[safe], 0))]
    huge = []
    for hv in ([2], [1], list(range(7)), list(range(200, 2200)),
               [1] + [11] * 3000 + [2]):
        hv = np.array(hv)
        pad = 0 if len(hv) == 1 else 5
        hvidx, hdeg, hrow = (np.concatenate([a, np.full(pad, f)])
                             for a, f in ((hv, v), (deg[hv], 0),
                                          (row_ptr[hv], 0)))
        start_e = np.cumsum(hdeg) - hdeg
        huge.append(([t32(hvidx), t32(start_e), t32(hrow)],
                     int(hdeg.sum())))
    errs = {"twc_bin_relax": {"int": 0.0, "float": 0.0},
            "edge_lb_relax": {"int": 0.0, "float": 0.0}}
    counted = {k: getattr(relax, k).launches for k in errs}
    cases = {k: 0 for k in errs}

    def held(name, got, want):
        kind = "float" if got.dtype.is_floating_point else "int"
        errs[name][kind] = max(errs[name][kind], relax_err(got, want))
        cases[name] += 1

    for opname in RELAX_OPS:
        op = relax_op(opname)
        for b in (1, 3, 8):
            val, lab, fm = relax_state(dev, rng, opname, b, v)
            for width in (8, 128, 1024, 2048):
                for chunk in (0, 1, 2):
                    for ch in (chunk, t32([chunk])):
                        for n in (len(vid), 0):
                            r = [x[:n] for x in rows]
                            held("twc_bin_relax", relax.twc_bin_relax(
                                val, lab.clone(), fm, col, w, *r, op,
                                width=width, chunk=ch),
                                ref.twc_bin_relax_ref(
                                val, lab.clone(), fm, col, w, *r, op,
                                width=width, chunk=chunk))
            for t, total in huge:
                for n_enum in (next_bucket(total, 2048), total):
                    for tiles in (64, 7):
                        for dist in ("cyclic", "blocked"):
                            kw = dict(distribution=dist, num_tiles=tiles)
                            held("edge_lb_relax", relax.edge_lb_relax(
                                val, lab.clone(), fm, col, w, *t, total,
                                n_enum, op, **kw),
                                ref.edge_lb_relax_ref(
                                val, lab.clone(), fm, col, w, *t, total,
                                n_enum, op, **kw))
    torch.cuda.synchronize()
    for name, err in errs.items():
        check(err["int"] == 0 and err["float"] <= RELAX_FLOAT_RTOL,
              f"{name} != plain: {err}")
    launched = {k: getattr(relax, k).launches - counted[k] for k in errs}
    check(launched["twc_bin_relax"] == cases["twc_bin_relax"] // 2 and
          launched["edge_lb_relax"] == cases["edge_lb_relax"],
          f"relax launches {launched} for cases {cases}")
    print(f"phase 2: fused relax == plain on {cases} cases ({launched} "
          f"launches; min and int add exact, float add within rtol "
          f"{RELAX_FLOAT_RTOL}): {errs}", flush=True)
    return errs


def static_entries_vs_plain(dev) -> dict:
    """The device-int32 entries of the static-shape round against their
    plain versions given the same values as host ints, on phase 2's
    random CSR: ``twc_bin_relax`` over V rows (sentinel ``V`` for
    non-members, as the static round lays a bin out) with the first
    chunk and the pass count on the device (0 passes, 1, 2, and every
    pass a 6,000-degree row needs), without a row bound and with one on
    the device (V, V / 3: the static round's tile walk), every operator,
    B in {1, 3};
    ``edge_lb_relax`` over the static span (every edge of the graph)
    with the total on the device (0, one row, several, 2,000 rows), both
    deals, 64 and 7 tiles; ``merge_path_map`` and ``edge_lb_map`` with a
    device total against a span far past it (total 0, ragged tails,
    zero-degree runs).  Returns the max errors."""
    import torch
    from repro_torch.kernels import edge_lb, merge_path, ref, relax
    rng = np.random.default_rng(17)
    v, deg, row_ptr, col, w = relax_graph(dev, rng)
    e = int(row_ptr[-1])

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    member = rng.random(v) < 0.2
    member[:12] = True
    rows = [t32(np.where(member, a, f)) for a, f in
            ((np.arange(v), v), (deg, 0), (row_ptr[:-1], 0))]
    huge = []
    for hv in ([], [0], list(range(7)), list(range(200, 2200))):
        m = np.zeros(v, bool)
        m[hv] = True
        hvidx, hdeg, hrow = (np.where(m, a, f) for a, f in
                             ((np.arange(v), v), (deg, 0), (row_ptr[:-1], 0)))
        huge.append(([t32(hvidx), t32(np.cumsum(hdeg) - hdeg), t32(hrow)],
                     int(hdeg.sum())))
    errs = {"twc_bin_relax": {"int": 0.0, "float": 0.0},
            "edge_lb_relax": {"int": 0.0, "float": 0.0},
            "merge_path_map": 0, "edge_lb_map": 0}
    cases = {k: 0 for k in errs}

    def held(name, got, want):
        kind = "float" if got.dtype.is_floating_point else "int"
        errs[name][kind] = max(errs[name][kind], relax_err(got, want))
        cases[name] += 1

    for opname in RELAX_OPS:
        op = relax_op(opname)
        for b in (1, 3):
            val, lab, fm = relax_state(dev, rng, opname, b, v)
            for width in (8, 128, 1024):
                most = -(-int(deg.max()) // width)
                for chunk in (0, 1):
                    for passes in sorted({0, 1, 2, most - chunk}):
                        # no row bound (one group a row), and bounds at V
                        # and at V / 3 (the tile walk of the static round)
                        for bound in (None, v, v // 3):
                            held("twc_bin_relax", relax.twc_bin_relax(
                                val, lab.clone(), fm, col, w, *rows, op,
                                width=width, chunk=t32(chunk),
                                passes=t32(passes),
                                rows=None if bound is None else t32(bound)),
                                ref.twc_bin_relax_ref(
                                val, lab.clone(), fm, col, w, *rows, op,
                                width=width, chunk=chunk, passes=passes,
                                rows=bound))
            for t, total in huge:
                for tiles in (64, 7):
                    for dist in ("cyclic", "blocked"):
                        kw = dict(distribution=dist, num_tiles=tiles)
                        held("edge_lb_relax", relax.edge_lb_relax(
                            val, lab.clone(), fm, col, w, *t, t32(total),
                            e, op, **kw),
                            ref.edge_lb_relax_ref(
                            val, lab.clone(), fm, col, w, *t, total, e, op,
                            **kw))
    for h in (1, 700, 5000):
        for tile in (128, 2048):
            hdeg = rng.integers(0, 50, h).astype(np.int32)
            hdeg[rng.random(h) < 0.3] = 0
            if h == 1:
                hdeg[:] = 0                        # total 0
            start_e = t32(np.cumsum(hdeg) - hdeg)
            row = t32(rng.integers(0, 1 << 20, h))
            total = int(hdeg.sum())
            span = 3 * total + 5 * tile + 17       # ragged, far past it
            k = merge_path.merge_path_map(start_e, row, t32(total), span,
                                          tile_edges=tile)
            p = ref.merge_path_map_ref(start_e, row, total, span,
                                       tile_edges=tile)
            check(all(torch.equal(a, b) for a, b in zip(k, p)),
                  f"merge_path_map (device total) != plain (H={h})")
            cases["merge_path_map"] += 1
            for dist in ("cyclic", "blocked"):
                k = edge_lb.edge_lb_map(start_e, row, row, t32(total), span,
                                        tile_edges=tile, distribution=dist)
                p = ref.edge_lb_map_ref(start_e, row, row, total, span,
                                        tile_edges=tile, distribution=dist)
                errs["edge_lb_map"] = max(errs["edge_lb_map"],
                                          masked_err(k, p))
                cases["edge_lb_map"] += 1
    torch.cuda.synchronize()
    for name in ("twc_bin_relax", "edge_lb_relax"):
        check(errs[name]["int"] == 0 and
              errs[name]["float"] <= RELAX_FLOAT_RTOL,
              f"{name} (device int32 entry) != plain: {errs[name]}")
    check(errs["edge_lb_map"] == 0, "edge_lb_map (device total) != plain")
    print(f"phase 2: device-int32 entries == plain on {cases} cases (min "
          f"and int add exact, float add within rtol {RELAX_FLOAT_RTOL}): "
          f"{errs}", flush=True)
    return errs


# the LM kernels against their plain versions: positions_in_expert
# exactly; flash_attention at tests/test_kernels_lm.py's tolerances
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def lm_kernels_vs_plain(dev) -> dict:
    """``positions_in_expert`` exactly over N x E x (uniform, one-expert,
    out-of-range ids); ``flash_attention`` over S x (H, Hkv) x hd x
    causal x dtype, and bf16 hd = 128 at S = 127, 129 and 1000 (the
    wgmma route's ragged tiles), within ``FLASH_TOL``, each launch
    counted on the route ``flash_attention.route`` gives it.  Returns
    the max errors."""
    import torch
    from repro_torch.kernels import flash_attention, moe_dispatch, ref
    rng = np.random.default_rng(1)
    pie_err, pie_cases = 0, 0
    for n in (0, 1, 24, 255, 1024, 1025, 24_576, 10 ** 6):
        for e in (1, 8, 64):
            for ids in (rng.integers(0, e, n), np.full(n, e - 1),
                        rng.integers(-2, e + 3, n)):
                t = torch.from_numpy(ids.astype(np.int32)).to(dev)
                got = moe_dispatch.positions_in_expert(t, e)
                want = ref.positions_in_expert_ref(t, e)
                check(got.dtype == torch.int32 and got.shape == want.shape,
                      f"positions_in_expert: dtype/shape (N={n}, E={e})")
                d = (got.long() - want.long()).abs()
                pie_err = max(pie_err, int(d.max()) if n else 0)
                pie_cases += 1
    torch.cuda.synchronize()
    check(pie_err == 0, f"positions_in_expert != plain: {pie_err}")
    fa_err = {"bfloat16": 0.0, "float32": 0.0}
    fa_cases = {"wgmma": 0, "simt": 0}
    by_route = flash_attention.flash_attention.launches_by_route
    counted = dict(by_route)
    gen = torch.Generator(device=dev).manual_seed(2)
    sweep = [(s, hd, dtype) for s in (1, 100, 128, 1024, 2048)
             for hd in (16, 64, 128) for dtype in ("bfloat16", "float32")]
    sweep += [(s, 128, "bfloat16") for s in (127, 129, 1000)]
    for s, hd, dtype in sweep:
        b = 1 if s > 1024 else 2
        for h, hkv in ((16, 16), (4, 2), (8, 1)):
            q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
                       .to(getattr(torch, dtype)) for n in (h, hkv, hkv))
            for causal in (True, False):
                got = flash_attention.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention_ref(q, k, v, causal=causal)
                check(got.dtype == q.dtype and got.shape == q.shape,
                      "flash_attention: dtype/shape")
                err = float((got.float() - want.float()).abs().max())
                fa_err[dtype] = max(fa_err[dtype], err)
                fa_cases[flash_attention.route(q.dtype, hd)] += 1
    torch.cuda.synchronize()
    for dtype, tol in FLASH_TOL.items():
        check(fa_err[dtype] <= tol, f"flash_attention {dtype} != plain: "
              f"max error {fa_err[dtype]} > {tol}")
    launched = {r: by_route[r] - counted[r] for r in by_route}
    check(launched == fa_cases and fa_cases["wgmma"] > 0,
          f"flash_attention: launches by route {launched}, expected "
          f"{fa_cases}")
    print(f"phase 2: positions_in_expert == plain on {pie_cases} cases "
          f"(tolerance 0): max error {pie_err}; flash_attention within "
          f"{FLASH_TOL} of plain on {sum(fa_cases.values())} cases "
          f"(launches by route {launched}): max error {fa_err}",
          flush=True)
    return {"positions_in_expert": pie_err, "flash_attention": fa_err}


# the sweep of moe_plan: T tokens per group, (E, K) as deepseek-moe-16b
# (64, 6), llama4-scout (16, 1), the SMOKE configs (8, 2) and the
# kernel's limits (256, 16); G groups
MOE_T = (1, 4, 33, 1024, 4096)
MOE_EK = ((8, 2), (16, 1), (64, 6), (256, 16))
MOE_G = (1, 2, 4)


def plan_err(got, want) -> int:
    """Max |got - want| over the four outputs of a plan, the gates
    compared as their int32 words (a NaN row compares too): 0 iff the
    plans are bitwise equal."""
    import torch
    err = 0
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(a.dtype == b.dtype and a.shape == b.shape, "plan dtype/shape")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def moe_plan_vs_plain(dev) -> dict:
    """``moe_plan`` against ``moe_plan_ref`` bitwise over T x (E, K) x G
    x adaptive x (uniform, skewed: one expert takes all, exact ties, one
    row with a NaN); the skewed cases' cap is small enough that the
    overflow exceeds the free places.  Three more plans of (16, 1) at
    T = 2048c - 1 reach cluster sizes c = 5, 6 and 7, so every size the
    wrapper picks is launched.  Returns the max error and the cases."""
    import torch
    from repro_torch.kernels import moe_plan, ref
    rng = np.random.default_rng(4)
    by_cluster = dict(moe_plan.moe_plan.launches_by_cluster)
    before = moe_plan.moe_plan.launches
    sweep = [(t, e, k, g, a, kind) for t in MOE_T for e, k in MOE_EK
             for g in MOE_G for a in (True, False)
             for kind in ("uniform", "skewed", "ties", "nan")]
    sweep += [(2048 * c - 1, 16, 1, 1, True, "uniform") for c in (5, 6, 7)]
    err, beyond_free = 0, 0
    for t, e, k, g, adaptive, kind in sweep:
        x = rng.random((g, t, e)).astype(np.float32)
        cap = max(int(1.25 * t * k / e), 4)
        if kind == "skewed":
            x[..., 0] += 1e4
            cap = max(cap // 8, 1)
            beyond_free += e * cap < t * k
        elif kind == "ties":
            x = np.round(x * 4) / 4 + 0.25
            x[..., 1] = x[..., 0]
        elif kind == "nan":
            x[g - 1, t // 2, e // 3] = np.nan
        p = torch.from_numpy(x / x.sum(-1, keepdims=True)).to(dev)
        kw = dict(top_k=k, cap=cap, groups=g, adaptive=adaptive)
        err = max(err, plan_err(moe_plan.moe_plan(p, **kw),
                                ref.moe_plan_ref(p, **kw)))
    torch.cuda.synchronize()
    check(err == 0, f"moe_plan != plain: max error {err}")
    launched = moe_plan.moe_plan.launches - before
    clusters = {c: moe_plan.moe_plan.launches_by_cluster[c] - n
                for c, n in by_cluster.items()}
    check(launched == len(sweep), f"moe_plan: {launched} launches for "
          f"{len(sweep)} plans")
    check(all(clusters[c] > 0 for c in range(1, moe_plan.MAX_CLUSTER + 1)),
          f"moe_plan: cluster sizes launched {clusters}")
    print(f"phase 2: moe_plan == plain bitwise on {len(sweep)} plans "
          f"({beyond_free} with the overflow beyond the free places); "
          f"launches by cluster size {clusters}", flush=True)
    return {"max_err": err, "cases": len(sweep), "by_cluster": clusters}


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
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them; where that
    line is inside torch, the innermost line of the port that led to it
    follows (``... via file:line``)."""
    import torch
    torch.cuda.synchronize()
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = f"{Path(filename).name}:{lineno}"
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename]
        if ours and Path(ours[-1].filename) != Path(filename):
            site += f" via {Path(ours[-1].filename).name}:{ours[-1].lineno}"
        sites.append(site)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def main_path(dev, scale: int) -> dict:
    import torch
    from repro_torch import kernels
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.graph import highest_out_degree_vertex, rmat
    from repro_torch.kernels import ops

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
    print(f"phase 3: kernel launches on the main path: {launches}; "
          f"unfused passes {ops.unfused_passes}", flush=True)
    for name in ("twc_bin_relax", "edge_lb_relax"):
        check(launches[name] > 0, f"{name} was not launched on the main "
              f"path")
    check(ops.unfused_passes == 0, "a built-in operator took the unfused "
          "route")

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
    from repro_torch.kernels import ops

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
          f"unfused passes {ops.unfused_passes}; peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    for name in GRAPH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the slice-2 "
              f"path")
    check(ops.unfused_passes == 0, "a built-in operator took the unfused "
          "route")
    # the kernel pair on pull rounds: pagerank's rounds are all pulls
    # (PR_PULL over the reverse CSR); adaptive cc's pull rounds served
    # both the bins and the huge bin
    for run in ("pagerank/kernel", "cc_adaptive/kernel"):
        check(by_run[run]["twc_bin_relax"] > 0 and
              by_run[run]["edge_lb_relax"] > 0,
              f"{run}: twc_bin_relax / edge_lb_relax not launched")
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
            "apps": apps, "cfgs": cfgs, "median_s": med, "sym": sym}


# ---------------------------------------------------------------------------
# phase 3c: an operator the fused kernels do not take
# ---------------------------------------------------------------------------

def user_op_path(g, src, sssp_labels) -> dict:
    """A user operator, int32 min with ``msg = v + 2w`` (no msg kind of
    the fused kernels), from ``src`` to the fixpoint through the
    ``pallas`` pair and through the ``xla`` pair (``drivers.resume_loop``),
    counted as one run (launch counts and ``ops.unfused_passes`` reset
    just before, read just after).  The pair takes its unfused route:
    the index maps ``twc_bin_map`` / ``edge_lb_map`` and the torch
    epilogue.  Labels and rounds bitwise equal between the pairs, and
    equal to twice the sssp labels of phase 3 (INF kept)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.frontier import single_source
    from repro_torch.core.operators import Operator
    from repro_torch.kernels import ops
    op = Operator("sssp_double_weight", "push", "min", lambda v, w: v + 2 * w)
    inf = 1 << 30

    def run(cfg):
        labels = torch.full((g.num_vertices,), inf, dtype=torch.int32,
                            device=g.device)
        labels[src] = 0
        return drivers.resume_loop(g, labels, single_source(
            g.num_vertices, src, g.device), cfg, op)
    kernels.reset_launch_counts()
    kern = run(BalancerConfig(strategy="alb", use_pallas=True))
    launches, unfused = kernels.launch_counts(), ops.unfused_passes
    plain = run(BalancerConfig(strategy="alb"))
    want = torch.where(sssp_labels < inf, 2 * sssp_labels, inf)
    print(f"phase 3c: user operator {op.name} (int32 min, msg v + 2w) "
          f"through the pallas pair: {kern.rounds} rounds, {unfused} "
          f"unfused passes, launches {launches}; wall {kern.seconds:.5f} s "
          f"(xla pair {plain.seconds:.5f} s)", flush=True)
    check(unfused > 0 and launches["twc_bin_map"] > 0 and
          launches["edge_lb_map"] > 0, "user operator: the unfused route "
          "was not taken")
    check(launches["twc_bin_relax"] == 0 and launches["edge_lb_relax"] == 0,
          "user operator: a fused kernel was launched")
    check(torch.equal(kern.labels, plain.labels) and
          kern.rounds == plain.rounds, "user operator: pallas pair != xla "
          "pair")
    check(torch.equal(kern.labels, want), "user operator: labels != 2 x "
          "sssp")
    print("phase 3c: labels and rounds bitwise equal to the xla pair and "
          "to 2 x the sssp labels", flush=True)
    return {"rounds": kern.rounds, "unfused_passes": unfused,
            "launches": launches, "seconds": kern.seconds,
            "seconds_xla": plain.seconds}


# ---------------------------------------------------------------------------
# phase 3d: the static-shape (spmd) and fused round modes
# ---------------------------------------------------------------------------

def no_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    syncing CUDA call torch makes inside raises."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def event_span_ms(fn) -> float:
    """Device time from the start to the end of ``fn()``'s work, by CUDA
    events; the stream is held busy while the host enqueues, so host
    time before the work starts is not counted."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


def fused_dispatches(g, sym, src, sources, cfgs, stats: bool) -> dict:
    """Each fused traversal of phase 3d up to its dispatch, without the
    final fetch: ``name -> callable`` returning device tensors (the
    apps' own entries, with the inputs the apps build, and stat rows
    kept when ``stats``)."""
    import torch
    from repro_torch.core import balancer
    from repro_torch.core import operators as tops
    from repro_torch.core.apps import drivers
    from repro_torch.core.frontier import multi_source_state
    from repro_torch.core.graph import INF

    def single(source):
        lab = torch.full((g.num_vertices,), int(INF), dtype=torch.int32,
                         device=g.device)
        lab[source] = 0
        return lab, lab == 0

    def traversal(op, state, cfg):
        return lambda: balancer.run_fused(g if op is not tops.CC_MIN
                                          else sym, *state, cfg, op,
                                          collect_stats=stats)[:3]
    deg = sym.out_degrees()
    frontier = (deg < KCORE_K) & (deg > 0)
    rg = g.reverse()
    outdeg = g.out_degrees().to(torch.float32)
    inv_out = torch.where(outdeg > 0, 1.0 / torch.clamp(outdeg, min=1.0),
                          0.0)
    comp = torch.arange(sym.num_vertices, dtype=torch.int32,
                        device=sym.device)
    return {
        "sssp": traversal(tops.SSSP_RELAX, single(src), cfgs["kernel"]),
        "bfs": traversal(tops.BFS_HOP, single(src), cfgs["kernel"]),
        "sssp_batch": traversal(
            tops.SSSP_RELAX,
            multi_source_state(g.num_vertices, sources, INF, g.device),
            cfgs["kernel"]),
        "sssp_adaptive": traversal(tops.SSSP_RELAX, single(src),
                                   cfgs["adaptive"]),
        "cc_adaptive": traversal(tops.CC_MIN,
                                 (comp, torch.ones_like(comp, dtype=bool)),
                                 cfgs["adaptive"]),
        "kcore": lambda: drivers._kcore_fused(
            sym, deg, frontier, frontier | (deg < KCORE_K), KCORE_K,
            cfgs["kernel"], 10_000, stats)[:2],
        "pagerank": lambda: drivers._pagerank_fused(
            rg, inv_out, outdeg == 0, 0.85, 0.0, cfgs["kernel"], PR_ROUNDS,
            stats)[:2],
        "sssp/merge_path": traversal(tops.SSSP_RELAX, single(src),
                                     cfgs["merge_path"]),
        "sssp/twc": traversal(tops.SSSP_RELAX, single(src), cfgs["twc"])}


def static_path(g, sym, src, sources) -> dict:
    """Phase 3d: the static-shape round (``mode="spmd"``: one replay of
    a captured round graph and one counted fetch a round) and the fused
    traversal (``mode="fused"``: one graph launch whose WHILE node turns
    on the card) through the kernel pair, on phase 3's graph and its
    symmetrized form; sssp also fused through merge_path and under
    ``strategy="twc"`` (the unbounded bin: a device pass count).  Held
    against host mode.  Launches are counted on the card: the static
    entries' kernels count their own launches (``csrc/device_count.cuh``,
    replays and WHILE turns included), reset just before and read just
    after each spmd or fused run, and held against what the run's rounds
    need: every bin of the plan and the huge bin once a round (one round
    more in spmd mode, whose loop learns of convergence from a round on
    the empty frontier).  The wrappers' own counts say how many launches
    the captures recorded."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.core import graph_loop
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig, effective_plan
    from repro_torch.kernels import ops

    kern = BalancerConfig(strategy="alb", use_pallas=True)
    cfgs = {"kernel": kern,
            "adaptive": dataclasses.replace(kern, direction="adaptive"),
            "merge_path": BalancerConfig(strategy="alb",
                                         backend="merge_path"),
            "twc": BalancerConfig(strategy="twc", use_pallas=True)}
    apps = {
        "sssp": lambda m, st: drivers.sssp(g, src, kern, mode=m,
                                           collect_stats=st),
        "bfs": lambda m, st: drivers.bfs(g, src, kern, mode=m,
                                         collect_stats=st),
        "sssp_batch": lambda m, st: drivers.sssp_batch(
            g, sources, kern, mode=m, collect_stats=st),
        "sssp_adaptive": lambda m, st: drivers.sssp(
            g, src, cfgs["adaptive"], mode=m, collect_stats=st),
        "cc_adaptive": lambda m, st: drivers.cc(
            sym, cfgs["adaptive"], mode=m, collect_stats=st),
        "kcore": lambda m, st: drivers.kcore(sym, KCORE_K, kern, mode=m,
                                             collect_stats=st),
        "pagerank": lambda m, st: drivers.pagerank(
            g, cfg=kern, max_rounds=PR_ROUNDS, tol=0.0, mode=m,
            collect_stats=st),
        "sssp/merge_path": lambda m, st: drivers.sssp(
            g, src, cfgs["merge_path"], mode=m, collect_stats=st),
        "sssp/twc": lambda m, st: drivers.sssp(g, src, cfgs["twc"],
                                               mode=m, collect_stats=st)}
    cfg_of = {a: cfgs["kernel"] for a in apps}
    cfg_of.update({"sssp_adaptive": cfgs["adaptive"],
                   "cc_adaptive": cfgs["adaptive"],
                   "sssp/merge_path": cfgs["merge_path"],
                   "sssp/twc": cfgs["twc"]})
    modes = {a: ("fused",) if "/" in a else ("spmd", "fused") for a in apps}
    host = {a: apps[a]("host", True) for a in apps}

    def needed(a, m, rounds) -> dict:
        """Launches a run's rounds need: each bin of the plan and the
        huge bin once a round."""
        ran = rounds + (m == "spmd" and a != "pagerank")
        plan = effective_plan(cfg_of[a])
        if cfg_of[a].executor == "merge_path":
            return {"twc_bin_relax": 0, "edge_lb_relax": 0,
                    "merge_path_map": ran}
        return {"twc_bin_relax": ran * len(plan.bins),
                "edge_lb_relax": ran * (plan.lb != "none"),
                "merge_path_map": 0}

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    kernels.device_launch_counts(reset=True)
    graph_loop.set_runs(reset=True)
    caps0, cap_s0 = graph_loop.captures, graph_loop.capture_seconds
    out, by_run, captured_by_run = {}, {}, {}
    for a in apps:
        for m in modes[a]:
            before = kernels.capture_counts()
            out[a, m] = apps[a](m, True)
            after = kernels.capture_counts()
            on_card = kernels.device_launch_counts(reset=True)
            by_run[f"{a}/{m}"] = on_card
            captured_by_run[f"{a}/{m}"] = {
                k: after[k] - before[k] for k in after
                if after[k] > before[k]}
            want = needed(a, m, out[a, m].rounds)
            check(on_card == want, f"{a}/{m}: launches on the card "
                  f"{on_card} != {want} for {out[a, m].rounds} rounds")
    launches = {k: sum(r[k] for r in by_run.values())
                for k in kernels.DEVICE_COUNTED}
    captured = kernels.capture_counts()
    decisions = graph_loop.set_runs(reset=True)
    captures = graph_loop.captures - caps0
    capture_s = graph_loop.capture_seconds - cap_s0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 3d: kernel launches on the card by the spmd and fused "
          f"runs, each run's equal to its rounds x bins: {launches} (by "
          f"run {by_run}); launches recorded by the captures: {captured}; "
          f"unfused passes {ops.unfused_passes}; {captures} graphs "
          f"captured in {capture_s:.2f} s; the condition kernel took "
          f"{decisions} branch and loop decisions on the card; peak "
          f"device memory {peak_gb:.2f} GB", flush=True)
    for name in GRAPH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by phase 3d")
    check(by_run["sssp/twc/fused"]["twc_bin_relax"] > 0,
          "the twc strategy's unbounded bin did not launch twc_bin_relax")
    check(ops.unfused_passes == 0, "a built-in operator took the unfused "
          "route")
    check(decisions > 0, "the condition kernel never ran")

    # ---- held against host mode ----
    pr_err = {}
    for (a, m), r in out.items():
        h = host[a]
        if a == "pagerank":
            got = r.labels.double().cpu().numpy()
            ref = h.labels.double().cpu().numpy()
            pr_err[m] = float(np.max(np.abs(got - ref) / ref))
            check(pr_err[m] <= PR_RTOL_PAIR,
                  f"pagerank/{m} != host: rel {pr_err[m]}")
        else:
            check(torch.equal(r.labels, h.labels), f"{a}/{m}: labels != "
                  f"host")
        check(r.rounds == h.rounds and len(r.stats) == len(h.stats),
              f"{a}/{m}: rounds {r.rounds} != host {h.rounds}")
        for x, y in zip(h.stats, r.stats):
            check((x.frontier_size, x.frontier_edges, x.direction) ==
                  (y.frontier_size, y.frontier_edges, y.direction),
                  f"{a}/{m}: round stats != host: {x} / {y}")
        want = 0 if m == "fused" else h.host_transfers
        check(r.host_transfers == want,
              f"{a}/{m}: host_transfers {r.host_transfers} != {want}")
    check("P" in directions(out["sssp_adaptive", "fused"]) and
          "P" in directions(out["cc_adaptive", "fused"]),
          "adaptive fused runs took no pull round")

    # ---- zero syncing calls between dispatch and fetch ----
    dispatch = fused_dispatches(g, sym, src, sources, cfgs, stats=True)
    for a, fn in dispatch.items():
        before = graph_loop.captures
        res = no_syncs(fn)             # raises on any syncing call
        check(graph_loop.captures == before, f"{a}: captured again")
        lab, r = res[0], int(res[-1])
        want = out[a, "fused"]
        check(r == want.rounds, f"{a}: dispatch rounds {r}")
        if a != "pagerank":
            check(torch.equal(lab, want.labels), f"{a}: dispatch labels")
    print(f"phase 3d: spmd and fused == host mode (labels, rounds, "
          f"per-round frontier size, edges and direction; pagerank within "
          f"rtol {PR_RTOL_PAIR}: {pr_err}); fused host_transfers 0, spmd "
          f"as host; 0 syncing calls between dispatch and fetch of "
          f"{len(dispatch)} fused traversals under "
          f"set_sync_debug_mode('error')", flush=True)

    # ---- wall times, host / spmd / fused in turns, one card ----
    seconds = {f"{a}/{m}": [] for a in apps for m in ("host",) + modes[a]}
    for i in range(6):
        for a in apps:
            ms = ("host",) + modes[a]
            for m in (ms if i % 2 == 0 else ms[::-1]):
                seconds[f"{a}/{m}"].append(apps[a](m, False).seconds)
    med = {k: float(np.median(v)) for k, v in seconds.items()}
    print(f"phase 3d: median wall seconds of 6 runs each: {med}",
          flush=True)
    # the profiler sees only part of a graph's conditional bodies (a
    # fused run shows about one round's kernels), so a fused traversal's
    # device time is the span of its one launch between CUDA events
    dispatch = fused_dispatches(g, sym, src, sources, cfgs, stats=False)
    span = {a: float(np.median([event_span_ms(fn) for _ in range(6)]))
            for a, fn in dispatch.items()}
    busy = {a: span[a] / (med[f"{a}/fused"] * 1e3) for a in span}
    print(f"phase 3d: device span of each fused traversal (CUDA events "
          f"around its dispatch, median of 6), ms: {span}; over the "
          f"median fused wall: {busy}", flush=True)
    prof = profile_path(
        {f"{a}/{m}": (lambda a=a, m=m: apps[a](m, False))
         for a in ("sssp", "pagerank") for m in ("host", "spmd")},
        med, label="phase 3d")
    return {"launches": launches, "launches_by_run": by_run,
            "captured": captured, "captured_by_run": captured_by_run,
            "captures": captures, "capture_s": capture_s,
            "condition_decisions": decisions,
            "rounds": {f"{a}/{m}": r.rounds for (a, m), r in out.items()},
            "host_transfers": {f"{a}/{m}": r.host_transfers
                               for (a, m), r in out.items()},
            "direction_traces": {f"{a}/{m}": directions(r)
                                 for (a, m), r in out.items()
                                 if "adaptive" in a},
            "pagerank_rel_err": pr_err, "peak_device_gb": peak_gb,
            "seconds": seconds, "median_s": med, "profile": prof,
            "fused_span_ms": span, "fused_busy": busy}


# ---------------------------------------------------------------------------
# phase 3e: streaming updates with incremental repair
# ---------------------------------------------------------------------------

STREAM_CAP = 4096             # update slots a batch
STREAM_BATCHES = 8            # batches a trace
STREAM_MODES = {"sssp": ("host", "spmd", "fused"), "bfs": ("host", "fused"),
                "cc": ("host", "fused")}


def stream_traces(g, seed: int, mirror: bool) -> dict:
    """Phase 3e's two update traces over the real vertices of ``g`` (a
    streaming graph), from ``numpy.random.default_rng(seed)``:
    ``insert-only`` (STREAM_BATCHES batches of STREAM_CAP inserts,
    weights 1..100) and ``mixed`` (60% inserts, 20% deletes of existing
    edges, 10% reweights of existing edges, 10% no-ops: deletes of absent
    edges and re-inserts of existing edges at a worse weight).  With
    ``mirror`` every update is followed by its reverse, so a symmetrized
    graph stays symmetric."""
    from repro_torch.core import streaming as ts
    rng = np.random.default_rng(seed)
    nv = ts.real_vertices(g)
    rp = g.row_ptr.cpu().numpy().astype(np.int64)
    ci, ew = g.col_idx.cpu().numpy(), g.edge_w.cpu().numpy()
    k = STREAM_CAP // 2 if mirror else STREAM_CAP

    def batch(op, u, v, w):
        if mirror:
            op, w = np.repeat(op, 2), np.repeat(w, 2)
            u, v = np.stack([u, v], 1).ravel(), np.stack([v, u], 1).ravel()
        return ts.UpdateBatch(*(np.asarray(a).astype(np.int32)
                                for a in (op, u, v, w)))

    def fresh():
        return (rng.integers(0, nv, k), rng.integers(0, nv, k),
                rng.integers(1, 101, k))

    out = {"insert-only": [], "mixed": []}
    for _ in range(STREAM_BATCHES):
        out["insert-only"].append(batch(np.full(k, ts.OP_INSERT), *fresh()))
    for _ in range(STREAM_BATCHES):
        r = rng.random(k)
        u, v, w = fresh()
        e = rng.integers(0, int(rp[-1]), k)          # existing edges
        eu, ev = np.searchsorted(rp, e, side="right") - 1, ci[e]
        delete, reweight = (r >= 0.6) & (r < 0.8), (r >= 0.8) & (r < 0.9)
        absent, worse = (r >= 0.9) & (r < 0.95), r >= 0.95
        op = np.full(k, ts.OP_INSERT)
        op[delete | absent] = ts.OP_DELETE
        op[reweight] = ts.OP_REWEIGHT
        on_edge = delete | reweight | worse
        u[on_edge], v[on_edge] = eu[on_edge], ev[on_edge]
        w[worse] = ew[e[worse]] + rng.integers(1, 101, int(worse.sum()))
        w[delete | absent] = 0
        out["mixed"].append(batch(op, u, v, w))
    return out


def numpy_rebuild(g0, batches, vp: int, ecap: int) -> list:
    """The CSR arrays after ``batches`` applied to ``g0`` (the graph the
    streaming graph was made from), rebuilt on the host without the
    port: the batches replayed in slot order (insert keeps the minimum,
    delete of an absent edge and reweight of one are no-ops) into a dict
    over the keys they touch, on top of ``g0``'s sorted edge keys; the
    live edges then put in (src, dst) order by a stable sort of
    ``src * vp + dst`` (the order of ``np.lexsort((dst, src))``) and
    padded to ``(vp, ecap)`` with the sentinel ``vp - 1`` and INF."""
    rp = g0.row_ptr.cpu().numpy().astype(np.int64)
    n = int(rp[-1])
    src = np.repeat(np.arange(len(rp) - 1, dtype=np.int64), np.diff(rp))
    key = src * vp + g0.col_idx[:n].cpu().numpy()
    w = g0.edge_w[:n].cpu().numpy().astype(np.int64)
    del src
    overlay = {}
    for b in batches:
        live = b.op != 0
        tk = np.unique(b.src[live].astype(np.int64) * vp + b.dst[live])
        pos = np.minimum(np.searchsorted(key, tk), n - 1)
        cur = {int(t): overlay.get(int(t), int(w[p]) if key[p] == t
                                   else None)
               for t, p in zip(tk, pos)}
        for o, u, v, x in zip(b.op.tolist(), b.src.tolist(),
                              b.dst.tolist(), b.w.tolist()):
            t = u * vp + v
            if o == 1:
                cur[t] = x if cur[t] is None else min(cur[t], x)
            elif o == 2:
                cur[t] = None
            elif o == 3 and cur[t] is not None:
                cur[t] = x
        overlay.update(cur)
    ok = np.fromiter(overlay, np.int64, len(overlay))
    pos = np.minimum(np.searchsorted(key, ok), n - 1)
    keep = np.ones(n, bool)
    keep[pos[key[pos] == ok]] = False
    added = [(t, x) for t, x in overlay.items() if x is not None]
    key = np.concatenate([key[keep], np.array([t for t, _ in added],
                                              np.int64)])
    w = np.concatenate([w[keep], np.array([x for _, x in added], np.int64)])
    order = np.argsort(key, kind="stable")
    key, w = key[order], w[order]
    m = len(key)
    row_ptr = np.zeros(vp + 1, np.int32)
    np.cumsum(np.bincount(key // vp, minlength=vp), out=row_ptr[1:])
    col = np.full(max(ecap, m), vp - 1, np.int32)
    col[:m] = key % vp
    wts = np.full(max(ecap, m), 1 << 30, np.int32)
    wts[:m] = w
    return [row_ptr, col, wts]


@contextlib.contextmanager
def program_versions(seen: list):
    """Inside the block, each ``graph_loop.run`` on the card appends
    ``(version the replayed program was captured for, owner's version
    now)`` to ``seen``: a program of a superseded version must never
    run."""
    from repro_torch.core import graph_loop
    real = graph_loop.run

    def run(owner, key, fn, *inputs):
        out = real(owner, key, fn, *inputs)
        cache = owner.__dict__.get("_programs")
        if cache:
            seen.append((next(reversed(cache))[0], owner.version))
        return out

    graph_loop.run = run
    try:
        yield
    finally:
        graph_loop.run = real


def stream_update_row(st, batch, entry: dict) -> tuple:
    """One measured ``stream_update``: its apply time (an
    ``apply_updates`` of the same batch on the same graph, synchronized,
    result dropped), then the update itself with the card's launch
    counts, captures and peak memory reset just before and read just
    after, and its syncing calls.  Returns ``(report, row)``; ``entry``
    accumulates the launches by entry (host or static)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import graph_loop
    from repro_torch.core import streaming as ts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tmp = ts.apply_updates(st.g, batch)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    del tmp
    kernels.device_launch_counts(reset=True)
    caps, cap_s = graph_loop.captures, graph_loop.capture_seconds
    torch.cuda.reset_peak_memory_stats()
    rep = []
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: rep.append(ts.stream_update(st, batch)))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches = kernels.device_launch_counts(reset=True)
    for k, n in launches.items():
        entry[k] = entry.get(k, 0) + n
    rep = rep[0]
    return rep, {
        "apply_s": apply_s, "update_s": update_s,
        "repair_s": max(update_s - apply_s, 0.0), "rounds": rep.rounds,
        "full_recompute": rep.full_recompute, "seeds": rep.seeds,
        "captures": graph_loop.captures - caps,
        "capture_s": graph_loop.capture_seconds - cap_s,
        "launches": {k: launches[k] for k in ("twc_bin_relax",
                                              "edge_lb_relax")},
        "syncs": len(syncs),
        "sync_sites": {x: syncs.count(x) for x in sorted(set(syncs))},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def stream_path(g, sym, src) -> dict:
    """Phase 3e: the streaming layer on phase 3's graph.  ``g`` and its
    symmetrized form (for cc) made streaming (``streaming_graph``), then
    sssp and bfs from the hub and cc kept across two traces of
    STREAM_BATCHES batches (:func:`stream_traces`) by ``stream_update``
    with the ALB kernel pair, in host and fused mode (sssp also spmd).
    After every batch the labels are held bitwise against a from-scratch
    host-mode run on the mutated graph, whose rounds a fallback must
    report; after the mixed trace, sssp's CSR against
    :func:`numpy_rebuild` and its labels against scipy.  Per batch: apply
    and repair seconds, rounds, fallback, seeds, captures, the fused
    kernels' launches on the card, syncing calls, peak device memory.
    Held per series: no capture in host mode and as many per batch after
    the first in spmd / fused mode, the last batch's peak within 10% of
    the first's, and no program replayed on a superseded version."""
    import torch
    from repro_torch.core import graph_loop
    from repro_torch.core import streaming as ts
    from repro_torch.core.balancer import BalancerConfig

    kern = BalancerConfig(strategy="alb", use_pallas=True)
    t0 = time.perf_counter()
    sg = ts.streaming_graph(g)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    ssym = ts.streaming_graph(sym)
    nv = ts.real_vertices(sg)
    print(f"phase 3e: streaming_graph on the card in {make_s:.2f} s: V "
          f"{sg.num_vertices} ({nv} real), Ecap {sg.num_edges}; "
          f"symmetrized Ecap {ssym.num_edges}", flush=True)
    t0 = time.perf_counter()
    traces = {"g": stream_traces(sg, 0, mirror=False),
              "sym": stream_traces(ssym, 0, mirror=True)}
    print(f"phase 3e: traces of {STREAM_BATCHES} x {STREAM_CAP} updates "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {"V": sg.num_vertices, "Ecap": sg.num_edges,
           "Ecap_sym": ssym.num_edges, "streaming_graph_s": make_s}
    # each series starts from a streaming graph of its own, which only
    # its state holds: every batch then holds the same graphs (the one
    # it starts from and the one it makes) beside the raw g and sym
    del sg, ssym
    graph_loop.set_runs(reset=True)
    entry = {"host": {}, "static": {}}
    series, seen = {}, []
    with program_versions(seen):
        for app, modes in STREAM_MODES.items():
            source = None if app == "cc" else src
            for trace in ("insert-only", "mixed"):
                batches = traces["sym" if app == "cc" else "g"][trace]
                for mode in modes:
                    name = f"{app}/{trace}/{mode}"
                    st = ts.stream_init(
                        ts.streaming_graph(sym if app == "cc" else g), app,
                        source=source, cfg=kern, mode=mode)
                    rows = []
                    for i, batch in enumerate(batches):
                        rep, row = stream_update_row(
                            st, batch, entry["host" if mode == "host"
                                             else "static"])
                        ref = ts._full_compute(st.g, app, source, kern,
                                               "host")
                        check(torch.equal(st.labels[:nv], ref.labels[:nv]),
                              f"{name} batch {i}: labels != from scratch")
                        check(not rep.full_recompute
                              or rep.rounds == ref.rounds,
                              f"{name} batch {i}: fallback rounds "
                              f"{rep.rounds} != {ref.rounds}")
                        check(rep.version == i + 1, f"{name}: version")
                        rows.append(row)
                    print(f"phase 3e: {name}: " + "; ".join(
                        f"b{i} apply {r['apply_s']:.3f} repair "
                        f"{r['repair_s']:.3f} s, {r['rounds']} rounds"
                        f"{' (full)' if r['full_recompute'] else ''}, "
                        f"{r['seeds']} seeds, {r['captures']} captures "
                        f"({r['capture_s']:.2f} s), launches "
                        f"{r['launches']['twc_bin_relax']}/"
                        f"{r['launches']['edge_lb_relax']}, {r['syncs']} "
                        f"syncs, peak {r['peak_gb']:.2f} GB"
                        for i, r in enumerate(rows)), flush=True)
                    print(f"phase 3e: {name}: syncing calls of the last "
                          f"batch by site: {rows[-1]['sync_sites']}",
                          flush=True)
                    caps = [r["captures"] for r in rows]
                    if mode == "host":
                        check(caps == [0] * len(caps),
                              f"{name}: host mode captured {caps}")
                    else:
                        check(caps[0] > 0 and caps[1:] == [caps[1]] * (
                            len(caps) - 1), f"{name}: captures {caps}")
                    peaks = [r["peak_gb"] for r in rows]
                    check(peaks[-1] <= 1.1 * peaks[0],
                          f"{name}: peak memory {peaks}")
                    if name == "sssp/mixed/host":
                        t1 = time.perf_counter()
                        want = numpy_rebuild(g, batches, out["V"],
                                             out["Ecap"])
                        got = [t.cpu().numpy() for t in
                               (st.g.row_ptr, st.g.col_idx, st.g.edge_w)]
                        check(all(np.array_equal(a, b)
                                  for a, b in zip(got, want)),
                              f"{name}: CSR != the numpy rebuild")
                        t2 = time.perf_counter()
                        ora = oracle(ts.unpadded(st.g), src, False)
                        check(np.array_equal(
                            st.real_labels.astype(np.int64), ora),
                            f"{name}: labels != scipy oracle")
                        print(f"phase 3e: {name}: CSR == numpy rebuild "
                              f"({t2 - t1:.1f} s); labels == scipy "
                              f"oracle ({time.perf_counter() - t2:.1f} s)",
                              flush=True)
                    del st
                    series[name] = rows
    check(seen and all(p == v for p, v in seen),
          "a program ran on a superseded graph version")
    launches = {k: entry["host"].get(k, 0) + entry["static"].get(k, 0)
                for k in ("twc_bin_relax", "edge_lb_relax")}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched by phase 3e")
    decisions = graph_loop.set_runs(reset=True)
    print(f"phase 3e: fused kernels launched on the card by the updates "
          f"(host / static entry): {entry}; {len(seen)} program replays, "
          f"each on the version it was captured for; {decisions} "
          f"condition decisions", flush=True)
    out.update({"series": series, "launches": launches,
                "launches_by_entry": entry, "program_runs": len(seen),
                "condition_decisions": decisions})
    return out, traces["g"]["mixed"][:2]


# ---------------------------------------------------------------------------
# phase 3f: the query service and the fleet
# ---------------------------------------------------------------------------

SERVE_SLOTS = 8
SERVE_CACHE = 32
SERVE_QUERIES = 64            # 48 sssp, 16 bfs, a quarter of them repeats
FLEET_QUERIES = 32


def serve_traffic(g, seed: int) -> list:
    """Phase 3f's ``(app, source)`` queries: 48 distinct pairs (36 sssp,
    12 bfs) over vertices of nonzero out-degree, then 16 repeats of
    earlier pairs (12 sssp, 4 bfs), each placed after its original,
    from ``numpy.random.default_rng(seed)``."""
    from repro_torch.core import streaming as ts
    rng = np.random.default_rng(seed)
    deg = np.diff(g.row_ptr.cpu().numpy())[:ts.real_vertices(g)]
    srcs = rng.choice(np.flatnonzero(deg > 0), 48, replace=False)
    apps = ["sssp"] * 36 + ["bfs"] * 12
    qs = [(apps[i], int(srcs[i])) for i in rng.permutation(48)]
    for app, n in (("sssp", 12), ("bfs", 4)):
        pool = [q for q in qs if q[0] == app]
        for j in rng.choice(len(pool), n, replace=False):
            first = qs.index(pool[j])
            qs.insert(int(rng.integers(first + 1, len(qs) + 1)), pool[j])
    return qs


def serve_scenario(svc, sg, traffic, batches) -> list:
    """Submit the traffic in three waves with two update batches between
    them, applied while queries run; returns the qids."""
    svc.register_graph("g", sg)
    qids, waves = [], (0, 24, 44, len(traffic))
    for w in range(3):
        for app, s in traffic[waves[w]:waves[w + 1]]:
            qids.append(svc.submit("g", app, s))
        if w < 2:
            for _ in range(3):
                svc.step()
            svc.apply_updates("g", batches[w])
    svc.run()
    return qids


def serve_path(g, batches, built: int) -> dict:
    """Phase 3f: a ``QueryService`` (SERVE_SLOTS slots, a SERVE_CACHE
    entry cache, the ALB kernel pair) on phase 3e's streaming graph in
    host, spmd and fused mode (``fused_rounds=8``), serving
    :func:`serve_traffic` with two mixed update batches applied while
    queries are in flight (a stale bank drains on its snapshot); then a
    ``Fleet`` of two replicas on the card, one throttled so hedges fire.
    ``g`` is phase 3's graph, made streaming here.
    Every served result is held bitwise against a standalone run on the
    graph version its query ran on (a reference chain of the same
    batches; each service's versions are held equal to it);
    ``host_transfers`` as the JAX engine counts them (two a step in host
    mode: the round's and the liveness fetch; one otherwise); the
    fleet's routing trace replays exactly.  Launches are counted on the
    card around each service and fleet run; no program runs on a
    superseded version; nothing is built after phase 1."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import graph_loop
    from repro_torch.core import streaming as ts
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.kernels import build
    from repro_torch.serve import QueryService, DONE
    from repro_torch.serve.fleet import (Fleet, RouterConfig, replay,
                                         ceiling_violations)

    kern = BalancerConfig(strategy="alb", use_pallas=True)
    sg = ts.streaming_graph(g)
    traffic = serve_traffic(sg, 1)
    chain = [sg]
    for b in batches:
        chain.append(ts.apply_updates(chain[-1], b))
    refs = {}

    def ref(app, s, version):
        if (app, s, version) not in refs:
            fn = drivers.sssp if app == "sssp" else drivers.bfs
            refs[app, s, version] = fn(chain[version], s,
                                       kern).labels.cpu().numpy()
        return refs[app, s, version]

    def held(svc, qids, what):
        made = {}                    # id of a computed result -> version
        for q in map(svc.poll, qids):
            if q.slot is None and q.status == DONE and not q.from_cache:
                made[id(q.result)] = q.version
        for q in map(svc.poll, qids):
            check(q.status == DONE, f"{what}: query {q.qid} {q.status}")
            v = q.version
            if q.from_cache and q.rounds_in_system > 0:   # a follower
                v = made[id(q.result)]
            check(np.array_equal(q.result, ref(q.app, q.source, v)),
                  f"{what}: query {q.qid} ({q.app} from {q.source}, "
                  f"version {v}) != standalone run")

    entry = {"host": {}, "static": {}}
    seen, out = [], {"modes": {}}
    with program_versions(seen):
        for mode in ("host", "spmd", "fused"):
            svc = QueryService(num_slots=SERVE_SLOTS, cfg=kern, mode=mode,
                               cache_capacity=SERVE_CACHE, fused_rounds=8)
            kernels.device_launch_counts(reset=True)
            caps = graph_loop.captures
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            box = []
            syncs = count_syncs(lambda: box.append(
                serve_scenario(svc, sg, traffic, batches)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            qids = box[0]
            launches = kernels.device_launch_counts(reset=True)
            side = entry["host" if mode == "host" else "static"]
            for k, n in launches.items():
                side[k] = side.get(k, 0) + n
            captures = graph_loop.captures - caps
            g_now = svc._graphs["g"]
            check(g_now.version == 2 and all(
                torch.equal(a, b) for a, b in zip(
                    (g_now.row_ptr, g_now.col_idx, g_now.edge_w),
                    (chain[2].row_ptr, chain[2].col_idx, chain[2].edge_w))),
                f"{mode}: the service's graph != the reference chain's")
            held(svc, qids, f"service/{mode}")
            st = svc.stats
            per_step = 2 if mode == "host" else 1
            check(st.host_transfers == per_step * st.steps,
                  f"{mode}: host_transfers {st.host_transfers} != "
                  f"{per_step} x {st.steps} steps")
            check(captures == 0 if mode == "host" else captures > 0,
                  f"{mode}: {captures} captures")
            served = st.queries_served
            row = {"wall_s": wall, "queries_per_s": served / wall,
                   "queries": served, "steps": st.steps,
                   "p50_rounds": st.latency_percentile(50),
                   "p95_rounds": st.latency_percentile(95),
                   "cache_hits": st.cache_hits,
                   "host_transfers": st.host_transfers,
                   "syncs": len(syncs),
                   "syncs_per_step": len(syncs) / st.steps,
                   "sync_sites": {x: syncs.count(x)
                                  for x in sorted(set(syncs))},
                   "captures": captures, "launches": launches,
                   "occupancy": st.occupancy}
            out["modes"][mode] = row
            del svc
            print(f"phase 3f: service/{mode}: {served} queries in "
                  f"{wall:.2f} s ({row['queries_per_s']:.1f} / s), "
                  f"{st.steps} steps, rounds-in-system p50 "
                  f"{row['p50_rounds']:.2f} p95 {row['p95_rounds']:.2f}, "
                  f"{st.cache_hits} cache hits, host_transfers "
                  f"{st.host_transfers}, {len(syncs)} syncing calls "
                  f"({row['syncs_per_step']:.2f} a step) at "
                  f"{row['sync_sites']}, {captures} captures, launches "
                  f"{launches}", flush=True)
        # device busy share: torch.profiler for host and spmd (a second
        # run of the scenario); a fused step is one graph launch, which
        # the profiler sees only in part, so its busy time is the CUDA
        # event span of each chunk's launch
        for mode in ("host", "spmd"):
            svc = QueryService(num_slots=SERVE_SLOTS, cfg=kern, mode=mode,
                               cache_capacity=SERVE_CACHE)
            prof = profile_path(
                {f"service/{mode}": lambda: serve_scenario(
                    svc, sg, traffic, batches)},
                {f"service/{mode}": out["modes"][mode]["wall_s"]},
                label="phase 3f")
            out["modes"][mode]["busy_share"] = prof[
                f"service/{mode}"]["busy_share"]
            out["modes"][mode]["device_ms"] = prof[
                f"service/{mode}"]["device_ms"]
        from repro_torch.serve import engine
        spans, real_fused = [], engine.run_fused

        def timed_fused(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = real_fused(*a, **k)
            e.record()
            spans.append((s, e))
            return res

        engine.run_fused = timed_fused
        try:
            svc = QueryService(num_slots=SERVE_SLOTS, cfg=kern,
                               mode="fused", cache_capacity=SERVE_CACHE,
                               fused_rounds=8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve_scenario(svc, sg, traffic, batches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine.run_fused = real_fused
        busy_ms = sum(s.elapsed_time(e) for s, e in spans)
        out["modes"]["fused"].update(
            {"busy_share": busy_ms / (wall * 1e3), "device_ms": busy_ms,
             "busy_wall_s": wall})
        print(f"phase 3f: service/fused: {len(spans)} chunk launches, "
              f"{busy_ms:.2f} ms of device time by CUDA events over a "
              f"{wall * 1e3:.2f} ms wall "
              f"({out['modes']['fused']['busy_share']:.1%})", flush=True)

        # ---- the fleet: two replicas on the card, one a straggler ----
        fleet = Fleet(num_replicas=2, cfg=kern, num_slots=SERVE_SLOTS,
                      cache_capacity=SERVE_CACHE, seed=0,
                      devices=[sg.device],
                      router=RouterConfig(hedge_after=8))
        fleet.replicas[1].throttle = 2
        fleet.register_graph("g", chain[2])
        kernels.device_launch_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fqids = [fleet.submit("g", app, s)
                 for app, s in traffic[:FLEET_QUERIES]]
        summary = fleet.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.device_launch_counts(reset=True)
        for k, n in launches.items():
            entry["host"][k] = entry["host"].get(k, 0) + n
        for f in fqids:
            rec = fleet.poll(f)
            check(rec.status == DONE and np.array_equal(
                rec.result, ref(rec.app, rec.source, 2)),
                f"fleet query {f} != standalone run")
        check(replay(fleet.trace.rows) == [], "fleet trace diverged")
        check(ceiling_violations(fleet.trace.rows) == [],
              "fleet broke its load ceiling")
        check(summary["hedges_launched"] > 0, "no hedge fired")
        out["fleet"] = {k: v for k, v in summary.items()}
        out["fleet"].update({"wall_s": wall, "trace_rows": len(
            fleet.trace), "launches": launches})
        del fleet
        print(f"phase 3f: fleet of 2 replicas (replica 1 throttled 2x): "
              f"{FLEET_QUERIES} queries in {wall:.2f} s, bitwise equal to "
              f"standalone runs; {summary['hedges_launched']} hedges "
              f"launched, "
              f"{summary['hedges_cancelled']} cancelled; the trace of "
              f"{out['fleet']['trace_rows']} decisions replays exactly",
              flush=True)
    check(seen and all(p == v for p, v in seen),
          "a program ran on a superseded graph version")
    launches = {k: entry["host"].get(k, 0) + entry["static"].get(k, 0)
                for k in ("twc_bin_relax", "edge_lb_relax")}
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched by phase 3f")
    check(len(build.BUILD_LOG) == built, "a kernel was built after phase 1")
    out.update({"launches": launches, "launches_by_entry": entry,
                "standalone_refs": len(refs), "program_runs": len(seen),
                "condition_decisions": graph_loop.set_runs(reset=True)})
    print(f"phase 3f: fused kernels launched on the card (host / static "
          f"entry): {entry}; {len(refs)} standalone references; nothing "
          f"built after phase 1", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 4: timing at the main path's shapes
# ---------------------------------------------------------------------------

RELAX_KERNELS = ("twc_bin_relax", "edge_lb_relax")


def capture_launches(run) -> dict:
    """The arguments of every kernel launch of ``run()``, recorded by
    swapping the kernel modules the executor entries call through for
    recorders that forward to the real wrappers.  A fused relax call's
    labels are recorded as a copy of what the call found (the kernel
    combines into them)."""
    import types
    from repro_torch.kernels import ops
    calls = {"twc_bin_relax": [], "edge_lb_relax": [], "merge_path_map": []}

    def recorder(name, fn):
        def rec(*a, **k):
            kept = (a[0], a[1].clone()) + a[2:] if name in RELAX_KERNELS \
                else a
            calls[name].append((kept, k))
            return fn(*a, **k)
        return rec

    real = ops._relax, ops._merge_path
    ops._relax = types.SimpleNamespace(takes=real[0].takes, **{
        n: recorder(n, getattr(real[0], n)) for n in RELAX_KERNELS})
    ops._merge_path = types.SimpleNamespace(
        merge_path_map=recorder("merge_path_map", real[1].merge_path_map))
    try:
        run()
    finally:
        ops._relax, ops._merge_path = real
    return calls


def twc_unfused(values, labels, fmask, col_idx, edge_w, vidx, deg,
                row_start, op, *, width, chunk, passes=1):
    """The route ``twc_bin_relax`` replaced, as ``ops.twc_bin_apply`` ran
    it before the fused kernels (a yardstick the port never calls): per
    pass, the batch-0 value gather, the ``twc_bin_map`` kernel, then the
    torch epilogue into fresh labels."""
    import torch
    from repro_torch.kernels import ref, twc_gather
    v = labels.shape[-1]
    for c in range(chunk, chunk + passes):
        val = values[0, torch.where(vidx < v, vidx, 0)]
        ge, anchor, _, mask = twc_gather.twc_bin_map(
            vidx, deg, row_start, val, width=width, chunk=c, sentinel=v)
        labels = ref.slot_epilogue(col_idx, edge_w, values, labels, fmask,
                                   anchor.reshape(-1), ge.reshape(-1),
                                   mask.reshape(-1), op)
    return labels


def host_ints(k: dict) -> dict:
    """A recorded call's keyword arguments with its device scalars (a
    static entry's ``chunk`` / ``passes``) read as host ints: for the
    plain and unfused routes, which would read them inside the timed
    region otherwise."""
    import torch
    return {n: int(x) if isinstance(x, torch.Tensor) else x
            for n, x in k.items()}


def lb_unfused(values, labels, fmask, col_idx, edge_w, hvidx, start_e,
               row_start, total, n_enum, op, **kw):
    """The route ``edge_lb_relax`` replaced, as ``ops.edge_lb_apply`` ran
    it before the fused kernels (a yardstick the port never calls): the
    batch-0 ``hval`` gather, the ``edge_lb_map`` kernel, then the torch
    epilogue into fresh labels."""
    import torch
    from repro_torch.kernels import edge_lb, ref
    v = labels.shape[-1]
    hval = values[0, torch.where(hvidx < v, hvidx, 0)]
    ge, j, _, mask = edge_lb.edge_lb_map(start_e, row_start, hval, total,
                                         n_enum, **kw)
    src = hvidx[j.clamp(0, hvidx.shape[0] - 1)]
    return ref.slot_epilogue(col_idx, edge_w, values, labels, fmask, src,
                             ge, mask, op)


def map_args(name, a, k) -> tuple:
    """The index-map kernel's call at a fused call's shapes."""
    if name == "twc_bin_relax":
        vidx, deg, row_start = a[5:8]
        return ((vidx, deg, row_start, vidx),
                {"width": k["width"], "chunk": k["chunk"],
                 "sentinel": a[1].shape[-1]})
    start_e, row_start, total, n_enum = a[6:10]
    return (start_e, row_start, start_e, total, n_enum), dict(k)


def relax_work(name, a, k) -> tuple:
    """(bytes, operations) one fused pass must do on these inputs, each
    byte once.  Reads: of a bin row, vidx alone for a sentinel row,
    vidx and deg for a row with no edge in this chunk, all three int32
    inputs otherwise (a huge-bin slot: all three); col_idx of the live
    edges, and edge_w for v + w; one fmask byte per query at each
    distinct gather vertex; the value at each distinct live (query,
    gather vertex); the label at each distinct live (query, target).
    Writes: a label only where the pass changes it (the plain version's
    output differs from its input).  So at most the whole [B, V]
    arrays.  Operations: ~8 integer operations per live (edge, query),
    plus 4 per step of each huge-bin id's slot search."""
    import torch
    from repro_torch.core.operators import msg_kind
    from repro_torch.kernels import ref
    values, labels, fmask, col_idx = a[:4]
    b, v = labels.shape
    if name == "twc_bin_relax":
        op, vidx, deg = a[8], a[5], a[6]
        k = host_ints(k)
        first, width = k.get("chunk", 0), k["width"]
        ge, src = [vidx[:0]], [vidx[:0]]      # live slots, pass by pass
        for c in range(first, first + k.get("passes", 1)):
            rows = (vidx < v) & (deg > c * width)    # rows with an edge
            m = ref.twc_bin_map_ref(vidx[rows], deg[rows], a[7][rows],
                                    vidx[rows], width=width, chunk=c,
                                    sentinel=v)
            ge.append(m[0][m[3]])
            src.append(m[1][m[3]])
        ge, src = torch.cat(ge), torch.cat(src)
        mask = torch.ones_like(ge, dtype=torch.bool)
        want = ref.twc_bin_relax_ref(values, labels.clone(), *a[2:], **k)
        real = vidx < v
        edged = real & (deg > first * width)
        fixed = 4 * vidx.shape[0] + 4 * int(real.sum()) + \
            4 * int(edged.sum())
        search = 0
    else:
        op, hvidx = a[10], a[5]
        ge, j, _, mask = ref.edge_lb_map_ref(*map_args(name, a, k)[0], **k)
        want = ref.edge_lb_relax_ref(values, labels.clone(), *a[2:], **k)
        src = hvidx[j]
        fixed = 12 * hvidx.shape[0]
        search = int(mask.sum()) * 4 * hvidx.shape[0].bit_length()
    ge, src = ge[mask].long(), src[mask].long()
    dst = col_idx[ge].long()
    gather, scatter = (src, dst) if op.direction == "push" else (dst, src)
    q = torch.arange(b, device=ge.device)[:, None] * v
    live = fmask[:, gather]                                  # [B, n_e]
    nbytes = (fixed + 4 * ge.numel() * (2 if msg_kind(op) == 0 else 1)
              + b * torch.unique(gather).numel()
              + 4 * torch.unique((q + gather)[live]).numel()
              + 4 * torch.unique((q + scatter)[live]).numel()
              + 4 * int((want != labels).sum()))
    return nbytes, 8 * int(live.sum()) + search


def device_ms(fn, calls, reps: int = 3,
              sleep_cycles: int = 2_000_000) -> float:
    """Mean device time per call over ``calls`` (CUDA events).  The
    stream is held busy (``sleep_cycles``: longer for a chain of many
    small ops) while the host enqueues each group of ``reps`` calls, so
    host overhead between launches is not counted."""
    import torch
    for a, k in calls:                   # warm-up
        fn(*a, **k)
    pairs = []
    for a, k in calls:
        torch.cuda._sleep(sleep_cycles)
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


def device_ms_fresh(fn, calls, reps: int = 3) -> float:
    """Mean device time per call of ``fn``, which combines into the
    labels it is given (its second argument): every launch starts from a
    fresh copy of the recorded labels, made on the stream before its
    start event.  CUDA events around each launch; the stream is held
    busy while the host enqueues, so host overhead is not counted."""
    import torch
    work = [a[1].clone() for a, _ in calls]
    for (a, k), lab in zip(calls, work):          # warm-up
        fn(a[0], lab, *a[2:], **k)
    pairs = []
    for (a, k), lab in zip(calls, work):
        torch.cuda._sleep(2_000_000)
        for _ in range(reps):
            lab.copy_(a[1])
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(a[0], lab, *a[2:], **k)
            e.record()
            pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def bound(work, calls) -> tuple:
    """(bound ms, "bytes" | "operations", mean bytes) of the mean call."""
    done = [work(a, k) for a, k in calls]
    b = sum(w[0] for w in done) / len(calls)
    o = sum(w[1] for w in done) / len(calls)
    t_b, t_o = b / HBM_BYTES_PER_S * 1e3, o / SCALAR_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations", b


def members_only(a, k) -> tuple:
    """A static round's ``twc_bin_relax`` call (one with ``rows``)
    reduced to its member rows, for the plain version, the unfused route
    and the work count: it spans V rows, mostly empty, and those two
    would build ``[V, W]`` tiles (16 GB at rmat 22 and W = 1024) for
    rows that add nothing.  Returns the call with host-int keywords, and the bytes the
    kernel must still read for the empty rows below ``rows`` (their
    4-byte vidx)."""
    k = host_ints(k)
    rows = k.pop("rows", None)
    if rows is None:                   # a host round's call: as it is
        return a, k, 0
    vidx = a[5]
    n = min(rows, vidx.shape[0])
    keep = (vidx[:n] < a[1].shape[-1]).nonzero().flatten()
    sub = tuple(t[keep].contiguous() for t in a[5:8])
    return a[:5] + sub + a[8:], k, 4 * (n - keep.numel())


def time_relax(name, cs) -> dict:
    """One fused kernel over the recorded calls ``cs``: held against its
    plain version (exact for int labels, ``RELAX_FLOAT_RTOL`` for
    float), then timed beside its plain version, the unfused route it
    replaced and its bound.  A ``twc_bin_relax`` call's plain version,
    unfused route and work take its member rows (``members_only``)."""
    from repro_torch.kernels import ref, relax
    fn = getattr(relax, name)
    plain = {"twc_bin_relax": ref.twc_bin_relax_ref,
             "edge_lb_relax": ref.edge_lb_relax_ref}[name]
    unfused = {"twc_bin_relax": twc_unfused,
               "edge_lb_relax": lb_unfused}[name]
    reduced = [members_only(a, k) if name == "twc_bin_relax"
               else (a, host_ints(k), 0) for a, k in cs]
    host_cs = [(a, k) for a, k, _ in reduced]
    abs_err, rel_err = 0.0, 0.0
    for (a, k), (ha, hk) in zip(cs, host_cs):
        got = fn(a[0], a[1].clone(), *a[2:], **k)
        want = plain(ha[0], ha[1].clone(), *ha[2:], **hk)
        abs_err = max(abs_err, float((got.double() - want.double())
                                     .abs().max()))
        if got.dtype.is_floating_point:
            rel_err = max(rel_err, relax_err(got, want))
    check((abs_err == 0 or cs[0][0][1].dtype.is_floating_point) and
          rel_err <= RELAX_FLOAT_RTOL,
          f"{name} != plain on main-path inputs: {abs_err}, {rel_err}")
    extra = iter([e for _, _, e in reduced])
    bms, by, nbytes = bound(
        lambda a, k: tuple(x + y for x, y in zip(relax_work(name, a, k),
                                                 (next(extra), 0))),
        host_cs)
    return {"ms": device_ms_fresh(fn, cs),
            "plain_ms": device_ms_fresh(plain, host_cs),
            "unfused_ms": device_ms_fresh(unfused, host_cs),
            "bound_ms": bms, "bound_by": by, "max_abs_err": abs_err,
            "max_rel_err": rel_err, "timed_launches": len(cs),
            "mean_bytes": nbytes}


def tile_walk_ms(cs) -> float:
    """The host round's ``twc_bin_relax`` calls ``cs`` through the static
    round's row schedule (a resident grid walking tiles of 256 rows,
    given a device row bound of all N rows) instead of the one group per
    compacted row that the host round launches: held equal to them
    (int exact, float add within ``RELAX_FLOAT_RTOL``) and timed, so
    that the two schedules can be compared on the same rows."""
    import torch
    from repro_torch.kernels import relax
    walk = [(a, {**k, "rows": torch.tensor([a[5].shape[0]],
                                           dtype=torch.int32,
                                           device=a[5].device)})
            for a, k in cs]
    for (a, k), (_, wk) in zip(cs, walk):
        want = relax.twc_bin_relax(a[0], a[1].clone(), *a[2:], **k)
        got = relax.twc_bin_relax(a[0], a[1].clone(), *a[2:], **wk)
        if got.dtype.is_floating_point:
            check(relax_err(got, want) <= RELAX_FLOAT_RTOL,
                  "twc_bin_relax: the tile walk != one group per row")
        else:
            check(torch.equal(got, want),
                  "twc_bin_relax: the tile walk != one group per row")
    return device_ms_fresh(relax.twc_bin_relax, walk)


def time_kernels(g, src, sources, errs: dict, launches: dict) -> list:
    """Phase 4's rows of the graph kernels.  The fused kernels at the
    shapes of one ALB sssp (their row), of one sssp_batch (B = 8) and of
    two pagerank rounds (``by_run``; ``twc_bin_relax`` also through the
    static round's row schedule, :func:`tile_walk_ms`); the index-map
    kernels at the same sssp's shapes (no main path launches them);
    ``merge_path_map`` at one merge-path sssp's."""
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.kernels import edge_lb, merge_path, ref, twc_gather
    kern = BalancerConfig(strategy="alb", use_pallas=True)
    calls = {"sssp": capture_launches(lambda: drivers.sssp(g, src, kern)),
             "sssp_batch": capture_launches(
                 lambda: drivers.sssp_batch(g, sources, kern)),
             "pagerank": capture_launches(lambda: drivers.pagerank(
                 g, cfg=kern, max_rounds=2, tol=0.0))}
    mp_calls = capture_launches(lambda: drivers.sssp(
        g, src, BalancerConfig(strategy="alb", backend="merge_path")))
    rows = []
    for name, source, replaces in (
            ("twc_bin_relax", "src/repro_torch/kernels/csrc/twc_relax.cu",
             "src/repro/kernels/twc_gather.py:54"),
            ("edge_lb_relax",
             "src/repro_torch/kernels/csrc/edge_lb_relax.cu",
             "src/repro/kernels/edge_lb.py:105")):
        by_run = {}
        for run, cs in calls.items():
            check(len(cs[name]) > 0, f"{name}: no launch captured ({run})")
            by_run[run] = time_relax(name, cs[name])
            if name == "twc_bin_relax":
                by_run[run]["tile_walk_ms"] = tile_walk_ms(cs[name])
        top = by_run["sssp"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in by_run.values()),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
            "library_ms": None, "unfused_ms": top["unfused_ms"],
            "timed_launches": top["timed_launches"],
            "mean_bytes": top["mean_bytes"], "by_run": by_run})
    table = [("twc_bin_map", twc_gather.twc_bin_map, ref.twc_bin_map_ref,
              twc_work, "src/repro_torch/kernels/csrc/twc_gather.cu",
              "src/repro/kernels/twc_gather.py:54",
              [map_args("twc_bin_relax", a, k)
               for a, k in calls["sssp"]["twc_bin_relax"]]),
             ("edge_lb_map", edge_lb.edge_lb_map, ref.edge_lb_map_ref,
              lb_work, "src/repro_torch/kernels/csrc/edge_lb.cu",
              "src/repro/kernels/edge_lb.py:105",
              [map_args("edge_lb_relax", a, k)
               for a, k in calls["sssp"]["edge_lb_relax"]]),
             ("merge_path_map", merge_path.merge_path_map,
              ref.merge_path_map_ref, mp_work,
              "src/repro_torch/kernels/csrc/merge_path.cu",
              "src/repro/kernels/merge_path.py:107",
              mp_calls["merge_path_map"])]
    for name, fn, plain, work, source, replaces, cs in table:
        check(len(cs) > 0, f"{name}: no launch captured")
        # the kernel against its plain version on the main path's inputs
        for a, k in cs:
            errs[name] = max(errs[name], masked_err(fn(*a, **k),
                                                    plain(*a, **k)))
        check(errs[name] == 0, f"{name} != plain on main-path inputs")
        bms, by, nbytes = bound(work, cs)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": device_ms(fn, cs), "plain_ms": device_ms(plain, cs),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "timed_launches": len(cs), "mean_bytes": nbytes})
    return rows


def static_calls(g, src, cfg) -> dict:
    """The kernel launches of one static-shape sssp, run eagerly round by
    round on the card and recorded with their inputs
    (:func:`capture_launches`): ``balancer._relax_spmd_impl`` in push
    direction through a kernel pair has no branch or loop of its own,
    so it needs no capture; its entries get the device pass count and
    total as the captured round gives them.  The loop reads each
    frontier on the host: a measurement harness, not the port's path."""
    import torch
    from repro_torch.core import balancer
    from repro_torch.core.graph import INF
    from repro_torch.core.operators import SSSP_RELAX

    def run():
        lab = torch.full((1, g.num_vertices), int(INF), dtype=torch.int32,
                         device=g.device)
        lab[0, src] = 0
        fr = lab == 0
        while bool(fr.any()):
            new = balancer._relax_spmd_impl(g, lab, lab, fr, cfg,
                                            SSSP_RELAX)
            fr, lab = new < lab, new
    return capture_launches(run)


def time_static_kernels(g, src, launches: dict, captured: dict) -> list:
    """Phase 4's rows of the static entries, at the shapes of one static
    ALB sssp (``twc_bin_relax`` over V rows, ``edge_lb_relax`` over an
    E-id span with the device total), one static twc sssp (its unbounded
    bin: the device pass count) and one static merge-path sssp
    (``merge_path_map`` over E ids with the device total), each held
    against its plain version and timed beside it, the unfused route and
    its bound.  ``launches``: phase 3d's counts on the card;
    ``captured``: the launches its captures recorded."""
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.kernels import merge_path, ref
    alb = static_calls(g, src, BalancerConfig(strategy="alb",
                                              use_pallas=True))
    twc = static_calls(g, src, BalancerConfig(strategy="twc",
                                              use_pallas=True))
    mp = static_calls(g, src, BalancerConfig(strategy="alb",
                                             backend="merge_path"))
    unbounded = [(a, k) for a, k in twc["twc_bin_relax"]
                 if "passes" in k and hasattr(k["passes"], "device")]
    check(len(unbounded) > 0, "twc: no launch with a device pass count")
    rows = []
    for name, source, replaces, by_run in (
            ("twc_bin_relax", "src/repro_torch/kernels/csrc/twc_relax.cu",
             "src/repro/kernels/twc_gather.py:54",
             {"alb": alb["twc_bin_relax"], "twc_unbounded": unbounded}),
            ("edge_lb_relax",
             "src/repro_torch/kernels/csrc/edge_lb_relax.cu",
             "src/repro/kernels/edge_lb.py:105",
             {"alb": alb["edge_lb_relax"]})):
        timed_runs = {}
        for run, cs in by_run.items():
            check(len(cs) > 0, f"{name} (static): no launch ({run})")
            timed_runs[run] = time_relax(name, cs)
        top = timed_runs["alb"]
        rows.append({
            "name": f"{name} (static entry)", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": launches[name], "captured": captured[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in timed_runs.values()),
            **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
            "library_ms": None, "unfused_ms": top["unfused_ms"],
            "timed_launches": top["timed_launches"],
            "mean_bytes": top["mean_bytes"], "by_run": timed_runs})
    cs = mp["merge_path_map"]
    check(len(cs) > 0, "merge_path_map (static): no launch")
    err = 0
    for a, k in cs:
        err = max(err, masked_err(merge_path.merge_path_map(*a, **k),
                                  ref.merge_path_map_ref(*a, **k)))
    check(err == 0, "merge_path_map (static) != plain on phase 3d inputs")
    bms, by, nbytes = bound(mp_work, cs)
    host_cs = [(a[:2] + (int(a[2]),) + a[3:], k) for a, k in cs]
    rows.append({
        "name": "merge_path_map (static entry)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/merge_path.cu",
        "replaces": "src/repro/kernels/merge_path.py:107",
        "launches": launches["merge_path_map"],
        "captured": captured["merge_path_map"], "max_abs_err": err,
        "ms": device_ms(merge_path.merge_path_map, cs),
        "plain_ms": device_ms(ref.merge_path_map_ref, host_cs),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "timed_launches": len(cs), "mean_bytes": nbytes})
    return rows


def time_graph_loop(dev, decisions: int) -> dict:
    """The condition kernel of ``csrc/graph_loop.cu`` (no TPU
    counterpart): per decision, the time of a captured WHILE loop of
    1,000 turns whose body adds one to a device counter, against the
    same loop driven from the host (one ``.item()`` read a turn, its
    plain version).  Bound: one byte read and one word written a turn.
    ``decisions``: phase 3d's count of the kernel's runs on the card."""
    import torch
    from repro_torch.core import graph_loop

    class Owner:
        version = 0

    turns = 1000

    def loop(n):
        return graph_loop.while_(lambda i: i < n, lambda i: (i + 1,),
                                 (torch.zeros_like(n),))[0]

    n = torch.tensor(turns, dtype=torch.int32, device=dev)
    owner = Owner()
    check(int(graph_loop.run(owner, "loop", loop, n)) == turns,
          "graph_loop: the WHILE node did not turn 1,000 times")
    graph_loop.set_runs(reset=True)
    ms = device_ms(lambda: graph_loop.run(owner, "loop", loop, n),
                   [((), {})]) / (turns + 1)
    check(graph_loop.set_runs(reset=True) >= turns, "set_cond runs")

    def plain():
        i = torch.zeros((), dtype=torch.int32, device=dev)
        while i.item() < turns:
            i = i + 1
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / turns
    bms = 5 / HBM_BYTES_PER_S * 1e3
    return {"name": "graph_loop set_cond (port-only helper)",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/graph_loop.cu",
            "replaces": "none: no TPU kernel (the control flow XLA "
                        "compiles for lax.while_loop / lax.cond, "
                        "src/repro/core/balancer.py:1022, :1051, :1119, "
                        ":1181)",
            "launches": decisions, "max_abs_err": 0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": "bytes",
            "library_ms": None, "timed_launches": turns + 1}


def profile_path(runs: dict, wall_s: dict, label: str = "phase 4") -> dict:
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
        plan = [v for n, v in by_name.items() if "moe_plan" in n]
        out[name] = {
            "profiled_wall_ms": wall_us / 1e3,
            "unprofiled_wall_ms": plain_wall_us / 1e3,
            "device_ms": busy_us / 1e3,
            "busy_share": busy_us / plain_wall_us if busy_us else None,
            "launches": sum(v[1] for v in by_name.values()),
            "moe_plan_ms": sum(v[0] for v in plan) / 1e3,
            "moe_plan_launches": sum(v[1] for v in plan),
            "top": [[n, round(t / 1e3, 4), c] for n, (t, c) in top]}
        print(f"{label}: profiled {name}: device busy "
              f"{busy_us / 1e3:.2f} ms of the unprofiled median wall "
              f"{plain_wall_us / 1e3:.2f} ms "
              + (f"({busy_us / plain_wall_us:.1%})" if busy_us else
                 "(profiler saw no device time: not measured)")
              + f"; profiled wall {wall_us / 1e3:.2f} ms; "
              f"{out[name]['launches']} kernel launches", flush=True)
        for n, t, c in out[name]["top"]:
            print(f"{label}:   {t:9.3f} ms {c:5d}x {n}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: the LM serving path (deepseek-moe-16b, ALB-adaptive MoE)
# ---------------------------------------------------------------------------

LM_ARCH = "deepseek-moe-16b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 32
# The kernel route (flash attention, kernel dispatch) against the plain
# route (plain attention, one-hot dispatch).  With random weights the
# 28-layer model is chaotic: attention outputs one bf16 rounding apart
# flip near-tie expert choices, and by layer 28 the logits decorrelate
# (PERF.md).  So each kernel is held where its difference does not
# compound: dispatch alone over all 28 layers (bitwise), each layer's
# attention sublayer on the same input (LM_ATTN_RTOL), and the whole
# model at depth 1 (LM_LOGITS_RTOL, first tokens equal); the divergence
# at depths 2..28 is printed.
LM_ATTN_RTOL = 1 / 32           # of the largest |attention output|
LM_LOGITS_RTOL = 0.05           # of the largest |logit|
LM_DEPTHS = (1, 2, 4, 8, 16, 28)
# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12


def timed(fn):
    """(fn(), seconds) on the host clock, between device synchronizes."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve(model, cfg, prompts, gen: int, **kw) -> dict:
    """Prefill ``prompts`` into an empty cache, then ``gen - 1`` greedy
    decode steps: ``gen`` tokens per request.  Host clock around work
    that ends in a device synchronize; the tokens stay on the card until
    the end."""
    import torch
    from repro_torch.models import transformer as T
    b, p = prompts.shape
    cache = T.zeros_cache(cfg, b, p + gen, device=prompts.device)
    (logits, cache), prefill_s = timed(
        lambda: T.prefill(model, cfg, prompts, cache, **kw))
    first_logits = logits
    toks = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]

    def decode():
        nonlocal logits, cache
        for _ in range(gen - 1):
            logits, cache = T.decode_step(model, cfg, toks[-1], cache, **kw)
            toks.append(logits[:, -1].argmax(-1, keepdim=True)
                        .to(torch.int32))
    _, decode_s = timed(decode)
    return {"first_logits": first_logits, "tokens": torch.cat(toks, 1),
            "prefill_s": prefill_s,
            "decode_ms_per_step": decode_s / max(gen - 1, 1) * 1e3,
            "tokens_per_s": b * gen / (prefill_s + decode_s),
            "index": cache["index"]}


def moe_inputs(model):
    """Forward pre-hooks that keep each MoE layer's input: returns (the
    list they fill with ``(layer, x)``, a function that removes them)."""
    seen, handles = [], []
    for li, blk in enumerate(model.layers):
        handles.append(blk.moe.register_forward_pre_hook(
            lambda mod, args, li=li: seen.append((li, args[0]))))
    return seen, lambda: [h.remove() for h in handles]


def plans_equal(model, cfg, seen) -> int:
    """Each captured MoE input's dispatch plan through the kernel route
    (``moe_plan``) and the plain route (``moe_plan_ref``: one-hot
    ranks), from the same probs: bitwise equal.  Returns the number of
    plans compared."""
    import torch
    from repro_torch.models import moe as MOE
    for li, x in seen:
        t = x.shape[0] * x.shape[1]
        probs = MOE.router_probs(model.layers[li].moe,
                                 x.reshape(t, -1).to(torch.bfloat16))
        a = MOE.dispatch_plan(probs, cfg.moe, t, use_pallas_dispatch=True)
        b = MOE.dispatch_plan(probs, cfg.moe, t, use_pallas_dispatch=False)
        check(a[4] == b[4] and all(torch.equal(x, y)
                                   for x, y in zip(a[:4], b[:4])),
              f"layer {li}: dispatch plan differs between the kernel and "
              f"the one-hot route")
    return len(seen)


def attention_inputs(model):
    """Forward pre-hooks that keep each attention sublayer's prefill
    input (calls with more than one position): returns (the list they
    fill with ``(layer, x, positions)``, a function that removes
    them)."""
    seen, handles = [], []

    def hook(mod, args, kwargs, li):
        x = args[0]
        if x.shape[1] > 1:
            seen.append((li, x, kwargs["positions"]))
    for li, blk in enumerate(model.layers):
        handles.append(blk.attn.register_forward_pre_hook(
            lambda mod, args, kwargs, li=li: hook(mod, args, kwargs, li),
            with_kwargs=True))
    return seen, lambda: [h.remove() for h in handles]


def attention_sublayers(model, cfg, attn_in) -> list:
    """Each layer's GQA sublayer on its captured prefill input, through
    flash_attention and through plain attention: max |diff| over max
    |plain output|, per layer."""
    from repro_torch.models import layers as L
    errs = []
    for li, x, pos in attn_in:
        p = model.layers[li].attn
        a, _ = L.gqa_apply(p, x, cfg, positions=pos, attn_impl="flash")
        b, _ = L.gqa_apply(p, x, cfg, positions=pos, attn_impl="plain")
        errs.append(float((a.float() - b.float()).abs().max()) /
                    float(b.float().abs().max()))
    check(len(errs) == cfg.num_layers, "attention inputs captured")
    return errs


def depth_sweep(model, cfg, prompts, dev) -> list:
    """Prefill through the first L layers of the same weights (and the
    head), kernel route against plain attention + one-hot dispatch:
    logits, first tokens and each layer's routing (the plan from each
    route's own MoE input) compared, for L in LM_DEPTHS."""
    import dataclasses
    import types
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    out = []
    for depth in (d for d in LM_DEPTHS if d <= cfg.num_layers):
        sub = types.SimpleNamespace(
            embed=model.embed, layers=model.layers[:depth],
            final_norm=model.final_norm, lm_head=model.lm_head)
        cfg_d = dataclasses.replace(cfg, num_layers=depth)
        res = []
        for kw in ({}, {"use_pallas_dispatch": False, "attn_impl": "plain"}):
            seen, remove = moe_inputs(sub)
            try:
                logits, _ = T.prefill(sub, cfg_d, prompts, T.zeros_cache(
                    cfg_d, prompts.shape[0], prompts.shape[1], device=dev),
                    **kw)
            finally:
                remove()
            plans = []
            for li, x in seen:
                t = x.shape[0] * x.shape[1]
                probs = MOE.router_probs(model.layers[li].moe,
                                         x.reshape(t, -1).to(torch.bfloat16))
                plans.append(MOE.dispatch_plan(probs, cfg.moe, t)[0])
            res.append((logits, plans))
        (lk, pk), (lp, pp) = res
        out.append({
            "layers": depth,
            "logit_err": float((lk - lp).abs().max()),
            "logit_scale": float(lp.abs().max()),
            "first_tokens_equal": bool(torch.equal(lk[:, -1].argmax(-1),
                                                   lp[:, -1].argmax(-1))),
            "layers_same_routing": sum(bool(torch.equal(a, b))
                                       for a, b in zip(pk, pp)),
            "slots_differ": sum(int((a != b).sum()) for a, b in zip(pk, pp))})
    return out


def skewed_layer0(model, cfg, dev) -> dict:
    """Every prompt position one repeated token: layer 0 routes every
    slot to the same top-k experts (the power-law case).  Kept shares
    with and without the ALB rebalance, and the per-expert loads."""
    import dataclasses
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    prompts = torch.full((LM_BATCH, LM_PROMPT), 7, dtype=torch.int32,
                         device=dev)
    seen, remove = moe_inputs(model)
    try:
        T.prefill(model, cfg, prompts,
                  T.zeros_cache(cfg, LM_BATCH, LM_PROMPT, device=dev))
    finally:
        remove()
    x = seen[0][1]
    t = x.shape[0] * x.shape[1]
    m = cfg.moe
    probs = MOE.router_probs(model.layers[0].moe,
                             x.reshape(t, -1).to(torch.bfloat16))
    fe, _, _, keep, cap = MOE.dispatch_plan(probs, m, t,
                                            use_pallas_dispatch=True)
    fe0, _, _, keep0, _ = MOE.dispatch_plan(
        probs, dataclasses.replace(m, adaptive=False), t,
        use_pallas_dispatch=True)
    load = torch.bincount(fe[keep].long(), minlength=m.num_experts)
    routed = torch.bincount(fe0.long(), minlength=m.num_experts)
    out = {"slots": int(fe.numel()), "cap": cap,
           "kept_adaptive": float(keep.float().mean()),
           "kept_static": float(keep0.float().mean()),
           "experts_routed_to": int((routed > 0).sum()),
           "routed_load": routed.tolist(), "kept_load": load.tolist()}
    check(out["kept_adaptive"] > out["kept_static"],
          f"skewed set: the rebalance kept no more slots: {out}")
    if cap * m.num_experts >= fe.numel():
        check(out["kept_adaptive"] == 1.0,
              f"skewed set: capacity covers every slot, kept {out}")
    print(f"phase 5: skewed set, layer 0: {out['slots']} slots to "
          f"{out['experts_routed_to']} experts (cap {cap}); kept "
          f"{out['kept_adaptive']:.4f} with the ALB rebalance, "
          f"{out['kept_static']:.4f} by pos < cap alone; routed load "
          f"{[c for c in out['routed_load'] if c]} -> kept load min "
          f"{min(out['kept_load'])} max {max(out['kept_load'])}",
          flush=True)
    return out


def lm_path(dev, smoke: bool = False) -> dict:
    """Phase 5: deepseek-moe-16b at its published widths and depth
    (``smoke``: its SMOKE config, for a rehearsal on the CPU with the
    CUDA calls stubbed), random bf16 weights
    from a seeded generator on the card, 4 requests of 1024 prompt
    tokens and 32 greedy tokens each."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T
    cfg = (get_smoke_config if smoke else get_config)(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model, init_s = timed(lambda: T.init(cfg, generator=gen, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"phase 5: {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} (+{cfg.moe.num_shared_experts} shared), "
          f"{n_params} parameters, {weight_bytes / 1e9:.3f} GB of bf16 "
          f"weights and f32 gains on the card (init {init_s:.1f} s); peak "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)

    # the counted run: every launch of the serving path
    seen, remove = moe_inputs(model)
    attn_in, remove_attn = attention_inputs(model)
    kernels.reset_launch_counts()
    try:
        kern = serve(model, cfg, prompts, LM_GEN)
    finally:
        remove()
        remove_attn()
    launches = kernels.launch_counts()
    flash_routes = dict(kernels.KERNELS["flash_attention"].launches_by_route)
    clusters = {c: n for c, n in
                kernels.KERNELS["moe_plan"].launches_by_cluster.items() if n}
    want = {"moe_plan": cfg.num_layers * LM_GEN, "positions_in_expert": 0,
            "flash_attention": cfg.num_layers}
    print(f"phase 5: kernel launches serving {LM_BATCH} x ({LM_PROMPT} + "
          f"{LM_GEN}) tokens: {launches} (expected {want}); "
          f"flash_attention by route {flash_routes}; moe_plan by cluster "
          f"size {clusters}", flush=True)
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the serving path, expected {n}")
    check(flash_routes["wgmma"] == cfg.num_layers,
          f"flash_attention: {flash_routes} on the serving path, expected "
          f"all {cfg.num_layers} on the wgmma route")
    from repro_torch.kernels.moe_plan import cluster_size
    slots = cfg.moe.top_k * LM_BATCH
    want_clusters = {cluster_size(slots * LM_PROMPT): cfg.num_layers,
                     cluster_size(slots): cfg.num_layers * (LM_GEN - 1)}
    check(clusters == want_clusters, f"moe_plan: launches by cluster size "
          f"{clusters}, expected {want_clusters}")
    check(kern["index"] == LM_PROMPT + LM_GEN - 1, "cache index")
    logits = kern["first_logits"]
    check(logits.shape == (LM_BATCH, 1, cfg.padded_vocab) and
          logits.dtype == torch.float32 and
          bool(torch.isfinite(logits).all()), "prefill logits")
    check(kern["tokens"].shape == (LM_BATCH, LM_GEN) and
          bool(((kern["tokens"] >= 0) &
                (kern["tokens"] < cfg.vocab_size)).all()), "tokens")
    n_plans = plans_equal(model, cfg, seen)
    del seen

    # the plan kernel in the model: the plain plan (one-hot ranks) with
    # the same attention gives the same plans, so logits and tokens
    # equal bitwise
    onehot = serve(model, cfg, prompts, LM_GEN, use_pallas_dispatch=False)
    check(torch.equal(onehot["first_logits"], logits) and
          torch.equal(onehot["tokens"], kern["tokens"]),
          "kernel dispatch != one-hot dispatch over the serving run")
    # kernel 5 in the model: each layer's attention sublayer on the
    # kernel route's own prefill input, flash against plain attention
    attn_err = attention_sublayers(model, cfg, attn_in)
    del attn_in
    # the whole model: kernel route against plain attention + one-hot
    # dispatch, by depth
    depth = depth_sweep(model, cfg, prompts, dev)
    plain = serve(model, cfg, prompts, LM_GEN, use_pallas_dispatch=False,
                  attn_impl="plain")
    agree = float((kern["tokens"] == plain["tokens"]).float().mean())
    print(f"phase 5: {n_plans} dispatch plans bitwise equal through the "
          f"kernel and one-hot routes; one-hot dispatch serving run: "
          f"logits and all {LM_BATCH} x {LM_GEN} tokens bitwise equal; "
          f"attention sublayers, flash against plain on each layer's "
          f"input: max |diff| / max |out| {max(attn_err):.5f} (tolerance "
          f"{LM_ATTN_RTOL:.5f}; per layer {[round(e, 5) for e in attn_err]})",
          flush=True)
    for d in depth:
        print(f"phase 5: depth {d['layers']:2d}: prefill logits kernel "
              f"route vs plain route: max |diff| {d['logit_err']:.5f} of "
              f"max |logit| {d['logit_scale']:.4f} "
              f"({d['logit_err'] / d['logit_scale']:.4f}); first tokens "
              f"equal {d['first_tokens_equal']}; layers routed "
              f"identically {d['layers_same_routing']} of {d['layers']}; "
              f"slots routed differently {d['slots_differ']}", flush=True)
    print(f"phase 5: {cfg.num_layers} layers, plain route serving run: "
          f"first tokens "
          f"{kern['tokens'][:, 0].tolist()} (kernel) vs "
          f"{plain['tokens'][:, 0].tolist()} (plain); {agree:.4f} of the "
          f"{LM_BATCH} x {LM_GEN} generated tokens agree", flush=True)
    check(max(attn_err) <= LM_ATTN_RTOL,
          "attention sublayer: flash != plain attention")
    d1 = depth[0]
    check(d1["logit_err"] <= LM_LOGITS_RTOL * d1["logit_scale"] and
          d1["first_tokens_equal"],
          f"depth {d1['layers']}: kernel route != plain route: {d1}")
    skew = skewed_layer0(model, cfg, dev)

    # the kernel route and, in turns (k r r k k r), the route moe_plan
    # replaced, on the same card in this call
    runs, replaced = [kern], []
    for i in range(5):
        if i in (2, 3):
            runs.append(serve(model, cfg, prompts, LM_GEN))
        else:
            with replaced_plan_route():
                replaced.append(serve(model, cfg, prompts, LM_GEN))
    med = {k: float(np.median([r[k] for r in runs]))
           for k in ("prefill_s", "decode_ms_per_step", "tokens_per_s")}
    med_replaced = {k: float(np.median([r[k] for r in replaced]))
                    for k in med}
    cache = T.zeros_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    _, cache = T.prefill(model, cfg, prompts, cache)
    tok = kern["tokens"][:, :1]
    syncs = count_syncs(lambda: T.decode_step(model, cfg, tok, cache))
    print(f"phase 5: median of 3 runs: prefill {med['prefill_s']:.4f} s, "
          f"decode {med['decode_ms_per_step']:.3f} ms per step, "
          f"{med['tokens_per_s']:.1f} generated tokens per s; "
          f"{len(syncs)} syncing calls in one decode step "
          f"{sorted(set(syncs))}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    wall = {"prefill": med["prefill_s"],
            "decode_step": med["decode_ms_per_step"] / 1e3}
    steps = {"prefill": lambda: T.prefill(model, cfg, prompts, cache),
             "decode_step": lambda: T.decode_step(model, cfg, tok, cache)}
    prof = profile_path(steps, wall, label="phase 5")
    with replaced_plan_route():
        prof_replaced = profile_path(
            steps, {"prefill": med_replaced["prefill_s"],
                    "decode_step": med_replaced["decode_ms_per_step"] / 1e3},
            label="phase 5, replaced route")
    print(f"phase 5: the route moe_plan replaced (the torch plan with the "
          f"positions_in_expert kernel), same call, median of 3 runs in "
          f"turns: prefill {med_replaced['prefill_s']:.4f} s, decode "
          f"{med_replaced['decode_ms_per_step']:.3f} ms per step, "
          f"{med_replaced['tokens_per_s']:.1f} generated tokens per s",
          flush=True)
    for name, pr in prof.items():
        print(f"phase 5: {name}: {pr['launches']} kernel launches "
              f"(replaced route {prof_replaced[name]['launches']}); "
              f"moe_plan {pr['moe_plan_launches']} launches, "
              f"{pr['moe_plan_ms'] / cfg.num_layers * 1e3:.2f} us of device "
              f"time per layer", flush=True)
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "params": n_params, "weight_bytes": weight_bytes,
            "init_s": init_s, "launches": launches,
            "flash_launches_by_route": flash_routes,
            "moe_plan_launches_by_cluster": clusters,
            "plans_compared": n_plans, "attn_sublayer_err": attn_err,
            "depth_sweep": depth, "tokens_agree_28_layers": agree,
            "first_tokens": kern["tokens"][:, 0].tolist(),
            "seconds": {k: [r[k] for r in runs] for k in med},
            "median": med, "median_replaced_route": med_replaced,
            "seconds_replaced_route": {k: [r[k] for r in replaced]
                                       for k in med},
            "profile_replaced_route": prof_replaced,
            "syncs_per_decode_step": len(syncs),
            "sync_sites": sorted(set(syncs)), "skewed": skew,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": prof, "model": model, "cfg": cfg, "prompts": prompts,
            "cache": cache, "tok": tok}


def capture_lm_launches(model, cfg, prompts, cache, tok) -> dict:
    """The arguments of every kernel launch of one prefill and one decode
    step, recorded by swapping the names the model calls through for
    recorders that forward to the real wrappers; each call is tagged
    with its phase."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    calls = {"moe_plan": [], "flash_attention": []}
    phase = ["prefill"]

    def recorder(name, fn):
        def rec(*a, **k):
            calls[name].append((phase[0], a, k))
            return fn(*a, **k)
        return rec

    real = MOE.moe_plan, L.flash_attention
    MOE.moe_plan = recorder("moe_plan", real[0])
    L.flash_attention = recorder("flash_attention", real[1])
    try:
        T.prefill(model, cfg, prompts, cache)
        phase[0] = "decode"
        T.decode_step(model, cfg, tok, cache)
    finally:
        MOE.moe_plan, L.flash_attention = real
    return calls


@contextlib.contextmanager
def replaced_plan_route():
    """``models.moe`` plans through ``unfused_plan`` inside the block (a
    yardstick run of the route ``moe_plan`` replaced)."""
    from repro_torch.models import moe as MOE
    real = MOE.moe_plan
    MOE.moe_plan = unfused_plan
    try:
        yield
    finally:
        MOE.moe_plan = real


def unfused_plan(probs, *, top_k, cap, groups, adaptive):
    """The route ``moe_plan`` replaced (a yardstick the port never
    calls): ``dispatch_plan``'s torch ops with the ``positions_in_expert``
    kernel for the ranks, one rank launch per group."""
    from repro_torch.kernels import moe_dispatch, ref
    return ref.moe_plan_ref(probs, top_k=top_k, cap=cap, groups=groups,
                            adaptive=adaptive,
                            positions=moe_dispatch.positions_in_expert)


def plan_work(a, k):
    """(bytes, operations) of one plan: the float32 probabilities read
    once and 13 bytes written per slot (flat_expert, pos, gate, keep);
    one compare-select per probability and top-k round, and ~10 integer
    operations per slot (rank, overflow rank, search, writes)."""
    g, t, e = a[0].shape
    n = g * t * k["top_k"]
    return 4 * g * t * e + 13 * n, g * t * e * k["top_k"] + 10 * n


def time_lm_kernels(lm: dict) -> list:
    """The LM kernels' rows: each kernel and its plain version on the card
    at the shapes phase 5 gave it (CUDA events, stream held busy), beside
    the least time the card could take; ``ms`` is the mean per launch
    over the serving run's mix (one prefill, LM_GEN - 1 decode steps).
    ``moe_plan`` also beside the route it replaced (``unfused_plan``,
    its kernels and the gaps between them on the card) and
    ``positions_in_expert`` alone; ``positions_in_expert`` is off the
    main path, so it is timed on the top-k expert ids of the same
    plans."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, moe_dispatch, moe_plan
    from repro_torch.kernels import ref
    from repro_torch.models import moe as MOE
    calls = capture_lm_launches(lm["model"], lm["cfg"], lm["prompts"],
                                lm["cache"], lm["tok"])
    calls["positions_in_expert"] = [
        (ph, (MOE._top_k(a[0][0], k["top_k"])[1].reshape(-1),
              a[0].shape[-1]), {}) for ph, a, k in calls["moe_plan"]]
    steps = {"prefill": 1, "decode": LM_GEN - 1}

    def sdpa(q, k, v, causal=True):
        kw = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, **kw)

    def pie_work(a, k):
        return 8 * a[0].numel(), 0

    def fa_work(a, k):
        q, kk = a[0], a[1]
        b, s, h, hd = q.shape
        byts = (2 * q.numel() + 2 * kk.numel()) * q.element_size()
        flops = 2 * b * h * s * s * hd
        if not k.get("causal", True):
            flops *= 2
        return byts, flops

    def abs_err(got, want):
        return float((got.float() - want.float()).abs().max())

    # name, kernel, plain, library call, work, peak rate of its operations,
    # error against plain, tolerance, source, TPU kernel replaced
    table = [("moe_plan", moe_plan.moe_plan, ref.moe_plan_ref, None,
              plan_work, SCALAR_OPS_PER_S, plan_err, 0,
              "src/repro_torch/kernels/csrc/moe_plan.cu",
              "src/repro/kernels/moe_dispatch.py:45"),
             ("positions_in_expert", moe_dispatch.positions_in_expert,
              ref.positions_in_expert_ref, None, pie_work, SCALAR_OPS_PER_S,
              abs_err, 0, "src/repro_torch/kernels/csrc/moe_dispatch.cu",
              "src/repro/kernels/moe_dispatch.py:45"),
             ("flash_attention", flash_attention.flash_attention,
              ref.flash_attention_ref, sdpa, fa_work, BF16_FLOPS_PER_S,
              abs_err, FLASH_TOL["bfloat16"],
              "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
              "src/repro/kernels/flash_attention.py:68")]
    rows = []
    for name, fn, plain, lib, work, rate, err_of, tol, source, replaces \
            in table:
        by_phase = {}
        for ph, a, k in calls[name]:
            by_phase.setdefault(ph, []).append((a, k))
        check(len(by_phase) > 0, f"{name}: no launch captured")
        err = 0.0
        for cs in by_phase.values():   # the kernel against plain, main path
            for a, k in cs:
                err = max(err, err_of(fn(*a, **k), plain(*a, **k)))
        check(err <= tol, f"{name} != plain on main-path inputs: {err}")
        t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
             "ops": 0.0}
        per_phase = {}
        n_launch = 0
        for ph, cs in by_phase.items():
            w = steps[ph] * len(cs)          # calls on the serving run
            cs = cs[:4]                      # time a few of each shape
            ms = device_ms(fn, cs)
            pms = device_ms(plain, cs, sleep_cycles=20_000_000)
            lms = device_ms(lib, cs) if lib is not None else None
            b = sum(work(a, k)[0] for a, k in cs) / len(cs)
            o = sum(work(a, k)[1] for a, k in cs) / len(cs)
            per_phase[ph] = {"ms": ms, "plain_ms": pms, "library_ms": lms,
                             "bytes": b, "ops": o, "calls": w,
                             "shape": list(cs[0][0][0].shape)}
            if name == "flash_attention":     # which of its two kernels
                q = cs[0][0][0]
                per_phase[ph]["kernel_route"] = flash_attention.route(
                    q.dtype, q.shape[-1])
            if name == "moe_plan":            # beside the route replaced
                pie = [((MOE._top_k(a[0][0], k["top_k"])[1].reshape(-1),
                         a[0].shape[-1]), {}) for a, k in cs]
                per_phase[ph].update({
                    "unfused_ms": device_ms(unfused_plan, cs,
                                            sleep_cycles=20_000_000),
                    "positions_in_expert_ms": device_ms(
                        moe_dispatch.positions_in_expert, pie),
                    "cluster": moe_plan.cluster_size(
                        cs[0][0][0].shape[1] * cs[0][1]["top_k"])})
            n_launch += w
            for key, val in (("ms", ms), ("plain_ms", pms),
                             ("library_ms", lms or 0.0), ("bytes", b),
                             ("ops", o)):
                t[key] += w * val
        t = {k: v / n_launch for k, v in t.items()}
        t_b = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t_o = t["ops"] / rate * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lm["launches"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": t["library_ms"] if lib is not None else None,
            "by_phase": per_phase})
    return rows


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
                if "registers" in ln or "spill" in ln or
                "Performance" in ln]
        print(f"phase 1: {name}: {' | '.join(info)}", flush=True)
    built = len(build.BUILD_LOG)

    errs = kernel_vs_plain(dev)
    relax_vs_plain(dev)
    static_errs = static_entries_vs_plain(dev)
    lm_kernels_vs_plain(dev)
    moe_plan_vs_plain(dev)
    mp = main_path(dev, args.scale)
    g, src, sources = mp.pop("graph"), mp.pop("src"), mp.pop("sources")
    res = mp.pop("results")
    pp = pull_path(g, src, sources, res)
    apps, cfgs, sym = pp.pop("apps"), pp.pop("cfgs"), pp.pop("sym")
    pp["user_operator"] = user_op_path(g, src, res["sssp"].labels)
    del res
    sp = static_path(g, sym, src, sources)
    se, serve_batches = stream_path(g, sym, src)
    sv = serve_path(g, serve_batches, built)
    del serve_batches
    # launches on the main paths: phases 3 and 3b (host entries), 3d
    # (static entries), and 3e and 3f (host entries in host mode, static
    # entries in spmd and fused mode)
    launches = {k: mp["launches"][k] + pp["launches"][k]
                for k in GRAPH_KERNELS + ("twc_bin_map", "edge_lb_map")}
    static_launches = dict(sp["launches"])
    by_phase = {}
    for k in ("twc_bin_relax", "edge_lb_relax"):
        by_phase[k] = {"3": mp["launches"][k], "3b": pp["launches"][k],
                       "3d": sp["launches"][k]}
        for ph, o in (("3e", se), ("3f", sv)):
            host_n = o["launches_by_entry"]["host"].get(k, 0)
            static_n = o["launches_by_entry"]["static"].get(k, 0)
            launches[k] += host_n
            static_launches[k] += static_n
            by_phase[k][ph] = {"host": host_n, "static": static_n}
    rows = time_kernels(g, src, sources, errs, launches)
    rows += time_static_kernels(g, src, static_launches, sp["captured"])
    rows.append(time_graph_loop(
        dev, sp["condition_decisions"] + se["condition_decisions"]
        + sv["condition_decisions"]))
    for r in rows:
        if r["name"].split()[0] in by_phase:
            r["launches_by_phase"] = by_phase[r["name"].split()[0]]
    for r in rows[-4:]:
        r["phase2_err"] = static_errs.get(r["name"].split()[0])
    for r in rows:
        print(f"phase 4: {r['name']}: {r['ms']:.4f} ms per launch "
              f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}"
              + (f", unfused route {r['unfused_ms']:.4f} ms"
                 if "unfused_ms" in r else "")
              + f") over {r['timed_launches']} launches of one sssp; "
              f"{r['launches']} launches on its main-path runs (phases "
              f"3d-3f for a static entry and the condition kernel; by "
              f"phase {r.get('launches_by_phase')})", flush=True)
        for run, t in r.get("by_run", {}).items():
            print(f"phase 4:   {r['name']} at {run}'s shapes: {t}",
                  flush=True)
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
    print(json.dumps({"static_path": sp}), flush=True)
    print(json.dumps({"stream_path": se}), flush=True)
    print(json.dumps({"serve_path": sv}), flush=True)

    # phase 5 needs the card's memory: free the graph phases' tensors
    # (and the programs captured on them)
    del g, sym, apps, cfgs, kern
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_path(dev)
    lm_rows = time_lm_kernels(lm)
    for r in lm_rows:
        routes = sorted({p.get("kernel_route", "cuda")
                         for p in r["by_phase"].values()})
        print(f"phase 4: {r['name']} ({'/'.join(routes)}): {r['ms']:.4f} ms "
              f"per launch over the serving mix (plain {r['plain_ms']:.4f} "
              f"ms, library "
              f"{r['library_ms']} ms, bound {r['bound_ms']:.7f} ms by "
              f"{r['bound_by']}); max error against plain on main-path "
              f"inputs {r['max_abs_err']}; {r['launches']} launches; by "
              f"phase {r['by_phase']}", flush=True)
    plan = lm_rows[0]["by_phase"]
    for ph, t in plan.items():
        bms = max(t["bytes"] / HBM_BYTES_PER_S,
                  t["ops"] / SCALAR_OPS_PER_S) * 1e3
        print(f"phase 4: moe_plan at {ph} (cluster {t['cluster']}): "
              f"{t['ms']:.4f} ms per launch, bound {bms:.7f} ms; plain "
              f"{t['plain_ms']:.4f} ms; the route it replaced "
              f"{t['unfused_ms']:.4f} ms; positions_in_expert alone "
              f"{t['positions_in_expert_ms']:.4f} ms", flush=True)
    for k in ("model", "cfg", "prompts", "cache", "tok"):
        lm.pop(k)
    print(json.dumps({"lm_path": lm}), flush=True)
    print(json.dumps({"kernels": rows + lm_rows}), flush=True)
    print(card, flush=True)              # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
