"""The static round's bin kernels and fused spans of one checkout of the
port, on one card: for comparing two commits in one call.

    python scripts/static_entry_ab.py ROOT GRAPH_DIR LABEL

``ROOT`` is a checkout (its ``chip_smoke.py`` and ``src/`` are used);
``GRAPH_DIR`` caches ``rmat(22, 16, seed=0)`` as ``g.npz`` (built on the
first run, loaded by the next, so that runs of two checkouts in turns
share one graph).  Prints one ``RESULT {...}`` JSON line: the card, the
device span of fused sssp (alb, edge_lb, twc and merge_path),
sssp_batch (B = 8) and pagerank (20 rounds; the kernel pair and
merge_path; CUDA events, median of 6), the device profile of sssp and
pagerank in ``mode="spmd"`` (launches, busy ms and the
``index_elementwise_kernel`` ms), the merge-path pair's static launch
at one static
merge-path sssp's and two static pagerank rounds' shapes
(``merge_path_relax`` beside the route it replaced, where the checkout
has it, else ``merge_path_map`` alone), ``twc_bin_relax``'s static
entry at
one static ALB sssp's, twc's unbounded bin's and (where the checkout
lists bins) two static pagerank rounds' shapes, ``edge_lb_relax``'s
static entry at one static ALB sssp's, one static edge_lb sssp's and
two static pagerank rounds' shapes (and each ALB sssp call alone: its
total, its slots, its time and the time of the same launch with a total
of 0), ``twc_bin_list`` at the shapes
where the checkout lists (ALB sssp, edge_lb sssp, pagerank, ALB
sssp_batch), each call in the checkout's own signature (recorded by its
``chip_smoke.capture_launches``, timed by its ``time_list``), the
host round's ``twc_bin_relax`` calls of one sssp, one group a row
and through the static schedule, and, where the checkout's listing
reads the dense mask, where its time goes (``list_sweep``).  Needs a
CUDA device.
"""
import inspect
import json
import sys
import time
from pathlib import Path


def list_sweep(cs, g) -> dict:
    """Where ``twc_bin_list``'s time goes at ``g``'s V, with alb's bins
    and its huge (LB) bin: the listing over ``[R, V]`` masks, R = 1 and
    8, that list nothing, a sparse union (0.1% of the vertices), 5% and
    every vertex (each beside its bound, ``chip_smoke.list_work``, and
    ``mask.any(0)``: torch reading the same mask); then empty ``[1, V']``
    masks over 1 to 1,024 tiles of 4,096 vertices (V' = 4,096 t, a
    ``row_ptr`` of zeros), whose time beyond one tile's is the mask read
    and the look-back across tiles; and the wrapper's scratch zeroing
    alone at ``g``'s V."""
    import torch
    from repro_torch.kernels import relax
    dev, v = g.row_ptr.device, g.num_vertices
    bounds = cs.LB_LIST_BOUNDS["alb+lb"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"masks": [], "empty_tiles": []}
    for r in (1, 8):
        for name, p in (("empty", 0.0), ("sparse", 1e-3), ("5%", 0.05),
                        ("all", 1.0)):
            mask = torch.rand((r, v), generator=gen, device=dev) < p / r
            if p == 1.0:
                mask.fill_(True)
            calls = [((mask, g.row_ptr, bounds), {"lb": True})]
            lists = relax.twc_bin_list(*calls[0][0], lb=True)
            bms, _, nbytes = cs.bound(cs.list_work, calls)
            out["masks"].append({
                "r": r, "mask": name,
                "listed": int(mask.any(0).sum()),
                "members": int(lists.count.sum()),
                "ms": cs.device_ms(relax.twc_bin_list, calls),
                "bound_ms": bms, "bytes": nbytes,
                "any_ms": cs.device_ms(lambda m: m.any(0),
                                       [((mask,), {})])})
    for tiles in (1, 8, 64, 256, 1024):
        n = 4096 * tiles
        mask = torch.zeros((1, n), dtype=torch.bool, device=dev)
        rp = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        out["empty_tiles"].append({
            "tiles": tiles, "v": n,
            "ms": cs.device_ms(relax.twc_bin_list,
                               [((mask, rp, bounds), {"lb": True})])})
    size = relax._list_scratch()(v, len(bounds))
    out["scratch_zeros_ms"] = cs.device_ms(
        lambda: torch.zeros(size, dtype=torch.int32, device=dev), [((), {})])
    return out


def main() -> int:
    root, gdir, label = Path(sys.argv[1]).resolve(), Path(sys.argv[2]), \
        sys.argv[3]
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import balancer, graph as tg
    from repro_torch.core import operators as tops
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.graph import INF
    from repro_torch.kernels import build, merge_path, relax

    if not torch.cuda.is_available():
        print("static_entry_ab: needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.load_all([n for n in build.sources()
                    if not n.startswith(("flash", "moe"))])
    dev = torch.device("cuda", 0)
    gdir.mkdir(parents=True, exist_ok=True)
    cached = gdir / "g.npz"
    if cached.exists():
        z = np.load(cached)
        g = tg.Graph.from_numpy(z["row_ptr"], z["col_idx"], z["edge_w"],
                                device=dev)
    else:
        g = tg.rmat(22, 16, seed=0, device=dev)
        np.savez(cached, row_ptr=g.row_ptr.cpu().numpy(),
                 col_idx=g.col_idx.cpu().numpy(),
                 edge_w=g.edge_w.cpu().numpy())
    src = int(tg.highest_out_degree_vertex(g))
    deg = np.diff(g.row_ptr.cpu().numpy())
    sources = [src] + [int(x) for x in np.random.default_rng(0).choice(
        np.flatnonzero(deg), 7, replace=False)]
    print(label, "set-up", time.perf_counter() - t0, flush=True)
    kern = BalancerConfig(strategy="alb", use_pallas=True)
    twc = BalancerConfig(strategy="twc", use_pallas=True)
    elb = BalancerConfig(strategy="edge_lb", use_pallas=True)
    mpc = BalancerConfig(strategy="alb", backend="merge_path")
    out = {"label": label, "card": cs.card_line()}

    def single():
        lab = torch.full((g.num_vertices,), int(INF), dtype=torch.int32,
                         device=dev)
        lab[src] = 0
        return lab, lab == 0

    def batch():
        lab = torch.full((len(sources), g.num_vertices), int(INF),
                         dtype=torch.int32, device=dev)
        lab[torch.arange(len(sources)), torch.tensor(sources)] = 0
        return lab, lab == 0

    def batch_calls(cfg):
        """The launches of one static sssp_batch, round by round, in
        this checkout's signature."""
        def run():
            lab, fr = batch()
            while bool(fr.any()):
                new = balancer._relax_spmd_impl(g, lab, lab, fr, cfg,
                                                tops.SSSP_RELAX)
                fr, lab = new < lab, new
        return cs.capture_launches(run)
    rg = g.reverse()
    outdeg = g.out_degrees().to(torch.float32)
    inv_out = torch.where(outdeg > 0, 1.0 / torch.clamp(outdeg, min=1.0),
                          0.0)
    fused = {
        "sssp": lambda: balancer.run_fused(g, *single(), kern,
                                           tops.SSSP_RELAX)[:3],
        "sssp/twc": lambda: balancer.run_fused(g, *single(), twc,
                                               tops.SSSP_RELAX)[:3],
        "sssp/edge_lb": lambda: balancer.run_fused(g, *single(), elb,
                                                   tops.SSSP_RELAX)[:3],
        "sssp/merge_path": lambda: balancer.run_fused(
            g, *single(), mpc, tops.SSSP_RELAX)[:3],
        "sssp_batch": lambda: balancer.run_fused(g, *batch(), kern,
                                                 tops.SSSP_RELAX)[:3],
        "pagerank": lambda: drivers._pagerank_fused(
            rg, inv_out, outdeg == 0, 0.85, 0.0, kern, 20, False)[:2],
        "pagerank/merge_path": lambda: drivers._pagerank_fused(
            rg, inv_out, outdeg == 0, 0.85, 0.0, mpc, 20, False)[:2]}
    for fn in fused.values():                     # capture, warm up
        fn()
    torch.cuda.synchronize()
    out["fused_span_ms"] = {
        k: float(np.median([cs.event_span_ms(fn) for _ in range(6)]))
        for k, fn in fused.items()}
    spmd = {"sssp/spmd": lambda: drivers.sssp(g, src, kern, mode="spmd"),
            "pagerank/spmd": lambda: drivers.pagerank(
                g, cfg=kern, max_rounds=20, tol=0.0, mode="spmd")}
    walls = {k: float(np.median([fn().seconds for _ in range(4)]))
             for k, fn in spmd.items()}
    prof = cs.profile_path(spmd, walls, label=label)
    out["spmd_profile"] = {
        k: {"launches": r["launches"], "device_ms": r["device_ms"],
            "wall_ms": walls[k] * 1e3,
            "index_elementwise_ms": sum(t for n, t, _ in r["top"]
                                        if "index_elementwise" in n)}
        for k, r in prof.items()}
    alb = cs.static_calls(g, src, kern)
    tw = cs.static_calls(g, src, twc)
    el = cs.static_calls(g, src, elb)
    runs = {"alb": alb["twc_bin_relax"],
            "twc_unbounded": [(a, k) for a, k in tw["twc_bin_relax"]
                              if hasattr(k.get("passes"), "device")]}
    lb_runs = {"alb": alb["edge_lb_relax"], "edge_lb": el["edge_lb_relax"]}
    listed = {"alb": alb["twc_bin_list"], "edge_lb": el["twc_bin_list"]}
    if hasattr(cs, "static_pagerank_calls"):      # a checkout that lists
        pr = cs.static_pagerank_calls(g, kern)
        runs["pagerank"] = pr["twc_bin_relax"]
        lb_runs["pagerank"] = pr["edge_lb_relax"]
        listed["pagerank"] = pr["twc_bin_list"]
    listed["sssp_batch"] = batch_calls(kern)["twc_bin_list"]
    # a checkout lists the edge_lb strategy only if it lists its LB bin
    out["list"] = {r: cs.time_list(c) for r, c in listed.items() if c}
    out["static_relax"] = {r: cs.time_relax("twc_bin_relax", c)
                           for r, c in runs.items()}
    out["static_lb"] = {r: cs.time_relax("edge_lb_relax", c)
                        for r, c in lb_runs.items()}
    out["static_lb_calls"] = [
        {"total": int(a[8]), "slots": int(k.get("rows", a[5].shape[0])),
         "ms": cs.device_ms_fresh(relax.edge_lb_relax, [(a, k)]),
         "empty_ms": cs.device_ms_fresh(
             relax.edge_lb_relax,
             [(a[:8] + (torch.zeros_like(a[8]),) + a[9:], k)])}
        for a, k in lb_runs["alb"]]
    host = cs.capture_launches(
        lambda: drivers.sssp(g, src, kern))["twc_bin_relax"]
    out["host_relax_ms"] = cs.time_relax("twc_bin_relax", host)["ms"]
    mp = {"sssp": cs.static_calls(g, src, mpc),
          "pagerank": cs.static_pagerank_calls(g, mpc)}
    if mp["sssp"].get("merge_path_relax"):
        out["static_mp"] = {r: cs.time_relax("merge_path_relax",
                                             c["merge_path_relax"])
                            for r, c in mp.items()}
    else:                            # the parent: the index map alone
        out["static_mp_map_ms"] = {
            r: cs.device_ms(merge_path.merge_path_map, c["merge_path_map"])
            for r, c in mp.items()}
    schedule = getattr(cs, "static_schedule_ms", None) or \
        getattr(cs, "tile_walk_ms")
    out["static_schedule_ms"] = schedule(host)
    if next(iter(inspect.signature(relax.twc_bin_list).parameters)) == \
            "mask":                          # a checkout that reads it
        out["list_sweep"] = list_sweep(cs, g)
    out["seconds"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
