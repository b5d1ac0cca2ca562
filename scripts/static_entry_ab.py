"""The static round's bin kernels and fused spans of one checkout of the
port, on one card: for comparing two commits in one call.

    python scripts/static_entry_ab.py ROOT GRAPH_DIR LABEL

``ROOT`` is a checkout (its ``chip_smoke.py`` and ``src/`` are used);
``GRAPH_DIR`` caches ``rmat(22, 16, seed=0)`` as ``g.npz`` (built on the
first run, loaded by the next, so that runs of two checkouts in turns
share one graph).  Prints one ``RESULT {...}`` JSON line: the card, the
device span of fused sssp (alb, edge_lb, twc and merge_path) and
pagerank (20 rounds; the kernel pair and merge_path; CUDA events,
median of 6), the merge-path pair's static launch at one static
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
where the checkout lists (ALB sssp, edge_lb sssp, pagerank), and the
host round's ``twc_bin_relax`` calls of one sssp, one group a row and
through the static schedule.  Needs a CUDA device.
"""
import json
import sys
import time
from pathlib import Path


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
    out["seconds"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
