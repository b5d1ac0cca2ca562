"""The system under test: the port's drivers, called the way a traffic
mix names them.  This is the one module of the benchmark that imports
``repro_torch``; it takes the port's graph container, its drivers and
its balancer configuration, and nothing else.

A traffic mix's ``app`` picks the driver:

* ``sssp`` — one source a query (``drivers.sssp``);
* ``sssp_batch`` — ``batch`` sources a query, one ``[B, V]`` traversal;
* ``pagerank`` — ``drivers.pagerank`` with ``damping``, ``tol`` and, the
  graph being symmetric, ``rg`` the graph itself.

Every call runs in the mix's ``mode`` with ``BalancerConfig(**balancer)``
and returns ``(labels, rounds)``: labels on the device, rounds a host
int (the driver has fetched it, after synchronising).
"""
from __future__ import annotations

#: app -> (sources a query: "one" | "batch" | None, weighted)
APPS = {"sssp": ("one", True), "sssp_batch": ("batch", True),
        "pagerank": (None, None)}


def load_kernels() -> None:
    """Load (building on first use, into the checkout's build directory)
    the port's CUDA libraries, as its first captured traversal would."""
    from repro_torch.kernels import build
    build.load_all()


def entry(traffic: dict, csr):
    """``call(sources) -> (labels, rounds)`` for the mix's app on the
    benchmark's CSR ``(row_ptr, col_idx, edge_w)``, held by the port's
    ``Graph`` container (shared, not copied)."""
    from repro_torch.core.apps import drivers
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.graph import Graph
    g = Graph(*csr)
    app = traffic["app"]
    if app not in APPS:
        raise ValueError(f"unknown app {app!r}; one of {sorted(APPS)}")
    cfg = BalancerConfig(**traffic["balancer"])
    mode, max_rounds = traffic["mode"], int(traffic["max_rounds"])
    fn = getattr(drivers, app)
    if app == "pagerank":
        def call(sources):
            res = fn(g, damping=float(traffic["damping"]),
                     tol=float(traffic["tol"]), cfg=cfg,
                     max_rounds=max_rounds, rg=g, mode=mode)
            return res.labels, res.rounds
    elif APPS[app][0] == "one":
        def call(sources):
            res = fn(g, int(sources[0]), cfg, max_rounds=max_rounds,
                     mode=mode)
            return res.labels, res.rounds
    else:
        def call(sources):
            res = fn(g, list(sources), cfg, max_rounds=max_rounds,
                     mode=mode)
            return res.labels, res.rounds
    return call
