"""Port parity of the distributed runtime (``repro_torch.core.gluon`` over
``core.partition``, ``core.wire`` and ``core.collectives``) against the
JAX package's ``repro.core.gluon`` on 4 devices.

JAX's multi-device runs need 4 devices, which the tier-1 process does
not have (its tests skip there), so a module-scoped fixture runs ONE
JAX subprocess with 4 forced host devices over the whole case matrix:
the cases of tests/test_mirror_sync.py, tests/test_wire.py (the
multi-device ones), tests/test_batched_queries.py (the distributed
ones), tests/test_fused.py (the distributed script) and
tests/test_distributed_graph.py, on ``rmat(9, 8, seed=5)`` (and
``rmat(10, 8, seed=3)`` for the wire codecs' compression gate).  It
writes labels, rounds, ``host_transfers``, every per-round, per-device
``RoundStats`` field, its partitions and the refusals' messages to an
``.npz``.  The port runs each case on a CPU mesh of 4 slots, on its own
partition and on JAX's (``partitioned_from_numpy``), and must match
exactly; pagerank's ranks at rtol 2e-6 (XLA contracts the rank update
into an FMA, ROADMAP Queue 3).
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro_torch.core import gluon as TGl
from repro_torch.core import graph as TG
from repro_torch.core import operators as ops
from repro_torch.core import partition as TP
from repro_torch.core import streaming as TS
from repro_torch.core import wire as TW
from repro_torch.core.apps import drivers as TD
from repro_torch.core.balancer import BalancerConfig as TCfg
from repro_torch.core.balancer import host_transfer_count, relax_spmd
from repro_torch.core.collectives import device_mesh

NDEV = 4
PR_RTOL = 2e-6
REPO = Path(__file__).resolve().parents[1]
MESH = device_mesh(NDEV, devices=["cpu"] * NDEV)
SCALARS = ("frontier_size", "edges_twc", "edges_lb", "lb_invoked",
           "mirrors_synced", "bytes_synced", "bytes_wire", "frontier_edges",
           "host_transfers", "is_pull")
ARRAYS = ("tile_loads_twc", "tile_loads_lb", "frontier_per_query")
# the mirror pagerank's exchange volume counts changed ranks: held to 8
# vertices a round and slot of JAX's (measured: 6 of about 260 at most
# on rmat(9, 8)), each at most 1 count, 8 logical bytes and 10 wire bytes
VOLUME = ("mirrors_synced", "bytes_synced", "bytes_wire")
PR_VOLUME_VERTICES = 8
PR_VOLUME_BYTES = (1, 8, 10)


def _case_table() -> dict:
    """name -> spec: the JAX tests' distributed cases.  ``srcs`` "top4" /
    "top3" name the highest-out-degree vertices (descending)."""
    cases = {}

    def add(name, app, **kw):
        spec = dict(app=app, graph="g", policy="oec", sync="mirror",
                    mode="host", stats=True, wire="identity", pallas=False)
        spec.update(kw)
        if spec["mode"] == "fused":
            spec["stats"] = False
        cases[name] = spec

    # tests/test_mirror_sync.py, tests/test_distributed_graph.py
    for app in ("sssp", "bfs"):
        for pol in ("oec", "iec", "cvc"):
            for sync in ("replicated", "mirror"):
                add(f"{app}/{pol}/{sync}", app, policy=pol, sync=sync)
    for app in ("cc", "kcore"):
        for pol in ("oec", "cvc"):
            for sync in ("replicated", "mirror"):
                add(f"{app}/{pol}/{sync}", app, graph="sym", policy=pol,
                    sync=sync)
    add("sssp_batch8/oec/mirror", "sssp_batch",
        srcs=[int(x) for x in np.arange(8) * 64])
    for pol in ("oec", "iec"):
        for sync in ("replicated", "mirror"):
            add(f"pagerank15/{pol}/{sync}", "pagerank", graph="rev",
                policy=pol, sync=sync, rounds=15, tol=0.0)
    # tests/test_fused.py's distributed script (there on rmat(8, 8))
    for sync in ("replicated", "mirror"):
        add(f"sssp/oec/{sync}/fused", "sssp", sync=sync, mode="fused")
        for mode in ("host", "fused"):
            add(f"pagerank20/oec/{sync}/{mode}", "pagerank", graph="rev",
                sync=sync, mode=mode, stats=False, rounds=20, tol=1e-6)
    # tests/test_wire.py
    for sync in ("replicated", "mirror"):
        add(f"bfs/oec/{sync}/fused", "bfs", sync=sync, mode="fused")
        for codec in ("delta", "bitmap", "quantize"):
            for mode in ("host", "fused"):
                add(f"bfs/{codec}/{sync}/{mode}", "bfs", sync=sync,
                    mode=mode, wire=codec)
    for app in ("cc", "kcore"):
        for codec in ("delta", "bitmap") + (("quantize",) if app == "kcore"
                                            else ()):
            add(f"{app}/{codec}/mirror", app, graph="sym", wire=codec)
    for codec in ("identity", "delta", "bitmap"):
        add(f"pagerank10/{codec}/mirror", "pagerank", graph="rev",
            wire=codec, rounds=10, tol=0.0)
    for codec in ("delta", "bitmap"):
        add(f"bfs_batch8/{codec}/mirror", "bfs_batch", graph="c",
            wire=codec, srcs=[0, 7, 23, 99, 200, 311, 450, 512])
    # tests/test_batched_queries.py
    for pallas in (False, True):
        add(f"sssp_batch4/replicated/pallas={pallas}", "sssp_batch",
            sync="replicated", pallas=pallas, srcs="top4")
    for pol in ("oec", "cvc"):
        add(f"sssp_batch4/{pol}/mirror", "sssp_batch", policy=pol,
            srcs="top4")
    for sync in ("replicated", "mirror"):
        add(f"bfs_batch3/{sync}", "bfs_batch", sync=sync, srcs="top3")
    return cases


CASES = _case_table()

# the refusals, each raising before any round runs: name -> (app, kwargs
# of the driver call, BalancerConfig fields)
REFUSALS = {
    "pull": ("sssp", {}, {"direction": "pull"}),
    "adaptive": ("bfs", {"sync": "mirror"}, {"direction": "adaptive"}),
    "quantize_sssp": ("sssp", {"sync": "mirror"}, {"wire": "quantize"}),
    "quantize_cc_fused": ("cc", {"sync": "replicated", "mode": "fused"},
                          {"wire": "quantize"}),
    "quantize_pagerank": ("pagerank", {"sync": "mirror"},
                          {"wire": "quantize"}),
    "unknown_sync": ("sssp", {"sync": "allgather"}, {}),
    "unknown_sync_pagerank": ("pagerank", {"sync": "allgather"}, {}),
    "unknown_mode": ("bfs", {"mode": "spmd"}, {}),
    "mirror_without_meta": ("sssp", {"sync": "mirror", "meta": None}, {}),
    "fused_with_stats": ("sssp", {"mode": "fused", "collect_stats": True},
                         {}),
    "fused_with_stats_mirror": ("kcore", {"mode": "fused", "sync": "mirror",
                                          "collect_stats": True}, {}),
    "fused_with_stats_pagerank": ("pagerank", {"mode": "fused",
                                               "collect_stats": True}, {}),
}

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from repro.core import graph as G
from repro.core.partition import partition, partition_stats
from repro.core import gluon
from repro.core.balancer import BalancerConfig, host_transfer_count

assert len(jax.devices()) == 4, jax.devices()
spec = json.load(open(sys.argv[1]))
out = {}
g = G.rmat(9, 8, seed=5)
graphs = {"g": g, "sym": G.symmetrized(g), "rev": G.reverse_graph(g),
          "c": G.rmat(10, 8, seed=3)}
deg = np.asarray(g.out_degrees())
srcs_of = {"top4": [int(x) for x in np.argsort(-deg)[:4]],
           "top3": [int(x) for x in np.argsort(-deg)[:3]]}
src = G.highest_out_degree_vertex(g)
mesh = gluon.device_mesh(4)
parts = {}


def part(gk, pol):
    key = f"{gk}/{pol}"
    if key not in parts:
        sg, meta = partition(graphs[gk], 4, pol)
        parts[key] = (sg, meta)
        for f in ("row_ptr", "col_idx", "edge_w"):
            out[f"part/{key}/{f}"] = np.asarray(getattr(sg, f))
        for f in ("master_bounds", "owner", "mirror_idx", "mirror_counts"):
            out[f"part/{key}/{f}"] = np.asarray(getattr(meta, f))
        out[f"part/{key}/stats"] = np.asarray(
            json.dumps(partition_stats(sg, meta)))
    return parts[key]


def call(c, cfg, sg, meta, **kw):
    app, gk = c["app"], c["graph"]
    if app == "pagerank":
        return gluon.pagerank_distributed(
            sg, mesh, g.out_degrees(), cfg=cfg, max_rounds=c.get("rounds", 5),
            tol=c.get("tol", 1e-6), meta=meta, **kw)
    if app in ("sssp", "bfs"):
        fn = getattr(gluon, f"{app}_distributed")
        return fn(sg, mesh, src, cfg, meta=meta, **kw)
    if app in ("sssp_batch", "bfs_batch"):
        fn = getattr(gluon, f"{app}_distributed")
        s = c["srcs"]
        return fn(sg, mesh, srcs_of.get(s, s) if isinstance(s, str) else
                  np.asarray(s), cfg, meta=meta, **kw)
    if app == "cc":
        return gluon.cc_distributed(sg, mesh, cfg, meta=meta, **kw)
    return gluon.kcore_distributed(sg, mesh, 8, cfg, meta=meta, **kw)


for name, c in spec["cases"].items():
    cfg = BalancerConfig(strategy="alb", threshold=64,
                         use_pallas=c["pallas"], wire=c["wire"])
    sg, meta = part(c["graph"], c["policy"])
    t0 = host_transfer_count()
    res = call(c, cfg, sg, meta, sync=c["sync"], mode=c["mode"],
               collect_stats=c["stats"])
    out[f"{name}/host_transfers"] = np.asarray(host_transfer_count() - t0)
    out[f"{name}/labels"] = np.asarray(res[0])
    out[f"{name}/rounds"] = np.asarray(res[1])
    if c["stats"]:
        st = res[3]
        out[f"{name}/scalars"] = np.asarray(
            [[[getattr(s, f) if f != "is_pull" else s.direction == "pull"
               for f in spec["scalars"]] for s in r] for r in st],
            np.int64).reshape(len(st), 4, len(spec["scalars"]))
        for f in spec["arrays"]:
            out[f"{name}/{f}"] = np.asarray(
                [[getattr(s, f) for s in r] for r in st], np.int64)

for name, (app, kw, cf) in spec["refusals"].items():
    cfg = BalancerConfig(strategy="alb", threshold=64, **cf)
    c = {"app": app, "graph": "rev" if app == "pagerank" else "g"}
    sg, meta = part(c["graph"], "oec")
    kw = dict(kw)
    meta = kw.pop("meta", meta)
    try:
        call(c, cfg, sg, meta, **kw)
        out[f"refusal/{name}"] = np.asarray("no error")
    except Exception as e:
        out[f"refusal/{name}"] = np.asarray(f"{type(e).__name__}: {e}")

np.savez(sys.argv[2], **out)
print("JAX_DIST_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's cases run ops on tensors of a few thousand entries,
    which gain nothing from intra-op threads; with the suite's other
    workers on the same cores, threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """One JAX subprocess over every case (4 forced host devices)."""
    tmp = tmp_path_factory.mktemp("gluon_ref")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"cases": CASES, "refusals": REFUSALS,
                                "scalars": SCALARS, "arrays": ARRAYS}))
    out = tmp / "ref.npz"
    env = dict(os.environ)
    # one thread an op: the suite's other workers hold the other cores
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4"
                        " --xla_cpu_multi_thread_eigen=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(spec),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_DIST_OK" in proc.stdout
    return dict(np.load(out))


@pytest.fixture(scope="module")
def graphs():
    g = JG.rmat(9, 8, seed=5)
    out = {"g": g, "sym": JG.symmetrized(g), "rev": JG.reverse_graph(g),
           "c": JG.rmat(10, 8, seed=3)}
    return {k: TG.Graph.from_numpy(v.row_ptr, v.col_idx, v.edge_w,
                                   device="cpu") for k, v in out.items()}


@pytest.fixture(scope="module")
def parts(graphs, jax_ref):
    """``(graph, policy, which) -> (local graphs, meta)``, made on first
    use: the port's own partition (``which="port"``) or JAX's, carried
    across (``"jax"``), over the CPU mesh."""
    cache = {}

    def get(gk, pol, which):
        if (gk, pol, which) not in cache:
            cache[gk, pol, which] = _partition(graphs, jax_ref, gk, pol,
                                               which)
        return cache[gk, pol, which]
    return get


def _partition(graphs, ref, gk, pol, which):
    if which == "port":
        return TP.partition(graphs[gk], NDEV, pol, mesh=MESH)
    arr = {f: ref[f"part/{gk}/{pol}/{f}"]
           for f in ("row_ptr", "col_idx", "edge_w", "master_bounds",
                     "owner", "mirror_idx", "mirror_counts")}
    meta = types.SimpleNamespace(num_devices=NDEV,
                                 num_vertices=arr["owner"].shape[0], **arr)
    return TP.partitioned_from_numpy(types.SimpleNamespace(**arr), meta,
                                     mesh=MESH)


def _sources(graphs, s):
    if not isinstance(s, str):
        return s
    deg = graphs["g"].out_degrees().numpy()
    return [int(x) for x in np.argsort(-deg)[:int(s[3:])]]


def _run_port(graphs, c, local, meta, cfg=None):
    cfg = cfg or TCfg(strategy="alb", threshold=64, use_pallas=c["pallas"],
                      wire=c["wire"])
    kw = dict(sync=c["sync"], mode=c["mode"], collect_stats=c["stats"],
              meta=meta)
    app = c["app"]
    if app == "pagerank":
        return TGl.pagerank_distributed(
            local, MESH, graphs["g"].out_degrees(), cfg=cfg,
            max_rounds=c.get("rounds", 5), tol=c.get("tol", 1e-6), **kw)
    if app in ("sssp", "bfs"):
        src = TG.highest_out_degree_vertex(graphs["g"])
        return getattr(TGl, f"{app}_distributed")(local, MESH, src, cfg,
                                                  **kw)
    if app in ("sssp_batch", "bfs_batch"):
        return getattr(TGl, f"{app}_distributed")(
            local, MESH, _sources(graphs, c["srcs"]), cfg, **kw)
    if app == "cc":
        return TGl.cc_distributed(local, MESH, cfg, **kw)
    return TGl.kcore_distributed(local, MESH, 8, cfg, **kw)


def _stat_rows(stats):
    sc = np.asarray([[[getattr(s, f) if f != "is_pull"
                       else s.direction == "pull" for f in SCALARS]
                      for s in r] for r in stats], np.int64)
    return sc.reshape(len(stats), NDEV, len(SCALARS)), {
        f: np.asarray([[getattr(s, f) for s in r] for r in stats], np.int64)
        for f in ARRAYS}


def _assert_matches(ref, name, c, res, transfers):
    want = ref[f"{name}/labels"]
    got = res[0].numpy()
    if c["app"] == "pagerank":
        np.testing.assert_allclose(got, want, rtol=PR_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    assert res[1] == int(ref[f"{name}/rounds"])
    assert transfers == int(ref[f"{name}/host_transfers"])
    if not c["stats"]:
        return
    sc, arrs = _stat_rows(res[3])
    want = ref[f"{name}/scalars"]
    for f in ARRAYS:
        np.testing.assert_array_equal(arrs[f], ref[f"{name}/{f}"],
                                      err_msg=f)
    if c["app"] == "pagerank" and c["sync"] == "mirror":
        # the broadcast ring ships the vertices whose rank changed this
        # round, and ranks are XLA's only to rtol 2e-6 (ROADMAP Queue 3),
        # so a few vertices a round whose rank moves by under an ulp in
        # one package and not the other change the volume fields
        vol = [SCALARS.index(f) for f in VOLUME]
        rest = [i for i in range(len(SCALARS)) if i not in vol]
        np.testing.assert_array_equal(sc[..., rest], want[..., rest])
        for i, per_vertex in zip(vol, PR_VOLUME_BYTES):
            np.testing.assert_allclose(sc[..., i], want[..., i], rtol=0,
                                       atol=PR_VOLUME_VERTICES * per_vertex,
                                       err_msg=SCALARS[i])
        assert np.array_equal(sc[..., vol[1]], sc[..., vol[0]] * 8)
    else:
        np.testing.assert_array_equal(sc, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(jax_ref, graphs, parts, name):
    """Labels bitwise (pagerank at rtol 2e-6), rounds, host_transfers
    and every per-round, per-device RoundStats field equal to JAX's 4
    devices, on the port's own partition and on JAX's."""
    c = CASES[name]
    for which in ("port", "jax"):
        local, meta = parts(c["graph"], c["policy"], which)
        t0 = host_transfer_count()
        res = _run_port(graphs, c, local, meta)
        _assert_matches(jax_ref, name, c, res, host_transfer_count() - t0)


@pytest.mark.parametrize("gk,pol", sorted({(c["graph"], c["policy"])
                                           for c in CASES.values()}))
def test_partitions_and_stats_match_jax(jax_ref, parts, gk, pol):
    """The port's partition of each case graph is bitwise JAX's, and so
    is ``partition_stats``."""
    local, meta = parts(gk, pol, "port")
    st = local.stacked()
    for f in ("row_ptr", "col_idx", "edge_w"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      jax_ref[f"part/{gk}/{pol}/{f}"])
    for f in ("master_bounds", "owner", "mirror_idx", "mirror_counts"):
        np.testing.assert_array_equal(getattr(meta, f),
                                      jax_ref[f"part/{gk}/{pol}/{f}"])
    assert TP.partition_stats(local, meta) == json.loads(
        str(jax_ref[f"part/{gk}/{pol}/stats"]))


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_jax(jax_ref, graphs, parts, name):
    """The same exception and message as JAX, before any round runs."""
    app, kw, cf = REFUSALS[name]
    c = dict(app=app, graph="rev" if app == "pagerank" else "g",
             policy="oec", sync="replicated", mode="host", stats=False,
             wire="identity", pallas=False)
    local, meta = parts(c["graph"], "oec", "port")
    kw = dict(kw)
    c["sync"] = kw.pop("sync", c["sync"])
    c["mode"] = kw.pop("mode", c["mode"])
    c["stats"] = kw.pop("collect_stats", c["stats"])
    meta = kw.pop("meta", meta)
    cfg = TCfg(strategy="alb", threshold=64, **cf)
    t0 = host_transfer_count()
    with pytest.raises(Exception) as err:
        _run_port(graphs, c, local, meta, cfg=cfg)
    assert f"{type(err.value).__name__}: {err.value}" == str(
        jax_ref[f"refusal/{name}"])
    assert host_transfer_count() == t0


# ---- port-only properties -------------------------------------------------

def _own(graphs, gk="g", pol="oec"):
    return TP.partition(graphs[gk], NDEV, pol, mesh=MESH)


def test_fused_refuses_a_mesh_of_several_devices(graphs):
    """A CUDA graph lives on one device: fused mode on a mesh whose
    slots span devices raises, naming the case, and never runs host
    mode instead.  (The second device here is PyTorch's ``meta``
    device: the refusal comes before any computation.)"""
    local, meta = _own(graphs)
    mesh = device_mesh(2, devices=["cpu", "meta"])
    g0, g1 = local[0], local[1]
    spread = TP.LocalGraphs([g0, TG.Graph(g1.row_ptr.to("meta"),
                                          g1.col_idx.to("meta"),
                                          g1.edge_w.to("meta"))])
    for sync in ("replicated", "mirror"):
        with pytest.raises(ValueError, match="one device.*several cards"):
            TGl.sssp_distributed(spread, mesh, 0, TCfg(), sync=sync,
                                 meta=meta, mode="fused")
    with pytest.raises(ValueError, match="one device"):
        TGl.pagerank_distributed(spread, mesh, graphs["g"].out_degrees(),
                                 mode="fused")


def test_local_graph_off_its_slot_is_refused(graphs):
    local, _ = _own(graphs)
    with pytest.raises(ValueError, match="local graphs on a mesh"):
        TGl.bfs_distributed(TP.LocalGraphs(local[:2]), MESH, 0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_replicated_shared_labels_equal_private_copies(graphs, app,
                                                       use_pallas):
    """The partitions of one device share the replicated label tensor;
    a round over it equals, bitwise, the same round given a private
    copy per partition (no partition's in-place combine leaks into
    another's input), and leaves the shared tensor unchanged."""
    gk = "rev" if app == "pagerank" else "g"
    local, _ = _own(graphs, gk)
    cfg = TCfg(strategy="alb", threshold=64, use_pallas=use_pallas)
    v = local.num_vertices
    if app == "pagerank":
        op, delta = ops.PR_PULL, True
        labels = torch.zeros((v,), dtype=torch.float32)
        values = torch.rand((v,), generator=torch.Generator().manual_seed(0))
        frontier = torch.ones((v,), dtype=torch.bool)
    else:
        op, delta = ops.SSSP_RELAX, False
        res = TD.sssp(graphs["g"], 0, cfg, max_rounds=2)
        labels = res.labels
        values = labels
        frontier = labels < (1 << 30)
    round_fn = TGl.make_round_fn(MESH, cfg, op, sync_delta=delta)
    keep = labels.clone()
    shared = round_fn(local, values, labels, frontier)
    assert torch.equal(labels, keep)
    # private copies: one round per partition on its own clone, then the
    # same all-reduce
    outs = []
    for g in local:
        base = torch.zeros_like(labels) if delta else labels.clone()
        outs.append(relax_spmd(g, values.clone(), base, frontier.clone(),
                               cfg, op))
    red = outs[0]
    for o in outs[1:]:
        red = red + o if delta else torch.minimum(red, o)
    want = labels + red if delta else red
    assert torch.equal(shared, want)


@pytest.mark.parametrize("sync", ["replicated", "mirror"])
def test_fused_equals_host_bitwise_in_the_port(graphs, sync):
    """Fused mode reads the host loop's arithmetic: labels (pagerank
    ranks included) and rounds bitwise equal, 0 host transfers."""
    local, meta = _own(graphs, "rev")
    outdeg = graphs["g"].out_degrees()
    h = TGl.pagerank_distributed(local, MESH, outdeg, max_rounds=12,
                                 sync=sync, meta=meta)
    t0 = host_transfer_count()
    f = TGl.pagerank_distributed(local, MESH, outdeg, max_rounds=12,
                                 sync=sync, meta=meta, mode="fused")
    assert host_transfer_count() == t0
    assert torch.equal(h[0], f[0]) and h[1] == f[1]


def test_codecs_bitwise_identity_and_compress(graphs):
    """Every codec's bfs labels equal the identity run bitwise; delta and
    bitmap put fewer bytes on the wire than the logical volume on every
    non-final round of the batched gate workload; the logical volume is
    ``mirrors_synced * (INDEX_BYTES + B * 4)`` and below the replicated
    baseline ``B * V * 4 * D`` every round."""
    local, meta = _own(graphs, "c")
    srcs = [0, 7, 23, 99, 200, 311, 450, 512]
    v = local.num_vertices
    ident = TGl.bfs_batch_distributed(local, MESH, srcs, TCfg(threshold=64),
                                      sync="mirror", meta=meta,
                                      collect_stats=True)
    for codec in ("delta", "bitmap", "quantize"):
        res = TGl.bfs_batch_distributed(
            local, MESH, srcs, TCfg(threshold=64, wire=codec),
            sync="mirror", meta=meta, collect_stats=True)
        assert torch.equal(res[0], ident[0])
        per_round = [(sum(s.bytes_synced for s in r),
                      sum(s.bytes_wire for s in r)) for r in res[3]]
        assert res[1] >= 3
        for logical, wired in per_round[:-1]:
            assert 0 < wired < logical, (codec, per_round)
        for r in res[3]:
            for s in r:
                assert s.bytes_synced == s.mirrors_synced * (
                    TW.INDEX_BYTES + len(srcs) * 4)
            assert sum(s.bytes_synced for s in r) < len(srcs) * v * 4 * NDEV


def _trace(rng, edges, nv, n_batches, size=12):
    """Random batches of inserts, deletes and reweights (some of them
    no-ops) over the live edge dict."""
    edges = dict(edges)
    out = []
    for _ in range(n_batches):
        ups = []
        for _ in range(size):
            r, keys = float(rng.random()), list(edges)
            if r < 0.5 or not keys:
                u, v = int(rng.integers(nv)), int(rng.integers(nv))
                w = int(rng.integers(1, 20))
                ups.append(("insert", u, v, w))
                edges[(u, v)] = min(edges.get((u, v), w), w)
            elif r < 0.75:
                u, v = keys[int(rng.integers(len(keys)))]
                ups.append(("delete", u, v))
                edges.pop((u, v))
            else:
                u, v = keys[int(rng.integers(len(keys)))]
                w = int(rng.integers(1, 20))
                ups.append(("reweight", u, v, w))
                edges[(u, v)] = w
        out.append(ups)
    return out


@pytest.mark.parametrize("policy", ["oec", "cvc"])
def test_streaming_labels_match_mirror_sync(policy):
    """tests/test_streaming.py's distributed case: after a mutation
    trace, the incrementally kept labels equal a mirror-sync bfs over
    the mutated graph."""
    gj = JG.rmat(5, 3, seed=7)
    base = TG.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                               device="cpu")
    cfg = TCfg(strategy="alb", threshold=64)
    src = TG.highest_out_degree_vertex(base)
    st = TS.stream_init(TS.streaming_graph(base), "bfs", source=src,
                        cfg=cfg)
    rng = np.random.default_rng(100)
    for ups in _trace(rng, TS.edge_map(base), base.num_vertices, 3):
        TS.stream_update(st, TS.make_batch(ups, capacity=16))
    local, meta = TP.partition(TS.unpadded(st.g), NDEV, policy, mesh=MESH)
    labels, _, _, _ = TGl.bfs_distributed(local, MESH, src, cfg,
                                          collect_stats=True, sync="mirror",
                                          meta=meta)
    np.testing.assert_array_equal(labels.numpy()[:base.num_vertices],
                                  st.real_labels)
