"""Port parity: cc, kcore and pagerank, the direction-optimizing rounds
and the merge-path backend of ``repro_torch`` against the JAX drivers,
on the same CSR.

Exact for the integer apps: labels, rounds, every per-round
``RoundStats`` field (``direction`` included) and ``host_transfers``,
for push / pull / adaptive x the ``xla`` (torch-ops), ``pallas`` (the
kernel pair, plain versions on CPU tensors; Pallas in interpret mode on
the JAX side) and ``merge_path`` backends.

pagerank is float32 and held within a stated tolerance: XLA's CPU
compiler contracts ``(1 - d)/n + d * (acc + dangling/n)`` into one FMA,
while the port rounds the product and the sum apart (it equals a
float32 numpy evaluation of the formula bitwise), so each round may
differ by one rounding of the update (``test_pr_round_math_rounding``
shows both); over 30 rounds the ranks differ in the last bits, and the
tests allow ``rtol=2e-6``.  Rounds and ``host_transfers`` (2 per round)
are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro.core.apps import drivers as jd
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops
from repro_torch.core.apps import drivers as td

BACKENDS = ["xla", "pallas", "merge_path"]
DIRECTIONS = ["push", "pull", "adaptive"]
PR_RTOL = 2e-6


@pytest.fixture(scope="module")
def rmat_pair():
    gj = jg.rmat(9, 8, seed=3)
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                             device="cpu")
    return gj, gt, jg.highest_out_degree_vertex(gj)


@pytest.fixture(scope="module")
def sym_pair(rmat_pair):
    gj, gt, _ = rmat_pair
    return jg.symmetrized(gj), tg.symmetrized(gt)


def assert_same_stats(rj, rt):
    assert len(rt.stats) == len(rj.stats) == rt.rounds
    for sj, st in zip(rj.stats, rt.stats):
        for f in sj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          np.asarray(getattr(sj, f)),
                                          err_msg=f)


def assert_same_result(rj, rt, transfers_per_round=1, extra=1):
    assert rt.labels.dtype == torch.int32
    np.testing.assert_array_equal(rt.labels.numpy(), np.asarray(rj.labels))
    assert rt.rounds == rj.rounds
    assert rt.host_transfers == rj.host_transfers == \
        transfers_per_round * rt.rounds + extra
    assert_same_stats(rj, rt)


def cfgs(**kw):
    return jb.BalancerConfig(**kw), tb.BalancerConfig(**kw)


# ---- min-combine apps x direction x backend ---------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("app", ["sssp", "bfs", "bfs_batch"])
def test_traversals_directions_match_jax(rmat_pair, app, direction,
                                         backend):
    gj, gt, src = rmat_pair
    arg = [src, 1, 2, gj.num_vertices - 1] if app.endswith("_batch") \
        else src
    cj, ct = cfgs(strategy="alb", threshold=64, backend=backend)
    rj = getattr(jd, app)(gj, arg, cj, collect_stats=True,
                          direction=direction)
    rt = getattr(td, app)(gt, arg, ct, collect_stats=True,
                          direction=direction)
    assert_same_result(rj, rt)
    if direction != "push":
        assert any(s.direction == "pull" for s in rt.stats)
    push = getattr(td, app)(gt, arg, tb.BalancerConfig(threshold=64))
    assert torch.equal(rt.labels, push.labels)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cc_matches_jax(sym_pair, direction, backend):
    sj, st = sym_pair
    cj, ct = cfgs(strategy="alb", threshold=64, backend=backend)
    rj = jd.cc(sj, cj, collect_stats=True, direction=direction)
    rt = td.cc(st, ct, collect_stats=True, direction=direction)
    assert_same_result(rj, rt)
    if direction == "adaptive":      # cc's dense first frontier pulls
        assert rt.stats[0].direction == "pull"


@pytest.mark.parametrize("direction", ["push", "adaptive"])
@pytest.mark.parametrize("strategy", ["twc", "edge_lb"])
def test_cc_on_road_grid_matches_jax(direction, strategy):
    """Many rounds, thinning frontiers: adaptive flips to push."""
    gj, gt = jg.road_grid(10), tg.road_grid(10, device="cpu")
    cj, ct = cfgs(strategy=strategy)
    rj = jd.cc(gj, cj, collect_stats=True, direction=direction)
    rt = td.cc(gt, ct, collect_stats=True, direction=direction)
    assert_same_result(rj, rt)
    assert rt.rounds > 10


def test_cc_matches_scipy_components(sym_pair):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    _, st = sym_pair
    v = st.num_vertices
    m = csr_matrix((np.ones(st.num_edges), st.col_idx.numpy(),
                    st.row_ptr.numpy()), shape=(v, v))
    _, comp = connected_components(m, directed=False)
    # min-id label of each component
    first = np.full(comp.max() + 1, v, np.int64)
    np.minimum.at(first, comp, np.arange(v))
    got = td.cc(st, tb.BalancerConfig(backend="merge_path"),
                direction="adaptive").labels.numpy()
    np.testing.assert_array_equal(got, first[comp])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [2, 4, 9])
def test_kcore_matches_jax(sym_pair, k, backend):
    sj, st = sym_pair
    cj, ct = cfgs(strategy="alb", threshold=64, backend=backend)
    rj = jd.kcore(sj, k, cj, collect_stats=True)
    rt = td.kcore(st, k, ct, collect_stats=True)
    assert_same_result(rj, rt)


def test_kcore_matches_peeling_oracle(sym_pair):
    _, st = sym_pair
    rp, ci = st.row_ptr.numpy(), st.col_idx.numpy()
    deg = np.diff(rp).astype(np.int64)
    alive = np.ones(st.num_vertices, bool)
    while True:
        dead = np.flatnonzero(alive & (deg < 4))
        if dead.size == 0:
            break
        alive[dead] = False
        for v in dead:
            deg[ci[rp[v]:rp[v + 1]]] -= 1
    got = td.kcore(st, 4, tb.BalancerConfig(use_pallas=True)).labels
    np.testing.assert_array_equal(got.numpy(), alive.astype(np.int32))


@pytest.mark.parametrize("direction", ["pull", "adaptive"])
def test_kcore_and_pagerank_reject_direction(sym_pair, direction):
    sj, st = sym_pair
    cj, ct = cfgs(direction=direction)
    for fj, ft in ((lambda: jd.kcore(sj, 4, cj), lambda: td.kcore(st, 4, ct)),
                   (lambda: jd.pagerank(sj, cfg=cj, max_rounds=2),
                    lambda: td.pagerank(st, cfg=ct, max_rounds=2))):
        with pytest.raises(ValueError):
            fj()
        with pytest.raises(ValueError, match="push min-combine"):
            ft()


# ---- pagerank ---------------------------------------------------------------

def np_pagerank(rp, ci, n, damping=0.85, iters=30):
    """float64 power iteration with dangling mass redistributed
    (tests/test_strategies.py's oracle)."""
    outdeg = np.diff(rp)
    src = np.repeat(np.arange(n), outdeg)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        acc = np.zeros(n)
        np.add.at(acc, ci, rank[src] * inv[src])
        rank = (1 - damping) / n + damping * (
            acc + rank[outdeg == 0].sum() / n)
    return rank


def test_pr_round_math_rounding():
    """The port's update is the float32 formula with every operation
    rounded; the JAX package's equals it with ``c + d * x`` fused into
    one FMA (emulated exactly here: the float64 product of two float32
    values is exact, then one rounding to float32)."""
    rng = np.random.default_rng(0)
    n, d = 512, 0.85
    rank = rng.random(n).astype(np.float32)
    rank /= rank.sum()
    inv = rng.random(n).astype(np.float32)
    sink = rng.random(n) < 0.2
    acc = (rng.random(n) * 1e-3).astype(np.float32)
    args = [rank, inv, sink]
    cj, dj = jd._pr_round_math(*map(jnp.asarray, args), None, d)
    ct, dt = td._pr_round_math(*map(torch.from_numpy, args), None, d)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert float(dt) == float(dj)
    nj, _ = jd._pr_round_math(*map(jnp.asarray, args + [acc]), d)
    nt, _ = td._pr_round_math(*map(torch.from_numpy, args + [acc]), d)
    x = acc + np.float32(dt) / np.float32(n)
    c = np.float32((1.0 - d) / n)
    np.testing.assert_array_equal(nt.numpy(), c + np.float32(d) * x)
    fma = (np.float64(np.float32(d)) * x.astype(np.float64)
           + np.float64(c)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(nj), fma)
    assert not np.array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("make", [
    lambda m, **k: m.rmat(9, 8, seed=3, **k),
    lambda m, **k: m.uniform_random(300, avg_degree=3, seed=5, **k),
], ids=["rmat9", "uniform300_sinks"])
def test_pagerank_matches_jax(make, backend):
    gj, gt = make(jg), make(tg, device="cpu")
    cj, ct = cfgs(strategy="alb", threshold=64, backend=backend)
    rj = jd.pagerank(gj, tol=0.0, cfg=cj, max_rounds=30,
                     collect_stats=True)
    rt = td.pagerank(gt, tol=0.0, cfg=ct, max_rounds=30,
                     collect_stats=True)
    assert rt.labels.dtype == torch.float32
    np.testing.assert_allclose(rt.labels.numpy(), np.asarray(rj.labels),
                               rtol=PR_RTOL, atol=0)
    assert rt.rounds == rj.rounds == 30
    assert rt.host_transfers == rj.host_transfers == 2 * rt.rounds
    assert_same_stats(rj, rt)
    rank = rt.labels.numpy()
    np.testing.assert_allclose(
        rank, np_pagerank(gt.row_ptr.numpy(), gt.col_idx.numpy(),
                          gt.num_vertices), rtol=2e-4)
    assert abs(float(rank.sum()) - 1.0) < 1e-4


def test_pagerank_tolerance_stops_like_jax(rmat_pair):
    gj, gt, _ = rmat_pair
    rj = jd.pagerank(gj, tol=1e-6)
    rt = td.pagerank(gt, tol=1e-6, rg=gt.reverse())
    assert rt.rounds == rj.rounds < 1000
    assert rt.host_transfers == rj.host_transfers == 2 * rt.rounds
    np.testing.assert_allclose(rt.labels.numpy(), np.asarray(rj.labels),
                               rtol=PR_RTOL, atol=0)


# ---- resumable loop, serving step -------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_resume_loop_matches_jax(rmat_pair, direction, backend):
    """Resume sssp from a partial state: a few rounds, then the rest."""
    gj, gt, src = rmat_pair
    cj, ct = cfgs(strategy="alb", threshold=64, backend=backend)
    part = td.sssp(gt, src, ct, max_rounds=2)
    lab0 = td.sssp(gt, src, ct, max_rounds=1).labels
    frontier = part.labels < lab0
    rj = jd.resume_loop(gj, jnp.asarray(part.labels.numpy()),
                        jnp.asarray(frontier.numpy()), cj, jops.SSSP_RELAX,
                        collect_stats=True, direction=direction)
    rt = td.resume_loop(gt, part.labels, frontier, ct, tops.SSSP_RELAX,
                        collect_stats=True, direction=direction)
    assert_same_result(rj, rt)
    assert torch.equal(rt.labels, td.sssp(gt, src, ct).labels)
    with pytest.raises(ValueError, match="min-combine"):
        td.resume_loop(gt, part.labels, frontier, ct, tops.KCORE_DEC)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_step_batch_matches_jax(rmat_pair, direction):
    gj, gt, src = rmat_pair
    cj, ct = cfgs(strategy="alb", threshold=64, direction=direction)
    assert td.QUERY_APPS.keys() == jd.QUERY_APPS.keys()
    for name, (op, fill) in td.QUERY_APPS.items():
        jop, jfill = jd.QUERY_APPS[name]
        assert op.name == jop.name and int(fill) == int(jfill)
    from repro.core.frontier import multi_source_state as jms
    from repro_torch.core.frontier import multi_source_state as tms
    sources = [src, 3, 100]
    lj, fj = jms(gj.num_vertices, sources, jg.INF)
    lt, ft = tms(gt.num_vertices, sources, tg.INF, "cpu")
    for _ in range(4):
        lj, fj, sj = jd.step_batch(gj, lj, fj, cj, jops.SSSP_RELAX,
                                   collect_stats=True)
        lt, ft, st = td.step_batch(gt, lt, ft, ct, tops.SSSP_RELAX,
                                   collect_stats=True)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        for f in sj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          np.asarray(getattr(sj, f)))
    with pytest.raises(ValueError, match="min-combine"):
        td.step_batch(gt, lt, ft, ct, tops.KCORE_DEC)
