"""Port parity of the static-shape round: ``relax_spmd`` (push on the CSR,
pull on the reverse CSR over its in-degree mask), the device-directed
``relax_spmd_directed`` and ``resolve_direction_device``, against the
JAX package on the same numpy state.  Exact: labels, every
``RoundStatsDev`` / ``RoundStats`` field, the dirty mask and the
liveness vector.  The JAX ``pallas`` pair runs its kernels in interpret
mode, as the JAX package's own tests run them on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import graph_loop as tgl
from repro_torch.core import operators as tops

STRATEGIES = ["vertex", "twc", "edge_lb", "alb"]
BACKENDS = ["xla", "pallas", "merge_path"]
# on rmat(9, 8) (degrees up to 147 out, 140 in) these bins take two
# passes: ALB's large bin (128, 139] as static passes, twc's large bin
# and the vertex strategy's one bin as a device pass count; the hub is
# ALB's huge bin.  (The JAX pallas pair strides chunks by 128 lanes
# below W = 128, ROADMAP Queue 3, so multi-pass bins stay at W = 128.)
TWO_PASS = dict(threshold=140, large_width=128)


def _port(gj):
    return tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                               device="cpu")


@pytest.fixture(scope="module")
def graphs():
    uni = jg.uniform_random(200, 6, seed=3)
    out = {"uniform": uni, "uniform_sym": jg.symmetrized(uni),
           "road": jg.road_grid(8), "rmat": jg.rmat(9, 8, seed=3)}
    return {k: (gj, _port(gj)) for k, gj in out.items()}


def _state(v, b, seed, hub=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 500, (b, v)).astype(np.int32)
    labels[rng.random((b, v)) < 0.3] = jg.INF
    frontier = rng.random((b, v)) < 0.25
    frontier[:, hub] = True
    return labels, frontier


def _cfgs(**kw):
    return jb.BalancerConfig(**kw), tb.BalancerConfig(**kw)


def _assert_dev_stats_equal(sj, st):
    assert sj._fields == st._fields
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)


def _assert_stats_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_relax_spmd_matches_jax(graphs, strategy, backend, direction):
    """One static round, B = 3, two-pass bins: labels, stats and dirty
    bitwise.  Pull runs the operator's pull twin over the cached reverse
    CSR with its in-degree ``emask``, as the fused round does."""
    gj, gt = graphs["rmat"]
    cj, ct = _cfgs(strategy=strategy, backend=backend, **TWO_PASS)
    labels, frontier = _state(gj.num_vertices, 3, 5)
    jop, top = jops.SSSP_RELAX, tops.SSSP_RELAX
    kj, kt = {}, {}
    if direction == "pull":
        pj, pt = jb._pull_enum(gj, cj), tb._pull_enum(gt, ct)
        gj, gt = pj.rg, pt.rg
        jop, top = jops.as_pull(jop), tops.as_pull(top)
        kj, kt = dict(emask=pj.emask), dict(emask=pt.emask)
    lj, sj, dj = jb.relax_spmd(gj, jnp.asarray(labels), jnp.asarray(labels),
                               jnp.asarray(frontier), cj, jop,
                               collect_stats=True, return_dirty=True, **kj)
    lt, st, dt = tb.relax_spmd(gt, torch.from_numpy(labels),
                               torch.from_numpy(labels),
                               torch.from_numpy(frontier), ct, top,
                               collect_stats=True, return_dirty=True, **kt)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    _assert_dev_stats_equal(sj, st)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_relax_spmd_directed_adaptive_matches_jax(graphs, strategy,
                                                  backend):
    """The device-directed round at default widths on the uniform graph:
    a sparse frontier (push) and a dense one (pull), B = 2; labels,
    host stats and liveness bitwise, one counted transfer each."""
    gj, gt = graphs["uniform"]
    cj, ct = _cfgs(strategy=strategy, backend=backend, threshold=16,
                   direction="adaptive")
    v = gj.num_vertices
    for seed, density in ((1, 0.02), (2, 0.6)):
        labels, _ = _state(v, 2, seed)
        frontier = np.random.default_rng(seed).random((2, v)) < density
        frontier[1] = False                       # a retired row
        frontier[0, 7] = True
        oj = jb.relax_spmd_directed(gj, jnp.asarray(labels),
                                    jnp.asarray(labels),
                                    jnp.asarray(frontier), cj,
                                    jops.SSSP_RELAX, collect_stats=True,
                                    return_active=True)
        before = tb.host_transfer_count()
        ot = tb.relax_spmd_directed(gt, torch.from_numpy(labels),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(frontier), ct,
                                    tops.SSSP_RELAX, collect_stats=True,
                                    return_active=True)
        assert tb.host_transfer_count() == before + 1
        np.testing.assert_array_equal(np.asarray(oj[0]), ot[0].numpy())
        _assert_stats_equal(oj[1], ot[1])
        np.testing.assert_array_equal(oj[2], ot[2])
        assert ot[1].direction == ("pull" if density > 0.5 else "push")


def test_relax_spmd_directed_observes_nothing_unasked(graphs):
    """Without stats or liveness the directed round fetches nothing."""
    gj, gt = graphs["road"]
    _, ct = _cfgs(direction="adaptive", threshold=16)
    labels, frontier = _state(gt.num_vertices, 1, 3)
    before = tb.host_transfer_count()
    lab, st = tb.relax_spmd_directed(gt, torch.from_numpy(labels[0]),
                                     torch.from_numpy(labels[0]),
                                     torch.from_numpy(frontier[0]), ct,
                                     tops.SSSP_RELAX)
    assert st is None and tb.host_transfer_count() == before
    assert lab.shape == (gt.num_vertices,)


@pytest.mark.parametrize("direction", ["push", "pull", "adaptive"])
def test_resolve_direction_device_matches_host(direction):
    cj, ct = _cfgs(direction=direction)
    for v, e in ((2000, 16000), (97, 5)):
        for nf in (0, 1, 83, 84, 1000):
            for mf in (0, 1, 1142, 1143, 100000):
                want = jb.resolve_direction(cj, nf, mf, v, e)
                got = tb.resolve_direction_device(
                    ct, torch.tensor(nf, dtype=torch.int32),
                    torch.tensor(mf, dtype=torch.int32), v, e)
                assert got.dtype == torch.bool and got.shape == ()
                assert bool(got) == (want == "pull")
                assert bool(got) == bool(jb.resolve_direction_device(
                    cj, jnp.int32(nf), jnp.int32(mf), v, e))


def test_graph_loop_runs_eagerly_on_the_cpu():
    """cond / while_ / repeat on CPU tensors are Python control flow,
    capture nothing, and leave the carry they are given unwritten."""
    before = tgl.captures
    x = torch.arange(4)
    got = tgl.while_(lambda i, y: i < 3, lambda i, y: (i + 1, y * 2),
                     (torch.tensor(0), x))
    assert int(got[0]) == 3 and got[1].tolist() == [0, 8, 16, 24]
    assert x.tolist() == [0, 1, 2, 3]
    assert tgl.cond(torch.tensor(False), lambda: 1, lambda: 2) == 2
    seen = []
    tgl.repeat(lambda y, i: seen.append(int(i)) or y, x, 2,
               torch.tensor(3, dtype=torch.int32))
    tgl.repeat(lambda y, i: seen.append(i) or y, x, 5, 2)
    assert seen == [2, 3, 4, 5, 6]
    assert tgl.captures == before
    with pytest.raises(RuntimeError, match="captured program"):
        tgl._recorder("cond")


@pytest.mark.parametrize("batch", [None, 3])
def test_frontier_helpers_match_jax(batch):
    """dirty_mask, dirty_vertices and rows_active against JAX's."""
    from repro.core import frontier as jf
    from repro_torch.core import frontier as tf
    rng = np.random.default_rng(11)
    shape = (200,) if batch is None else (batch, 200)
    old = rng.integers(0, 5, shape).astype(np.int32)
    new = np.where(rng.random(shape) < 0.1, old - 1, old)
    fr = rng.random(shape) < 0.02
    if batch is not None:
        fr[1] = False                              # a retired row
    for name in ("dirty_mask", "dirty_vertices"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jf, name)(jnp.asarray(old),
                                         jnp.asarray(new))),
            getattr(tf, name)(torch.from_numpy(old),
                              torch.from_numpy(new)).numpy())
    np.testing.assert_array_equal(np.asarray(jf.rows_active(jnp.asarray(fr))),
                                  tf.rows_active(torch.from_numpy(fr)).numpy())


# operators the fused kernels do not take: the pallas pair's unfused
# route (index maps + torch epilogue), as JAX's pallas pair runs them
USER_OPS = {name: (jops.Operator(name, "push", comb, msg),
                   tops.Operator(name, "push", comb, msg), dtype)
            for name, (comb, msg, dtype) in {
                "int_min_v_plus_2w": ("min", lambda v, w: v + 2 * w,
                                      np.int32),
                "float_min": ("min", lambda v, w: v + w, np.float32),
                "int_add_own_msg": ("add", lambda v, w: 3 * v - w,
                                    np.int32)}.items()}


@pytest.mark.parametrize("strategy", ["twc", "alb"])
@pytest.mark.parametrize("op", sorted(USER_OPS))
def test_relax_spmd_user_operators_match_jax(graphs, op, strategy):
    """A static round of the ``pallas`` pair with an operator the fused
    kernels do not take: the index maps with a device chunk (a WHILE
    over an unbounded bin's chunks) and a device total, then the torch
    epilogue; labels and stats bitwise against JAX's pallas pair."""
    gj, gt = graphs["rmat"]
    jop, top, dtype = USER_OPS[op]
    cj, ct = _cfgs(strategy=strategy, use_pallas=True, **TWO_PASS)
    labels, frontier = _state(gj.num_vertices, 2, 21)
    labels = labels.astype(dtype)
    if op == "int_add_own_msg":
        labels = np.minimum(labels, 1000)
    lj, sj = jb.relax_spmd(gj, jnp.asarray(labels), jnp.asarray(labels),
                           jnp.asarray(frontier), cj, jop,
                           collect_stats=True)
    lt, st = tb.relax_spmd(gt, torch.from_numpy(labels),
                           torch.from_numpy(labels),
                           torch.from_numpy(frontier), ct, top,
                           collect_stats=True)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    _assert_dev_stats_equal(sj, st)
