"""The merge-path pair's fused pass (``kernels.relax.merge_path_relax``)
and its drivers, on the CPU, against the JAX package.

* The plain version (``ref.merge_path_relax_ref``, what the wrapper runs
  on CPU tensors) against JAX's ``merge_path_apply_static`` (its Pallas
  map in interpret mode, as the JAX tests run it): push and pull, B in
  {1, 3}, int32 min and int32 add bitwise, float32 add within
  ``FLOAT_RTOL``, tiles of 128, 256 and 2048 ids, slot layouts over V
  rows (zero-degree runs) and listed ones bounded by ``rows`` (junk past
  the count, as the listing kernel leaves it), total 0 and ragged
  tails.
* The port's ``merge_path`` drivers (bfs, sssp, sssp_batch, cc, kcore,
  pagerank) in host, spmd and fused mode against JAX's
  ``backend="merge_path"``: labels, rounds, ``host_transfers`` and every
  ``RoundStats`` field bitwise (pagerank's ranks within ``PR_RTOL``),
  with ``merge_path_relax`` called once a round and ``merge_path_map``
  never.
* A user operator outside ``operators.msg_kind``'s table through the
  pair's unfused route (``merge_path_map`` and the torch epilogue),
  bitwise JAX's, counted in ``ops.unfused_passes``.

The CUDA kernel is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro.core.apps import drivers as jd
from repro.kernels import ops as jkops
from repro_torch import kernels as tk
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops
from repro_torch.core.apps import drivers as td
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import relax as trelax

# float32 add: torch's index_add_ and XLA's scatter-add sum a vertex's
# candidates in other orders (as tests/test_torch_fused.py holds
# pagerank's ranks)
FLOAT_RTOL = 2e-6
PR_RTOL = 2e-6
OPS = ["SSSP_RELAX", "SSSP_RELAX@pull", "CC_MIN", "KCORE_DEC", "PR_PULL"]


def _port(gj):
    return tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                               device="cpu")


@pytest.fixture(scope="module")
def graphs():
    rm = jg.rmat(9, 8, seed=3)
    uni = jg.uniform_random(200, 6, seed=3)
    out = {"rmat": rm, "rmat_rev": rm.reverse(), "uniform": uni,
           "uniform_sym": jg.symmetrized(uni)}
    return {k: (gj, _port(gj)) for k, gj in out.items()}


def _ops(name):
    base, _, pull = name.partition("@")
    jop, top = getattr(jops, base), getattr(tops, base)
    return (jops.as_pull(jop), tops.as_pull(top)) if pull else (jop, top)


def _state(name, b, v, seed):
    """``(values, labels, fmask)`` as numpy: int32 labels with INF
    entries (values the same), small float32 ones for PR_PULL."""
    rng = np.random.default_rng(seed)
    fmask = rng.random((b, v)) < 0.6
    if name == "PR_PULL":
        return ((rng.random((b, v)) * 1e-3).astype(np.float32),
                (rng.random((b, v)) * 1e-3).astype(np.float32), fmask)
    lab = rng.integers(0, 500, (b, v)).astype(np.int32)
    lab[rng.random((b, v)) < 0.3] = jg.INF
    return lab.copy(), lab, fmask


def _layout(gj, layout, seed):
    """``(hvidx, hdeg, hrow, n)`` of one slot layout (int32 numpy, V
    slots) and its member count ``n``: ``"v_rows"``, a member mask laid
    over V rows (sentinel V, degree 0 off it: zero-degree runs);
    ``"list"`` / ``"ragged"``, the members compacted to the front in
    vertex order with the padding a plain listing writes; ``"empty"``,
    no member (total 0)."""
    v = gj.num_vertices
    deg = np.diff(np.asarray(gj.row_ptr)).astype(np.int32)
    row = np.asarray(gj.row_ptr)[:-1].astype(np.int32)
    rng = np.random.default_rng(seed)
    member = (rng.random(v) < 0.4) & (deg > 0) & (layout != "empty")
    if layout == "v_rows":
        return (np.where(member, np.arange(v), v).astype(np.int32),
                np.where(member, deg, 0).astype(np.int32),
                np.where(member, row, 0).astype(np.int32), v)
    at = np.flatnonzero(member)
    n = len(at)
    hvidx, hdeg, hrow = (np.full(v, v, np.int32), np.zeros(v, np.int32),
                         np.zeros(v, np.int32))
    hvidx[:n], hdeg[:n], hrow[:n] = at, deg[at], row[at]
    return hvidx, hdeg, hrow, n


def _junk(a, n, seed):
    """``a`` with its entries past ``n`` overwritten, as the listing
    kernel leaves a list's rows past its count unwritten."""
    out = a.copy()
    out[n:] = np.random.default_rng(seed).integers(0, 1 << 20, len(a) - n)
    return out


@pytest.mark.parametrize("layout", ["v_rows", "list", "empty", "ragged"])
@pytest.mark.parametrize("tile_edges", [128, 256, 2048])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_jax_merge_path_apply_static(graphs, op, b,
                                                   tile_edges, layout):
    """The plain version against JAX's static merge-path entry on the
    same numpy inputs: over V rows, JAX's own layout; over a list, the
    port's slots past ``rows`` (a device-style int32) hold junk, where
    JAX's hold the plain listing's padding.  ``ecap`` is every edge of
    the graph (the static span), or the total itself (``"ragged"``: a
    tail tile past the total)."""
    jop, top = _ops(op)
    gj, gt = graphs["rmat_rev" if jop.direction == "pull" else "rmat"]
    v, e = gj.num_vertices, gj.num_edges
    hvidx, hdeg, hrow, n = _layout(gj, layout, len(op) + b)
    total = int(hdeg.sum())
    ecap = total if layout == "ragged" else e
    values, labels, fmask = _state(op.partition("@")[0], b, v, tile_edges)
    want = jkops.merge_path_apply_static(
        gj, jnp.asarray(values), jnp.asarray(labels), jnp.asarray(fmask),
        jnp.asarray(hvidx), jnp.asarray(hdeg), jnp.asarray(hrow),
        jnp.int32(total), ecap, jop, "cyclic", 64, tile_edges)
    start_e = (np.cumsum(hdeg) - hdeg).astype(np.int32)
    rows = None
    if layout != "v_rows":
        rows = torch.tensor([n], dtype=torch.int32)
        hvidx, start_e, hrow = (_junk(a, n, i)
                                for i, a in enumerate((hvidx, start_e, hrow)))
    lab = torch.from_numpy(labels.copy())
    got = tref.merge_path_relax_ref(
        torch.from_numpy(values), lab, torch.from_numpy(fmask), gt.col_idx,
        gt.edge_w, *(torch.from_numpy(a) for a in (hvidx, start_e, hrow)),
        torch.tensor(total, dtype=torch.int32), ecap, top,
        tile_edges=tile_edges, rows=rows)
    assert got is lab
    if op == "PR_PULL":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLOAT_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if layout == "empty":
        np.testing.assert_array_equal(got.numpy(), labels)


def test_wrapper_runs_the_plain_version_and_checks(graphs):
    """On CPU tensors the wrapper is the plain version and counts no
    launch; a host-int total equals a tensor one, and a host-int row
    bound a tensor one; it refuses what the kernel does not take."""
    gj, gt = graphs["rmat"]
    v, e = gj.num_vertices, gj.num_edges
    hvidx, hdeg, hrow, n = _layout(gj, "list", 4)
    start_e = np.cumsum(hdeg) - hdeg
    t = [torch.from_numpy(a.astype(np.int32))
         for a in (hvidx, start_e, hrow)]
    total = int(hdeg.sum())
    values, labels, fmask = (torch.from_numpy(a)
                             for a in _state("SSSP_RELAX", 2, v, 1))
    args = (values, fmask, gt.col_idx, gt.edge_w, *t)

    def call(lab, tot, **kw):
        return trelax.merge_path_relax(args[0], lab, *args[1:], tot, e,
                                       tops.SSSP_RELAX, **kw)
    tk.reset_launch_counts()
    want = tref.merge_path_relax_ref(values, labels.clone(), *args[1:],
                                     total, e, tops.SSSP_RELAX)
    assert not torch.equal(want, labels)
    for tot in (total, torch.tensor([total], dtype=torch.int32)):
        for rows in (None, n, torch.tensor([n], dtype=torch.int32)):
            assert torch.equal(call(labels.clone(), tot, rows=rows), want)
    assert torch.equal(call(labels.clone(), total, rows=0), labels)
    assert torch.equal(call(labels.clone(), 0), labels)
    assert tk.launch_counts()["merge_path_relax"] == 0
    with pytest.raises(ValueError, match="multiple of 128"):
        call(labels.clone(), total, tile_edges=100)
    with pytest.raises(ValueError, match="H >= 1"):
        trelax.merge_path_relax(values, labels.clone(), fmask, gt.col_idx,
                                gt.edge_w, *(x[:0] for x in t), 0, e,
                                tops.SSSP_RELAX)
    with pytest.raises(TypeError, match="start_e"):
        trelax.merge_path_relax(values, labels.clone(), fmask, gt.col_idx,
                                gt.edge_w, t[0], t[1].long(), t[2], total,
                                e, tops.SSSP_RELAX)
    with pytest.raises(ValueError, match="share memory"):
        trelax.merge_path_relax(labels, labels, *args[1:], total, e,
                                tops.SSSP_RELAX)
    user = tops.Operator("double", "push", "min", lambda v, w: 2 * v)
    with pytest.raises(ValueError, match="msg kind"):
        trelax.merge_path_relax(values, labels.clone(), *args[1:], total, e,
                                user)


# ---- the drivers: host, spmd and fused mode against JAX's ---------------

def _assert_stats_equal(sj, st):
    assert (sj is None) == (st is None)
    if sj is None:
        return
    assert len(sj) == len(st)
    for a, b in zip(sj, st):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)


def _assert_same_run(rj, rt, rtol=None):
    if rtol is None:
        np.testing.assert_array_equal(np.asarray(rj.labels),
                                      rt.labels.numpy())
    else:
        np.testing.assert_allclose(rt.labels.numpy(), np.asarray(rj.labels),
                                   rtol=rtol, atol=0)
    assert (rj.rounds, rj.host_transfers) == (rt.rounds, rt.host_transfers)
    _assert_stats_equal(rj.stats, rt.stats)


def _count_calls(monkeypatch):
    """Count the calls of the merge-path pair's two kernels."""
    from repro_torch.kernels import merge_path as tmp
    calls = {"merge_path_relax": 0, "merge_path_map": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, call)
    counted(trelax, "merge_path_relax")
    counted(tmp, "merge_path_map")
    return calls


# (graph, direction, driver call): every driver through the merge-path
# pair, in every direction it takes
DRIVERS = {
    "bfs": ("uniform", "adaptive",
            lambda d, g, c, m: d.bfs(g, 5, c, mode=m, collect_stats=True)),
    "sssp": ("rmat", "push",
             lambda d, g, c, m: d.sssp(g, 0, c, mode=m, collect_stats=True)),
    "sssp-pull": ("uniform", "pull",
                  lambda d, g, c, m: d.sssp(g, 3, c, mode=m,
                                            collect_stats=True)),
    "sssp_batch": ("rmat", "adaptive",
                   lambda d, g, c, m: d.sssp_batch(g, [0, 5, 99, 150], c,
                                                   mode=m,
                                                   collect_stats=True)),
    "cc": ("uniform_sym", "adaptive",
           lambda d, g, c, m: d.cc(g, c, mode=m, collect_stats=True)),
    "kcore": ("uniform_sym", "push",
              lambda d, g, c, m: d.kcore(g, 9, c, mode=m,
                                         collect_stats=True)),
    "pagerank": ("rmat", "push",
                 lambda d, g, c, m: d.pagerank(g, cfg=c, mode=m,
                                               max_rounds=15,
                                               collect_stats=True)),
}


@pytest.mark.parametrize("mode", ["host", "spmd", "fused"])
@pytest.mark.parametrize("app", sorted(DRIVERS))
def test_merge_path_driver_matches_jax(graphs, monkeypatch, app, mode):
    """Labels, rounds, ``host_transfers`` and every ``RoundStats`` field
    bitwise JAX's ``backend="merge_path"`` (pagerank's ranks within
    ``PR_RTOL``); built-in operators launch ``merge_path_relax`` (once
    a round with an LB member in host mode) and never ``merge_path_map``,
    and no pass takes the unfused route."""
    name, direction, run = DRIVERS[app]
    gj, gt = graphs[name]
    kw = dict(backend="merge_path", direction=direction)
    rj = run(jd, gj, jb.BalancerConfig(**kw), mode)
    calls = _count_calls(monkeypatch)
    tk.reset_launch_counts()
    rt = run(td, gt, tb.BalancerConfig(**kw), mode)
    _assert_same_run(rj, rt, rtol=PR_RTOL if app == "pagerank" else None)
    assert calls["merge_path_map"] == 0 and tkops.unfused_passes == 0
    assert calls["merge_path_relax"] > 0
    if mode == "host" and rt.stats is not None:
        assert calls["merge_path_relax"] == sum(s.lb_invoked
                                                for s in rt.stats)


# a user operator: int32 min with a msg outside msg_kind's table
USER_J = jops.Operator("v_plus_2w", "push", "min", lambda v, w: v + 2 * w)
USER_T = tops.Operator("v_plus_2w", "push", "min", lambda v, w: v + 2 * w)


@pytest.mark.parametrize("mode", ["host", "spmd", "fused"])
def test_user_operator_takes_the_unfused_route_as_jax(graphs, monkeypatch,
                                                      mode):
    """``resume_loop`` with an operator the fused kernel does not take:
    the pair runs ``merge_path_map`` and the torch epilogue, copied into
    its labels, counted in ``ops.unfused_passes`` (once a round with an
    LB member in host mode); labels, rounds, ``host_transfers`` and
    stats bitwise JAX's merge-path pair."""
    gj, gt = graphs["rmat"]
    assert not trelax.takes(USER_T, torch.int32)
    v = gj.num_vertices
    labels = np.full(v, jg.INF, np.int32)
    labels[[0, 7]] = 0
    frontier = labels == 0
    kw = dict(backend="merge_path")
    rj = jd.resume_loop(gj, jnp.asarray(labels), jnp.asarray(frontier),
                        jb.BalancerConfig(**kw), USER_J, mode=mode,
                        collect_stats=True)
    calls = _count_calls(monkeypatch)
    tk.reset_launch_counts()
    rt = td.resume_loop(gt, torch.from_numpy(labels),
                        torch.from_numpy(frontier), tb.BalancerConfig(**kw),
                        USER_T, mode=mode, collect_stats=True)
    _assert_same_run(rj, rt)
    assert rt.rounds > 1
    assert calls["merge_path_relax"] == 0
    assert calls["merge_path_map"] == tkops.unfused_passes > 0
    if mode == "host":
        assert tkops.unfused_passes == sum(s.lb_invoked for s in rt.stats)
    tk.reset_launch_counts()
    assert tkops.unfused_passes == 0
