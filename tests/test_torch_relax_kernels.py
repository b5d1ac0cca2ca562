"""Port parity: the fused entries of the ``pallas`` executor pair
(``repro_torch.kernels.ops.twc_bin_apply`` / ``edge_lb_apply``, one
``relax.twc_bin_relax`` / ``relax.edge_lb_relax`` per pass) against the
JAX package's Pallas pair (``repro.kernels.ops``, Pallas in interpret
mode), on the same numpy inputs.

On CPU tensors the fused wrappers run their plain versions (the
reference index map plus the torch epilogue, written into ``labels``),
so the comparison is bitwise for every min-combine and int add
operator, and within ``PR_RTOL`` for pagerank's float32 add (XLA and
torch add in another order).  The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core import operators as jops
from repro.kernels import ops as jkops
from repro_torch import kernels as tk
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops
from repro_torch.core.frontier import next_bucket
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import relax as trelax

PR_RTOL = 2e-6        # as tests/test_torch_pull_apps.py holds pagerank
V = 3000
INF = int(jg.INF)
# degrees that straddle every bin width, and huge rows whose sums land
# on (4096) and off a 2048-edge tile boundary
SPECIAL_DEG = [4096, 2500, 2048, 2048, 1500, 2600, 1025, 1024, 1023, 300,
               129, 128, 127, 17, 9, 8, 7, 1, 0]
# every operator of the fused kernels, and the pull twins
OPS = ["SSSP_RELAX", "BFS_HOP", "CC_MIN", "KCORE_DEC", "PR_PULL",
       "SSSP_RELAX@pull", "BFS_HOP@pull", "CC_MIN@pull"]


def op_pair(name):
    base, _, pull = name.partition("@")
    j, t = getattr(jops, base), getattr(tops, base)
    return (jops.as_pull(j), tops.as_pull(t)) if pull else (j, t)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(11)
    deg = rng.integers(0, 30, V)
    deg[:len(SPECIAL_DEG)] = SPECIAL_DEG
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(row_ptr[-1])
    col = rng.integers(0, V, e).astype(np.int32)
    w = rng.integers(1, 101, e).astype(np.int32)
    gj = jg.Graph(jnp.asarray(row_ptr), jnp.asarray(col), jnp.asarray(w))
    gt = tg.Graph.from_numpy(row_ptr, col, w, device="cpu")
    return gj, gt, row_ptr


def state(name, b, seed):
    """(values, labels, fmask) as numpy: ``values`` equal the labels at
    round entry, as in a round; pagerank's are float32."""
    rng = np.random.default_rng(seed)
    fmask = rng.random((b, V)) < 0.6
    if name == "PR_PULL":
        values = (rng.random((b, V)) * 1e-3).astype(np.float32)
        return values, (rng.random((b, V)) * 1e-3).astype(np.float32), fmask
    labels = rng.integers(0, 500, (b, V)).astype(np.int32)
    if name != "KCORE_DEC":
        labels[rng.random((b, V)) < 0.3] = INF
    return labels.copy(), labels, fmask


def check(name, got, want, labels_t):
    assert got is labels_t            # combined in place, returned
    if name == "PR_PULL":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PR_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def bin_rows(row_ptr, rng):
    """Bin member arrays over every special vertex and some others, with
    sentinel rows (``vidx = V``, deg 0) interleaved and at the tail."""
    vid = np.concatenate([np.arange(len(SPECIAL_DEG)),
                          rng.choice(np.arange(len(SPECIAL_DEG), V), 20,
                                     replace=False)])
    rng.shuffle(vid)
    vid = np.insert(vid, [3, 11, 30], V)
    vid = np.concatenate([vid, np.full(next_bucket(len(vid)) - len(vid), V)])
    real = vid < V
    safe = np.where(real, vid, 0)
    deg = np.where(real, row_ptr[safe + 1] - row_ptr[safe], 0)
    row = np.where(real, row_ptr[safe], 0)
    return [a.astype(np.int32) for a in (vid, deg, row)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("width", [8, 128, 1024])
@pytest.mark.parametrize("chunk", [0, 1])
@pytest.mark.parametrize("b", [1, 3])
def test_twc_bin_apply_matches_pallas(graphs, op, width, chunk, b):
    gj, gt, row_ptr = graphs
    jop, top = op_pair(op)
    values, labels, fmask = state(op, b, width + chunk + b)
    bins = bin_rows(row_ptr, np.random.default_rng(width))
    if width % 128:
        # the Pallas kernel pads W=8 lanes to 128 and strides its chunks
        # by 128, a TPU artifact that no bin of the round reaches (W=8
        # bins are capped at one pass): the XLA pass has the contract
        want = jb._bin_pass_impl(gj, jnp.asarray(values), jnp.asarray(labels),
                                 jnp.asarray(fmask),
                                 *map(jnp.asarray, bins), width, jop, chunk)
    else:
        want = jkops.twc_bin_apply(gj, jnp.asarray(values),
                                   jnp.asarray(labels), jnp.asarray(fmask),
                                   *map(jnp.asarray, bins), width, jop,
                                   chunk)
    lt = torch.from_numpy(labels.copy())
    got = tkops.twc_bin_apply(gt, torch.from_numpy(values), lt,
                              torch.from_numpy(fmask),
                              *map(torch.from_numpy, bins), width, top,
                              chunk)
    check(op, got, want, lt)


# (huge vertices, total edges): on and off a 2048-edge tile boundary
HUGE = {"one_on_tile": [0], "one_off_tile": [1],
        "two_on_tile": [2, 3], "three_off_tile": [4, 5, 6]}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("huge", sorted(HUGE))
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("b", [1, 3])
def test_edge_lb_apply_matches_pallas(graphs, op, huge, distribution, b):
    gj, gt, row_ptr = graphs
    jop, top = op_pair(op)
    values, labels, fmask = state(op, b, len(huge) + b)
    hv = np.array(HUGE[huge], np.int32)
    hdeg = (row_ptr[hv + 1] - row_ptr[hv]).astype(np.int32)
    total = int(hdeg.sum())
    assert (total % 2048 == 0) == huge.endswith("on_tile")
    # sentinel slots (vidx = V, deg 0) after the huge vertices; none
    # when the bin is one vertex (H = 1)
    pad = 0 if len(hv) == 1 else next_bucket(len(hv), 4) - len(hv) + 1
    hvidx = np.concatenate([hv, np.full(pad, V)]).astype(np.int32)
    hdeg = np.concatenate([hdeg, np.zeros(pad)]).astype(np.int32)
    hrow = np.concatenate([row_ptr[hv], np.zeros(pad)]).astype(np.int32)
    ecap = next_bucket(total, minimum=2048)
    want = jkops.edge_lb_apply(gj, jnp.asarray(values), jnp.asarray(labels),
                               jnp.asarray(fmask), jnp.asarray(hvidx),
                               jnp.asarray(hdeg), jnp.asarray(hrow),
                               jnp.int32(total), ecap, jop, distribution,
                               64, 2048)
    lt = torch.from_numpy(labels.copy())
    got = tkops.edge_lb_apply(gt, torch.from_numpy(values), lt,
                              torch.from_numpy(fmask),
                              torch.from_numpy(hvidx),
                              torch.from_numpy(hdeg),
                              torch.from_numpy(hrow), total, ecap, top,
                              distribution, 64, 2048)
    check(op, got, want, lt)


def test_msg_kind_table_covers_every_operator():
    kinds = {name: tops.msg_kind(op_pair(name)[1]) for name in OPS}
    assert kinds == {"SSSP_RELAX": 0, "BFS_HOP": 1, "CC_MIN": 2,
                     "KCORE_DEC": 3, "PR_PULL": 2, "SSSP_RELAX@pull": 0,
                     "BFS_HOP@pull": 1, "CC_MIN@pull": 2}
    assert [tops.MSG_KINDS[k] for k in (0, 1, 2, 3)] == \
        ["v+w", "v+1", "v", "-1"]
    # the enum's msg is the operator's own msg
    v = torch.tensor([5, -3, 1 << 30], dtype=torch.int32)
    w = torch.tensor([7, 1, 100], dtype=torch.int32)
    expect = {0: v + w, 1: v + 1, 2: v, 3: torch.full_like(v, -1)}
    for name in OPS:
        op = op_pair(name)[1]
        assert torch.equal(op.msg(v, w), expect[tops.msg_kind(op)]), name
    other = tops.Operator("double", "push", "min", lambda v, w: 2 * v)
    with pytest.raises(ValueError, match="no msg kind"):
        tops.msg_kind(other)


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(graphs):
    _, gt, _ = graphs
    lab = torch.zeros((1, V), dtype=torch.int32)
    val, fm = lab.clone(), torch.ones((1, V), dtype=torch.bool)
    rows = [torch.zeros(4, dtype=torch.int32)] * 3
    g = (gt.col_idx, gt.edge_w)

    def twc(values, labels, fmask, op=tops.SSSP_RELAX):
        return trelax.twc_bin_relax(values, labels, fmask, *g, *rows, op,
                                    width=8)
    with pytest.raises(ValueError, match="no msg kind"):
        twc(val, lab, fm, tops.Operator("x", "push", "min", lambda v, w: v))
    with pytest.raises(TypeError, match="combine 'min'"):
        twc(val.float(), lab.float(), fm)
    with pytest.raises(TypeError, match="values"):
        twc(val.float(), lab, fm)
    with pytest.raises(TypeError, match="fmask"):
        twc(val, lab, fm.to(torch.uint8))
    with pytest.raises(ValueError, match="share memory"):
        twc(lab, lab, fm)
    with pytest.raises(ValueError, match="contiguous"):
        twc(torch.zeros((V, 2), dtype=torch.int32).t(),
            torch.zeros((2, V), dtype=torch.int32),
            torch.ones((2, V), dtype=torch.bool))
    with pytest.raises(ValueError, match="on cpu"):
        twc(val.to("meta"), lab, fm)
    with pytest.raises(ValueError, match="H >= 1"):
        trelax.edge_lb_relax(val, lab, fm, *g, *(r[:0] for r in rows), 0, 64,
                             tops.SSSP_RELAX)
    with pytest.raises(ValueError, match="distribution"):
        trelax.edge_lb_relax(val, lab, fm, *g, *rows, 0, 64,
                             tops.SSSP_RELAX, distribution="zigzag")


def test_fused_wrappers_on_cpu_count_nothing(graphs):
    _, gt, row_ptr = graphs
    tk.reset_launch_counts()
    values, labels, fmask = (torch.from_numpy(a)
                             for a in state("SSSP_RELAX", 2, 0))
    bins = [torch.from_numpy(a)
            for a in bin_rows(row_ptr, np.random.default_rng(0))]
    tkops.twc_bin_apply(gt, values, labels, fmask, *bins, 128,
                        tops.SSSP_RELAX, torch.tensor([0], dtype=torch.int32))
    tkops.edge_lb_apply(gt, values, labels, fmask, *bins, 100, 2048,
                        tops.SSSP_RELAX, "cyclic", 64, 2048)
    assert set(tk.launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def rmat_pair():
    gj = jg.rmat(9, 8, seed=3)
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                             device="cpu")
    return gj, gt


@pytest.mark.parametrize("direction", ["push", "pull"])
@pytest.mark.parametrize("batch", [None, 3])
def test_in_place_round_keeps_caller_tensors(rmat_pair, monkeypatch,
                                             direction, batch):
    """``values is labels``: the in-place pair's round leaves both
    unwritten, combines every pass into ONE private copy, and equals the
    ``xla`` pair bitwise."""
    _, gt = rmat_pair
    rng = np.random.default_rng(4)
    b = batch or 1
    labels = rng.integers(0, 500, (b, gt.num_vertices)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = INF
    frontier = rng.random(labels.shape) < 0.3
    frontier[:, 0] = True                     # the hub: a huge-bin vertex
    if batch is None:
        labels, frontier = labels[0], frontier[0]
    pallas = tb.get_executor("pallas")
    assert pallas.in_place and not tb.get_executor("xla").in_place
    seen = []

    def rec(fn):
        def entry(g, values, labels, *rest):
            seen.append((values, labels))
            return fn(g, values, labels, *rest)
        return entry
    monkeypatch.setitem(tb._REGISTRY, "pallas", tb.ExecutorPair(
        "pallas", rec(pallas.bin_host), rec(pallas.lb_host), in_place=True))
    kw = dict(strategy="alb", threshold=64, direction=direction)
    lt = torch.from_numpy(labels.copy())
    got, st = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                       tb.BalancerConfig(use_pallas=True, **kw),
                       tops.SSSP_RELAX, collect_stats=True)
    want, _ = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                       tb.BalancerConfig(**kw), tops.SSSP_RELAX)
    np.testing.assert_array_equal(lt.numpy(), labels)
    assert torch.equal(got, want)
    assert st.lb_invoked and st.edges_twc > 0 and len(seen) > 2
    copy = seen[0][1]
    assert all(lab is copy for _, lab in seen)
    assert copy.untyped_storage().data_ptr() != \
        lt.untyped_storage().data_ptr()
    assert all(val.untyped_storage().data_ptr() ==
               lt.untyped_storage().data_ptr() for val, _ in seen)


# ---- operators the fused kernels do not take: the unfused route ------------

def _user_ops(msgs):
    """The same user operators in both packages (module-level singletons,
    as operators are): none is in ``operators.msg_kind``'s table."""
    return {name: (jops.Operator(name, "push", comb, msg),
                   tops.Operator(name, "push", comb, msg), dtype)
            for name, (comb, msg, dtype) in msgs.items()}


USER_OPS = _user_ops({
    "int_min_v_plus_2w": ("min", lambda v, w: v + 2 * w, np.int32),
    "float_min": ("min", lambda v, w: v + w, np.float32),
    "int_add_own_msg": ("add", lambda v, w: 3 * v - w, np.int32)})
USER_CASES = [("int_min_v_plus_2w", "push"), ("int_min_v_plus_2w", "pull"),
              ("float_min", "push"), ("float_min", "pull"),
              ("int_add_own_msg", "push")]


@pytest.fixture(scope="module")
def road_pair():
    gj = jg.road_grid(12)
    return gj, tg.road_grid(12, device="cpu")


def _assert_stats_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)
        else:
            assert x == y, (f, x, y)


def _user_state(gv, dtype, b, seed):
    """Labels (INF / inf where unreached; small for the add), a frontier
    that holds every vertex of SPECIAL_DEG (the huge bin's rows)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 1000, (b, gv)).astype(dtype)
    if dtype == np.float32:
        labels += rng.random((b, gv)).astype(np.float32)
    labels[rng.random((b, gv)) < 0.3] = INF if dtype == np.int32 else np.inf
    frontier = rng.random((b, gv)) < 0.3
    frontier[:, :len(SPECIAL_DEG)] = True
    return labels, frontier


@pytest.mark.parametrize("op,direction", USER_CASES)
@pytest.mark.parametrize("graph", ["graphs", "road_pair"])
def test_pallas_pair_runs_user_operators_as_jax(request, op, direction,
                                                graph):
    """``relax`` through the port's ``pallas`` pair with an operator the
    fused kernels do not take equals JAX's ``pallas`` pair (Pallas in
    interpret mode) bitwise: labels and every ``RoundStats`` field.  The
    operator-chosen route is counted, and no fused launch is."""
    gj, gt = request.getfixturevalue(graph)[:2]
    jop, top, dtype = USER_OPS[op]
    assert not trelax.takes(top, torch.from_numpy(np.zeros(1, dtype)).dtype)
    labels, frontier = _user_state(gj.num_vertices, dtype, 2,
                                   len(op) + len(direction))
    kw = dict(strategy="alb", direction=direction, use_pallas=True)
    out_j = jb.relax(gj, jnp.asarray(labels), jnp.asarray(labels),
                     jnp.asarray(frontier), jb.BalancerConfig(**kw), jop,
                     collect_stats=True)
    tk.reset_launch_counts()
    lt = torch.from_numpy(labels.copy())
    out_t = tb.relax(gt, lt, lt, torch.from_numpy(frontier),
                     tb.BalancerConfig(**kw), top, collect_stats=True)
    assert tkops.unfused_passes > 0
    assert set(tk.launch_counts().values()) == {0}
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    _assert_stats_equal(out_j[1], out_t[1])
    assert out_t[1].direction == direction
    np.testing.assert_array_equal(lt.numpy(), labels)
    assert out_t[1].edges_twc > 0
    if graph == "graphs" and direction == "push":   # the hubs' out-edges
        assert out_t[1].lb_invoked
    tk.reset_launch_counts()
    assert tkops.unfused_passes == 0


@pytest.mark.parametrize("op", OPS)
def test_builtin_operators_never_take_the_unfused_route(graphs, op):
    """Every operator of the fused kernels, and the pull twins, on the
    labels they run on: ``takes`` holds and a round of the ``pallas``
    pair counts no unfused pass."""
    _, gt, _ = graphs
    top = op_pair(op)[1]
    values, labels, fmask = state(op.partition("@")[0], 2, 9)
    assert trelax.takes(top, torch.from_numpy(labels).dtype)
    tk.reset_launch_counts()
    fr = torch.from_numpy(fmask)
    fr[:, :len(SPECIAL_DEG)] = True
    g = gt.reverse() if top.direction == "pull" else gt
    out, st = tb.relax(g, torch.from_numpy(values), torch.from_numpy(labels),
                       fr, tb.BalancerConfig(strategy="alb",
                                             use_pallas=True),
                       top, collect_stats=True)
    assert st.edges_twc > 0
    assert st.lb_invoked or top.direction == "pull"   # hubs: out-edges
    assert tkops.unfused_passes == 0


def test_takes_answers_without_raising():
    other = tops.Operator("double", "push", "min", lambda v, w: 2 * v)
    assert not trelax.takes(other, torch.int32)
    assert not trelax.takes(tops.as_pull(other), torch.int32)
    assert not trelax.takes(tops.SSSP_RELAX, torch.float32)   # float min
    assert not trelax.takes(tops.KCORE_DEC, torch.int64)
    assert trelax.takes(tops.SSSP_RELAX, torch.int32)
    assert trelax.takes(tops.as_pull(tops.BFS_HOP), torch.int32)
    assert trelax.takes(tops.PR_PULL, torch.float32)
