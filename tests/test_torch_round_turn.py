"""The fused min-combine loop's turn, ``kernels.relax.round_turn``.

Its plain version (``ref.round_turn_ref``, which the wrapper runs on CPU
tensors) bitwise against the torch ops the loop ran before it: ``new <
lab``, ``count(union_frontier(.))``, ``where(union, out_degrees,
0).sum(int32)`` and ``lab := new``; the fused sssp / bfs / sssp_batch /
bfs_batch loops in every direction through every executor pair against
the JAX package's ``run_fused`` (labels, rounds and every ``RoundStats``
field bitwise, a ``max_rounds`` cut-off too); and that the fused min
loop's body reads nothing V-wide of its own (no union frontier, no
out-degrees, no labels copy) while kcore's and pagerank's loops and the
spmd round still do.  The kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro.core import balancer as jb
from repro.core import graph as jg
from repro.core.apps import drivers as jd
from repro_torch.core import balancer as tb
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops
from repro_torch.core.apps import drivers as td
from repro_torch.core.frontier import count, union_frontier
from repro_torch.kernels import ref as tref
from repro_torch.kernels import relax as trelax

INT32_MAX = np.iinfo(np.int32).max


def _csr(v, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, v)
    deg[rng.random(v) < 0.05] = 3000        # a few hubs
    return torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                            .astype(np.int32))


def _state(shape, density, seed, top=False):
    """``(lab, new)``: ``new <= lab``, lowered at ``density`` of the
    labels; ``top`` puts every label at INT32_MAX first."""
    rng = np.random.default_rng(seed)
    lab = (np.full(shape, INT32_MAX, np.int32) if top else
           rng.integers(0, 1 << 30, shape).astype(np.int32))
    low = rng.random(shape) < density
    new = np.where(low, lab - rng.integers(1, 1 << 20, shape), lab)
    return torch.from_numpy(lab), torch.from_numpy(new.astype(np.int32))


def _torch_ops(lab, new, row_ptr):
    """What the fused loop computed with torch ops before the kernel:
    the next frontier, its census over the batch, the next labels."""
    fr = new < lab
    union = union_frontier(fr)
    deg = row_ptr[1:] - row_ptr[:-1]
    return (fr, count(union), torch.where(union, deg, 0)
            .sum(dtype=torch.int32), new.clone())


SHAPES = {"V": lambda v: (v,), "B1": lambda v: (1, v),
          "B3": lambda v: (3, v), "B8": lambda v: (8, v)}


@pytest.mark.parametrize("v", [1, 1000, 4099])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("density", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("top", [False, True])
def test_round_turn_ref_matches_torch_ops(v, shape, density, top):
    """Bitwise: the frontier, ``n_f``, ``m_f`` and the labels, in place,
    at no, sparse and every label lowered, labels at INT32_MAX, V not a
    multiple of the kernel's 4,096-vertex tile; the census scratch stays
    0."""
    row_ptr = _csr(v, 1)
    lab, new = _state(SHAPES[shape](v), density, 2, top)
    fr_want, nf, mf, lab_want = _torch_ops(lab, new, row_ptr)
    fr = torch.ones(lab.shape, dtype=torch.bool)
    census = trelax.census_buffer("cpu")
    got = tref.round_turn_ref(lab, new, row_ptr, fr, census)
    assert got is census
    assert torch.equal(fr, fr_want)
    assert torch.equal(lab, lab_want)
    assert census.tolist() == [int(nf), int(mf), 0, 0, 0]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("density", [0.0, 0.01, 1.0])
def test_round_turn_census_entry_matches_torch_ops(shape, density):
    """With no labels the kernel takes the census of the frontier it is
    given, and writes nothing else."""
    v = 4099
    row_ptr = _csr(v, 3)
    rng = np.random.default_rng(4)
    fr = torch.from_numpy(rng.random(SHAPES[shape](v)) < density)
    union = union_frontier(fr)
    want = [int(count(union)),
            int(torch.where(union, row_ptr[1:] - row_ptr[:-1], 0)
                .sum(dtype=torch.int32))]
    keep = fr.clone()
    census = trelax.round_turn(None, None, row_ptr, fr,
                               trelax.census_buffer("cpu"))
    assert census.tolist() == want + [0, 0, 0]
    assert torch.equal(fr, keep)


def test_round_turn_wraps_the_degree_sum_as_int32():
    """``m_f`` is an int32 sum, as ``.sum(dtype=torch.int32)`` takes it:
    out-degrees past 2**31 in all wrap, the same in both."""
    v = 4
    row_ptr = torch.tensor([0, 1 << 30, (1 << 31) - 2, (1 << 31) - 1,
                            (1 << 31) - 1], dtype=torch.int32)
    deg = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    fr = torch.ones(v, dtype=torch.bool)
    census = trelax.round_turn(None, None, row_ptr, fr,
                               trelax.census_buffer("cpu"))
    want = (int(deg.sum()) + (1 << 31)) % (1 << 32) - (1 << 31)
    assert census[1].item() == want == torch.where(
        fr, row_ptr[1:] - row_ptr[:-1], 0).sum(dtype=torch.int32).item()


def test_round_turn_float_labels_copy_the_words():
    """float32 labels: the frontier is torch's ``<`` (NaN and -0.0 are
    not below) and the labels take ``new``'s words exactly."""
    lab = torch.tensor([1.0, 0.0, float("nan"), 2.0, 5.0])
    new = torch.tensor([0.5, -0.0, float("nan"), float("nan"), 5.0])
    row_ptr = torch.arange(6, dtype=torch.int32)
    fr = torch.zeros(5, dtype=torch.bool)
    want_fr = new < lab
    trelax.round_turn(lab, new, row_ptr, fr, trelax.census_buffer("cpu"))
    assert torch.equal(fr, want_fr)
    assert torch.equal(lab.view(torch.int32), new.view(torch.int32))


def test_round_turn_wrapper_refuses_what_the_kernel_does_not_take():
    v = 8
    row_ptr = torch.arange(v + 1, dtype=torch.int32)
    lab = torch.zeros(2, v, dtype=torch.int32)
    fr = torch.zeros(2, v, dtype=torch.bool)
    census = trelax.census_buffer("cpu")
    with pytest.raises(ValueError, match="together"):
        trelax.round_turn(lab, None, row_ptr, fr, census)
    with pytest.raises(TypeError, match="bool"):
        trelax.round_turn(lab, lab.clone(), row_ptr, fr.to(torch.int32),
                          census)
    with pytest.raises(TypeError, match="one dtype"):
        trelax.round_turn(lab, lab.float(), row_ptr, fr, census)
    with pytest.raises(ValueError, match="share memory"):
        trelax.round_turn(lab, lab, row_ptr, fr, census)
    with pytest.raises(ValueError, match="contiguous"):
        trelax.round_turn(lab.t().contiguous().t(), lab.clone(), row_ptr,
                          fr, census)
    with pytest.raises(ValueError, match="contiguous"):
        trelax.round_turn(None, None, row_ptr,
                          torch.zeros(v, 2, dtype=torch.bool).t(), census)
    with pytest.raises(ValueError, match="R >= 1"):
        trelax.round_turn(None, None, row_ptr,
                          torch.zeros(0, v, dtype=torch.bool), census)
    with pytest.raises(ValueError):
        trelax.round_turn(None, None, row_ptr[:-1], fr, census)
    with pytest.raises(ValueError):
        trelax.round_turn(None, None, row_ptr, fr, census[:2])


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64,
                                   torch.int16])
def test_round_turn_takes_any_label_dtype_on_the_cpu(dtype):
    """On CPU tensors the wrapper runs the plain version for labels of
    any dtype (the card takes 32- and 64-bit ones): bitwise the torch
    ops, int64 labels past 2**32 too."""
    lab, new = _state((3, 1000), 0.1, 5)
    scale = 1 << 20 if dtype == torch.int64 else 1
    lab, new = (lab.to(dtype) * scale, new.to(dtype) * scale) \
        if dtype != torch.int16 else (lab >> 16, new >> 16)
    lab, new = lab.to(dtype), new.to(dtype)
    row_ptr = _csr(1000, 5)
    fr_want, n_f, m_f, lab_want = _torch_ops(lab, new, row_ptr)
    fr = torch.zeros(3, 1000, dtype=torch.bool)
    census = trelax.round_turn(lab, new, row_ptr, fr,
                               trelax.census_buffer("cpu"))
    assert torch.equal(fr, fr_want) and fr.any()
    assert census.tolist() == [int(n_f), int(m_f), 0, 0, 0]
    assert torch.equal(lab, lab_want)


# ---- the fused loops against the JAX package's run_fused ----------------

@pytest.fixture(scope="module")
def graph():
    gj = jg.uniform_random(200, 6, seed=3)
    return gj, tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                                   device="cpu")


APPS = {
    "sssp": lambda d, g, c, **kw: d.sssp(g, 0, c, mode="fused",
                                         collect_stats=True, **kw),
    "bfs": lambda d, g, c, **kw: d.bfs(g, 5, c, mode="fused",
                                       collect_stats=True, **kw),
    "sssp_batch": lambda d, g, c, **kw: d.sssp_batch(
        g, [0, 5, 99, 150], c, mode="fused", collect_stats=True, **kw),
    "bfs_batch": lambda d, g, c, **kw: d.bfs_batch(
        g, [0, 7, 21], c, mode="fused", collect_stats=True, **kw),
}


def _assert_same(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.labels), rt.labels.numpy())
    assert (rj.rounds, rj.host_transfers) == (rt.rounds, rt.host_transfers)
    assert len(rj.stats) == len(rt.stats) == rt.rounds
    for a, b in zip(rj.stats, rt.stats):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)


@pytest.mark.parametrize("backend", ["pallas", "merge_path", "xla"])
@pytest.mark.parametrize("direction", ["push", "pull", "adaptive"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_fused_loop_matches_jax(graph, app, direction, backend):
    gj, gt = graph
    kw = dict(threshold=16, direction=direction, backend=backend)
    rj = APPS[app](jd, gj, jb.BalancerConfig(**kw))
    rt = APPS[app](td, gt, tb.BalancerConfig(**kw))
    assert rt.rounds > 2
    _assert_same(rj, rt)


@pytest.mark.parametrize("app,direction,backend", [
    ("sssp", "push", "pallas"), ("bfs_batch", "adaptive", "merge_path"),
    ("sssp_batch", "pull", "xla")])
def test_fused_loop_cut_off_matches_jax(graph, app, direction, backend):
    """A ``max_rounds`` cut-off stops both loops at the same round, with
    the same labels and stats."""
    gj, gt = graph
    kw = dict(threshold=16, direction=direction, backend=backend)
    rj = APPS[app](jd, gj, jb.BalancerConfig(**kw), max_rounds=2)
    rt = APPS[app](td, gt, tb.BalancerConfig(**kw), max_rounds=2)
    assert rt.rounds == 2
    _assert_same(rj, rt)


# ---- nothing V-wide of its own in the fused min loop's body --------------

def _count_v_wide(monkeypatch, v):
    """Count calls of ``balancer.union_frontier``, ``Graph.out_degrees``
    and clones of a tensor of V labels (``[V]`` or ``[B, V]``)."""
    calls = {"union_frontier": 0, "out_degrees": 0, "clone": 0}
    union, degrees, clone = (tb.union_frontier, tg.Graph.out_degrees,
                             torch.Tensor.clone)

    def counted_union(*a, **k):
        calls["union_frontier"] += 1
        return union(*a, **k)

    def counted_degrees(self):
        calls["out_degrees"] += 1
        return degrees(self)

    def counted_clone(self, *a, **k):
        if self.ndim in (1, 2) and self.shape[-1] == v and \
                self.dtype in (torch.int32, torch.float32):
            calls["clone"] += 1
        return clone(self, *a, **k)

    monkeypatch.setattr(tb, "union_frontier", counted_union)
    monkeypatch.setattr(tg.Graph, "out_degrees", counted_degrees)
    monkeypatch.setattr(torch.Tensor, "clone", counted_clone)
    return calls


def _per_round(monkeypatch, v, run):
    """The counts a round adds: a run cut off after one round against a
    run cut off after three."""
    calls = _count_v_wide(monkeypatch, v)
    seen = []
    for rounds in (1, 3):
        for k in calls:
            calls[k] = 0
        assert run(rounds).rounds == rounds
        seen.append(dict(calls))
    return {k: (seen[1][k] - seen[0][k]) / 2 for k in calls}


@pytest.mark.parametrize("backend", ["pallas", "merge_path"])
@pytest.mark.parametrize("direction", ["push", "pull", "adaptive"])
@pytest.mark.parametrize("app", ["sssp", "sssp_batch"])
def test_fused_min_loop_body_reads_nothing_v_wide(graph, monkeypatch, app,
                                                  direction, backend):
    """Without ``collect_stats`` a round of the fused min loop through a
    kernel pair calls no ``union_frontier``, no ``Graph.out_degrees``
    and copies no labels: the census comes from the turn, and the pair
    relaxes into the loop's shadow of its labels."""
    gt = graph[1]
    cfg = tb.BalancerConfig(threshold=16, direction=direction,
                            backend=backend)
    run = {"sssp": lambda n: td.sssp(gt, 0, cfg, mode="fused",
                                     max_rounds=n),
           "sssp_batch": lambda n: td.sssp_batch(gt, [0, 5, 99], cfg,
                                                 mode="fused",
                                                 max_rounds=n)}[app]
    assert _per_round(monkeypatch, gt.num_vertices, run) == {
        "union_frontier": 0, "out_degrees": 0, "clone": 0}


def test_other_loops_keep_their_own_census(graph, monkeypatch):
    """kcore's and pagerank's fused loops (add-combine, their own
    turns) and the spmd round still take the census over V and copy
    their labels for the kernel pair, once a round."""
    gt = graph[1]
    gs = tg.symmetrized(gt)
    cfg = tb.BalancerConfig(threshold=16, backend="pallas")
    ada = tb.BalancerConfig(threshold=16, backend="pallas",
                            direction="adaptive")
    for run in (lambda n: td.kcore(gs, 9, cfg, mode="fused",
                                   max_rounds=n),
                lambda n: td.pagerank(gt, cfg=cfg, mode="fused",
                                      max_rounds=n, tol=0.0),
                lambda n: td.sssp(gt, 0, ada, mode="spmd", max_rounds=n)):
        per = _per_round(monkeypatch, gt.num_vertices, run)
        assert per["union_frontier"] >= 1 and per["out_degrees"] >= 1
        assert per["clone"] >= 1
        monkeypatch.undo()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fused_loop_turns_int64_labels(graph, backend):
    """int64 labels, past 2**32, turn through the same wrapper: a
    resumed fused loop equals host mode."""
    gt = graph[1]
    cfg = tb.BalancerConfig(threshold=16, backend=backend)
    v = gt.num_vertices
    lab = torch.full((v,), 1 << 40, dtype=torch.int64)
    lab[0] = 0
    fr = lab == 0
    runs = [td.resume_loop(gt, lab.clone(), fr.clone(), cfg,
                           tops.SSSP_RELAX, mode=m) for m in ("host",
                                                               "fused")]
    assert torch.equal(runs[0].labels, runs[1].labels)
    assert runs[0].rounds == runs[1].rounds > 2
    assert torch.equal(lab[1:], torch.full((v - 1,), 1 << 40))
