"""The CUDA kernels of ``repro_torch`` against their plain versions on
the card (the index kernels exactly: masks equal, masked positions
equal; the fused relax kernels exactly for min and int add, within
``FLOAT_ADD_RTOL`` for float add; the fused MoE plan bitwise;
attention, both routes, at the tolerances of tests/test_kernels_lm.py),
the captured programs of the static and fused modes, and streaming
repair and the query service on the card (programs follow the graph
version, captures per batch constant, peak memory flat).  Marked
``gpu``:
they skip without a CUDA device.  No JAX import, so the file also runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import operators as tops
from repro_torch.kernels import edge_lb as tlb
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import merge_path as tmp
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import moe_plan as tmplan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import relax as trelax
from repro_torch.kernels import twc_gather as ttwc

# float32 add on the card sums a vertex's candidates in another order
# than the plain version, whose index_add_ adds with atomics in a
# run-dependent order: the bins reduce in a fixed tree, the huge bin
# with atomics.  Sums of up to a few thousand positive terms.
FLOAT_ADD_RTOL = 1e-4
RELAX_OPS = ["SSSP_RELAX", "BFS_HOP", "CC_MIN", "KCORE_DEC", "PR_PULL",
             "SSSP_RELAX@pull", "BFS_HOP@pull", "CC_MIN@pull"]


def _huge(rng, h):
    deg = rng.integers(1, 300, h).astype(np.int32)
    start_e = (np.cumsum(deg) - deg).astype(np.int32)
    row = rng.integers(0, 1 << 20, h).astype(np.int32)
    val = rng.integers(0, 1 << 10, h).astype(np.int32)
    return deg, start_e, row, val


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_cuda_kernels_match_plain(cuda_device, distribution):
    rng = np.random.default_rng(3)
    deg, start_e, row, val = _huge(rng, 777)
    t = [torch.from_numpy(a).to(cuda_device) for a in (start_e, row, val)]
    total = int(deg.sum())
    k = tlb.edge_lb_map(*t, total, total, distribution=distribution)
    p = tref.edge_lb_map_ref(*t, total, total, distribution=distribution)
    assert torch.equal(k[3], p[3])
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a[k[3]], b[p[3]])
    for width in (8, 128, 1024):
        v = [torch.from_numpy(rng.integers(0, 3 * width, 300)
                              .astype(np.int32)).to(cuda_device)
             for _ in range(4)]
        k = ttwc.twc_bin_map(*v, width=width, chunk=1, sentinel=600)
        p = tref.twc_bin_map_ref(*v, width=width, chunk=1, sentinel=600)
        assert torch.equal(k[3], p[3])
        for a, b in zip(k[:3], p[:3]):
            assert torch.equal(a[k[3]], b[p[3]])


@pytest.mark.gpu
@pytest.mark.parametrize("tile_edges", [128, 2048])
def test_cuda_merge_path_matches_plain(cuda_device, tile_edges):
    """All outputs equal (0 where masked, on both), on random degrees
    with zero-degree runs, one huge slot, and an empty frontier."""
    rng = np.random.default_rng(tile_edges)
    cases = []
    for h in (1, 61, 1000, 5000):
        deg = rng.integers(0, 300, h).astype(np.int32)
        deg[rng.random(h) < 0.3] = 0
        deg[0] += 1
        cases.append(deg)
    cases += [np.array([50_000], np.int32), np.zeros(4, np.int32)]
    for deg in cases:
        start_e = (np.cumsum(deg) - deg).astype(np.int32)
        row = rng.integers(0, 1 << 20, deg.shape[0]).astype(np.int32)
        t = [torch.from_numpy(a).to(cuda_device) for a in (start_e, row)]
        total = int(deg.sum())
        for ecap in (max(total, 1), 2 * total + 3 * tile_edges):
            k = tmp.merge_path_map(*t, total, ecap, tile_edges=tile_edges)
            p = tref.merge_path_map_ref(*t, total, ecap,
                                        tile_edges=tile_edges)
            for a, b in zip(k, p):
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 24, 1024, 1025, 24_576, 100_003])
@pytest.mark.parametrize("e", [1, 8, 64, 256])
def test_cuda_positions_in_expert_matches_plain(cuda_device, n, e):
    """Exact, on uniform, one-expert and out-of-range id streams."""
    rng = np.random.default_rng(n + e)
    streams = [rng.integers(0, e, n), np.full(n, e - 1),
               rng.integers(-2, e + 3, n)]
    for ids in streams:
        t = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
        got = tmd.positions_in_expert(t, e)
        want = tref.positions_in_expert_ref(t, e)
        assert got.dtype == torch.int32 and torch.equal(got, want)


def _plan_bits(plan):
    """The plan with the gates as their int32 words (NaN compares)."""
    fe, pos, gate, keep = plan
    return fe, pos, gate.view(torch.int32), keep


@pytest.mark.gpu
@pytest.mark.parametrize("ek", [(8, 2), (16, 1), (64, 6), (256, 16)])
@pytest.mark.parametrize("t,g", [(1, 1), (4, 1), (33, 4), (1024, 2),
                                 (4096, 1)])
@pytest.mark.parametrize("adaptive", [True, False])
def test_cuda_moe_plan_matches_plain(cuda_device, ek, t, g, adaptive):
    """Bitwise, on uniform, skewed (one expert takes all, with a cap
    small enough that the overflow exceeds the free places), tied and
    NaN-row probabilities; one launch per plan, counted by its cluster
    size."""
    e, k = ek
    rng = np.random.default_rng(e + k + t + g)
    x = rng.random((g, t, e)).astype(np.float32)
    skew = x.copy()
    skew[..., 0] += 1e4
    ties = np.round(x * 4) / 4 + 0.25
    ties[..., 1] = ties[..., 0]
    nan = x.copy()
    nan[0, t // 2, e // 3] = np.nan
    cap = max(int(1.25 * t * k / e), 4)
    for probs, c in ((x, cap), (skew, max(cap // 8, 1)), (ties, cap),
                     (nan, cap)):
        p = torch.from_numpy(probs / probs.sum(-1, keepdims=True)) \
            .to(cuda_device)
        before = tmplan.moe_plan.launches
        got = tmplan.moe_plan(p, top_k=k, cap=c, groups=g,
                              adaptive=adaptive)
        want = tref.moe_plan_ref(p, top_k=k, cap=c, groups=g,
                                 adaptive=adaptive)
        assert tmplan.moe_plan.launches == before + 1
        for a, b in zip(_plan_bits(got), _plan_bits(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert tmplan.moe_plan.launches_by_cluster[
        tmplan.cluster_size(t * k)] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 100, 127, 128, 129, 300, 1024])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1), (16, 16)])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain(cuda_device, s, h, hkv, hd,
                                            dtype, causal):
    """Both routes: bf16 at hd 64 and 128 through the wgmma kernel (S
    127, 129 and 1024 reach its ragged 128-row tiles), the rest through
    the CUDA-core kernel; the launch is counted on its route."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * hd + h)
    q, k, v = (torch.randn((2, s, n, hd), generator=gen, device=cuda_device)
               .to(dtype) for n in (h, hkv, hkv))
    which = tfa.route(dtype, hd)
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, causal=causal)
    after = tfa.flash_attention.launches_by_route
    assert after[which] == before[which] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert which == ("wgmma" if dtype == torch.bfloat16 and hd >= 64
                     else "simt")
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ---- fused relax kernels ----------------------------------------------------

def _relax_op(name):
    base, _, pull = name.partition("@")
    op = getattr(tops, base)
    return tops.as_pull(op) if pull else op


def _relax_graph(dev, v=20_000):
    """A random CSR with a spread of degrees up to 3000 (col_idx, edge_w,
    row_ptr on ``dev``; row_ptr and degrees also on the host)."""
    rng = np.random.default_rng(v)
    deg = rng.integers(0, 40, v)
    deg[:12] = [3000, 2500, 2048, 1500, 1025, 1024, 1023, 300, 129, 128, 9,
                0]
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(row_ptr[-1])
    col = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.integers(1, 101, e).astype(np.int32)).to(dev)
    return col, w, row_ptr, deg


def _relax_state(dev, name, b, v, seed):
    rng = np.random.default_rng(seed)
    fmask = torch.from_numpy(rng.random((b, v)) < 0.6).to(dev)
    if name == "PR_PULL":
        lab = (rng.random((b, v)) * 1e-3).astype(np.float32)
        val = (rng.random((b, v)) * 1e-3).astype(np.float32)
    else:
        lab = rng.integers(0, 500, (b, v)).astype(np.int32)
        lab[rng.random((b, v)) < 0.3] = 1 << 30
        val = lab.copy()
    return (torch.from_numpy(val).to(dev), torch.from_numpy(lab).to(dev),
            fmask)


def _assert_relax_equal(name, got, want):
    if name == "PR_PULL":
        torch.testing.assert_close(got, want, rtol=FLOAT_ADD_RTOL, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("b", [1, 3, 8])
def test_cuda_twc_bin_relax_matches_plain(cuda_device, op, b):
    """Every width and chunk (host int and device int32), sentinel rows
    and an empty bin; launches counted.  Width 2048 is wider than a pull
    lane's register slots (4 a lane on a 256-thread block)."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    rng = np.random.default_rng(b)
    vid = np.concatenate([np.arange(12), rng.integers(12, v, 200),
                          np.full(60, v)])
    rng.shuffle(vid)
    safe = np.where(vid < v, vid, 0)
    rows = [torch.from_numpy(a.astype(np.int32)).to(cuda_device)
            for a in (vid, np.where(vid < v, deg[safe], 0),
                      np.where(vid < v, row_ptr[safe], 0))]
    val, lab, fm = _relax_state(cuda_device, op, b, v, b)
    before = trelax.twc_bin_relax.launches
    launched = 0
    for width in (8, 128, 1024, 2048):
        for chunk in (0, 1, 2):
            for ch in (chunk, torch.tensor([chunk], dtype=torch.int32,
                                           device=cuda_device)):
                for n in (len(vid), 0):
                    got = trelax.twc_bin_relax(
                        val, lab.clone(), fm, col, w, *(r[:n] for r in rows),
                        _relax_op(op), width=width, chunk=ch)
                    want = tref.twc_bin_relax_ref(
                        val, lab.clone(), fm, col, w, *(r[:n] for r in rows),
                        _relax_op(op), width=width, chunk=chunk)
                    _assert_relax_equal(op, got, want)
                    launched += n > 0
    assert trelax.twc_bin_relax.launches == before + launched


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_cuda_edge_lb_relax_matches_plain(cuda_device, op, b, distribution):
    """One-row huge bins (on and off a tile boundary), several rows with
    sentinel slots, bucketed and ragged spans, 64 and 7 tiles."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    val, lab, fm = _relax_state(cuda_device, op, b, v, b + 7)
    # the last case has a 3000-slot run of zero-degree slots: a tile
    # window wider than the kernel's shared-memory stage
    cases = [[2], [1], [0, 1, 2, 3, 4, 5, 6], list(range(200, 2200)),
             [1] + [11] * 3000 + [2]]
    before = trelax.edge_lb_relax.launches
    for hv in cases:
        hv = np.array(hv)
        pad = 0 if len(hv) == 1 else 5
        hvidx, hdeg, hrow = (np.concatenate([a, np.full(pad, f)])
                             .astype(np.int32)
                             for a, f in ((hv, v), (deg[hv], 0),
                                          (row_ptr[hv], 0)))
        start_e = (np.cumsum(hdeg) - hdeg).astype(np.int32)
        total = int(hdeg.sum())
        t = [torch.from_numpy(a).to(cuda_device)
             for a in (hvidx, start_e, hrow)]
        for n_enum in (next_pow2(max(total, 2048)), total):
            for tiles in (64, 7):
                kw = dict(distribution=distribution, num_tiles=tiles)
                got = trelax.edge_lb_relax(val, lab.clone(), fm, col, w, *t,
                                           total, n_enum, _relax_op(op), **kw)
                want = tref.edge_lb_relax_ref(val, lab.clone(), fm, col, w,
                                              *t, total, n_enum,
                                              _relax_op(op), **kw)
                _assert_relax_equal(op, got, want)
    assert trelax.edge_lb_relax.launches == before + 4 * len(cases)


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# ---- device-int32 entries of the static-shape round ----------------------

def _dev_int(x, dev):
    return torch.tensor([x], dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_twc_bin_relax_device_passes_match_plain(cuda_device, op, b):
    """A pass count read on the card, 0 to 4 passes from chunk 0 or 1
    (width 1024 against degrees up to 3000), V rows with sentinels as
    the static round gives them, with and without a device row bound:
    the same labels as that many passes of the plain version."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    rng = np.random.default_rng(b + 20)
    member = rng.random(v) < 0.2
    member[:12] = True
    vid = np.where(member, np.arange(v), v)
    rows = [torch.from_numpy(a.astype(np.int32)).to(cuda_device)
            for a in (vid, np.where(member, deg, 0),
                      np.where(member, row_ptr[:-1], 0))]
    val, lab, fm = _relax_state(cuda_device, op, b, v, b + 3)
    for width in (8, 128, 1024):
        for chunk in (0, 1):
            for passes in (0, 1, 2, 4):
                # no row bound, and the static round's: all rows, a third
                for bound in (None, v, v // 3):
                    got = trelax.twc_bin_relax(
                        val, lab.clone(), fm, col, w, *rows, _relax_op(op),
                        width=width, chunk=_dev_int(chunk, cuda_device),
                        passes=_dev_int(passes, cuda_device),
                        rows=(None if bound is None
                              else _dev_int(bound, cuda_device)))
                    want = tref.twc_bin_relax_ref(
                        val, lab.clone(), fm, col, w, *rows, _relax_op(op),
                        width=width, chunk=chunk, passes=passes, rows=bound)
                    _assert_relax_equal(op, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_cuda_edge_lb_relax_device_total_matches_plain(cuda_device, op,
                                                       distribution):
    """A total read on the card over the static span (every edge of the
    graph): total 0, one huge row, a ragged tail; the same labels as the
    plain version given the same total."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    e = int(row_ptr[-1])
    val, lab, fm = _relax_state(cuda_device, op, 2, v, 11)
    for hv in ([], [0], [0, 1, 2, 3, 4, 5, 6], list(range(12, 3000))):
        member = np.zeros(v, bool)
        member[hv] = True
        hvidx, hdeg, hrow = (np.where(member, a, f).astype(np.int32)
                             for a, f in ((np.arange(v), v), (deg, 0),
                                          (row_ptr[:-1], 0)))
        start_e = (np.cumsum(hdeg) - hdeg).astype(np.int32)
        total = int(hdeg.sum())
        t = [torch.from_numpy(a).to(cuda_device)
             for a in (hvidx, start_e, hrow)]
        for tiles in (64, 7):
            kw = dict(distribution=distribution, num_tiles=tiles)
            got = trelax.edge_lb_relax(val, lab.clone(), fm, col, w, *t,
                                       _dev_int(total, cuda_device), e,
                                       _relax_op(op), **kw)
            want = tref.edge_lb_relax_ref(val, lab.clone(), fm, col, w, *t,
                                          total, e, _relax_op(op), **kw)
            _assert_relax_equal(op, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_edges", [128, 2048])
def test_cuda_index_maps_device_total_match_plain(cuda_device, tile_edges):
    """merge_path_map and edge_lb_map with the total read on the card,
    over a span much wider than the total (the static round's E): total
    0, a ragged tail, zero-degree runs; every output equal."""
    rng = np.random.default_rng(tile_edges + 1)
    for h, total_cut in ((1, 0), (700, None), (5000, None)):
        deg = rng.integers(0, 50, h).astype(np.int32)
        deg[rng.random(h) < 0.3] = 0
        if total_cut == 0:
            deg[:] = 0
        start_e = (np.cumsum(deg) - deg).astype(np.int32)
        row = rng.integers(0, 1 << 20, h).astype(np.int32)
        total = int(deg.sum())
        ecap = 3 * total + 5 * tile_edges + 17
        se, rs = (torch.from_numpy(a).to(cuda_device) for a in (start_e, row))
        got = tmp.merge_path_map(se, rs, _dev_int(total, cuda_device), ecap,
                                 tile_edges=tile_edges)
        want = tref.merge_path_map_ref(se, rs, total, ecap,
                                       tile_edges=tile_edges)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for dist in ("cyclic", "blocked"):
            got = tlb.edge_lb_map(se, rs, rs, _dev_int(total, cuda_device),
                                  ecap, tile_edges=tile_edges,
                                  distribution=dist)
            want = tref.edge_lb_map_ref(se, rs, rs, total, ecap,
                                        tile_edges=tile_edges,
                                        distribution=dist)
            assert torch.equal(got[3], want[3])
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a[got[3]], b[want[3]])


@pytest.mark.gpu
def test_cuda_graph_loop_program_matches_eager(cuda_device):
    """A captured program with a WHILE node around two IF nodes, and a
    nested WHILE in one branch, against the same function run eagerly
    on the CPU; a second call with the same key captures nothing."""
    from repro_torch.core import graph_loop as gl

    def fn(x, n):
        def cond_fn(i, acc):
            return i < n

        def body(i, acc):
            odd = (i % 2) == 1

            def inner():
                def c2(j, a):
                    return j < 3

                def b2(j, a):
                    return j + 1, a * 2 + 1
                return gl.while_(c2, b2, (torch.zeros_like(i), acc))[1]
            acc = gl.cond(odd, inner, lambda: acc - i.to(acc.dtype))
            return i + 1, acc
        i, acc = gl.while_(cond_fn, body, (torch.zeros_like(n), x))
        return acc, i

    class Owner:
        version = 0

    owner = Owner()
    x = torch.arange(-5, 5, dtype=torch.int64)
    for steps in (0, 1, 6):
        n = torch.tensor(steps, dtype=torch.int32)
        want = fn(x, n)
        before = gl.captures
        got = gl.run(owner, "t", fn, x.to(cuda_device), n.to(cuda_device))
        assert gl.captures == before + (steps == 0)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_cuda_device_launch_counts(cuda_device):
    """The static entries' kernels count their launches on the card: an
    eager launch adds one there and to the wrapper's ``launches``; a
    captured one adds one to ``captured`` only, and then one on the card
    per replay."""
    from repro_torch import kernels as tk
    from repro_torch.core import graph_loop as gl
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    rows = [torch.from_numpy(a.astype(np.int32)).to(cuda_device)
            for a in (np.arange(v), deg, row_ptr[:-1])]
    val, lab, fm = _relax_state(cuda_device, "SSSP_RELAX", 1, v, 3)
    passes, n = _dev_int(24, cuda_device), _dev_int(v, cuda_device)

    def one(lab):
        return trelax.twc_bin_relax(val, lab, fm, col, w, *rows,
                                    _relax_op("SSSP_RELAX"), width=128,
                                    passes=passes, rows=n)

    class Owner:
        version = 0

    tk.reset_launch_counts()
    tk.device_launch_counts(reset=True)
    want = one(lab.clone())
    assert trelax.twc_bin_relax.launches == 1
    assert tk.device_launch_counts(reset=True)["twc_bin_relax"] == 1
    owner = Owner()
    for _ in range(3):
        assert torch.equal(gl.run(owner, "one", one, lab), want)
    assert trelax.twc_bin_relax.launches == 1
    assert tk.capture_counts()["twc_bin_relax"] == 1
    assert tk.device_launch_counts(reset=True) == {
        "twc_bin_relax": 3, "edge_lb_relax": 0, "merge_path_map": 0}


@pytest.mark.gpu
def test_cuda_graph_loop_cache_is_bounded(cuda_device):
    """Three times as many distinct programs on one graph as it keeps:
    at most ``MAX_PROGRAMS`` stay cached, the least recently used goes
    first, and the memory of the evicted ones goes back (reserved memory
    after a trim stays at the level of one full cache)."""
    from repro_torch.core import graph_loop as gl

    class Owner:
        version = 0

    owner = Owner()
    cap = gl.MAX_PROGRAMS
    x = torch.ones(1 << 20, device=cuda_device)    # 4 MB a temporary

    def fill(keys):
        for k in keys:
            got = gl.run(owner, k, lambda t, k=k: (t + k) * 2, x)
            assert torch.equal(got, (x + k) * 2)
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(cuda_device)

    full = fill(range(cap))
    assert len(owner._programs) == cap
    before = gl.captures
    fill([0])                         # a hit: key 0 becomes the newest
    assert gl.captures == before
    fill([cap])                       # evicts key 1, the oldest
    assert 0 in [k[1] for k in owner._programs]
    assert 1 not in [k[1] for k in owner._programs]
    again = fill(range(cap + 1, 3 * cap))
    assert len(owner._programs) == cap
    assert again <= full + (16 << 20), (again, full)


# ---- the static-shape round and the fused loop on the card ---------------

def _card_and_host_graph(dev, scale=11):
    from repro_torch.core import graph as tg
    gc = tg.rmat(scale, 8, seed=4, device=dev)
    gh = tg.Graph.from_numpy(gc.row_ptr.cpu(), gc.col_idx.cpu(),
                             gc.edge_w.cpu(), device="cpu")
    return gc, gh


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["xla", "pallas", "merge_path"])
@pytest.mark.parametrize("strategy", ["twc", "alb"])
def test_cuda_captured_round_matches_eager(cuda_device, backend, strategy):
    """relax_spmd_directed on the card (one replay of a captured graph
    with the direction's IF nodes, and twc's device pass count) against
    the same round run eagerly on the CPU, at a sparse and a dense
    frontier, B = 2: labels, stats and liveness equal."""
    from repro_torch.core import balancer as tb
    gc, gh = _card_and_host_graph(cuda_device)
    cfg = tb.BalancerConfig(strategy=strategy, backend=backend,
                            threshold=64, direction="adaptive")
    v = gh.num_vertices
    rng = np.random.default_rng(5)
    for density in (0.01, 0.5):
        lab = rng.integers(0, 500, (2, v)).astype(np.int32)
        fr = rng.random((2, v)) < density
        fr[:, 0] = True
        outs = [tb.relax_spmd_directed(g, torch.from_numpy(lab).to(d),
                                       torch.from_numpy(lab).to(d),
                                       torch.from_numpy(fr).to(d), cfg,
                                       tops.SSSP_RELAX, collect_stats=True,
                                       return_active=True)
                for g, d in ((gc, cuda_device), (gh, "cpu"))]
        (lc, sc, ac), (lh, sh, ah) = outs
        assert torch.equal(lc.cpu(), lh)
        np.testing.assert_array_equal(ac, ah)
        for f in sh._fields:
            np.testing.assert_array_equal(np.asarray(getattr(sc, f)),
                                          np.asarray(getattr(sh, f)),
                                          err_msg=f)


@pytest.mark.gpu
def test_cuda_fused_loop_matches_host(cuda_device):
    """Fused traversals on the card (one graph launch each) against host
    mode on the card: labels, rounds and per-round frontier stats equal
    (pagerank within FLOAT_ADD_RTOL: its huge bin adds with atomics);
    no host transfer; a second call with the same key captures
    nothing."""
    from repro_torch.core import balancer as tb
    from repro_torch.core import graph as tg
    from repro_torch.core import graph_loop as gl
    from repro_torch.core.apps import drivers as td
    g, _ = _card_and_host_graph(cuda_device, scale=12)
    sym = tg.symmetrized(g)
    kern = tb.BalancerConfig(use_pallas=True, threshold=64)
    ada = tb.BalancerConfig(use_pallas=True, threshold=64,
                            direction="adaptive")
    runs = [lambda m: td.sssp(g, 0, ada, mode=m, collect_stats=True),
            lambda m: td.sssp(g, 0, tb.BalancerConfig(
                strategy="twc", use_pallas=True), mode=m,
                collect_stats=True),
            lambda m: td.sssp(g, 0, tb.BalancerConfig(
                backend="merge_path"), mode=m, collect_stats=True),
            lambda m: td.sssp_batch(g, [0, 1, 2, 3], ada, mode=m),
            lambda m: td.cc(sym, ada, mode=m, collect_stats=True),
            lambda m: td.kcore(sym, 6, kern, mode=m, collect_stats=True),
            lambda m: td.pagerank(g, cfg=kern, mode=m, max_rounds=12)]
    for i, run in enumerate(runs):
        host, fused = run("host"), run("fused")
        if i == len(runs) - 1:
            torch.testing.assert_close(fused.labels, host.labels,
                                       rtol=FLOAT_ADD_RTOL, atol=0)
        else:
            assert torch.equal(fused.labels, host.labels)
        assert fused.rounds == host.rounds > 0
        assert fused.host_transfers == 0
        for a, b in zip(host.stats or (), fused.stats or ()):
            assert (a.frontier_size, a.frontier_edges, a.direction) == \
                (b.frontier_size, b.frontier_edges, b.direction)
        before = gl.captures
        again = run("fused")
        assert gl.captures == before
        assert again.rounds == fused.rounds


@pytest.mark.gpu
def test_cuda_captured_round_user_operator(cuda_device):
    """An operator the fused kernels do not take (``msg = v + 2w``)
    through the ``pallas`` pair's static round on the card: its
    unbounded bin's chunks are a WHILE node around ``twc_bin_map`` with
    a device chunk, its huge bin ``edge_lb_map`` with a device total;
    labels equal to the same round run eagerly on the CPU."""
    from repro_torch.core import balancer as tb
    gc, gh = _card_and_host_graph(cuda_device)
    op = tops.Operator("v_plus_2w", "push", "min", lambda v, w: v + 2 * w)
    v = gh.num_vertices
    rng = np.random.default_rng(8)
    lab = rng.integers(0, 500, (2, v)).astype(np.int32)
    fr = rng.random((2, v)) < 0.3
    for strategy in ("twc", "alb"):
        cfg = tb.BalancerConfig(strategy=strategy, use_pallas=True,
                                threshold=64)
        got, want = (tb.relax_spmd(g, torch.from_numpy(lab).to(d),
                                   torch.from_numpy(lab).to(d),
                                   torch.from_numpy(fr).to(d), cfg, op)
                     for g, d in ((gc, cuda_device), (gh, "cpu")))
        assert torch.equal(got.cpu(), want)


# ---- streaming updates and the service on the card ------------------------

def _stream_batches(g, n, k, seed):
    """``n`` seeded batches of ``k`` updates over ``g``'s real vertices:
    inserts, deletes and reweights of existing edges."""
    from repro_torch.core import streaming as ts
    rng = np.random.default_rng(seed)
    nv = ts.real_vertices(g)
    rp = g.row_ptr.cpu().numpy()
    ci = g.col_idx.cpu().numpy()
    out = []
    for _ in range(n):
        ups = []
        for _ in range(k):
            r = rng.random()
            if r < 0.7:
                ups.append(("insert", int(rng.integers(nv)),
                            int(rng.integers(nv)), int(rng.integers(1, 100))))
            else:
                u = int(rng.integers(nv))
                if rp[u + 1] == rp[u]:
                    continue
                v = int(ci[rng.integers(rp[u], rp[u + 1])])
                ups.append(("delete", u, v) if r < 0.85 else
                           ("reweight", u, v, int(rng.integers(1, 100))))
        out.append(ts.make_batch(ups, capacity=k))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("in_place", [False, True])
def test_cuda_stream_programs_follow_graph_versions(cuda_device, in_place,
                                                    monkeypatch):
    """Fused and spmd repair on the card over 6 batches: every program
    replayed was captured for the graph version it runs on (never one of
    a superseded version), the captures per batch are the same after the
    first batch (none in host mode), and the labels equal a from-scratch
    run on a CPU copy of each mutated graph."""
    from repro_torch.core import graph as tg
    from repro_torch.core import graph_loop as gl
    from repro_torch.core import streaming as ts
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.apps import drivers as td
    cfg = BalancerConfig(use_pallas=True, threshold=64)
    base = ts.streaming_graph(tg.rmat(11, 8, seed=4, device=cuda_device))
    batches = _stream_batches(base, 6, 64, seed=1)
    used = []
    real_run = gl.run

    def run(owner, key, fn, *inputs):
        out = real_run(owner, key, fn, *inputs)
        used.append((next(reversed(owner._programs))[0], owner.version))
        return out

    monkeypatch.setattr(gl, "run", run)
    for mode in ("host", "spmd", "fused"):
        st = ts.stream_init(base, "sssp", source=0, cfg=cfg, mode=mode)
        per_batch = []
        for batch in batches:
            before = gl.captures
            ts.stream_update(st, batch, in_place=in_place)
            per_batch.append(gl.captures - before)
            host = tg.Graph.from_numpy(st.g.row_ptr.cpu(),
                                       st.g.col_idx.cpu(),
                                       st.g.edge_w.cpu(), device="cpu")
            want = td.sssp(host, 0, cfg).labels
            assert torch.equal(st.labels.cpu(), want)
        if mode == "host":
            assert per_batch == [0] * len(batches)
        else:
            assert per_batch[0] >= 1
            assert per_batch[1:] == [per_batch[1]] * (len(batches) - 1)
        if in_place:
            base = ts.streaming_graph(tg.rmat(11, 8, seed=4,
                                              device=cuda_device))
    assert used and all(pv == gv for pv, gv in used)


@pytest.mark.gpu
def test_cuda_stream_peak_memory_is_flat(cuda_device):
    """8 batches of fused repair with ``in_place=False`` (a new graph, and
    new captured programs, per batch): a superseded graph and its
    programs are freed when the state lets go of it, so the peak device
    memory of the last batch is within 10% of the first's and the memory
    held after it does not grow."""
    from repro_torch.core import graph as tg
    from repro_torch.core import streaming as ts
    from repro_torch.core.balancer import BalancerConfig
    cfg = BalancerConfig(use_pallas=True, threshold=64)
    g = ts.streaming_graph(tg.rmat(13, 8, seed=4, device=cuda_device))
    batches = _stream_batches(g, 8, 256, seed=2)
    st = ts.stream_init(g, "sssp", source=0, cfg=cfg, mode="fused")
    del g
    peaks, held = [], []
    for batch in batches:
        torch.cuda.synchronize(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        ts.stream_update(st, batch)
        torch.cuda.synchronize(cuda_device)
        peaks.append(torch.cuda.max_memory_allocated(cuda_device))
        held.append(torch.cuda.memory_allocated(cuda_device))
    assert peaks[-1] <= 1.1 * peaks[0], peaks
    assert held[-1] <= held[0] + (1 << 20), held


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["host", "spmd", "fused"])
def test_cuda_service_matches_standalone_across_updates(cuda_device, mode):
    """The query service on the card with an update applied while
    queries run: every result equals a standalone run on the graph
    version its query was admitted under."""
    from repro_torch.core import graph as tg
    from repro_torch.core import streaming as ts
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.core.apps import drivers as td
    from repro_torch.serve import QueryService
    cfg = BalancerConfig(use_pallas=True, threshold=64)
    g = ts.streaming_graph(tg.rmat(11, 8, seed=4, device=cuda_device))
    svc = QueryService(num_slots=4, cfg=cfg, mode=mode, fused_rounds=2)
    svc.register_graph("g", g)
    graphs = {g.version: g}
    sources = [0, 1, 2, 3, 5, 8, 0, 13]
    qids = [svc.submit("g", "sssp", s) for s in sources[:4]]
    svc.step()
    svc.apply_updates("g", _stream_batches(g, 1, 64, seed=3)[0])
    graphs[svc._graphs["g"].version] = svc._graphs["g"]
    qids += [svc.submit("g", "bfs" if i % 2 else "sssp", s)
             for i, s in enumerate(sources[4:])]
    svc.run()
    for qid in qids:
        q = svc.poll(qid)
        fn = td.sssp if q.app == "sssp" else td.bfs
        want = fn(graphs[q.version], q.source, cfg).labels.cpu().numpy()
        np.testing.assert_array_equal(q.result, want)
