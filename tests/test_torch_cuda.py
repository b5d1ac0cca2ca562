"""The CUDA kernels of ``repro_torch`` against their plain versions on
the card (the index kernels exactly: masks equal, masked positions
equal; the fused relax kernels, ``merge_path_relax`` included, exactly
for min and int add, within
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
import contextlib

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


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 129, 1024])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 1)])
@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("dtype", [torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_simt_wide_heads(cuda_device, s, h, hkv, hd,
                                              dtype, causal):
    """The simt kernel at zamba2's head width (80, run at its 128
    instantiation) and paligemma's (256, its widest: 217,856 bytes of
    shared memory in float32) against the plain version, at the
    tolerance of ``test_cuda_flash_attention_matches_plain``."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * hd + h)
    q, k, v = (torch.randn((2, s, n, hd), generator=gen, device=cuda_device)
               .to(dtype) for n in (h, hkv, hkv))
    assert tfa.route(dtype, hd) == "simt"
    before = tfa.flash_attention.launches_by_route["simt"]
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.launches_by_route["simt"] == before + 1
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 100, 127, 129, 1000, 1024])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 1), (32, 32)])
@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_wgmma_wide_heads(cuda_device, s, h, hkv, hd,
                                               causal):
    """bf16 at zamba2's head width (80: five 16-lane boxes in the 32-byte
    swizzle) and paligemma's (256: 64-key tiles) through the wgmma
    kernel, against the plain version within 2e-2; S 127, 129 and 1000
    reach the ragged tiles, 1024 the diagonal of 64-key tiles."""
    gen = torch.Generator(device=cuda_device).manual_seed(s * hd + h + 1)
    q, k, v = (torch.randn((2, s, n, hd), generator=gen, device=cuda_device)
               .bfloat16() for n in (h, hkv, hkv))
    assert tfa.route(torch.bfloat16, hd) == "wgmma"
    before = dict(tfa.flash_attention.launches_by_route)
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert tfa.flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "simt": before["simt"]}
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


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


# the bins of the alb (default widths), twc and vertex strategies, and
# four bins, as ``(lo, hi)``
LIST_BOUNDS = {"alb": ((0, 8), (8, 128), (128, 1023)),
               "twc": ((0, 8), (8, 128), (128, None)),
               "vertex": ((0, None),),
               "four": ((0, 1), (1, 8), (8, 40), (40, None))}


def _frontier_mask(dev, v, density, seed, r=1):
    """A static round's dense frontier: a random bool ``[r, V]`` on
    ``dev`` whose union lists about ``density`` of the vertices."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((r, v)) < density / r).to(dev)


def _list_masks(dev, v, seed):
    """The listing's swept masks: sparse and dense, R = 1 and 8, empty
    and all-set, one vertex, and an R = 1 mask off a 16-byte boundary
    (the kernel's shifted loads)."""
    masks = [_frontier_mask(dev, v, d, seed + r, r)
             for d in (0.05, 0.9) for r in (1, 8)]
    one = torch.zeros((1, v), dtype=torch.bool, device=dev)
    one[0, v // 2] = True
    odd = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    odd[1:] = _frontier_mask(dev, v, 0.5, seed, 1)[0]
    return masks + [torch.zeros((3, v), dtype=torch.bool, device=dev),
                    torch.ones((1, v), dtype=torch.bool, device=dev), one,
                    odd[1:][None]]


def _assert_lists_equal(got, want):
    assert torch.equal(got.count, want.count)
    assert torch.equal(got.max_deg, want.max_deg)
    for b, k in enumerate(want.count.tolist()):
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g[b, :k], w[b, :k])
    assert (got.total is None) == (want.total is None)
    if want.total is not None:                 # the LB bin, listed last
        k = int(want.count[-1])
        assert torch.equal(got.total, want.total)
        assert torch.equal(got.start_e[:k], want.start_e[:k])


def _list_graph(dev, v, seed, hub):
    """Degrees of a listing sweep (zero-degree runs, 50 heavy vertices
    of ``hub`` to 3000) and their ``row_ptr`` on ``dev`` twice: aligned,
    and off a 16-byte boundary (the kernel's scalar loads)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, v)
    deg[rng.integers(0, v, 50)] = rng.integers(hub, 3000, 50)
    deg[rng.random(v) < 0.1] = 0
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    rp = torch.from_numpy(row_ptr).to(dev)
    shifted = torch.zeros(v + 2, dtype=torch.int32, device=dev)
    shifted[1:] = rp
    return rp, shifted[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("v", [1, 20_000, 3_000_001])
@pytest.mark.parametrize("bins", sorted(LIST_BOUNDS))
def test_cuda_twc_bin_list_matches_plain(cuda_device, v, bins):
    """The listing kernel against its plain version over swept masks:
    sparse and dense, R = 1 and 8 (OR-ed in the kernel), empty, all-set
    and one vertex, a V that is no multiple of the tile (and of 16:
    rows after the first start unaligned), V = 1, a mask and a
    ``row_ptr`` off a 16-byte boundary; members, counts and largest
    degrees equal."""
    rp, shifted = _list_graph(cuda_device, v, v, 100)
    bounds = LIST_BOUNDS[bins]
    before = trelax.twc_bin_list.launches
    launched = 0
    for mask in _list_masks(cuda_device, v, v):
        for row_ptr in (rp, shifted):
            got = trelax.twc_bin_list(mask, row_ptr, bounds)
            want = tref.twc_bin_list_ref(mask, row_ptr, bounds)
            _assert_lists_equal(got, want)
            launched += 1
    torch.cuda.synchronize()
    assert trelax.twc_bin_list.launches == before + launched


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_twc_bin_relax_on_lists_matches_plain(cuda_device, op, b):
    """The static entry over a bin list: the kernel's own lists with
    their device counts, and the plain version's (padded with
    sentinels) with device counts 0, 1 and V, each pass count of the
    bin, over a frontier of B rows; the same labels as
    ``twc_bin_relax_ref`` given the same rows."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    mask = _frontier_mask(cuda_device, v, 0.5, b, b)
    rp = torch.from_numpy(row_ptr).to(cuda_device)
    val, lab, fm = _relax_state(cuda_device, op, b, v, b + 5)
    bounds = LIST_BOUNDS["twc"]
    kern = trelax.twc_bin_list(mask, rp, bounds)
    plain = tref.twc_bin_list_ref(mask, rp, bounds)
    for i, width in enumerate((8, 128, 1024)):
        most = -(-int(plain.max_deg[i]) // width)
        for passes in sorted({1, most}):
            cases = [(kern, kern.count[i:i + 1])] + [
                (plain, _dev_int(k, cuda_device)) for k in (0, 1, v)]
            for lists, count in cases:
                got = trelax.twc_bin_relax(
                    val, lab.clone(), fm, col, w, lists.vidx[i],
                    lists.deg[i], lists.row_start[i], _relax_op(op),
                    width=width, passes=_dev_int(passes, cuda_device),
                    rows=count)
                want = tref.twc_bin_relax_ref(
                    val, lab.clone(), fm, col, w, plain.vidx[i],
                    plain.deg[i], plain.row_start[i], _relax_op(op),
                    width=width, passes=passes,
                    rows=min(int(count), int(plain.count[i])))
                _assert_relax_equal(op, got, want)


@pytest.mark.gpu
def test_cuda_listed_bins_replay_with_a_new_count(cuda_device):
    """The listing and the list-fed bin launches captured once
    (``graph_loop.run``) and replayed with other frontiers: each replay
    equals the same launches run eagerly on the CPU's plain versions,
    and no replay captures again."""
    from repro_torch.core import graph_loop as gl
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    rp = torch.from_numpy(row_ptr).to(cuda_device)
    val, lab, fm = _relax_state(cuda_device, "SSSP_RELAX", 2, v, 4)
    bounds = LIST_BOUNDS["alb"]
    op = _relax_op("SSSP_RELAX")

    def round_(lab, mask):
        lists = trelax.twc_bin_list(mask, rp, bounds)
        lab = lab.clone()
        for i, width in enumerate((8, 128, 1024)):
            lab = trelax.twc_bin_relax(
                val, lab, fm, col, w, lists.vidx[i], lists.deg[i],
                lists.row_start[i], op, width=width,
                rows=lists.count[i:i + 1])
        return lab

    class Owner:
        version = 0

    owner = Owner()
    host = [t.cpu() for t in (val, lab, fm, col, w, rp)]
    one = torch.zeros((2, v), dtype=torch.bool, device=cuda_device)
    one[1, 7] = True
    before = gl.captures
    for mask in (_frontier_mask(cuda_device, v, 0.6, 9, 2), one.logical_not(),
                 torch.zeros_like(one), one,
                 _frontier_mask(cuda_device, v, 0.3, 10, 2)):
        got = gl.run(owner, "listed", round_, lab, mask)
        lists = trelax.twc_bin_list(mask.cpu(), host[5], bounds)
        want = host[1].clone()
        for i, width in enumerate((8, 128, 1024)):
            want = tref.twc_bin_relax_ref(
                host[0], want, host[2], host[3], host[4], lists.vidx[i],
                lists.deg[i], lists.row_start[i], op, width=width,
                rows=lists.count[i:i + 1])
        assert torch.equal(got.cpu(), want)
    assert gl.captures == before + 1


# the LB bin listed after the degree bins: alb's huge bin (threshold
# 1024) and the edge_lb strategy's every vertex with an edge
LB_BOUNDS = {"alb": LIST_BOUNDS["alb"] + ((1023, None),),
             "edge_lb": ((0, None),)}


@pytest.mark.gpu
@pytest.mark.parametrize("v", [1, 20_000, 3_000_001])
@pytest.mark.parametrize("bins", sorted(LB_BOUNDS))
def test_cuda_twc_bin_list_lb_matches_plain(cuda_device, v, bins):
    """The listing with an LB bin against its plain version: members,
    counts and largest degrees, and the LB bin's degree prefix up to its
    count and its edge total, exactly; the masks and ``row_ptr`` of
    :func:`test_cuda_twc_bin_list_matches_plain`, and a pull round's
    ``emask`` (every vertex with an edge)."""
    rp, shifted = _list_graph(cuda_device, v, v + 1, 1000)
    bounds = LB_BOUNDS[bins]
    emask = (rp[1:] > rp[:-1])[None]
    for mask in _list_masks(cuda_device, v, v + 1) + [emask]:
        for row_ptr in (rp, shifted):
            _assert_lists_equal(
                trelax.twc_bin_list(mask, row_ptr, bounds, lb=True),
                tref.twc_bin_list_ref(mask, row_ptr, bounds, lb=True))


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_cuda_edge_lb_relax_on_lb_list_matches_plain(cuda_device, op,
                                                    distribution):
    """The static entry over an LB list, B = 2: the kernel's own list
    with its device count and total, and the plain version's (padded)
    with device counts 0, 1 and V and the total of the rows they keep;
    64 and 7 tiles; the same labels as ``edge_lb_relax_ref`` given the
    same rows."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v, e = len(deg), int(row_ptr[-1])
    val, lab, fm = _relax_state(cuda_device, op, 2, v, 13)
    mask = _frontier_mask(cuda_device, v, 0.5, 7, 2)
    rp = torch.from_numpy(row_ptr).to(cuda_device)
    for bins in sorted(LB_BOUNDS):
        bounds = LB_BOUNDS[bins]
        k = len(bounds) - 1
        kern = trelax.twc_bin_list(mask, rp, bounds, lb=True)
        plain = tref.twc_bin_list_ref(mask, rp, bounds, lb=True)
        members = int(plain.count[k])
        cases = [(kern, kern.count[k:], kern.total, members)]
        for c in (0, 1, v):
            kept = min(c, members)
            total = int(plain.start_e[kept]) if kept < members else \
                int(plain.total)
            cases.append((plain, _dev_int(c, cuda_device),
                          _dev_int(total, cuda_device), kept))
        for tiles in (64, 7):
            kw = dict(distribution=distribution, num_tiles=tiles)
            for lists, count, total, kept in cases:
                got = trelax.edge_lb_relax(
                    val, lab.clone(), fm, col, w, lists.vidx[k],
                    lists.start_e, lists.row_start[k], total, e,
                    _relax_op(op), rows=count, **kw)
                want = tref.edge_lb_relax_ref(
                    val, lab.clone(), fm, col, w, plain.vidx[k],
                    plain.start_e, plain.row_start[k], int(total), e,
                    _relax_op(op), rows=kept, **kw)
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


# ---- merge_path_relax: the merge-path pair's fused pass -------------------

def _mp_slots(dev, deg, row_ptr, hv, pad):
    """A slot list of the vertices ``hv`` (int32 on ``dev``: hvidx,
    start_e, row_start) with ``pad`` sentinel slots (deg 0: a host
    round's bucket padding), and its edge total."""
    v = len(deg)
    hvidx, hdeg, hrow = (np.concatenate([a, np.full(pad, f)]).astype(np.int32)
                         for a, f in ((hv, v), (deg[hv], 0), (row_ptr[hv], 0)))
    start_e = (np.cumsum(hdeg) - hdeg).astype(np.int32)
    return ([torch.from_numpy(a).to(dev) for a in (hvidx, start_e, hrow)],
            int(hdeg.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
@pytest.mark.parametrize("b", [1, 3, 8])
def test_cuda_merge_path_relax_matches_plain(cuda_device, op, b):
    """The host entry: one-slot lists (one tile, several tiles), several
    slots with bucket padding, 2,000 slots, a 3,000-slot zero-degree run
    (a window wider than a 2048-id tile's stage) and a V-row layout;
    tiles of 128 and 2048 ids and of 65,536 (a stage past what a block's
    shared memory holds: global windows); bucketed and ragged spans;
    launches counted."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v = len(deg)
    val, lab, fm = _relax_state(cuda_device, op, b, v, b + 17)
    rng = np.random.default_rng(b)
    rows = np.flatnonzero(rng.random(v) < 0.3)
    cases = [[2], [0], list(range(7)), list(range(200, 2200)),
             [1] + [11] * 3000 + [2], list(rows)]
    before = trelax.merge_path_relax.launches
    launched = 0
    for hv in cases:
        t, total = _mp_slots(cuda_device, deg, row_ptr, np.array(hv),
                             0 if len(hv) == 1 else 5)
        for tile in (128, 2048, 65_536):
            for ecap in sorted({total, next_pow2(max(total, tile))}):
                kw = dict(tile_edges=tile)
                got = trelax.merge_path_relax(val, lab.clone(), fm, col, w,
                                              *t, total, ecap, _relax_op(op),
                                              **kw)
                want = tref.merge_path_relax_ref(val, lab.clone(), fm, col,
                                                 w, *t, total, ecap,
                                                 _relax_op(op), **kw)
                _assert_relax_equal(op, got, want)
                launched += 1
    assert trelax.merge_path_relax.launches == before + launched


@pytest.mark.gpu
@pytest.mark.parametrize("op", RELAX_OPS)
def test_cuda_merge_path_relax_static_entry_matches_plain(cuda_device, op):
    """The static entry, B = 2, every edge of the graph as the span: over
    the kernel's own LB-all list (``twc_bin_list``) with its device count
    and total, over the plain list with device counts 0, 1 and V and
    the total of the slots they keep, and over V rows with a device
    total (0, one vertex, several, 2,000); tiles of 128 and 2048."""
    col, w, row_ptr, deg = _relax_graph(cuda_device)
    v, e = len(deg), int(row_ptr[-1])
    val, lab, fm = _relax_state(cuda_device, op, 2, v, 23)
    mask = _frontier_mask(cuda_device, v, 0.5, 9, 2)
    rp = torch.from_numpy(row_ptr).to(cuda_device)
    bounds = LB_BOUNDS["edge_lb"]
    kern = trelax.twc_bin_list(mask, rp, bounds, lb=True)
    plain = tref.twc_bin_list_ref(mask, rp, bounds, lb=True)
    members = int(plain.count[0])
    cases = [(kern, kern.count, kern.total, members)]
    for c in (0, 1, v):
        kept = min(c, members)
        total = int(plain.start_e[kept]) if kept < members else \
            int(plain.total)
        cases.append((plain, _dev_int(c, cuda_device),
                      _dev_int(total, cuda_device), kept))
    for tile in (128, 2048):
        for lists, count, total, kept in cases:
            got = trelax.merge_path_relax(
                val, lab.clone(), fm, col, w, lists.vidx[0], lists.start_e,
                lists.row_start[0], total, e, _relax_op(op), rows=count,
                tile_edges=tile)
            want = tref.merge_path_relax_ref(
                val, lab.clone(), fm, col, w, plain.vidx[0], plain.start_e,
                plain.row_start[0], int(total), e, _relax_op(op), rows=kept,
                tile_edges=tile)
            _assert_relax_equal(op, got, want)
        for hv in ([], [0], list(range(7)), list(range(12, 2012))):
            member = np.zeros(v, bool)
            member[hv] = True
            hvidx, hdeg, hrow = (np.where(member, a, f).astype(np.int32)
                                 for a, f in ((np.arange(v), v), (deg, 0),
                                              (row_ptr[:-1], 0)))
            start_e = (np.cumsum(hdeg) - hdeg).astype(np.int32)
            t = [torch.from_numpy(a).to(cuda_device)
                 for a in (hvidx, start_e, hrow)]
            total = int(hdeg.sum())
            got = trelax.merge_path_relax(
                val, lab.clone(), fm, col, w, *t,
                _dev_int(total, cuda_device), e, _relax_op(op),
                tile_edges=tile)
            want = tref.merge_path_relax_ref(val, lab.clone(), fm, col, w,
                                             *t, total, e, _relax_op(op),
                                             tile_edges=tile)
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
        "twc_bin_relax": 3, "edge_lb_relax": 0, "merge_path_relax": 0,
        "twc_bin_list": 0, "merge_path_map": 0, "round_turn": 0}


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
@pytest.mark.parametrize("strategy", ["twc", "alb", "edge_lb"])
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


def _mesh_pair(cuda_device, scale=12, reverse=False):
    """A 4-partition mesh on one card and the same partition on a CPU
    mesh (cut on the card, carried to the CPU slots unchanged)."""
    from repro_torch.core import graph as tg
    from repro_torch.core import partition as tp
    from repro_torch.core.collectives import device_mesh
    g = tg.rmat(scale, 8, seed=2, device=cuda_device)
    cut = g.reverse() if reverse else g
    card = device_mesh(4, devices=[cuda_device] * 4)
    cpu = device_mesh(4, devices=["cpu"] * 4)
    local, meta = tp.partition(cut, 4, "oec", mesh=card)
    local_cpu = tp.LocalGraphs(tg.to_device(x, "cpu") for x in local)
    return g, (card, local), (cpu, local_cpu), meta


@pytest.mark.gpu
@pytest.mark.parametrize("sync", ["replicated", "mirror"])
@pytest.mark.parametrize("mode", ["host", "fused"])
def test_cuda_distributed_sssp_matches_cpu_mesh(cuda_device, sync, mode):
    """A 4-partition mesh on one card (the kernel pair, each partition's
    round a replay of its captured program, or the whole traversal one
    graph launch) against the same mesh on the CPU (the plain
    versions): labels and rounds equal, host transfers as host mode
    counts them (0 fused), per-round stats equal in host mode; a second
    fused call captures nothing."""
    from repro_torch.core import gluon
    from repro_torch.core import graph_loop as gl
    from repro_torch.core.balancer import BalancerConfig, host_transfer_count
    g, (card, lc), (cpu, lh), meta = _mesh_pair(cuda_device)
    cfg = BalancerConfig(use_pallas=True, threshold=64)
    stats = mode == "host"
    out = {}
    for name, mesh, local in (("card", card, lc), ("cpu", cpu, lh)):
        t0 = host_transfer_count()
        res = gluon.sssp_distributed(local, mesh, 0, cfg, sync=sync,
                                     meta=meta, mode=mode,
                                     collect_stats=stats)
        out[name] = res, host_transfer_count() - t0
    (rc, tc), (rh, th) = out["card"], out["cpu"]
    assert torch.equal(rc[0].cpu(), rh[0]) and rc[1] == rh[1] > 0
    assert tc == th == (0 if mode == "fused" else
                        rh[1] + (sync == "replicated"))
    for a, b in zip(rc[3] if stats else (), rh[3] if stats else ()):
        for x, y in zip(a, b):
            for f in y._fields:
                np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                              np.asarray(getattr(y, f)),
                                              err_msg=f)
    if mode == "fused":
        before = gl.captures
        again = gluon.sssp_distributed(lc, card, 0, cfg, sync=sync,
                                       meta=meta, mode=mode)
        assert gl.captures == before and torch.equal(again[0], rc[0])
        assert gl.release(lc) >= 1 and gl.release(lc) == 0
        third = gluon.sssp_distributed(lc, card, 0, cfg, sync=sync,
                                       meta=meta, mode=mode)
        assert gl.captures == before + 1 and torch.equal(third[0], rc[0])


@pytest.mark.gpu
@pytest.mark.parametrize("sync", ["replicated", "mirror"])
def test_cuda_distributed_pagerank_matches_cpu_mesh(cuda_device, sync):
    """Pagerank over the partitioned reverse graph on one card, host and
    fused mode, against the CPU mesh: ranks within FLOAT_ADD_RTOL (the
    huge bin adds with atomics), rounds equal."""
    from repro_torch.core import gluon
    from repro_torch.core.balancer import BalancerConfig
    g, (card, lc), (cpu, lh), meta = _mesh_pair(cuda_device, reverse=True)
    cfg = BalancerConfig(use_pallas=True, threshold=64)
    want = gluon.pagerank_distributed(lh, cpu, g.out_degrees().cpu(),
                                      cfg=cfg, max_rounds=12, tol=0.0,
                                      sync=sync, meta=meta)
    for mode in ("host", "fused"):
        got = gluon.pagerank_distributed(lc, card, g.out_degrees(), cfg=cfg,
                                         max_rounds=12, tol=0.0, sync=sync,
                                         meta=meta, mode=mode)
        torch.testing.assert_close(got[0].cpu(), want[0],
                                   rtol=FLOAT_ADD_RTOL, atol=0)
        assert got[1] == want[1] == 12


@pytest.mark.gpu
@pytest.mark.parametrize("op_name", ["SSSP_RELAX", "KCORE_DEC"])
def test_cuda_replicated_shared_labels_equal_private_copies(cuda_device,
                                                            op_name):
    """The four partitions of one card share the replicated label tensor
    (the kernel pair combines in place into a private copy it makes):
    a round over the shared tensor equals, bitwise, the round given a
    private copy per partition, and leaves the shared tensor as it
    was."""
    from repro_torch.core import gluon
    from repro_torch.core.balancer import BalancerConfig, relax_spmd
    _, (card, lc), _, _ = _mesh_pair(cuda_device)
    op = getattr(tops, op_name)
    delta = op.combine == "add"
    cfg = BalancerConfig(use_pallas=True, threshold=64)
    v = lc.num_vertices
    rng = np.random.default_rng(9)
    labels = torch.from_numpy(rng.integers(0, 1000, (2, v)).astype(
        np.int32)).to(cuda_device)
    frontier = torch.from_numpy(rng.random((2, v)) < 0.3).to(cuda_device)
    keep = labels.clone()
    shared = gluon.make_round_fn(card, cfg, op, sync_delta=delta)(
        lc, labels, labels, frontier)
    assert torch.equal(labels, keep)
    outs = [relax_spmd(g, labels.clone(), torch.zeros_like(labels)
                       if delta else labels.clone(), frontier.clone(), cfg,
                       op) for g in lc]
    red = outs[0]
    for o in outs[1:]:
        red = red + o if delta else torch.minimum(red, o)
    assert torch.equal(shared, labels + red if delta else red)


# ---- the training path on the card --------------------------------------------

def _train_probs(g, t, e, k, seed, device):
    """Softmax rows where the first K experts take most, so slots
    overflow and the ALB rebalance moves some."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((g, t, e), generator=gen)
    logits[..., :k] += 2.0
    return torch.softmax(logits, -1).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["smoke", "train"])
@pytest.mark.parametrize("groups", [1, 2])
def test_cuda_moe_plan_autograd_matches_plain(cuda_device, shape, groups):
    """``moe_plan`` under autograd on the card: its forward (one launch)
    bitwise equal to the plain version, and the gate gradient of its
    hand-written backward within 1e-6 of its largest magnitude of
    autograd through the plain version, at the SMOKE config's shape
    (64 tokens, E 8, top-2) and the training shape of chip_smoke.py's
    phase 6 (8,192 tokens, E 64, top-6, cap 960)."""
    t, e, k = (64, 8, 2) if shape == "smoke" else (8192, 64, 6)
    tg = t // groups
    cap = max(int(1.25 * tg * k / e), 4)
    probs = _train_probs(groups, tg, e, k, groups, cuda_device)
    w = torch.randn((groups, tg * k), device=cuda_device)
    kw = dict(top_k=k, cap=cap, groups=groups, adaptive=True)
    outs, grads = [], []
    before = tmplan.moe_plan.launches
    for plan in (tmplan.moe_plan, tref.moe_plan_ref):
        p = probs.clone().requires_grad_()
        out = plan(p, **kw)
        (out[2] * w).sum().backward()
        outs.append(out)
        grads.append(p.grad)
    assert tmplan.moe_plan.launches == before + 1
    for a, b in zip(_plan_bits(outs[0]), _plan_bits(outs[1])):
        assert torch.equal(a, b)
    top = tmoe_top_k(probs, k)
    assert int((outs[0][0].reshape(groups, tg, k) != top).sum()) > 0
    err = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    assert err <= 1e-6, err


def tmoe_top_k(probs, k):
    from repro_torch.kernels import ref
    return ref._top_k(probs, k)[1]


def _smoke_state(device, seed=3):
    from repro_torch import configs
    from repro_torch.train import steps
    cfg = configs.get_smoke_config("deepseek-moe-16b")
    params, opt = steps.init_train_state(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, params.to(device), {
        k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict)
            else v.to(device)) for k, v in opt.items()}


@contextlib.contextmanager
def _compute_float32():
    from repro_torch.models import layers, moe, transformer
    mods = (layers, moe, transformer)
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, o in zip(mods, old):
            m.COMPUTE_DTYPE = o


@pytest.mark.gpu
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_cuda_train_steps_match_cpu(cuda_device, compute):
    """Two ``make_train_step`` steps of the MoE SMOKE config on the card
    (``moe_plan`` launched twice a layer a step: forward and remat)
    against the same steps on the CPU from the same state.  float32
    compute: losses within 1e-5 and grad norms within 1e-4 relative
    (cuBLAS and the CPU sum in other orders); bf16: the first step's
    loss within 2e-3 and grad norm within 5% (bf16 products)."""
    from repro_torch.data import SyntheticDataset
    from repro_torch.optim import OptConfig
    from repro_torch.train import steps
    ctx = _compute_float32() if compute == "float32" else \
        contextlib.nullcontext()
    runs = []
    with ctx:
        for dev in (torch.device("cpu"), cuda_device):
            cfg, params, opt = _smoke_state(dev)
            data = SyntheticDataset(1, 2, 32, cfg.vocab_size)
            step = steps.make_train_step(cfg, OptConfig(lr=3e-3))
            before = tmplan.moe_plan.launches
            out = []
            for i in range(2):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in data.batch(i).items()}
                params, opt, m = step(params, opt, batch)
                assert m["loss"].device.type == dev.type
                out.append((float(m["loss"]), float(m["grad_norm"])))
            launched = tmplan.moe_plan.launches - before
            assert launched == (4 * cfg.num_layers if dev.type == "cuda"
                                else 0)
            runs.append(out)
    cpu, card = runs
    if compute == "float32":
        for (a, b), (c, d) in zip(card, cpu):
            assert abs(a - c) <= 1e-5 * c and abs(b - d) <= 1e-4 * d
    else:
        assert abs(card[0][0] - cpu[0][0]) <= 2e-3 * cpu[0][0]
        assert abs(card[0][1] - cpu[0][1]) <= 0.05 * cpu[0][1]
    assert all(np.isfinite(v) for r in runs for s in r for v in s)


@pytest.mark.gpu
def test_cuda_checkpoint_crosses_devices(cuda_device, tmp_path):
    """A train state written from tensors on the card restores onto the
    CPU bitwise, and one written from the CPU restores onto the card
    (the template's device), bf16 leaves included."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models import convert
    _, params, opt = _smoke_state(cuda_device)
    tree = {"params": dict(params.named_parameters()),
            "mu": opt["mu"], "step": opt["step"],
            "bf16": params.embed.detach().bfloat16()}
    save_checkpoint(str(tmp_path / "card"), 1, tree)
    cpu_tmpl = {k: ({n: t.detach().cpu() for n, t in v.items()}
                    if isinstance(v, dict) else v.detach().cpu())
                for k, v in tree.items()}
    back, _ = restore_checkpoint(str(tmp_path / "card"), 1, cpu_tmpl)
    save_checkpoint(str(tmp_path / "cpu"), 2, cpu_tmpl)
    again, _ = restore_checkpoint(str(tmp_path / "cpu"), 2, tree)
    for key in tree:
        a = tree[key] if isinstance(tree[key], dict) else {"": tree[key]}
        b = back[key] if isinstance(back[key], dict) else {"": back[key]}
        c = again[key] if isinstance(again[key], dict) else {"": again[key]}
        for n in a:
            assert b[n].device.type == "cpu"
            assert c[n].device.type == "cuda"
            assert b[n].dtype == c[n].dtype == a[n].dtype
            assert torch.equal(b[n], a[n].detach().cpu())
            assert torch.equal(c[n], a[n].detach())
    state = convert.train_state_to_jax_tree(params, opt)
    assert state["params"]["layers"]["moe"]["w_up"].shape[0] == 2


@pytest.mark.gpu
def test_cuda_trainer_runs_and_resumes(cuda_device, tmp_path, capsys):
    """``launch.train.main`` on the card: 4 steps with a checkpoint, then
    resumed to 6 from it."""
    from repro_torch.launch import train
    args = ["--arch", "deepseek-moe-16b", "--smoke", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    assert np.isfinite(train.main(args + ["--steps", "4"]))
    assert np.isfinite(train.main(args + ["--steps", "6"]))
    assert "[restore] resumed from step 3" in capsys.readouterr().out


@pytest.mark.gpu
def test_cuda_sharded_prefill_launches_the_kernels(cuda_device):
    """A SMOKE deepseek-moe-16b prefill (widened to head width 64, the
    wgmma route) through DTensor parameters, cache and tokens on a
    1-rank NCCL group's ``(1, 1)`` mesh: ``flash_attention`` runs on its
    wgmma route once a layer and ``moe_plan`` once a layer, on the local
    shards (the counters say so), and the logits and the cache are
    bitwise those of the unsharded call."""
    import dataclasses
    import os
    import socket

    import torch.distributed as dist
    from repro_torch import configs, kernels
    from repro_torch.launch import distributed_init as DI
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.train import steps

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"REPRO_COORDINATOR": f"127.0.0.1:{port}",
           "REPRO_NUM_PROCESSES": "1", "REPRO_PROCESS_ID": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert DI.maybe_initialize_distributed()
        assert dist.get_backend() == "nccl"
        mesh = M.make_host_mesh()
        cfg = dataclasses.replace(
            configs.get_smoke_config("deepseek-moe-16b"), d_model=256)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        model = T.init(cfg, generator=gen, device=cuda_device)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(cuda_device)
        cache = T.zeros_cache(cfg, 2, 64, device=cuda_device)
        want, want_cache = T.prefill(model, cfg, toks, cache)
        SH.distribute_params(model, mesh, SH.param_specs(model),
                             from_local=True)
        dcache = SH.distribute_tree(
            T.zeros_cache(cfg, 2, 64, device=cuda_device), mesh,
            SH.cache_specs(cfg, False, 0, 64, 1), from_local=True)
        dtoks = SH.distribute_tree(toks, mesh, ("data", None),
                                   from_local=True)
        kernels.reset_launch_counts()
        got, dcache = steps.make_prefill_step(
            cfg, SH.make_shard_fn(mesh, False))(model, dtoks, dcache)
        fa = kernels.KERNELS["flash_attention"]
        assert fa.launches_by_route == {"wgmma": cfg.num_layers, "simt": 0}
        assert kernels.KERNELS["moe_plan"].launches == cfg.num_layers
        assert torch.equal(got.full_tensor(), want)
        for n, t in dcache["kv"].items():
            assert torch.equal(t.full_tensor(), want_cache["kv"][n]), n
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---- the traversal spans on the card (core/spans.py) ------------------------

def _stamp_ring():
    from repro_torch.core import spans
    return next(r for d, r in spans._RINGS.items() if d.type == "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["push", "pull", "adaptive"])
def test_cuda_spans_stamp_each_round(cuda_device, direction):
    """Traced fused traversals on the card: each round's phases in order
    and back to back inside the loop, the loop inside the driver's span,
    the stamped counts equal to ``collect_stats``, labels and rounds
    bitwise the untraced ones, and one capture per key for traced and
    untraced calls."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import balancer as tb
    from repro_torch.core import graph_loop as gl
    from repro_torch.core.apps import drivers as td
    g, _ = _card_and_host_graph(cuda_device, scale=12)
    cfg = tb.BalancerConfig(use_pallas=True, threshold=64,
                            direction=direction)
    for app, run in (
            ("sssp", lambda **kw: td.sssp(g, 0, cfg, mode="fused", **kw)),
            ("sssp_batch", lambda **kw: td.sssp_batch(
                g, [0, 1, 2, 3], cfg, mode="fused", **kw))):
        plain, stats = run(), run(collect_stats=True).stats
        before = gl.captures
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            res = run()
        again = run()
        assert gl.captures == before
        assert torch.equal(res.labels, plain.labels)
        assert torch.equal(again.labels, plain.labels)
        assert res.rounds == plain.rounds == again.rounds > 0
        assert again.spans is None
        rec = res.spans
        assert len(rec.rounds) == res.rounds and rec.overflow == 0
        top = rec.host_span(f"repro.{app}")
        assert top[1] <= rec.loop[0] < rec.loop[1] <= top[2]
        # the first round starts once the loop has set up its carry
        t = rec.rounds[0].phases["inspect"][0]
        assert t >= rec.loop[0]
        for rnd, st in zip(rec.rounds, stats):
            assert list(rnd.phases) == ["inspect", "list", "bin.small",
                                        "bin.medium", "bin.large", "lb",
                                        "turn"]
            for a, b in rnd.phases.values():
                assert a == t and b >= a
                t = b
            c = rnd.counts
            assert (c["n_f"], c["m_f"], c["lb_edges"]) == \
                (st.frontier_size, st.frontier_edges, st.edges_lb)
        assert t == rec.loop[1]
        assert {"repro.graph.copy_in", "repro.graph.launch",
                "repro.graph.copy_out", "repro.fetch"} <= \
            {h[0] for h in rec.host}


@pytest.mark.gpu
def test_cuda_spans_flag_off_writes_nothing(cuda_device):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import balancer as tb
    from repro_torch.core.apps import drivers as td
    g, _ = _card_and_host_graph(cuda_device, scale=11)
    cfg = tb.BalancerConfig(use_pallas=True, threshold=64)
    with profile(activities=[ProfilerActivity.CPU]):
        td.sssp(g, 0, cfg, mode="fused")
    ring = _stamp_ring()
    torch.cuda.synchronize()
    assert ring.buf.any()
    ring.buf.zero_()
    res = td.sssp(g, 3, cfg, mode="fused")
    torch.cuda.synchronize()
    assert res.rounds > 0 and not ring.on
    assert not ring.buf.any()


@pytest.mark.gpu
def test_cuda_spans_clock_matches_the_profiler(cuda_device):
    """The eager stamp before the graph launch, mapped onto the host
    clock, lands within 50 us of the profiler's own start of that
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import balancer as tb
    from repro_torch.core.apps import drivers as td
    g, _ = _card_and_host_graph(cuda_device, scale=12)
    cfg = tb.BalancerConfig(use_pallas=True, threshold=64)
    td.sssp(g, 0, cfg, mode="fused")        # the ring made and calibrated
    for src in (1, 2, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = td.sssp(g, src, cfg, mode="fused")
        t0 = prof.profiler.kineto_results.trace_start_ns()
        starts = sorted(t0 + e.time_range.start * 1e3 for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and "span_stamp" in e.name)
        assert starts, "the profiler saw no span_stamp kernel"
        assert abs(starts[0] - res.spans.launch_ns) < 50e3
        assert res.spans.launch_ns <= res.spans.loop[0]


@pytest.mark.gpu
def test_cuda_program_alive_at_exit_closes_quietly(cuda_device):
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(src)!r})
        import torch
        from repro_torch.core import graph_loop
        x = torch.arange(4, device="cuda", dtype=torch.float32)
        keep = graph_loop.Program(lambda t: t * 2, (x,), keep=())
        print(float(keep(x).sum()), flush=True)
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["12.0"]
    assert "Traceback" not in out.stderr and "Exception" not in out.stderr


# ---- the fused min loop's turn (csrc/round_turn.cu) ----------------------

def _turn_state(dev, v, b, share, dtype, seed):
    """``(lab, new, row_ptr, fr)`` on ``dev``: ``new <= lab`` lowered at
    ``share`` of the labels (int64 ones past 2**32), a CSR with a few
    hubs, a frontier of junk the turn overwrites."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 1 << 30, (b, v)).astype(np.int32)
    lab[:, rng.random(v) < 0.01] = np.iinfo(np.int32).max
    new = np.where(rng.random((b, v)) < share,
                   lab - rng.integers(1, 1 << 20, (b, v)), lab)
    lab, new = (torch.from_numpy(x.astype(np.int32)).to(dev)
                for x in (lab, new))
    if dtype == torch.int64:
        lab, new = lab.long() << 20, new.long() << 20
    lab, new = lab.to(dtype), new.to(dtype)
    deg = rng.integers(0, 40, v)
    deg[rng.random(v) < 1e-4] = 100_000
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                               .astype(np.int32)).to(dev)
    fr = torch.from_numpy(rng.random((b, v)) < 0.5).to(dev)
    return lab, new, row_ptr, fr


@pytest.mark.gpu
@pytest.mark.parametrize("v", [20_000, 3_000_001])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("share", [0.0, 0.001, 0.2, 1.0])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32,
                                   torch.int64, torch.float64])
def test_cuda_round_turn_matches_plain(cuda_device, v, b, share, dtype):
    """The kernel bitwise against its plain version on the same card:
    the frontier, the labels and the census, twice on one census buffer
    (each launch leaves its scratch at 0); then its census entry.  V
    20,000 takes the 16-byte path, V 3,000,001 the element path."""
    lab, new, row_ptr, fr = _turn_state(cuda_device, v, b, share, dtype, 7)
    want_lab, want_fr = lab.clone(), fr.clone()
    want = tref.round_turn_ref(want_lab, new, row_ptr, want_fr,
                               trelax.census_buffer(cuda_device))
    census = trelax.census_buffer(cuda_device)
    for _ in range(2):
        got_lab, got_fr = lab.clone(), fr.clone()
        trelax.round_turn(got_lab, new, row_ptr, got_fr, census)
        torch.cuda.synchronize()
        assert torch.equal(got_fr, want_fr)
        assert torch.equal(got_lab.view(torch.int32),
                           want_lab.view(torch.int32))
        assert torch.equal(census, want)
    seen = trelax.round_turn(None, None, row_ptr, fr, census)
    keep = fr.clone()
    assert torch.equal(seen, tref.round_turn_ref(
        None, None, row_ptr, keep, trelax.census_buffer(cuda_device)))
    assert torch.equal(fr, keep)


@pytest.mark.gpu
def test_cuda_round_turn_refuses_other_label_dtypes(cuda_device):
    """On the card the wrapper raises on labels that are not 32- or
    64-bit int or float words; it never turns them in torch ops."""
    lab, new, row_ptr, fr = _turn_state(cuda_device, 1000, 2, 0.2,
                                        torch.int32, 3)
    for dtype in (torch.int16, torch.float16, torch.uint8):
        with pytest.raises(TypeError, match="on the card"):
            trelax.round_turn(lab.to(dtype), new.to(dtype), row_ptr, fr,
                              trelax.census_buffer(cuda_device))


@pytest.mark.gpu
def test_cuda_round_turn_unaligned_rows_take_the_element_path(cuda_device):
    """Labels that start off a 16-byte boundary (a view one label in)
    and V a multiple of 4: the element path, bitwise the plain one."""
    v, b = 40_000, 3
    lab, new, row_ptr, fr = _turn_state(cuda_device, v + 1, b, 0.2,
                                        torch.int32, 9)
    lab, new = lab.reshape(-1)[1:b * v + 1], new.reshape(-1)[1:b * v + 1]
    lab, new = lab.view(b, v), new.view(b, v)
    row_ptr, fr = row_ptr[:v + 1].contiguous(), fr.reshape(-1)[:b * v]
    fr = fr.view(b, v)
    want_lab, want_fr = lab.clone(), fr.clone()
    want = tref.round_turn_ref(want_lab, new, row_ptr, want_fr,
                               trelax.census_buffer(cuda_device))
    census = trelax.round_turn(lab, new, row_ptr, fr,
                               trelax.census_buffer(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(lab, want_lab) and torch.equal(fr, want_fr)
    assert torch.equal(census, want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,direction", [
    ("pallas", "push"), ("pallas", "adaptive"), ("merge_path", "pull"),
    ("xla", "push")])
def test_cuda_captured_fused_sssp_matches_eager(cuda_device, backend,
                                                direction):
    """A captured fused sssp and sssp_batch (one graph launch, the turn
    in its WHILE body) against the same loop run eagerly on the CPU:
    labels, rounds and every stat bitwise; then again from the cached
    program."""
    from repro_torch.core import balancer as tb
    from repro_torch.core import graph_loop as gl
    from repro_torch.core.apps import drivers as td
    gc, gh = _card_and_host_graph(cuda_device, scale=12)
    cfg = tb.BalancerConfig(backend=backend, direction=direction,
                            threshold=64)
    for run in (lambda g, s: td.sssp(g, s, cfg, mode="fused",
                                     collect_stats=True),
                lambda g, s: td.sssp_batch(g, [s, s + 1, s + 7], cfg,
                                           mode="fused",
                                           collect_stats=True)):
        for src in (0, 3):
            card, host = run(gc, src), run(gh, src)
            assert torch.equal(card.labels.cpu(), host.labels)
            assert card.rounds == host.rounds > 0
            for a, b in zip(card.stats, host.stats):
                for f in a._fields:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a, f)),
                        np.asarray(getattr(b, f)), err_msg=f)
        before = gl.captures
        assert torch.equal(run(gc, 0).labels.cpu(), run(gh, 0).labels)
        assert gl.captures == before


@pytest.mark.gpu
def test_cuda_round_turn_launches_rounds_plus_one(cuda_device):
    """A fused min traversal launches ``round_turn`` once a round and
    once for its first census, counted on the card; the spmd round,
    kcore's and pagerank's loops launch it never."""
    from repro_torch import kernels as tk
    from repro_torch.core import balancer as tb
    from repro_torch.core import graph as tg
    from repro_torch.core.apps import drivers as td
    g, _ = _card_and_host_graph(cuda_device, scale=12)
    cfg = tb.BalancerConfig(use_pallas=True, threshold=64)
    ada = tb.BalancerConfig(use_pallas=True, threshold=64,
                            direction="adaptive")
    for run in (lambda: td.sssp(g, 0, cfg, mode="fused"),
                lambda: td.bfs(g, 3, ada, mode="fused"),
                lambda: td.sssp_batch(g, [0, 1, 2, 3], cfg, mode="fused")):
        for _ in range(2):               # the capture, then a replay
            tk.device_launch_counts(reset=True)
            res = run()
            assert tk.device_launch_counts(reset=True)["round_turn"] == \
                res.rounds + 1
    sym = tg.symmetrized(g)
    for run in (lambda: td.sssp(g, 0, ada, mode="spmd"),
                lambda: td.kcore(sym, 6, cfg, mode="fused"),
                lambda: td.pagerank(g, cfg=cfg, mode="fused",
                                    max_rounds=5)):
        tk.device_launch_counts(reset=True)
        assert run().rounds > 0
        assert tk.device_launch_counts(reset=True)["round_turn"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_cuda_fused_loop_turns_int64_labels(cuda_device, backend):
    """int64 labels past 2**32 through the public ``resume_loop``: the
    captured fused loop on the card turns them with the kernel (rounds
    + 1 launches) and equals host mode on the CPU."""
    from repro_torch import kernels as tk
    from repro_torch.core import balancer as tb
    from repro_torch.core import operators as tops
    from repro_torch.core.apps import drivers as td
    gc, gh = _card_and_host_graph(cuda_device, scale=12)
    cfg = tb.BalancerConfig(threshold=64, backend=backend)
    v = gh.num_vertices
    lab = torch.full((v,), 1 << 40, dtype=torch.int64)
    lab[0] = 0
    fr = lab == 0
    want = td.resume_loop(gh, lab.clone(), fr.clone(), cfg,
                          tops.SSSP_RELAX, mode="host")
    tk.device_launch_counts(reset=True)
    got = td.resume_loop(gc, lab.to(cuda_device), fr.to(cuda_device), cfg,
                         tops.SSSP_RELAX, mode="fused")
    assert tk.device_launch_counts(reset=True)["round_turn"] == \
        got.rounds + 1
    assert got.labels.dtype == torch.int64
    assert torch.equal(got.labels.cpu(), want.labels)
    assert got.rounds == want.rounds > 2


@pytest.mark.gpu
def test_cuda_fused_program_keeps_no_shadow_labels(cuda_device):
    """After a fused sssp's capture the memory still allocated is the
    program's copies of its inputs and its carry (and the caller's
    result): the loop's shadow of the labels lives in the program's
    pool only, as the per-round copy it replaces did."""
    from repro_torch.core import balancer as tb
    from repro_torch.core import graph as tg
    from repro_torch.core.apps import drivers as td
    cfg = tb.BalancerConfig(use_pallas=True, threshold=64)
    small, _ = _card_and_host_graph(cuda_device, scale=8)
    td.sssp(small, 0, cfg, mode="fused")    # the stamp ring, made once
    g = tg.rmat(20, 8, seed=4, device=cuda_device)
    v = g.num_vertices
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    res = td.sssp(g, 0, cfg, mode="fused")
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated(cuda_device) - before \
        - res.labels.numel() * 4
    # inputs and carry: int32 labels and a bool frontier, twice
    assert res.rounds > 1
    assert kept <= 2 * (4 * v + v) + (1 << 20), (kept, v)
