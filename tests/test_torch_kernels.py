"""Port parity: the plain versions of the three mapping kernels
(``repro_torch.kernels``) against the Pallas kernels of the JAX package,
run in interpret mode as tests/test_kernels_graph.py and
tests/test_fused.py run them.

Exact comparison (int32 and bit-copied values, tolerance 0): the masks
are equal and every masked position agrees.  On CPU tensors the
wrappers compute the plain version and count no launch; the CUDA
kernels themselves are held against it on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import edge_lb as jlb
from repro.kernels import merge_path as jmp
from repro.kernels import ref as jref
from repro.kernels import twc_gather as jtwc
from repro_torch import kernels as tk
from repro_torch.core.frontier import next_bucket
from repro_torch.kernels import edge_lb as tlb
from repro_torch.kernels import merge_path as tmp
from repro_torch.kernels import ref as tref
from repro_torch.kernels import twc_gather as ttwc


def assert_masked_equal(jax_out, port_out, rows=None):
    """Masks equal; the first three outputs equal where masked."""
    j = [np.asarray(a) for a in jax_out]
    p = [t.numpy() for t in port_out]
    if rows is not None:                 # the JAX kernel pads N to 8
        j = [a[:rows] for a in j]
    m = j[3].astype(bool)
    np.testing.assert_array_equal(p[3], m)
    for a, b in zip(j[:3], p[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a[m], b[m])


def _huge(rng, h, dtype):
    deg = rng.integers(1, 300, h).astype(np.int32)
    start_e = (np.cumsum(deg) - deg).astype(np.int32)
    row = rng.integers(0, 1 << 20, h).astype(np.int32)
    val = rng.integers(0, 1 << 10, h).astype(dtype)
    return deg, start_e, row, val


@pytest.mark.parametrize("h", [8, 64, 1000])
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_edge_lb_plain_matches_pallas(h, distribution, dtype):
    rng = np.random.default_rng(h)
    deg, start_e, row, val = _huge(rng, h, dtype)
    total = int(deg.sum())
    # the main path's bucketed span, and a ragged one (span padding)
    for n_enum in (next_bucket(total, 2048), total):
        j = jlb.edge_lb_map(jnp.asarray(start_e), jnp.asarray(row),
                            jnp.asarray(val), jnp.int32(total), n_enum,
                            distribution=distribution)
        p = tlb.edge_lb_map(torch.from_numpy(start_e),
                            torch.from_numpy(row), torch.from_numpy(val),
                            total, n_enum, distribution=distribution)
        assert p[0].shape == j[0].shape
        assert_masked_equal(j, p)


@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
@pytest.mark.parametrize("num_tiles", [64, 7])
def test_edge_lb_full_coverage(distribution, num_tiles):
    """Every edge of every huge vertex appears exactly once, whatever
    ``num_tiles`` does to the span (the exact-span contract)."""
    rng = np.random.default_rng(7)
    deg, start_e, row, val = _huge(rng, 128, np.int32)
    total = int(deg.sum())
    ge, j, v, m = tlb.edge_lb_map(
        torch.from_numpy(start_e), torch.from_numpy(row),
        torch.from_numpy(val), total, next_bucket(total, 2048),
        distribution=distribution, num_tiles=num_tiles)
    got = np.sort(ge[m].numpy())
    want = np.sort(np.concatenate(
        [np.arange(r, r + d) for r, d in zip(row, deg)]))
    np.testing.assert_array_equal(got, want)
    # slot j and its value are those of the edge's vertex
    jj = j[m].numpy()
    assert np.all((ge[m].numpy() >= row[jj]) &
                  (ge[m].numpy() < row[jj] + deg[jj]))
    np.testing.assert_array_equal(v[m].numpy(), val[jj])


@pytest.mark.parametrize("width", [8, 128, 1024])
@pytest.mark.parametrize("chunk", [0, 1])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_twc_plain_matches_pallas(width, chunk, dtype):
    rng = np.random.default_rng(width + chunk)
    n = 53                                    # ragged: not a tile multiple
    vidx = rng.integers(0, 4000, n).astype(np.int32)
    vidx[::9] = 1 << 22                       # sentinel rows
    deg = rng.integers(0, (chunk + 1) * width + 1, n).astype(np.int32)
    row = rng.integers(0, 1 << 20, n).astype(np.int32)
    val = rng.integers(0, 1 << 10, n).astype(dtype)
    args = [jnp.asarray(a) for a in (vidx, deg, row, val)]
    if chunk > 0 and width % 128:
        # the Pallas kernel pads W=8 lanes to 128 and then strides chunks
        # by 128, a TPU artifact no bin of the round reaches (W=8 bins
        # are capped at one pass); the JAX oracle has the true contract
        j = jref.twc_bin_map_ref(*args, width=width, chunk=chunk,
                                 sentinel=1 << 22)
    else:
        j = jtwc.twc_bin_map(*args, width=width, chunk=chunk,
                             sentinel=1 << 22)
    p = ttwc.twc_bin_map(*[torch.from_numpy(a)
                           for a in (vidx, deg, row, val)],
                         width=width, chunk=chunk, sentinel=1 << 22)
    assert p[0].shape == (n, width)
    assert_masked_equal(j, p, rows=n)


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    tk.reset_launch_counts()
    t = [torch.arange(70, dtype=torch.int32)] * 4
    out = ttwc.twc_bin_map(*t, width=8, chunk=torch.tensor([0],
                                                           dtype=torch.int32))
    ref = tref.twc_bin_map_ref(*t, width=8, chunk=0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    s = torch.arange(64, dtype=torch.int32) * 3
    tlb.edge_lb_map(s, s, s, 190, 2048)
    out = tmp.merge_path_map(s, s, 190, 2048)
    for a, b in zip(out, tref.merge_path_map_ref(s, s, 190, 2048)):
        assert torch.equal(a, b)
    assert tk.launch_counts() == {"twc_bin_relax": 0, "edge_lb_relax": 0,
                                  "merge_path_relax": 0, "twc_bin_list": 0,
                                  "round_turn": 0, "twc_bin_map": 0, "edge_lb_map": 0,
                                  "merge_path_map": 0, "moe_plan": 0,
                                  "positions_in_expert": 0,
                                  "flash_attention": 0}


def test_wrappers_validate_inputs():
    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="vidx"):
        ttwc.twc_bin_map(i32.long(), i32, i32, i32, width=8)
    with pytest.raises(TypeError, match="val"):
        ttwc.twc_bin_map(i32, i32, i32, i32.double(), width=8)
    with pytest.raises(ValueError, match="contiguous"):
        ttwc.twc_bin_map(i32, i32, torch.zeros(16, dtype=torch.int32)[::2],
                         i32, width=8)
    with pytest.raises(ValueError, match="row_start"):
        tlb.edge_lb_map(i32, i32[:4], i32, 0, 64)
    with pytest.raises(ValueError, match="distribution"):
        tlb.edge_lb_map(i32, i32, i32, 0, 64, distribution="zigzag")
    with pytest.raises(ValueError, match="multiple of 128"):
        tmp.merge_path_map(i32, i32, 0, 64, tile_edges=100)
    with pytest.raises(ValueError, match="H >= 1"):
        tmp.merge_path_map(i32[:0], i32[:0], 0, 64)
    with pytest.raises(TypeError, match="start_e"):
        tmp.merge_path_map(i32.long(), i32, 0, 64)
    with pytest.raises(ValueError, match="row_start"):
        tmp.merge_path_map(i32, i32[:4], 0, 64)


def test_kernel_sources_present():
    from repro_torch.kernels import build
    assert build.sources() == ["edge_lb", "edge_lb_relax",
                               "flash_attention", "flash_attention_wgmma",
                               "graph_loop", "merge_path",
                               "merge_path_relax", "moe_dispatch",
                               "moe_plan", "round_turn", "twc_gather",
                               "twc_list", "twc_relax"]


def test_build_cache_key_covers_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh header and the
    flags: a changed or added header gives a new path (rebuilt, not
    loaded stale); another source's change does not."""
    from repro_torch.kernels import build
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// b\n")
    (tmp_path / "h.cuh").write_text("#define X 1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._lib_path("a")
    assert first == build._lib_path("a")
    assert first.name.startswith("a-") and first.suffix == ".so"
    (tmp_path / "b.cu").write_text("// b, changed\n")
    assert build._lib_path("a") == first
    (tmp_path / "h.cuh").write_text("#define X 2\n")
    second = build._lib_path("a")
    assert second != first
    (tmp_path / "g.cuh").write_text("// new header\n")
    assert build._lib_path("a") not in (first, second)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-g",))
    assert build._lib_path("a") not in (first, second)


def test_build_log_kept_beside_library(tmp_path, monkeypatch):
    """A library without its build's log is built again (its ptxas
    report would be lost); with it, the log is read back when no build
    of this process has one."""
    from repro_torch.kernels import build
    (tmp_path / "a.cu").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "BUILD_LOG", {})
    assert build.build_log("a") is None
    lib = build._lib_path("a")
    lib.parent.mkdir()
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "_nvcc", lambda: "true")
    job = build._start("a")                # library alone: rebuilt
    assert job is not None
    job[3].communicate()
    lib.with_suffix(".log").write_text("0 bytes spill stores")
    assert build._start("a") is None       # library and log: reused
    assert build.build_log("a") == "0 bytes spill stores"
    build.BUILD_LOG["a"] = "this process"
    assert build.build_log("a") == "this process"


# ---- merge_path_map ---------------------------------------------------------

def check_merge_path(deg, row_start, total, tile_edges, ecap=None):
    """The plain version against the Pallas kernel (interpret mode): the
    masks equal, ``graph_e`` and ``slot_j`` equal where the mask is set
    (the TPU kernel's slot on masked ids depends on its window), and 0
    there in the plain version."""
    deg = np.asarray(deg, np.int32)
    start_e = (np.cumsum(deg) - deg).astype(np.int32)
    row_start = np.asarray(row_start, np.int32)
    ecap = int(max(total, 1)) if ecap is None else ecap
    j = jmp.merge_path_map(jnp.asarray(start_e), jnp.asarray(row_start),
                           jnp.int32(total), ecap, tile_edges=tile_edges)
    p = tmp.merge_path_map(torch.from_numpy(start_e),
                           torch.from_numpy(row_start), total, ecap,
                           tile_edges=tile_edges)
    m = np.asarray(j[2])
    assert p[0].shape == j[0].shape
    np.testing.assert_array_equal(p[2].numpy(), m)
    for a, b in zip(j[:2], p[:2]):
        np.testing.assert_array_equal(np.asarray(a)[m], b.numpy()[m])
        assert not b.numpy()[~m].any()
    return p


# the four cases of tests/test_fused.py
@pytest.mark.parametrize("deg,row_start,total,tile_edges", [
    ([0, 0, 0, 0], [0, 0, 0, 0], 0, 256),
    ([5000], [17], 5000, 256),
    ([100, 900, 1, 499, 1500], [0, 100, 1000, 1001, 1500], 3000, 1024),
    ([2, 0, 0, 3, 0, 5, 0], [0, 2, 2, 2, 5, 5, 10], 10, 128),
], ids=["empty", "single_huge", "ragged_tail", "zero_degree_runs"])
def test_merge_path_plain_matches_pallas_cases(deg, row_start, total,
                                               tile_edges):
    check_merge_path(deg, row_start, total, tile_edges)


@pytest.mark.parametrize("h", [1, 61, 1000])
@pytest.mark.parametrize("tile_edges", [128, 2048])
def test_merge_path_plain_matches_pallas_sweep(h, tile_edges):
    """Random degrees with zero-degree runs, the main path's bucketed
    span (``next_bucket(total, tile_edges)``) and a ragged total."""
    rng = np.random.default_rng(h + tile_edges)
    deg = rng.integers(0, 300, h).astype(np.int32)
    deg[rng.random(h) < 0.3] = 0
    deg[0] += 1                                # total > 0
    total = int(deg.sum())
    row = rng.integers(0, 1 << 20, h).astype(np.int32)
    ge, j, m = check_merge_path(deg, row, total, tile_edges,
                                ecap=next_bucket(total, tile_edges))
    # every edge of every slot exactly once, and each in its own slot
    got = np.sort(ge[m].numpy())
    want = np.sort(np.concatenate(
        [np.arange(r, r + d) for r, d in zip(row, deg)]))
    np.testing.assert_array_equal(got, want)
    jj = j[m].numpy()
    assert np.all((ge[m].numpy() >= row[jj]) &
                  (ge[m].numpy() < row[jj] + deg[jj]))
