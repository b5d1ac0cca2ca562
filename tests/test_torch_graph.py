"""Port parity: graph generators, derived graphs (reverse, symmetrized),
frontier helpers and operators of ``repro_torch`` against the JAX
package, on the same numpy inputs (exact: int32 throughout), plus the
port's structural rules."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfr
from repro.core import graph as jg
from repro.core import operators as jops
from repro_torch.core import frontier as tfr
from repro_torch.core import graph as tg
from repro_torch.core import operators as tops

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def csr(g):
    if isinstance(g, tg.Graph):
        return [t.numpy() for t in (g.row_ptr, g.col_idx, g.edge_w)]
    return [np.asarray(a) for a in (g.row_ptr, g.col_idx, g.edge_w)]


def assert_same_csr(gj, gt):
    for a, b in zip(csr(gj), csr(gt)):
        assert a.dtype == b.dtype == np.int32
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("make", [
    lambda m, **k: m.rmat(9, 8, seed=3, **k),
    lambda m, **k: m.rmat(8, 4, seed=1, weighted=False, **k),
    lambda m, **k: m.road_grid(16, **k),
    lambda m, **k: m.uniform_random(512, **k),
    lambda m, **k: m.uniform_random(300, avg_degree=3, seed=5,
                                    weighted=False, **k),
], ids=["rmat9", "rmat8_unweighted", "road16", "uniform512",
        "uniform300_unweighted"])
def test_generators_byte_identical(make):
    assert_same_csr(make(jg), make(tg, device=CPU))


def test_from_edge_list_dedup_keeps_min_weight():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 20, 400)
    dst = rng.integers(0, 20, 400)
    w = rng.integers(1, 50, 400)
    assert_same_csr(jg.from_edge_list(src, dst, 20, weights=w),
                    tg.from_edge_list(src, dst, 20, weights=w, device=CPU))
    assert_same_csr(jg.from_edge_list(src, dst, 20, dedup=False),
                    tg.from_edge_list(src, dst, 20, dedup=False,
                                      device=CPU))


def test_to_coo_and_source_pick_match():
    gj, gt = jg.rmat(9, 8, seed=3), tg.rmat(9, 8, seed=3, device=CPU)
    for a, b in zip(jg.to_coo(gj), tg.to_coo(gt)):
        np.testing.assert_array_equal(a, b)
    assert jg.highest_out_degree_vertex(gj) == \
        tg.highest_out_degree_vertex(gt)
    np.testing.assert_array_equal(np.asarray(gj.out_degrees()),
                                  gt.out_degrees().numpy())
    assert (gt.num_vertices, gt.num_edges) == (gj.num_vertices,
                                               gj.num_edges)


def test_graph_from_numpy_takes_the_jax_state():
    gj = jg.road_grid(8)
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w, device=CPU)
    assert_same_csr(gj, gt)
    assert gt.version == 0
    gt.bump_version()
    assert gt.version == 1


def test_graph_rejects_wrong_dtype():
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        tg.Graph(z, z, z)


# ---- frontier ---------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 64, 300])
def test_compact_matches_nonzero_with_truncation(size):
    mask = np.random.default_rng(size).random(200) < 0.3
    want = np.asarray(jfr.compact(jnp.asarray(mask), size))
    got = tfr.compact(torch.from_numpy(mask), size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_frontier_helpers_match():
    for n in (0, 1, 63, 64, 65, 5000):
        for m in (64, 2048):
            assert tfr.next_bucket(n, m) == jfr.next_bucket(n, m)
    fr = np.random.default_rng(0).random((3, 50)) < 0.2
    np.testing.assert_array_equal(
        tfr.union_frontier(torch.from_numpy(fr)).numpy(),
        np.asarray(jfr.union_frontier(jnp.asarray(fr))))
    lj, fj = jfr.multi_source_state(50, [4, 0, 49], jg.INF)
    lt, ft = tfr.multi_source_state(50, [4, 0, 49], tg.INF, CPU)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(
        tfr.single_source(50, 7, CPU).numpy(),
        np.asarray(jfr.single_source(50, 7)))
    with pytest.raises(ValueError, match="flat"):
        tfr.coerce_sources([[1, 2]], CPU)


# ---- operators --------------------------------------------------------------

@pytest.mark.parametrize("name", ["SSSP_RELAX", "BFS_HOP", "CC_MIN",
                                  "KCORE_DEC", "PR_PULL"])
def test_operator_singletons_match(name):
    oj, ot = getattr(jops, name), getattr(tops, name)
    for f in ("name", "direction", "combine", "uses_weight", "wire_narrow"):
        assert getattr(oj, f) == getattr(ot, f)
    v = np.arange(6, dtype=np.int32).reshape(2, 3)
    w = np.full((1, 3), 7, np.int32)
    want = np.broadcast_to(np.asarray(oj.msg(jnp.asarray(v),
                                             jnp.asarray(w))), v.shape)
    got = ot.msg(torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_array_equal(got.expand(v.shape).numpy(), want)
    assert tops.COMMUTATIVE_COMBINES == jops.COMMUTATIVE_COMBINES


def test_as_pull_memoized_and_rejects_add():
    assert tops.as_pull(tops.BFS_HOP) is tops.as_pull(tops.BFS_HOP)
    assert tops.as_pull(tops.SSSP_RELAX).direction == "pull"
    with pytest.raises(ValueError):
        tops.as_pull(tops.KCORE_DEC)


# ---- structural rules of the port ------------------------------------------

def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10
    port = REPO / "src" / "repro_torch"
    for rel in ("configs/base.py", "models/layers.py", "models/moe.py",
                "models/transformer.py", "models/convert.py",
                "kernels/moe_dispatch.py", "kernels/flash_attention.py",
                "core/streaming.py", "serve/__init__.py", "serve/engine.py",
                "serve/queue.py", "serve/scheduler.py", "serve/stats.py",
                "serve/cache.py", "serve/publish.py",
                "serve/fleet/__init__.py", "serve/fleet/fleet.py",
                "serve/fleet/replica.py", "serve/fleet/router.py",
                "serve/fleet/trace.py", "serve/fleet/hedge.py"):
        assert port / rel in files
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}: {n}")
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.rmat(4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.road_grid(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.Graph.from_numpy([0, 1], [0], [1])
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.uniform_random(8, device="cuda")
    assert tg.resolve_device("cpu").type == "cpu"


# ---- derived graphs: reverse and symmetrized ---------------------------------

DERIVED = [
    lambda m, **k: m.rmat(9, 8, seed=3, **k),
    lambda m, **k: m.rmat(8, 4, seed=1, weighted=False, **k),
    lambda m, **k: m.road_grid(12, **k),
    lambda m, **k: m.uniform_random(300, avg_degree=3, seed=5, **k),
]
DERIVED_IDS = ["rmat9", "rmat8_unweighted", "road12", "uniform300"]


@pytest.mark.parametrize("make", DERIVED, ids=DERIVED_IDS)
def test_reverse_and_symmetrized_byte_identical(make):
    gj, gt = make(jg), make(tg, device=CPU)
    assert_same_csr(jg.reverse_graph(gj), tg.reverse_graph(gt))
    assert_same_csr(jg.symmetrized(gj), tg.symmetrized(gt))
    assert gt.max_out_degree() == gj.max_out_degree()


def test_symmetrized_keeps_min_weight_of_both_directions():
    """(u, v) and (v, u) with different weights, parallel input edges
    and self loops: the one kept edge of each pair has the minimum."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 30, 500)
    dst = rng.integers(0, 30, 500)
    w = rng.integers(1, 9, 500)
    gj = jg.from_edge_list(src, dst, 30, weights=w)
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w, device=CPU)
    sj, st = jg.symmetrized(gj), tg.symmetrized(gt)
    assert_same_csr(sj, st)
    s, d, ww = tg.to_coo(st)
    pair = dict(zip(zip(s, d), ww))
    assert all(pair[(b, a)] == c for (a, b), c in pair.items())


def test_reverse_of_padded_graph_keeps_its_filler():
    gj = jg.pad_graph(jg.rmat(7, 4, seed=2), e_multiple=1024)
    assert gj.num_edges > int(gj.row_ptr[-1])
    gt = tg.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w, device=CPU)
    assert_same_csr(jg.reverse_graph(gj), tg.reverse_graph(gt))


def test_reverse_is_memoized_per_version():
    gt = tg.rmat(7, 4, seed=2, device=CPU)
    rg = gt.reverse()
    assert gt.reverse() is rg
    gt.bump_version()
    rg2 = gt.reverse()
    assert rg2 is not rg and gt.reverse() is rg2
    assert_same_csr(rg, rg2)


def test_full_frontier_matches():
    np.testing.assert_array_equal(tfr.full_frontier(37, CPU).numpy(),
                                  np.asarray(jfr.full_frontier(37)))
