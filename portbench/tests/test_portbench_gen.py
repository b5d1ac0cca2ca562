"""The device generators, run on the CPU at scale 8-10."""
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import gen

CONFIGS = ["gap-kron-s26", "gap-urand-s26"]


def config(name, scale):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["scale"] = scale
    return cfg


def numpy_csr(src, dst, w, n):
    """The host build of ``repro_torch.core.graph.from_edge_list`` on the
    undirected edge list: self-loops out, both ways, minimum weight kept
    (an independent loop over a dict)."""
    best = {}
    for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
        if s == d:
            continue
        for key in ((s, d), (d, s)):
            best[key] = min(best.get(key, x), x)
    keys = sorted(best)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptr, np.array([k[0] for k in keys], dtype=np.int64) + 1, 1)
    return (np.cumsum(row_ptr), np.array([k[1] for k in keys]),
            np.array([best[k] for k in keys]))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("scale", [8, 10])
def test_csr_equals_numpy_build(name, scale):
    cfg = config(name, scale)
    edges, n, hi, _ = gen.make_edges(cfg, 12345, "cpu")
    src, dst, w = (t.clone() for t in edges)
    row_ptr, col_idx, edge_w = gen.undirected_csr(edges, n, hi)
    want = numpy_csr(src, dst, w, n)
    np.testing.assert_array_equal(row_ptr.numpy(), want[0])
    np.testing.assert_array_equal(col_idx.numpy(), want[1])
    np.testing.assert_array_equal(edge_w.numpy(), want[2])
    for t in (row_ptr, col_idx, edge_w):
        assert t.dtype == torch.int32


@pytest.mark.parametrize("name", CONFIGS)
def test_bucketed_sort_equals_one_sort(name):
    cfg = config(name, 10)
    edges, n, hi, _ = gen.make_edges(cfg, 2**31 + 9, "cpu")
    copy = [t.clone() for t in edges]
    whole = gen.undirected_csr(edges, n, hi)
    parts = gen.undirected_csr(copy, n, hi, chunk=4096)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


@pytest.mark.parametrize("name", CONFIGS)
def test_deterministic_per_seed(name):
    cfg = config(name, 9)
    a, _ = gen.make_graph(cfg, 2**31 + 7, "cpu")
    b, _ = gen.make_graph(cfg, 2**31 + 7, "cpu")
    c, _ = gen.make_graph(cfg, 2**31 + 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(a, c))


@pytest.mark.parametrize("name", CONFIGS)
def test_symmetric_no_self_loops_weights(name):
    cfg = config(name, 10)
    (row_ptr, col_idx, edge_w), _ = gen.make_graph(cfg, 99, "cpu")
    n = row_ptr.numel() - 1
    src = torch.repeat_interleave(torch.arange(n), (row_ptr[1:]
                                                    - row_ptr[:-1]).long())
    assert not bool((src == col_idx).any())
    fwd = {(s, d): x for s, d, x in zip(src.tolist(), col_idx.tolist(),
                                       edge_w.tolist())}
    assert len(fwd) == col_idx.numel()          # no duplicate arcs
    assert all(fwd[(d, s)] == x for (s, d), x in fwd.items())
    lo, hi = cfg["weights"]
    assert int(edge_w.min()) >= lo and int(edge_w.max()) <= hi


def test_kron_is_skewed_urand_is_not():
    degs = {}
    for name in CONFIGS:
        (row_ptr, _, _), _ = gen.make_graph(config(name, 10), 5, "cpu")
        degs[name] = (row_ptr[1:] - row_ptr[:-1]).float()
    kron, urand = degs["gap-kron-s26"], degs["gap-urand-s26"]
    assert kron.max() > 8 * kron.mean()
    assert urand.max() < 3 * urand.mean()


def test_sources_have_edges_and_differ():
    cfg = config("gap-kron-s26", 10)
    (row_ptr, _, _), rng = gen.make_graph(cfg, 3, "cpu")
    srcs = gen.draw_sources(row_ptr, 512, rng)
    deg = (row_ptr[1:] - row_ptr[:-1])
    assert len(srcs) == len(set(srcs)) == 512
    assert all(int(deg[s]) > 0 for s in srcs)
    (row_ptr2, _, _), rng2 = gen.make_graph(cfg, 3, "cpu")
    assert gen.draw_sources(row_ptr2, 512, rng2) == srcs
    with pytest.raises(ValueError):
        gen.draw_sources(row_ptr, int((deg > 0).sum()) + 1, rng)
