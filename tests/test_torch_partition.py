"""Port parity of the partitioner (``repro_torch.core.partition``) against
the JAX package's ``repro.core.partition``: for oec / iec / cvc x D in
{1, 2, 3, 4} on the graphs of tests/test_partition_invariants.py, the
stacked CSR and every ``PartitionMeta`` field bitwise JAX's; that
file's invariants (an exact edge decomposition, contiguous masters,
mirror lists of exactly the non-owned endpoints); ``partition_stats``;
``partitioned_from_numpy``; and the mesh placement."""
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.partition import partition as jpartition
from repro.core.partition import partition_stats as jstats
from repro_torch.core import graph as TG
from repro_torch.core import partition as TP
from repro_torch.core.collectives import device_mesh

POLICIES = ["oec", "iec", "cvc"]
DEVICE_COUNTS = [1, 2, 3, 4]
META_FIELDS = ("master_bounds", "owner", "mirror_idx", "mirror_counts")


@pytest.fixture(scope="module", params=["rmat", "road"])
def graphs(request):
    gj = (JG.rmat(8, 8, seed=7) if request.param == "rmat"
          else JG.road_grid(12, seed=7))
    return gj, TG.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w,
                                   device="cpu")


@pytest.mark.parametrize("ndev", DEVICE_COUNTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_partition_bitwise_jax(graphs, policy, ndev):
    gj, gt = graphs
    sj, mj = jpartition(gj, ndev, policy)
    local, mt = TP.partition(gt, ndev, policy)
    st = local.stacked()
    for f in ("row_ptr", "col_idx", "edge_w"):
        want = np.asarray(getattr(sj, f))
        got = getattr(st, f).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (mt.num_devices, mt.num_vertices) == (mj.num_devices,
                                                 mj.num_vertices)
    for f in META_FIELDS:
        want, got = np.asarray(getattr(mj, f)), getattr(mt, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert mt.total_mirrors == mj.total_mirrors
    assert mt.replication_factor == mj.replication_factor
    assert TP.partition_stats(local, mt) == jstats(sj, mj)
    assert TP.partition_stats(local) == jstats(sj)


def _device_coo(local, d):
    g = local[d]
    rp = g.row_ptr.numpy().astype(np.int64)
    ne = int(rp[-1])
    src = np.repeat(np.arange(len(rp) - 1, dtype=np.int64), rp[1:] - rp[:-1])
    return (src, g.col_idx.numpy().astype(np.int64)[:ne],
            g.edge_w.numpy().astype(np.int64)[:ne])


def _sorted_triples(src, dst, w):
    order = np.lexsort((w, dst, src))
    return np.stack([src[order], dst[order], w[order]], axis=1)


@pytest.mark.parametrize("ndev", DEVICE_COUNTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_partition_is_exact_edge_decomposition(graphs, policy, ndev):
    _, gt = graphs
    local, _ = TP.partition(gt, ndev, policy)
    parts = [_device_coo(local, d) for d in range(ndev)]
    union = _sorted_triples(*(np.concatenate([p[i] for p in parts])
                              for i in range(3)))
    gs, gd, gw = TG.to_coo(gt)
    ref = _sorted_triples(gs, gd, gw.astype(np.int64))
    np.testing.assert_array_equal(union, ref)
    assert sum(len(p[0]) for p in parts) == gt.num_edges
    # every local graph keeps the padding: emax edges, 0 / 1 << 30
    emax = max(max(len(p[0]) for p in parts), 1)
    for d, p in enumerate(parts):
        assert local[d].num_edges == emax
        assert torch.all(local[d].col_idx[len(p[0]):] == 0)
        assert torch.all(local[d].edge_w[len(p[0]):] == TP.PAD_WEIGHT)


@pytest.mark.parametrize("ndev", DEVICE_COUNTS)
@pytest.mark.parametrize("policy", POLICIES)
def test_partition_meta_masters_and_mirrors(graphs, policy, ndev):
    _, gt = graphs
    local, meta = TP.partition(gt, ndev, policy)
    v = gt.num_vertices
    b = meta.master_bounds
    assert b[0] == 0 and b[-1] == v
    assert np.all(np.diff(b) >= 0)
    for d in range(ndev):
        assert np.all(meta.owner[b[d]:b[d + 1]] == d)
    for d in range(ndev):
        s, t, _ = _device_coo(local, d)
        ends = np.unique(np.concatenate([s, t]))
        expected = set(ends[meta.owner[ends] != d].tolist())
        listed = set()
        for o in range(ndev):
            n = int(meta.mirror_counts[d, o])
            lst = meta.mirror_idx[d, o, :n]
            assert np.all(meta.owner[lst] == o)
            assert len(np.unique(lst)) == n
            assert np.all(meta.mirror_idx[d, o, n:] == v)
            listed |= set(lst.tolist())
        assert listed == expected
        assert not (set(range(b[d], b[d + 1])) & listed)


@pytest.mark.parametrize("policy", POLICIES)
def test_partition_stats_reports_replication_factor(graphs, policy):
    _, gt = graphs
    local, meta = TP.partition(gt, 4, policy)
    st = TP.partition_stats(local, meta)
    assert st["replication_factor"] == pytest.approx(
        (gt.num_vertices + meta.total_mirrors) / gt.num_vertices)
    assert st["replication_factor"] >= 1.0
    assert len(st["mirrors_per_device"]) == 4
    assert "replication_factor" not in TP.partition_stats(local)


@pytest.mark.parametrize("policy", POLICIES)
def test_partitioned_from_numpy_carries_jax_partition(graphs, policy):
    """JAX's partition, carried across, is the port's own partition."""
    gj, gt = graphs
    sj, mj = jpartition(gj, 4, policy)
    mesh = device_mesh(4, devices=["cpu"] * 4)
    lj, mtj = TP.partitioned_from_numpy(sj, mj, mesh=mesh)
    lt, mt = TP.partition(gt, 4, policy, mesh=mesh)
    assert isinstance(lj, TP.LocalGraphs) and len(lj) == 4
    for a, b in zip(lj, lt):
        for f in ("row_ptr", "col_idx", "edge_w"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    for f in META_FIELDS:
        np.testing.assert_array_equal(getattr(mtj, f), getattr(mt, f))
    assert lj.nbytes() == lt.nbytes() == sum(
        np.asarray(getattr(sj, f)).nbytes
        for f in ("row_ptr", "col_idx", "edge_w"))


def test_partition_places_local_graphs_on_the_mesh(graphs):
    _, gt = graphs
    mesh = device_mesh(3, devices=["cpu"] * 3)
    local, _ = TP.partition(gt, 3, "oec", mesh=mesh)
    assert local.devices == mesh.devices
    assert local.num_vertices == gt.num_vertices
    assert local.version == 0
    with pytest.raises(ValueError, match="mesh of 3"):
        TP.partition(gt, 4, "oec", mesh=mesh)
    with pytest.raises(ValueError):
        TP.partition(gt, 2, "hvc")


def test_partition_of_a_padded_graph_skips_the_padding():
    """Only the ``row_ptr[-1]`` real edges are distributed, as JAX's
    ``to_coo`` does: a padded graph partitions like its real part."""
    gj = JG.rmat(7, 4, seed=1)
    gt = TG.Graph.from_numpy(gj.row_ptr, gj.col_idx, gj.edge_w, device="cpu")
    padded = TG.pad_graph(gt, v_multiple=8, e_multiple=1000)
    sj, mj = jpartition(JG.pad_graph(gj, v_multiple=8, e_multiple=1000), 2,
                        "oec")
    local, meta = TP.partition(padded, 2, "oec")
    for f in ("row_ptr", "col_idx", "edge_w"):
        np.testing.assert_array_equal(getattr(local.stacked(), f).numpy(),
                                      np.asarray(getattr(sj, f)))
    for f in META_FIELDS:
        np.testing.assert_array_equal(getattr(meta, f),
                                      np.asarray(getattr(mj, f)))


def test_device_mesh_defaults_to_the_cards():
    """Without ``devices=`` a mesh asks for CUDA cards and raises when
    there are fewer; a CPU mesh is the caller's choice."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        device_mesh(have + 1)
    mesh = device_mesh(2, devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.single_device() == torch.device("cpu")
    with pytest.raises(ValueError, match="3 slots"):
        device_mesh(3, devices=["cpu"] * 2)
