"""CuSP-style graph partitioner (OEC / IEC / CVC policies).

Port of ``repro/core/partition.py``.  For D partitions it produces D
edge-disjoint local CSR graphs over the *global* vertex id space, one
per mesh slot (:class:`LocalGraphs`), plus a :class:`PartitionMeta`
describing the master/mirror structure the Gluon sync
(``core.gluon``) exchanges over:

* every vertex has exactly one **master** partition (contiguous
  ``master_bounds`` ranges, the owner of its canonical label);
* a partition **mirrors** every endpoint of one of its local edges that
  is owned elsewhere; the padded per-(partition, owner) mirror lists
  drive the reduce-to-master / broadcast-to-mirrors rings.

The policy decides which edges, and so which work, land on each
partition, the role OEC / IEC / CVC play in the paper's Figure 9:

* OEC: vertices -> D contiguous ranges balanced by out-degree; a
  partition owns all out-edges of its vertices;
* IEC: the same, balanced by in-degree, edges assigned by destination;
* CVC: a cartesian vertex cut, edge (u, v) -> grid cell (row(u),
  col(v)) of a near-square grid.

The partition is computed with torch ops on the input graph's device
(stable sorts for the JAX package's ``np.lexsort``, ``torch.unique``
for ``np.unique``), so a 65 M-edge graph is cut on the card; the
result is bitwise the JAX package's (tests/test_torch_partition.py).
Every local graph keeps the JAX package's padding: ``emax`` edges,
``col_idx`` padded with 0 and ``edge_w`` with ``1 << 30``.  The meta's
arrays are host numpy arrays, as there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .collectives import Mesh
from .graph import Graph, resolve_device

#: weight of a padding edge (the JAX package's ``1 << 30``)
PAD_WEIGHT = 1 << 30


class LocalGraphs(tuple):
    """The D local graphs of a partition, slot by slot, each on its
    slot's device.  A tuple; the captured programs of the distributed
    runtime's fused mode are cached on it (``core.graph_loop.run``)."""

    @property
    def version(self) -> int:
        return max(g.version for g in self)

    @property
    def num_vertices(self) -> int:
        return self[0].num_vertices

    @property
    def devices(self) -> tuple:
        return tuple(g.device for g in self)

    def stacked(self) -> "_Stacked":
        """The JAX package's ``[D, ...]`` view, as ``(row_ptr, col_idx,
        edge_w)`` tensors stacked on the CPU (a namedtuple-like object
        with those attributes)."""
        return _Stacked(*(torch.stack([getattr(g, f).cpu() for g in self])  # repro: allow[host-sync] -- the JAX package's stacked view, for checking: on no round path
                          for f in ("row_ptr", "col_idx", "edge_w")))

    def nbytes(self) -> int:
        """Bytes the local CSR arrays hold on their devices."""
        return sum(t.numel() * t.element_size() for g in self
                   for t in (g.row_ptr, g.col_idx, g.edge_w))


class _Stacked(NamedTuple):
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    edge_w: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionMeta:
    """Master/mirror structure of a partition (host numpy arrays, as in
    the JAX package).

    num_devices / num_vertices : the partition's dimensions
    master_bounds : int64[D+1]  partition d masters vertices
                    ``[master_bounds[d], master_bounds[d+1])``
    owner         : int32[V]    master partition of each vertex
    mirror_idx    : int32[D, D, L]  ``mirror_idx[d, o]`` lists, in
                    ascending order, the vertices d mirrors whose master
                    is o (o != d), padded with the sentinel V; L is the
                    longest list (at least 1)
    mirror_counts : int64[D, D] the lists' true lengths
    """
    num_devices: int
    num_vertices: int
    master_bounds: np.ndarray
    owner: np.ndarray
    mirror_idx: np.ndarray
    mirror_counts: np.ndarray

    @property
    def total_mirrors(self) -> int:
        return int(self.mirror_counts.sum())

    @property
    def replication_factor(self) -> float:
        """Average proxies per vertex: 1 master each + all mirrors."""
        return (self.num_vertices + self.total_mirrors) / self.num_vertices


class Partitioned(NamedTuple):
    """``partition()`` result: the local graphs and the sync metadata."""
    graph: LocalGraphs
    meta: PartitionMeta


def _ranges_balanced(weights: torch.Tensor, parts: int) -> torch.Tensor:
    """Contiguous ranges with ~equal total weight: int64 ``bounds[D+1]``
    on the weights' device."""
    dev = weights.device
    csum = torch.zeros(weights.shape[0] + 1, dtype=torch.int64, device=dev)
    csum[1:] = torch.cumsum(weights, 0)
    targets = (torch.arange(1, parts, dtype=torch.int64, device=dev)
               * csum[-1]) // parts
    cuts = torch.searchsorted(csum, targets)            # side="left"
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cuts,
                      torch.full((1,), weights.shape[0], dtype=torch.int64,
                                 device=dev)])


def _range_of(bounds: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The range of ``bounds`` each id falls in (``searchsorted`` right,
    minus 1)."""
    return torch.searchsorted(bounds, ids, right=True) - 1


def _local_csr(s, t, w, num_vertices: int):
    """``from_edge_list(s, t, V, weights=w, dedup=False)`` of the JAX
    package: edges stably sorted by (src, dst), row pointers by count."""
    order = torch.sort(s * num_vertices + t, stable=True).indices
    counts = torch.bincount(s, minlength=num_vertices)
    row_ptr = torch.zeros(num_vertices + 1, dtype=torch.int32,
                          device=s.device)
    row_ptr[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    return row_ptr, t[order].to(torch.int32), w[order].to(torch.int32)


def _stack_local_graphs(edge_lists, num_vertices: int,
                        devices) -> LocalGraphs:
    """Per-partition CSR over the global vertex ids, every one padded to
    the longest's edge count, each moved to its slot's device."""
    locs = [_local_csr(s, t, w, num_vertices) for s, t, w in edge_lists]
    emax = max(max(c.shape[0] for _, c, _ in locs), 1)
    out = []
    for (rp, col, wt), dev in zip(locs, devices):
        pad = emax - col.shape[0]
        col = torch.cat([col, col.new_zeros(pad)])
        wt = torch.cat([wt, torch.full((pad,), PAD_WEIGHT, dtype=torch.int32,
                                       device=wt.device)])
        out.append(Graph(rp.to(dev), col.to(dev), wt.to(dev)))
    return LocalGraphs(out)


def _build_meta(num_devices: int, num_vertices: int,
                owner_v: torch.Tensor, edge_lists) -> PartitionMeta:
    """Mirror lists from the partitions' edge endpoints and the owner
    map (``owner_v``: int64 ``[V]``, non-decreasing)."""
    dev = owner_v.device
    bounds = torch.searchsorted(
        owner_v, torch.arange(num_devices + 1, dtype=torch.int64,
                              device=dev))
    per_pair = []
    lmax = 1
    for d in range(num_devices):
        s, t, _ = edge_lists[d]
        ends = torch.unique(torch.cat([s, t]))
        mirrors = ends[owner_v[ends] != d]
        row = [mirrors[owner_v[mirrors] == o] for o in range(num_devices)]
        lmax = max([lmax] + [lst.shape[0] for lst in row])
        per_pair.append(row)
    mirror_idx = np.full((num_devices, num_devices, lmax), num_vertices,
                         dtype=np.int32)
    counts = np.zeros((num_devices, num_devices), dtype=np.int64)
    for d in range(num_devices):
        for o in range(num_devices):
            lst = per_pair[d][o].cpu().numpy()  # repro: allow[host-sync] -- partition set-up: mirror lists, once per partition
            mirror_idx[d, o, :len(lst)] = lst
            counts[d, o] = len(lst)
    return PartitionMeta(num_devices=num_devices,
                         num_vertices=num_vertices,
                         master_bounds=bounds.cpu().numpy(),  # repro: allow[host-sync] -- partition set-up, once per partition
                         owner=owner_v.to(torch.int32).cpu().numpy(),  # repro: allow[host-sync] -- partition set-up, once per partition
                         mirror_idx=mirror_idx,
                         mirror_counts=counts)


def partition(g: Graph, num_devices: int, policy: str = "oec",
              mesh: Optional[Mesh] = None) -> Partitioned:
    """Partition ``g`` into ``num_devices`` local graphs under ``policy``
    (``oec`` | ``iec`` | ``cvc``), computed on ``g``'s device.  Local
    graph d goes to ``mesh.devices[d]`` (``g``'s device without a
    mesh).  Only the ``row_ptr[-1]`` real edges are distributed, as
    the JAX package's ``to_coo`` does."""
    if mesh is not None and mesh.size != num_devices:
        raise ValueError(f"partition into {num_devices} parts over a mesh "
                         f"of {mesh.size} slots")
    devices = mesh.devices if mesh is not None else (g.device,) * num_devices
    dev = g.device
    n = g.num_vertices
    rp = g.row_ptr.to(torch.int64)
    outdeg = rp[1:] - rp[:-1]
    e_real = int(rp[-1])  # repro: allow[host-sync] -- partition set-up: the edge count sizes the split, once per partition
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev), outdeg,
        output_size=e_real)
    ci = g.col_idx[:e_real].to(torch.int64)
    w = g.edge_w[:e_real]
    vids = torch.arange(n, dtype=torch.int64, device=dev)

    if policy in ("oec", "iec"):
        if policy == "oec":
            bounds = _ranges_balanced(outdeg, num_devices)
            owner = _range_of(bounds, src)
        else:
            indeg = torch.bincount(ci, minlength=n)
            bounds = _ranges_balanced(indeg, num_devices)
            owner = _range_of(bounds, ci)
        owner_v = _range_of(bounds, vids)
    elif policy == "cvc":
        pr = int(math.sqrt(num_devices))
        while num_devices % pr:
            pr -= 1
        pc = num_devices // pr
        rb = _ranges_balanced(outdeg, pr)
        cb = _ranges_balanced(torch.bincount(ci, minlength=n), pc)
        owner = _range_of(rb, src) * pc + _range_of(cb, ci)
        # a vertex's master is its own (row, col) cell: monotone in the
        # vertex id, since both range lookups are, so owned ranges stay
        # contiguous
        owner_v = _range_of(rb, vids) * pc + _range_of(cb, vids)
    else:
        raise ValueError(policy)

    edge_lists = []
    for d in range(num_devices):
        sel = owner == d
        edge_lists.append((src[sel], ci[sel], w[sel]))
    del src, ci, w, owner
    local = _stack_local_graphs(edge_lists, n, devices)
    meta = _build_meta(num_devices, n, owner_v, edge_lists)
    return Partitioned(local, meta)


def partitioned_from_numpy(stacked, meta, mesh: Optional[Mesh] = None,
                           device=None) -> Partitioned:
    """The port's :class:`Partitioned` from the JAX package's: ``stacked``
    has ``[D, ...]`` ``row_ptr`` / ``col_idx`` / ``edge_w`` arrays
    (anything ``np.asarray`` reads), ``meta`` the ``PartitionMeta``
    fields.  Local graph d goes to ``mesh.devices[d]``, else to
    ``device`` (the card unless the caller names another)."""
    rp, ci, ew = (np.asarray(stacked.row_ptr), np.asarray(stacked.col_idx),
                  np.asarray(stacked.edge_w))
    d_n = rp.shape[0]
    devices = (mesh.devices if mesh is not None
               else (resolve_device(device),) * d_n)
    local = LocalGraphs(Graph.from_numpy(rp[d], ci[d], ew[d],
                                         device=devices[d])
                        for d in range(d_n))
    pm = PartitionMeta(
        num_devices=int(meta.num_devices),
        num_vertices=int(meta.num_vertices),
        master_bounds=np.array(meta.master_bounds, dtype=np.int64),
        owner=np.array(meta.owner, dtype=np.int32),
        mirror_idx=np.array(meta.mirror_idx, dtype=np.int32),
        mirror_counts=np.array(meta.mirror_counts, dtype=np.int64))
    return Partitioned(local, pm)


def partition_stats(local: LocalGraphs,
                    meta: Optional[PartitionMeta] = None) -> dict:
    """Edges per partition, their imbalance (max over mean) and, given
    the meta, the replication factor and mirrors per partition."""
    local_edges = np.array([int(g.row_ptr[-1]) for g in local],
                           dtype=np.int32)
    st = dict(edges_per_device=local_edges.tolist(),
              imbalance=float(local_edges.max()
                              / max(local_edges.mean(), 1.0)))
    if meta is not None:
        st["replication_factor"] = meta.replication_factor
        st["mirrors_per_device"] = meta.mirror_counts.sum(axis=1).tolist()
    return st
