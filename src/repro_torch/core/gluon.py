"""Gluon-style distributed BSP runtime over a mesh of partition slots.

Port of ``repro/core/gluon.py``.  Each partition computes a round on its
local graph with the full ALB machinery (the static-shape round
``balancer.relax_spmd``), then all partitions reconcile their labels
with the operator's combiner (min for bfs / sssp / cc, add for pagerank
and kcore's decrements).  The JAX package runs this under ``shard_map``
on a ``("dev",)`` mesh; here one process drives a
``collectives.Mesh`` of D slots, each partition on its slot's device,
and the ``pmin`` / ``psum`` / ``ppermute`` collectives are
``collectives.all_reduce`` / ``ring_shift`` on the slots' tensors.

Two sync substrates (``sync=`` on every driver):

* ``"replicated"`` — every vertex mirrored everywhere: one all-reduce of
  the whole label array a round.  The parity baseline.  Slots of one
  device share one label tensor, so a partition's round never combines
  into it in place: it is never handed to an ``in_place`` pair as owned.
* ``"mirror"`` — the master/mirror substrate: labels live per slot,
  every vertex has one master (``PartitionMeta.master_bounds``), and a
  round runs a dirty-masked reduce-to-master ring and a
  broadcast-to-mirrors ring over the padded mirror lists only.  Every
  payload goes through ``cfg.wire``'s codec (``core.wire``).
  ``RoundStats.mirrors_synced`` counts the exchanged vertices,
  ``bytes_synced`` their logical bytes (index word + ``[B]`` labels),
  ``bytes_wire`` the encoded ones.

Two modes (``mode=``):

* ``"host"`` — the host drives the rounds: each partition's round is a
  replay of its captured static round on the card (a program per local
  graph, ``core.graph_loop``), the syncs are eager torch ops, and the
  loop reads one probe a round (counted in ``host_transfers`` exactly
  where the JAX package counts it);
* ``"fused"`` — the whole traversal, every partition's round and every
  ring step, is ONE ``graph_loop.while_``, captured once (cached on the
  :class:`~repro_torch.core.partition.LocalGraphs`) and launched as one
  CUDA graph: no host transfer between the dispatch and the fetch.  A
  CUDA graph lives on one device, so fused mode needs a mesh whose slots
  share one device; on a mesh spread over several cards it raises.

Both substrates take batched ``[B, V]`` state: every partition plans
one round over the union frontier of its B queries, and the mirror
rings ship one ``[B]`` vector per dirty boundary vertex.  The runtime
is push-only, as the JAX package's: partitions are cut along
out-edges.  Drivers return ``(labels, rounds, seconds)``, with
``collect_stats=True`` also ``stats[round][slot]`` (host
``RoundStats``); labels come back on slot 0's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import graph_loop
from . import operators as ops
from . import wire as wirecodec
from .apps.drivers import _identity, _min_changed, _pr_round_math
from .balancer import (BalancerConfig, RoundStats,
                       _note_host_transfer, _pack_stats, _relax_spmd_impl,
                       _unpack_stats, combine_neutral, relax_spmd)
from .collectives import Mesh, all_reduce, owner_gather, ring_shift, to_slots
# re-exported here, where ``repro.core.gluon`` defines it
from .collectives import device_mesh  # noqa: F401
from .frontier import multi_source_state
from .graph import INF
from .operators import Operator
from .partition import LocalGraphs, PartitionMeta
from .wire import step_logical_bytes

_int32 = wirecodec._int32


def _sync(mesh: Mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # repro: allow[host-sync] -- timing fence (the JAX package's block_until_ready): waits, moves no value


def _private(x: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when it shares memory with an input: the
    rings combine into it in place."""
    ptrs = {t.untyped_storage().data_ptr() for t in inputs}
    return x.clone() if x.untyped_storage().data_ptr() in ptrs else x


# ---- replicated substrate ---------------------------------------------------

def make_round_fn(mesh: Mesh, cfg: BalancerConfig, op: Operator,
                  sync_delta: bool = False, collect_stats: bool = False):
    """The one-BSP-round function of the replicated substrate:
    ``round_fn(graphs, values, labels, frontier)`` runs every
    partition's round on its slot (``relax_spmd``) and all-reduces.

    ``sync_delta``: for ``add``-combine operators each partition
    scatters into a zero delta, the deltas are summed and added to the
    replicated base (no double counting of the base).

    ``collect_stats``: also returns one ``RoundStatsDev`` per slot,
    with ``mirrors_synced`` = V, ``bytes_synced`` the all-reduce's
    per-slot volume (``B * V * itemsize``, the baseline the mirror
    substrate undercuts) and ``bytes_wire`` what ``cfg.wire``'s codec
    would put on a wire (the all-reduce itself stays full width)."""
    codec = wirecodec.get_codec(cfg.wire, op)

    def round_fn(graphs, values, labels, frontier):
        vals, labs, frs = (to_slots(t, mesh) for t in (values, labels,
                                                        frontier))
        outs, sts, prevs = [], [], []
        for d, g in enumerate(graphs):
            base = torch.zeros_like(labs[d]) if sync_delta else labs[d]
            out = relax_spmd(g, vals[d], base, frs[d], cfg, op,
                             collect_stats=collect_stats)
            new, st = out if collect_stats else (out, None)
            outs.append(new)
            sts.append(st)
            prevs.append(base)
        red = all_reduce(outs, "add" if sync_delta else op.combine,
                         mesh)[0]
        new = labels + red if sync_delta else red
        if not collect_stats:
            return new
        itemsize = labels.element_size()
        sts = [st._replace(
            mirrors_synced=_int32(labels.shape[-1], st.edges_twc.device),
            bytes_synced=_int32(labels.numel() * itemsize,
                                st.edges_twc.device),
            bytes_wire=codec.allreduce_wire_bytes(outs[d], prevs[d]))
            for d, st in enumerate(sts)]
        return new, sts

    return round_fn


def make_fused_traversal_fn(mesh: Mesh, cfg: BalancerConfig, op: Operator,
                            sync_delta: bool = False,
                            max_rounds: int = 10_000,
                            values_of=_identity,
                            next_frontier=_min_changed):
    """The fused replicated traversal: the whole BSP loop as ONE
    ``graph_loop.while_`` whose body runs every partition's round and
    the all-reduce.  The all-reduce keeps the labels replicated, so the
    loop condition needs no collective.  ``fn(graphs, labels,
    frontier)`` returns ``(labels, rounds)``, both on the device; on the
    card it is one launch of a graph captured once per configuration
    and cached on ``graphs``."""
    key = ("replicated", mesh, cfg, op, sync_delta, int(max_rounds),
           values_of, next_frontier)

    def trav(graphs, labels, frontier):
        def cond(r, lab, fr):
            return (r < max_rounds) & fr.any()

        def body(r, lab, fr):
            values = values_of(lab)
            outs = [_relax_spmd_impl(
                g, values, torch.zeros_like(lab) if sync_delta else lab,
                fr, cfg, op) for g in graphs]
            red = all_reduce(outs, "add" if sync_delta else op.combine,
                             mesh)[0]
            new = lab + red if sync_delta else red
            return r + 1, new, next_frontier(lab, new, fr)

        r0 = torch.zeros((), dtype=torch.int32, device=labels.device)
        r, labels, _ = graph_loop.while_(cond, body, (r0, labels, frontier))
        return labels, r

    def fn(graphs, labels, frontier):
        return graph_loop.run(graphs, key,
                              lambda la, fr: trav(graphs, la, fr),
                              labels, frontier)

    return fn


# ---- master/mirror substrate ------------------------------------------------

class _List(NamedTuple):
    """One mirror list on a slot's device: ``safe`` the padded ``[L]``
    ids with the sentinel mapped to 0 (for gathers), ``valid`` its real
    slots, ``real`` the ``[n]`` real ids (a prefix of the list, for
    scatters)."""
    safe: torch.Tensor
    valid: torch.Tensor
    real: torch.Tensor


class _Slot(NamedTuple):
    """A slot's sync tables: its owned-range mask and, for each ring
    step ``s = 1 .. D-1``, ``out[s-1]`` = the vertices it mirrors whose
    master is ``s`` slots ahead (``mirror_idx[d, d+s]``) and
    ``inc[s-1]`` = the vertices it masters that the slot ``s`` behind
    mirrors (``mirror_idx[d-s, d]``).  The reduce ring sends ``out``
    and receives into ``inc``; the broadcast ring the other way."""
    owned: torch.Tensor
    out: tuple
    inc: tuple


def _mirror_list(meta: PartitionMeta, d: int, o: int, dev) -> _List:
    idx = meta.mirror_idx[d, o]
    n = int(meta.mirror_counts[d, o])
    v = meta.num_vertices
    if not (np.all(idx[:n] < v) and np.all(idx[n:] == v)):
        raise ValueError(f"mirror list ({d}, {o}) is not its {n} ids "
                         f"followed by the sentinel {v}")
    t = torch.from_numpy(idx.astype(np.int64)).to(dev)
    valid = t < v
    return _List(torch.where(valid, t, 0), valid, t[:n])


def _mirror_tables(meta: PartitionMeta, mesh: Mesh):
    """Device-resident sync metadata: each slot's tables (:class:`_Slot`)
    on its device, and the owner map on slot 0's device.  Built once
    per mesh and cached on ``meta``."""
    cache = meta.__dict__.setdefault("_tables", {})
    if mesh.devices not in cache:
        ndev, v = meta.num_devices, meta.num_vertices
        if mesh.size != ndev:
            raise ValueError(f"a partition of {ndev} over a mesh of "
                             f"{mesh.size} slots")
        slots = []
        for d, dev in enumerate(mesh.devices):
            lo, hi = (int(x) for x in meta.master_bounds[d:d + 2])
            vids = torch.arange(v, device=dev)
            slots.append(_Slot(
                (vids >= lo) & (vids < hi),
                tuple(_mirror_list(meta, d, (d + s) % ndev, dev)
                      for s in range(1, ndev)),
                tuple(_mirror_list(meta, (d - s) % ndev, d, dev)
                      for s in range(1, ndev))))
        owner = torch.from_numpy(meta.owner).to(mesh.devices[0])
        cache[mesh.devices] = (tuple(slots), owner)
    return cache[mesh.devices]


def _combine_at(acc: torch.Tensor, idx: torch.Tensor, got: torch.Tensor,
                combine: str) -> None:
    """``acc[:, idx] = combine(acc[:, idx], got)`` in place (``idx``
    holds distinct ids, so this is order-free and exact)."""
    cur = acc.index_select(1, idx)
    acc.index_copy_(1, idx, torch.minimum(cur, got) if combine == "min"
                    else cur + got)


def _take_acc(lab, acc):
    return acc


def _add_delta(lab, acc):
    return lab + acc


class _Counters:
    """Per-slot exchange counters of one round (``collect_stats``)."""

    def __init__(self, labels):
        self.n = [_int32(0, t.device) for t in labels]
        self.logical = list(self.n)
        self.wire = list(self.n)

    def add(self, d, codec, op, payload, prev, live):
        self.n[d] = self.n[d] + live.sum(dtype=torch.int32)
        self.logical[d] = self.logical[d] + step_logical_bytes(
            live, payload.shape[0], payload.element_size())
        self.wire[d] = self.wire[d] + codec.step_wire_bytes(
            payload, prev, live, op)


def _mirror_round(graphs, slots, mesh: Mesh, codec, cfg: BalancerConfig,
                  op: Operator, labels: list, frontier: list, *, relax,
                  sync_delta: bool, collect_stats: bool, values_of,
                  next_frontier, post_sync, global_of, aux: list):
    """One BSP round over per-slot ``[B, V]`` state (JAX's
    ``one_round``): each partition's round, the reduce-to-master ring,
    the optional global scalar, ``post_sync``, the broadcast-to-mirrors
    ring, then the next frontiers, the activity count and the owned
    residual.  Invariant kept: after the round a slot's copy is right
    for every vertex it masters or mirrors (every endpoint of a local
    edge); other entries may be stale.  ``relax`` is ``relax_spmd``
    (host mode) or ``_relax_spmd_impl`` (inside a captured loop).
    Returns ``(final, next_frontier, active, resid, stats)``, lists per
    slot but for the two reduced scalars (on slot 0's device)."""
    ndev = len(graphs)
    news, sts, dirty_v = [], [], []
    for d, g in enumerate(graphs):
        values = values_of(labels[d], *aux[d])
        base = torch.zeros_like(labels[d]) if sync_delta else labels[d]
        out = relax(g, values, base, frontier[d], cfg, op,
                    collect_stats, True)
        new, st, dirty = out if collect_stats else (out[0], None, out[1])
        news.append(_private(new, labels[d], values))
        sts.append(st)
        dirty_v.append(dirty.any(dim=0))
    count = _Counters(labels) if collect_stats else None
    # non-dirty mirror slots carry the combiner's identity, so skipping
    # them is exact
    neutral = combine_neutral(op.combine, news[0].dtype)

    # ---- reduce-to-master: at step s each slot ships its dirty values
    # of the vertices mastered s slots ahead.  The codec's reference is
    # the round-entry labels (zeros in delta mode, where the payload is
    # a delta): both ends hold the same copy of every mirror-list vertex
    # since the previous broadcast overwrote it.  Each slot combines
    # into its own new labels, which it no longer sends from (a slot
    # sends what it mirrors and receives what it masters).
    prev_red = ([torch.zeros_like(t) for t in labels] if sync_delta
                else labels)
    acc = news
    for s in range(1, ndev):
        sent = []
        for d in range(ndev):
            lst = slots[d].out[s - 1]
            live = lst.valid & dirty_v[d][lst.safe]
            payload = torch.where(live[None], news[d][:, lst.safe], neutral)
            prev = prev_red[d][:, lst.safe]
            if collect_stats:
                count.add(d, codec, op, payload, prev, live)
            sent.append(codec.encode(payload, prev, op))
        for r, got in enumerate(ring_shift(sent, s, mesh)):
            lst = slots[r].inc[s - 1]
            got = codec.decode(got, prev_red[r][:, lst.safe], op,
                               acc[r].dtype)
            _combine_at(acc[r], lst.real, got[:, :lst.real.shape[0]],
                        op.combine)

    if global_of is not None:
        glob = all_reduce([global_of(labels[d], slots[d].owned, *aux[d])
                           for d in range(ndev)], "add", mesh)
        final = [post_sync(labels[d], acc[d], glob[d])
                 for d in range(ndev)]
    else:
        final = [post_sync(labels[d], acc[d]) for d in range(ndev)]
    final = [_private(f, labels[d]) for d, f in enumerate(final)]

    # ---- broadcast-to-mirrors: masters push the reduced values back
    # along the reverse ring and mirrors overwrite their copies.  The
    # reference is always the round-entry labels (the broadcast ships
    # labels, even in delta mode).
    gdirty = [(final[d] != labels[d]).any(dim=0) for d in range(ndev)]
    for s in range(1, ndev):
        sent = []
        for d in range(ndev):
            lst = slots[d].inc[s - 1]
            live = lst.valid & gdirty[d][lst.safe]
            payload = final[d][:, lst.safe]
            prev = labels[d][:, lst.safe]
            if collect_stats:
                count.add(d, codec, op, payload, prev, live)
            sent.append(codec.encode(payload, prev, op))
        for r, got in enumerate(ring_shift(sent, -s, mesh)):
            lst = slots[r].out[s - 1]
            # signed=False: the broadcast ships labels, which are
            # non-negative, so unsigned narrow words zero-extend
            got = codec.decode(got, labels[r][:, lst.safe], op,
                               final[r].dtype, signed=False)
            final[r].index_copy_(1, lst.real, got[:, :lst.real.shape[0]])

    nfr = [next_frontier(labels[d], final[d], frontier[d])
           for d in range(ndev)]
    active = all_reduce([f.sum(dtype=torch.int32) for f in nfr], "add",
                        mesh)[0]
    resid = all_reduce([torch.where(
        slots[d].owned[None],
        (final[d].to(torch.float32) - labels[d].to(torch.float32)).abs(),
        0.0).max() for d in range(ndev)], "max", mesh)[0]
    if collect_stats:
        # bytes_synced: the LOGICAL volume (each live vertex's index word
        # and [B] labels); bytes_wire: the encoded volume
        sts = [st._replace(mirrors_synced=count.n[d],
                           bytes_synced=count.logical[d],
                           bytes_wire=count.wire[d])
               for d, st in enumerate(sts)]
    return final, nfr, active, resid, sts


def make_mirror_round_fn(mesh: Mesh, cfg: BalancerConfig, op: Operator,
                         meta: PartitionMeta, sync_delta: bool = False,
                         collect_stats: bool = False,
                         values_of=_identity, next_frontier=_min_changed,
                         post_sync=None, global_of=None,
                         fused: bool = False, max_rounds: int = 10_000,
                         tol: Optional[float] = None):
    """One BSP round over owned state (the local ALB round, then Gluon's
    reduce-to-master / broadcast-to-mirrors pair), as JAX's.

    Host form (``fused=False``): ``fn(graphs, labels, frontier, aux)``
    over per-slot ``[B, V]`` lists returns ``(labels, frontier, active,
    resid)`` plus the per-slot ``RoundStatsDev`` list with
    ``collect_stats``.  ``values_of(labels, *aux)`` and
    ``global_of(labels, owned, *aux)`` take the slot's copy of the
    ``aux`` tensors (pagerank's ``inv_out`` and ``sink``);
    ``global_of``'s per-slot scalars over the owned range are summed
    and passed to ``post_sync(labels, acc, glob)``.

    Fused form: ``fn(graphs, labels, frontier, aux)`` over ``[D, B, V]``
    tensors on one device runs the rounds as ONE ``graph_loop.while_``
    until the activity count is 0, ``max_rounds`` is reached or (with
    ``tol``) the residual drops below ``tol``, captured once on the
    card; returns ``(labels, frontier, rounds)``.  Per-round stats need
    the per-round host boundary, so it refuses ``collect_stats``."""
    codec = wirecodec.get_codec(cfg.wire, op)
    if fused and collect_stats:
        raise ValueError("fused mirror traversal does not collect "
                         "per-round stats (one dispatch, no per-round "
                         "host boundary)")
    if post_sync is None:
        post_sync = _add_delta if sync_delta else _take_acc
    slots, _ = _mirror_tables(meta, mesh)
    hooks = dict(sync_delta=sync_delta, values_of=values_of,
                 next_frontier=next_frontier, post_sync=post_sync,
                 global_of=global_of)

    if not fused:
        def round_fn(graphs, labels, frontier, aux):
            final, nfr, active, resid, sts = _mirror_round(
                graphs, slots, mesh, codec, cfg, op, labels, frontier,
                relax=relax_spmd, collect_stats=collect_stats, aux=aux,
                **hooks)
            outs = (final, nfr, active, resid)
            return outs + (sts,) if collect_stats else outs
        return round_fn

    def trav(graphs, lab0, fr0, *aux):
        def cond(r, lab, fr, active, resid):
            ok = (r < max_rounds) & (active > 0)
            if tol is not None:
                ok = ok & (resid >= tol)
            return ok

        def body(r, lab, fr, active, resid):
            final, nfr, active, resid, _ = _mirror_round(
                graphs, slots, mesh, codec, cfg, op, list(lab.unbind(0)),
                list(fr.unbind(0)), relax=_relax_spmd_impl,
                collect_stats=False, aux=[aux] * len(graphs), **hooks)
            return r + 1, torch.stack(final), torch.stack(nfr), active, resid

        carry = (torch.zeros((), dtype=torch.int32, device=lab0.device),
                 lab0, fr0, fr0.sum(dtype=torch.int32),
                 torch.full((), float("inf"), dtype=torch.float32,
                            device=lab0.device))
        r, lab, fr, _, _ = graph_loop.while_(cond, body, carry)
        return lab, fr, r

    key = ("mirror", mesh, cfg, op, meta, int(max_rounds), tol,
           tuple(hooks.items()))

    def fn(graphs, labels, frontier, aux):
        return graph_loop.run(graphs, key,
                              lambda la, fr, *ax: trav(graphs, la, fr, *ax),
                              labels, frontier, *aux)

    return fn


def assemble_owned(labels_dev, meta: PartitionMeta) -> torch.Tensor:
    """Each vertex's label from its master's copy, the only copies the
    mirror substrate keeps globally right.  ``labels_dev``: per-slot
    ``[V]`` / ``[B, V]`` tensors (a list, or stacked ``[D, ...]``);
    returns ``[V]`` / ``[B, V]`` on the first slot's device."""
    parts = list(labels_dev)
    dev = parts[0].device
    owner = torch.from_numpy(meta.owner).to(dev)
    return owner_gather(parts, owner)


def stats_per_device(sts) -> list:
    """Per-slot ``RoundStatsDev`` as host ``RoundStats``, one per slot,
    in one transfer."""
    dev = sts[0].frontier_size.device
    rows = torch.stack([_pack_stats(st).to(dev) for st in sts]).cpu()  # repro: allow[host-sync] -- collect_stats only: the round's stats, uncounted as in the JAX package
    tiles = sts[0].tile_loads_twc.shape[-1]
    return [RoundStats.from_device(_unpack_stats(row, tiles))
            for row in rows]


def _any_host(frontier: torch.Tensor) -> bool:
    """The replicated host loop's per-round frontier probe: a blocking
    device->host sync, counted against ``host_transfers`` (what fused
    mode drives to zero)."""
    _note_host_transfer()
    return bool(frontier.any())


def _require_push_direction(cfg: BalancerConfig) -> None:
    """The distributed runtime is push-only (partitions are cut along
    out-edges; the substrates ship scatter targets): direction-optimized
    configs are refused, never silently run as push."""
    if cfg.direction != "push":
        raise ValueError(
            f"the distributed runtime is push-only; "
            f"cfg.direction={cfg.direction!r} is not supported "
            f"(DESIGN.md section 9)")


def _require_meta(meta, sync) -> None:
    if sync not in ("replicated", "mirror"):
        raise ValueError(f"unknown sync {sync!r} (replicated|mirror)")
    if sync == "mirror" and meta is None:
        raise ValueError("sync='mirror' needs the PartitionMeta returned "
                         "by partition()")


def _require_mode(mode: str, collect_stats: bool) -> None:
    if mode not in ("host", "fused"):
        raise ValueError(f"unknown distributed mode {mode!r} "
                         "(host|fused)")
    if mode == "fused" and collect_stats:
        raise ValueError("mode='fused' runs with collect_stats=False "
                         "(per-round stats need the per-round host "
                         "boundary)")


def _require_placement(graphs, mesh: Mesh, mode: str) -> torch.device:
    """The local graphs sit on their slots' devices; fused mode needs
    one device.  Returns slot 0's device."""
    if len(graphs) != mesh.size:
        raise ValueError(f"{len(graphs)} local graphs on a mesh of "
                         f"{mesh.size} slots")
    for d, g in enumerate(graphs):
        if g.device != mesh.devices[d]:
            raise ValueError(f"local graph {d} is on {g.device}, its slot "
                             f"on {mesh.devices[d]}")
    if mode == "fused" and mesh.single_device() is None:
        raise ValueError(
            f"mode='fused' runs a traversal as one CUDA graph, which "
            f"lives on one device; this mesh spreads its slots over "
            f"{sorted({str(d) for d in mesh.devices})} (fused mode on a "
            f"mesh of several cards is not ported yet)")
    return mesh.devices[0]


def _check(graphs, mesh, op, dtype, cfg, collect_stats, sync, meta, mode):
    """The refusals every driver makes before any round runs, in the JAX
    package's order, then the port's placement check."""
    _require_push_direction(cfg)
    _require_meta(meta, sync)
    # config-time codec / operator pairing: quantize on an operator
    # that declares no safe narrowing fails HERE
    wirecodec.get_codec(cfg.wire, op, dtype)
    _require_mode(mode, collect_stats)
    return _require_placement(graphs, mesh, mode)


def run_distributed(stacked_g: LocalGraphs, mesh: Mesh, op: Operator,
                    init_labels, init_frontier,
                    cfg: BalancerConfig = BalancerConfig(),
                    values_of=_identity, next_frontier=_min_changed,
                    sync_delta: bool = False, max_rounds: int = 10_000,
                    collect_stats: bool = False, sync: str = "replicated",
                    meta: Optional[PartitionMeta] = None,
                    mode: str = "host"):
    """Generic distributed data-driven loop over the local graphs of a
    partition.  Returns ``(labels, rounds, seconds)``, with
    ``collect_stats=True`` also ``stats[round][slot]``.

    ``sync="mirror"`` (needs ``meta``) swaps the all-reduce for the
    dirty-tracked boundary exchange; ``mode="fused"`` runs the whole
    traversal as one device loop, with no host sync between rounds.
    Host mode pays one counted transfer a round (the replicated loop's
    frontier probe, one more before the first round; the mirror loop's
    activity probe)."""
    dev = _check(stacked_g, mesh, op, init_labels.dtype, cfg, collect_stats,
                 sync, meta, mode)
    labels, frontier = init_labels.to(dev), init_frontier.to(dev)
    if sync == "mirror":
        return _run_mirror(stacked_g, mesh, op, labels, frontier, cfg,
                           values_of, next_frontier, sync_delta, max_rounds,
                           collect_stats, meta, mode=mode)
    if mode == "fused":
        trav_fn = make_fused_traversal_fn(
            mesh, cfg, op, sync_delta=sync_delta, max_rounds=max_rounds,
            values_of=values_of, next_frontier=next_frontier)
        t0 = time.perf_counter()
        labels, r = trav_fn(stacked_g, labels, frontier)
        _sync(mesh)
        return labels, int(r), time.perf_counter() - t0
    round_fn = make_round_fn(mesh, cfg, op, sync_delta=sync_delta,
                             collect_stats=collect_stats)
    rounds = 0
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    while rounds < max_rounds and _any_host(frontier):
        old = labels
        out = round_fn(stacked_g, values_of(labels), labels, frontier)
        if collect_stats:
            labels, st = out
            stats.append(stats_per_device(st))
        else:
            labels = out
        frontier = next_frontier(old, labels, frontier)
        rounds += 1
    _sync(mesh)
    total = time.perf_counter() - t0
    if collect_stats:
        return labels, rounds, total, stats
    return labels, rounds, total


def _run_mirror(graphs, mesh: Mesh, op: Operator, init_labels, init_frontier,
                cfg: BalancerConfig, values_of, next_frontier, sync_delta,
                max_rounds, collect_stats, meta: PartitionMeta,
                post_sync=None, tol: Optional[float] = None, global_of=None,
                mode: str = "host", aux: tuple = ()):
    """The owned-state loop of the data-driven drivers and of pagerank:
    it stops when the frontier empties, the round budget runs out or
    (``tol`` set) the owned residual drops below ``tol``.  State is
    batched ``[B, V]`` per slot; un-batched callers get the query axis
    added here and squeezed on return."""
    batched = init_labels.ndim == 2
    if not batched:
        init_labels, init_frontier = init_labels[None], init_frontier[None]
    _, owner = _mirror_tables(meta, mesh)
    fn = make_mirror_round_fn(
        mesh, cfg, op, meta, sync_delta=sync_delta,
        collect_stats=collect_stats, values_of=values_of,
        next_frontier=next_frontier, post_sync=post_sync,
        global_of=global_of, fused=mode == "fused", max_rounds=max_rounds,
        tol=tol)
    ndev = mesh.size
    if mode == "fused":
        t0 = time.perf_counter()
        lab, _, r = fn(graphs, init_labels.expand(ndev, *init_labels.shape),
                       init_frontier.expand(ndev, *init_frontier.shape), aux)
        labels = owner_gather(list(lab.unbind(0)), owner)
        _sync(mesh)
        return (labels if batched else labels[0]), int(r), \
            time.perf_counter() - t0
    slot_aux = list(zip(*(to_slots(a, mesh) for a in aux))) or [()] * ndev
    labels = to_slots(init_labels, mesh)
    frontier = to_slots(init_frontier, mesh)
    # the pre-loop seed count, paid once a traversal and not counted (the
    # JAX package's allowed host sync)
    active = int(init_frontier.sum())
    rounds = 0
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    while rounds < max_rounds and active > 0:
        out = fn(graphs, labels, frontier, slot_aux)
        labels, frontier, active_t, resid_t = out[:4]
        probe = [active_t.reshape(1), resid_t.reshape(1).view(torch.int32)]
        if collect_stats:
            probe += [_pack_stats(st).to(active_t.device) for st in out[4]]
        probe = torch.cat(probe).cpu()        # ONE fetch a round
        _note_host_transfer()      # the activity / residual probe blocks
        active, resid = int(probe[0]), float(probe[1:2].view(torch.float32))
        if collect_stats:
            tiles = out[4][0].tile_loads_twc.shape[-1]
            rows = probe[2:].reshape(ndev, -1)
            stats.append([RoundStats.from_device(_unpack_stats(row, tiles))
                          for row in rows])
        rounds += 1
        if tol is not None and resid < tol:
            break
    labels = owner_gather(labels, owner)
    if not batched:
        labels = labels[0]
    _sync(mesh)
    total = time.perf_counter() - t0
    if collect_stats:
        return labels, rounds, total, stats
    return labels, rounds, total


# ---- distributed application drivers --------------------------------------

def _single_source(graphs, mesh: Mesh, source: int):
    lab = torch.full((graphs.num_vertices,), int(INF), dtype=torch.int32,
                     device=mesh.devices[0])
    lab[source] = 0
    return lab, lab == 0


def sssp_distributed(stacked_g: LocalGraphs, mesh: Mesh, source: int,
                     cfg: BalancerConfig = BalancerConfig(),
                     max_rounds: int = 10_000, collect_stats: bool = False,
                     sync: str = "replicated",
                     meta: Optional[PartitionMeta] = None,
                     mode: str = "host"):
    """Distributed single-source SSSP over the local graphs of a
    partition; ``sync`` selects the replicated all-reduce or the
    master/mirror exchange, ``mode="fused"`` one device loop."""
    dist, frontier = _single_source(stacked_g, mesh, source)
    return run_distributed(stacked_g, mesh, ops.SSSP_RELAX, dist, frontier,
                           cfg, max_rounds=max_rounds,
                           collect_stats=collect_stats, sync=sync,
                           meta=meta, mode=mode)


def bfs_distributed(stacked_g: LocalGraphs, mesh: Mesh, source: int,
                    cfg: BalancerConfig = BalancerConfig(),
                    max_rounds: int = 10_000, collect_stats: bool = False,
                    sync: str = "replicated",
                    meta: Optional[PartitionMeta] = None,
                    mode: str = "host"):
    """Distributed single-source BFS (see :func:`sssp_distributed`)."""
    lvl, frontier = _single_source(stacked_g, mesh, source)
    return run_distributed(stacked_g, mesh, ops.BFS_HOP, lvl, frontier,
                           cfg, max_rounds=max_rounds,
                           collect_stats=collect_stats, sync=sync,
                           meta=meta, mode=mode)


def sssp_batch_distributed(stacked_g: LocalGraphs, mesh: Mesh, sources,
                           cfg: BalancerConfig = BalancerConfig(),
                           max_rounds: int = 10_000,
                           collect_stats: bool = False,
                           sync: str = "replicated",
                           meta: Optional[PartitionMeta] = None,
                           mode: str = "host"):
    """Batched multi-source SSSP: B queries share every round and, under
    ``sync="mirror"``, every boundary exchange (one ``[B]`` vector per
    dirty vertex).  Returns ``labels[B, V]``."""
    dist, frontier = multi_source_state(stacked_g.num_vertices, sources,
                                        INF, mesh.devices[0])
    return run_distributed(stacked_g, mesh, ops.SSSP_RELAX, dist, frontier,
                           cfg, max_rounds=max_rounds,
                           collect_stats=collect_stats, sync=sync,
                           meta=meta, mode=mode)


def bfs_batch_distributed(stacked_g: LocalGraphs, mesh: Mesh, sources,
                          cfg: BalancerConfig = BalancerConfig(),
                          max_rounds: int = 10_000,
                          collect_stats: bool = False,
                          sync: str = "replicated",
                          meta: Optional[PartitionMeta] = None,
                          mode: str = "host"):
    """Batched multi-source BFS (see :func:`sssp_batch_distributed`)."""
    lvl, frontier = multi_source_state(stacked_g.num_vertices, sources,
                                       INF, mesh.devices[0])
    return run_distributed(stacked_g, mesh, ops.BFS_HOP, lvl, frontier,
                           cfg, max_rounds=max_rounds,
                           collect_stats=collect_stats, sync=sync,
                           meta=meta, mode=mode)


def cc_distributed(stacked_g: LocalGraphs, mesh: Mesh,
                   cfg: BalancerConfig = BalancerConfig(),
                   max_rounds: int = 10_000, collect_stats: bool = False,
                   sync: str = "replicated",
                   meta: Optional[PartitionMeta] = None,
                   mode: str = "host"):
    """Distributed connected components by min-label propagation (a
    symmetrized input)."""
    dev = mesh.devices[0]
    v = stacked_g.num_vertices
    comp = torch.arange(v, dtype=torch.int32, device=dev)
    frontier = torch.ones((v,), dtype=torch.bool, device=dev)
    return run_distributed(stacked_g, mesh, ops.CC_MIN, comp, frontier,
                           cfg, max_rounds=max_rounds,
                           collect_stats=collect_stats, sync=sync,
                           meta=meta, mode=mode)


@dataclasses.dataclass(frozen=True)
class _KcoreNext:
    """kcore's next worklist: the vertices that crossed below ``k``
    (hashable, so one captured program serves every call)."""
    k: int

    def __call__(self, old, new, frontier):
        return (new < self.k) & (old >= self.k)


def kcore_distributed(stacked_g: LocalGraphs, mesh: Mesh, k: int,
                      cfg: BalancerConfig = BalancerConfig(),
                      max_rounds: int = 10_000, collect_stats: bool = False,
                      sync: str = "replicated",
                      meta: Optional[PartitionMeta] = None,
                      mode: str = "host"):
    """Distributed k-core over the partition of a *symmetrized* graph.
    Degrees only fall, so "dead" (< k) is monotone and the loop is
    :func:`run_distributed` with the newly-crossed frontier rule; each
    dead vertex pushes its -1 decrements once, through the delta sync
    (add combiner).  Returns in-core labels (1 = in the k-core)."""
    dev = mesh.devices[0]
    deg = sum(g.out_degrees().to(dev) for g in stacked_g).to(torch.int32)
    frontier = (deg < k) & (deg > 0)
    out = run_distributed(
        stacked_g, mesh, ops.KCORE_DEC, deg, frontier, cfg,
        next_frontier=_KcoreNext(int(k)), sync_delta=True,
        max_rounds=max_rounds, collect_stats=collect_stats, sync=sync,
        meta=meta, mode=mode)
    labels, rest = out[0], out[1:]
    return ((labels >= k).to(torch.int32),) + tuple(rest)


@dataclasses.dataclass(frozen=True)
class _PageRank:
    """The mirror pagerank's hooks, over ``aux = (inv_out, sink)``
    (hashable, so one captured program serves every call)."""
    damping: float
    v: int

    def values_of(self, rank, inv_out, sink):
        return rank * inv_out

    @staticmethod
    def keep(old, new, frontier):
        return frontier

    def post_sync(self, lab, acc, dangling):
        return (1.0 - self.damping) / self.v + self.damping * (
            acc + dangling / self.v)

    @staticmethod
    def dangling(lab, owned, inv_out, sink):
        return torch.where(owned[None] & sink[None], lab, 0.0).sum()


def _pagerank_replicated_fused(graphs, mesh: Mesh, rank, inv_out, sink,
                               damping: float, tol: float,
                               cfg: BalancerConfig, max_rounds: int):
    """The replicated power iteration, residual check included, as ONE
    ``graph_loop.while_`` (one graph launch on the card): ``(rank,
    rounds)`` on the device.  The update is ``_pr_round_math``, the host
    loop's, so both modes round alike."""
    v = rank.shape[0]

    def trav(graphs, rank, inv_out, sink):
        fr = torch.ones((v,), dtype=torch.bool, device=rank.device)

        def cond(r, rank, delta):
            return (r < max_rounds) & (delta >= tol)

        def body(r, rank, delta):
            contrib = rank * inv_out
            outs = [_relax_spmd_impl(g, contrib, torch.zeros_like(rank), fr,
                                     cfg, ops.PR_PULL) for g in graphs]
            acc = all_reduce(outs, "add", mesh)[0]
            new_rank, delta = _pr_round_math(rank, inv_out, sink, acc,
                                             damping)
            return r + 1, new_rank, delta

        carry = (torch.zeros((), dtype=torch.int32, device=rank.device),
                 rank, torch.full((), float("inf"), dtype=torch.float32,
                                  device=rank.device))
        r, rank, _ = graph_loop.while_(cond, body, carry)
        return rank, r

    return graph_loop.run(
        graphs, ("pagerank", mesh, cfg, damping, tol, int(max_rounds)),
        lambda ra, io, sk: trav(graphs, ra, io, sk), rank, inv_out, sink)


def pagerank_distributed(stacked_rg: LocalGraphs, mesh: Mesh, out_degrees,
                         damping: float = 0.85, tol: float = 1e-6,
                         cfg: BalancerConfig = BalancerConfig(),
                         max_rounds: int = 1000, collect_stats: bool = False,
                         sync: str = "replicated",
                         meta: Optional[PartitionMeta] = None,
                         mode: str = "host"):
    """Pagerank over the partition of the *reverse* graph (pull
    traverses in-edges).  Dangling vertices (out-degree 0) spread their
    mass uniformly each round, as the single-device driver; under the
    mirror substrate the dangling sum is taken over the owned ranges and
    summed with the round's collectives.  ``mode="fused"`` moves the
    whole power iteration, residual check included, into one device
    loop."""
    dev = _check(stacked_rg, mesh, ops.PR_PULL, torch.float32, cfg,
                 collect_stats, sync, meta, mode)
    v = stacked_rg.num_vertices
    outdeg = torch.as_tensor(out_degrees).to(dev, torch.float32)
    inv_out = torch.where(outdeg > 0, 1.0 / torch.clamp(outdeg, min=1.0),
                          0.0)
    sink = outdeg == 0
    rank = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    frontier = torch.ones((v,), dtype=torch.bool, device=dev)
    if sync == "mirror":
        # topology-driven: the full frontier every round, the rank update
        # as post_sync, convergence by the owned residual
        pr = _PageRank(float(damping), v)
        return _run_mirror(
            stacked_rg, mesh, ops.PR_PULL, rank, frontier, cfg,
            values_of=pr.values_of, next_frontier=pr.keep,
            sync_delta=True, max_rounds=max_rounds,
            collect_stats=collect_stats, meta=meta,
            post_sync=pr.post_sync, global_of=pr.dangling, tol=tol,
            mode=mode, aux=(inv_out, sink))
    if mode == "fused":
        t0 = time.perf_counter()
        rank, r = _pagerank_replicated_fused(
            stacked_rg, mesh, rank, inv_out, sink, float(damping),
            float(tol), cfg, max_rounds)
        _sync(mesh)
        return rank, int(r), time.perf_counter() - t0
    round_fn = make_round_fn(mesh, cfg, ops.PR_PULL, sync_delta=True,
                             collect_stats=collect_stats)
    rounds = 0
    stats = [] if collect_stats else None
    t0 = time.perf_counter()
    while rounds < max_rounds:
        contrib = rank * inv_out
        out = round_fn(stacked_rg, contrib,
                       torch.zeros((v,), dtype=torch.float32, device=dev),
                       frontier)
        if collect_stats:
            acc, st = out
            stats.append(stats_per_device(st))
        else:
            acc = out
        new_rank, delta_dev = _pr_round_math(rank, inv_out, sink, acc,
                                             float(damping))
        delta = float(delta_dev)
        _note_host_transfer()      # the residual check blocks
        rank = new_rank
        rounds += 1
        if delta < tol:
            break
    _sync(mesh)
    total = time.perf_counter() - t0
    if collect_stats:
        return rank, rounds, total, stats
    return rank, rounds, total
