"""Streaming graph mutations with incremental label repair (PyTorch port
of ``repro/core/streaming.py``).

A streaming graph is a versioned CSR that absorbs batched edge updates
at fixed array shapes, so whatever was built for it keeps serving it
across mutations.  Three layers, as in the JAX package:

* **Update batches** — :class:`UpdateBatch` is a fixed-capacity host
  ``int32[K]`` quadruple (op, src, dst, w); ops are insert / delete /
  reweight, padding slots are no-ops.  :func:`make_batch` builds one.
* **Versioned application** — :func:`streaming_graph` pads a graph to
  streaming shape (a sentinel vertex ``vp - 1`` and a bucketed edge
  capacity); :func:`apply_updates` applies a batch and rebuilds the CSR
  at the same shapes with :attr:`Graph.version` bumped, which
  invalidates every structure memoized on the graph (the reverse CSR,
  the pull enumerations, the captured programs of ``core.graph_loop``);
  :func:`diff_batch` reports the batch's net topology delta.
* **Incremental repair** — :func:`stream_init` / :func:`stream_update`
  keep a min-combine fixpoint (bfs / sssp / cc) across updates: added
  edges (and sssp weight decreases) seed a frontier and the ordinary
  round loop resumes from the current labels; removing or worsening a
  *tight* edge falls back to a full recompute.

Where the JAX package keeps the live edge set as a host dict
``(u, v) -> w`` and copies it for every batch, the port keeps it on the
graph's device: the sorted int64 keys ``u * Vp + v`` of the live edges
(``Vp`` the padded vertex count) with their int32 weights, which are the
CSR's own ``edge_w`` and in its order (:func:`_edge_keys`, memoized per
version).  A batch is replayed on the host over only the keys it
touches (at most K), whose prior weights come from one
``torch.searchsorted`` and one fetch; the net delta is then merged into
the keys on the device and the CSR rebuilt there.  Per batch the host
does O(K) work, the device O(E).  The semantics are the JAX package's,
rule for rule: insert keeps the min of duplicate weights, deleting an
absent edge is a no-op, a reweight applies only to an existing edge,
and invalid slots raise the same errors.  :func:`edge_map` and
:func:`unpadded` still build the dict view on demand; the update path
never does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .graph import Graph, INF, _csr_from_sorted, _edge_sources
from .frontier import next_bucket, seed_from_edges
from .balancer import BalancerConfig
from . import operators as ops
from .apps import drivers

# UpdateBatch op codes.  0 must be the padding no-op so a zeroed array
# is a valid (empty) batch.
OP_PAD = 0
OP_INSERT = 1
OP_DELETE = 2
OP_REWEIGHT = 3

_OP_NAMES = {"insert": OP_INSERT, "delete": OP_DELETE,
             "reweight": OP_REWEIGHT}

# The monotone (min-combine) applications the repair path maintains.
# bfs and cc are weight-blind: reweights never change their fixpoint.
STREAM_APPS = {
    "bfs": ops.BFS_HOP,
    "sssp": ops.SSSP_RELAX,
    "cc": ops.CC_MIN,
}


class UpdateBatch(NamedTuple):
    """Fixed-shape batch of edge updates: four host ``int32[K]`` numpy
    arrays.  ``op[k]`` is one of :data:`OP_PAD` (slot unused),
    :data:`OP_INSERT`, :data:`OP_DELETE`, :data:`OP_REWEIGHT`;
    ``src``/``dst`` name the edge and ``w`` carries the new weight
    (ignored for deletes).  K is the batch *capacity*: a stream that
    keeps one capacity seeds its repair frontier at one shape."""
    op: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray

    @property
    def capacity(self) -> int:
        """The fixed slot count K (live entries + padding)."""
        return int(self.op.shape[0])

    @property
    def num_updates(self) -> int:
        """How many live (non-padding) entries the batch carries."""
        return int(np.count_nonzero(self.op))


def make_batch(updates: Iterable[tuple],
               capacity: Optional[int] = None) -> UpdateBatch:
    """Build an :class:`UpdateBatch` from Python tuples.

    Each update is ``("insert", u, v, w)``, ``("delete", u, v)`` or
    ``("reweight", u, v, w)``.  ``capacity`` fixes K; by default K is
    the smallest power of two >= max(n, 16).  Entries beyond ``n`` are
    :data:`OP_PAD` no-ops."""
    parsed = []
    for t in updates:
        kind = t[0]
        if kind not in _OP_NAMES:
            raise ValueError(f"unknown update kind {kind!r} "
                             f"(have {sorted(_OP_NAMES)})")
        if kind == "delete":
            u, v = t[1], t[2]
            w = 0
        else:
            if len(t) != 4:
                raise ValueError(f"{kind} update needs (kind, u, v, w); "
                                 f"got {t!r}")
            u, v, w = t[1], t[2], t[3]
        parsed.append((_OP_NAMES[kind], int(u), int(v), int(w)))
    n = len(parsed)
    cap = next_bucket(n, minimum=16) if capacity is None else int(capacity)
    if n > cap:
        raise ValueError(f"{n} updates exceed batch capacity {cap}")
    op = np.zeros((cap,), np.int32)
    src = np.zeros((cap,), np.int32)
    dst = np.zeros((cap,), np.int32)
    w = np.zeros((cap,), np.int32)
    for i, (o, u, v, wt) in enumerate(parsed):
        op[i], src[i], dst[i], w[i] = o, u, v, wt
    return UpdateBatch(op=op, src=src, dst=dst, w=w)


# ---------------------------------------------------------------------------
# The live edge set, on the graph's device
# ---------------------------------------------------------------------------

def real_vertices(g: Graph) -> int:
    """The live vertex count of a (possibly streaming-padded) graph:
    vertices ``>= real_vertices(g)`` are structural padding.  Equals
    ``num_vertices`` for graphs never passed through
    :func:`streaming_graph`."""
    return g.__dict__.get("_v_real", g.num_vertices)


def _live_keys(g: Graph) -> tuple:
    """``(keys, w)`` of ``g``'s live edges, built from its CSR: the
    sorted int64 keys ``src * V + dst`` of the edges leaving a real
    vertex, and their int32 weights.  Parallel edges keep the last
    weight in CSR order, as the JAX package's dict comprehension does."""
    e_real = int(g.row_ptr[-1])
    src = _edge_sources(g, e_real).long()
    keys = src * g.num_vertices + g.col_idx[:e_real]
    w = g.edge_w[:e_real]
    live = src < real_vertices(g)
    if not bool(live.all()):
        keys, w = keys[live], w[live]
    keys, order = torch.sort(keys, stable=True)
    w = w[order]
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    if not bool(last.all()):
        keys, w = keys[last], w[last]
    return keys, w


def _edge_keys(g: Graph) -> tuple:
    """``(keys, w)``: the live edge set of ``g`` (see the module
    docstring), memoized per :attr:`Graph.version` like every derived
    structure.  A graph built by this module carries its entry from the
    build; for any other it is made from the CSR once."""
    cached = g.__dict__.get("_edge_keys_cache")
    if cached is not None and cached[0] == g.version:
        return cached[1], cached[2]
    keys, w = _live_keys(g)
    object.__setattr__(g, "_edge_keys_cache", (g.version, keys, w))
    return keys, w


def edge_map(g: Graph) -> Dict[Tuple[int, int], int]:
    """The graph's live edge set as a host dict ``(u, v) -> w``, in
    ascending ``(u, v)`` order (edges leaving a padded vertex excluded).
    Built on demand from the device key set for tests and consumers that
    want the dict; the update path never calls it."""
    keys, w = _edge_keys(g)
    vp = g.num_vertices
    k = keys.cpu().numpy()
    return dict(zip(zip((k // vp).tolist(), (k % vp).tolist()),
                    w.cpu().numpy().tolist()))


def unpadded(g: Graph) -> Graph:
    """The semantic (un-padded) graph a streaming-shaped graph
    represents: real vertices only, live edges only, no sentinel, a fresh
    Graph at version 0 on ``g``'s device (its CSR is
    ``repro.core.streaming.unpadded``'s)."""
    keys, w = _edge_keys(g)
    vp = g.num_vertices
    return _csr_from_sorted(keys // vp, keys % vp, w, real_vertices(g))


def _rebuild(keys: torch.Tensor, w: torch.Tensor, v_real: int, vp: int,
             ecap: int, version: int) -> Graph:
    """The CSR of the sorted live keys ``keys`` (``src * vp + dst``) and
    weights ``w`` at fixed ``(vp, ecap)`` shapes, on their device.
    Padded edges target the sentinel vertex ``vp - 1`` with weight INF
    (the ``pad_graph`` invariant).  An edge count past ``ecap`` grows it
    to the next bucket.  The graph keeps ``(keys, w)`` as its edge-set
    entry, ``w`` a view of its ``edge_w``."""
    n = keys.shape[0]
    if n > ecap:
        ecap = next_bucket(n, minimum=1024)
    dev = keys.device
    # the keys are sorted, so row v starts at the first key >= v * vp
    row_ptr = torch.searchsorted(
        keys, torch.arange(vp + 1, dtype=torch.int64, device=dev) * vp,
        out_int32=True)
    col_idx = torch.full((ecap,), vp - 1, dtype=torch.int32, device=dev)
    col_idx[:n] = keys % vp
    edge_w = torch.full((ecap,), int(INF), dtype=torch.int32, device=dev)
    edge_w[:n] = w
    out = Graph(row_ptr, col_idx, edge_w)
    object.__setattr__(out, "_v_real", v_real)
    object.__setattr__(out, "_version", version)
    object.__setattr__(out, "_edge_keys_cache", (version, keys,
                                                 edge_w[:n]))
    return out


def streaming_graph(g: Graph, edge_capacity: Optional[int] = None) -> Graph:
    """Prepare a graph for :func:`apply_updates`: a copy padded to
    streaming shape on ``g``'s device, its vertex count rounded up past a
    sentinel (``vp - 1``, a multiple of 8) and its edge count bucketed
    to a power of two with headroom.

    ``edge_capacity`` fixes the edge headroom (bucketed up); the default
    leaves ~50% growth room.  A batch that overflows the capacity still
    applies, growing E to the next bucket (new shapes, once)."""
    v_real = g.num_vertices
    keys, w = _live_keys(g)
    n = keys.shape[0]
    vp = -(-(v_real + 1) // 8) * 8      # >= v_real + 1, multiple of 8
    want = n if edge_capacity is None else int(edge_capacity)
    if want < n:
        raise ValueError(f"edge_capacity {want} < current edge count {n}")
    if edge_capacity is None:
        want = n + max(64, n // 2)
    ecap = next_bucket(want, minimum=1024)
    keys = (keys // v_real) * vp + keys % v_real     # re-key to vp
    return _rebuild(keys, w, v_real, vp, ecap, version=0)


# ---------------------------------------------------------------------------
# Replaying a batch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetDelta:
    """The NET effect a batch has on the edge set: final state against
    pre-batch state per (u, v) pair, so in-batch churn collapses away.

    ``added``      — ``(u, v, w_new)`` edges absent before, present after;
    ``removed``    — ``(u, v, w_pre)`` edges present before, absent after;
    ``reweighted`` — ``(u, v, w_pre, w_new)`` edges present in both with
    a changed weight.  Each list is in ascending ``(u, v)`` order.
    """
    added: List[Tuple[int, int, int]]
    removed: List[Tuple[int, int, int]]
    reweighted: List[Tuple[int, int, int, int]]

    def is_empty(self) -> bool:
        """True when the batch was a semantic no-op."""
        return not (self.added or self.removed or self.reweighted)

    def sources(self) -> List[int]:
        """Sorted unique source endpoints of every changed edge — the
        serve layer's cache-eviction probe."""
        vs = {u for (u, _, _) in self.added}
        vs |= {u for (u, _, _) in self.removed}
        vs |= {u for (u, _, _, _) in self.reweighted}
        return sorted(vs)


class _Net(NamedTuple):
    """A replayed batch: its :class:`NetDelta` and what the device merge
    needs — the old positions of the removed keys and of the reweighted
    ones (with their new weights), and the added keys (with theirs)."""
    delta: NetDelta
    removed_pos: np.ndarray
    reweight_pos: np.ndarray
    reweight_w: np.ndarray
    added_keys: np.ndarray
    added_w: np.ndarray


def _lookup(g: Graph, tkeys: np.ndarray) -> tuple:
    """Host ``(found, w, pos)`` of the sorted int64 keys ``tkeys`` in
    ``g``'s live edge set: whether each is present, its weight and its
    position there — one ``searchsorted`` and one fetch of ``3 x T``
    values."""
    keys, w = _edge_keys(g)
    t = tkeys.shape[0]
    if t == 0 or keys.shape[0] == 0:
        z = np.zeros((t,), np.int64)
        return z.astype(bool), z, z
    q = torch.from_numpy(tkeys).to(keys.device)
    pos = torch.searchsorted(keys, q).clamp_(max=keys.shape[0] - 1)
    found, wq, pos = torch.stack(
        [(keys[pos] == q).long(), w[pos].long(), pos]).cpu().numpy()
    return found.astype(bool), wq, pos


def _replay(g: Graph, batch: UpdateBatch) -> _Net:
    """Replay ``batch`` against ``g`` in slot order over only the keys it
    touches, with ``repro.core.streaming._apply_ops``'s rules and
    errors, and classify the net delta per touched key."""
    if "_v_real" not in g.__dict__:
        raise ValueError("graph is not streaming-enabled; wrap it with "
                         "streaming_graph(g) first")
    v_real, vp = real_vertices(g), g.num_vertices
    op = np.asarray(batch.op)
    src = np.asarray(batch.src).astype(np.int64)
    dst = np.asarray(batch.dst).astype(np.int64)
    ok = ((op != OP_PAD) & (src >= 0) & (src < v_real) & (dst >= 0)
          & (dst < v_real))
    tkeys = np.unique(src[ok] * vp + dst[ok])
    found, wq, pos = _lookup(g, tkeys)
    prior = {int(k): (int(x) if f else None)
             for k, f, x in zip(tkeys, found, wq)}
    at = dict(zip(tkeys.tolist(), pos.tolist()))
    cur = dict(prior)
    for i in range(batch.capacity):
        o = int(op[i])
        if o == OP_PAD:
            continue
        u, v, w = int(src[i]), int(dst[i]), int(batch.w[i])
        if not (0 <= u < v_real and 0 <= v < v_real):
            raise ValueError(f"update slot {i}: edge ({u}, {v}) out of "
                             f"range [0, {v_real})")
        k = u * vp + v
        if o == OP_DELETE:
            cur[k] = None
            continue
        if not 1 <= w < int(INF):
            raise ValueError(f"update slot {i}: weight {w} outside "
                             f"[1, INF)")
        if o == OP_INSERT:
            c = cur[k]
            cur[k] = w if c is None else min(c, w)
        elif o == OP_REWEIGHT:
            if cur[k] is not None:
                cur[k] = w
        else:
            raise ValueError(f"update slot {i}: unknown op code {o}")
    added, removed, reweighted = [], [], []
    rm_pos, rw_pos, rw_w, add_k, add_w = [], [], [], [], []
    for k in tkeys.tolist():
        b, a = prior[k], cur[k]
        u, v = divmod(k, vp)
        if b is None and a is not None:
            added.append((u, v, a))
            add_k.append(k)
            add_w.append(a)
        elif b is not None and a is None:
            removed.append((u, v, b))
            rm_pos.append(at[k])
        elif b is not None and a is not None and b != a:
            reweighted.append((u, v, b, a))
            rw_pos.append(at[k])
            rw_w.append(a)

    def arr(x, dt=np.int64):
        return np.asarray(x, dt).reshape(-1)

    return _Net(NetDelta(added, removed, reweighted), arr(rm_pos),
                arr(rw_pos), arr(rw_w, np.int32), arr(add_k),
                arr(add_w, np.int32))


def _merge(g: Graph, net: _Net) -> tuple:
    """The live edge set after ``net``, merged on ``g``'s device without
    a sort or a host read (the delta crosses in one copy): every kept
    key moves down by the removed keys before it and up by the added
    keys below it; each added key lands after the kept keys below it.
    Returns sorted ``(keys, w)``."""
    keys, w = _edge_keys(g)
    dev = keys.device
    n = keys.shape[0]
    r, q, a = (net.removed_pos.shape[0], net.reweight_pos.shape[0],
               net.added_keys.shape[0])
    n_new = n - r + a
    packed = torch.from_numpy(np.concatenate(
        [net.removed_pos, net.reweight_pos, net.reweight_w, net.added_keys,
         net.added_w]).astype(np.int64)).to(dev)
    rm_pos, rw_pos, rw_w, add_k, add_w = torch.split(packed,
                                                     [r, q, q, a, a])
    if q:
        w = w.clone()
        w.index_copy_(0, rw_pos, rw_w.to(torch.int32))
    out_k = torch.empty((n_new + 1,), dtype=torch.int64, device=dev)
    out_w = torch.empty((n_new + 1,), dtype=torch.int32, device=dev)
    dest = torch.arange(n, dtype=torch.int64, device=dev)
    if r:
        dest -= torch.searchsorted(rm_pos, dest)
    if a:
        dest += torch.searchsorted(add_k, keys)
    if r:
        dest.index_fill_(0, rm_pos, n_new)        # dropped: the spare slot
    out_k.index_copy_(0, dest, keys)
    out_w.index_copy_(0, dest, w)
    del dest
    if a:
        below = torch.searchsorted(keys, add_k)
        if r:
            below -= torch.searchsorted(keys[rm_pos], add_k)
        at = torch.arange(a, dtype=torch.int64, device=dev) + below
        out_k.index_copy_(0, at, add_k)
        out_w.index_copy_(0, at, add_w.to(torch.int32))
    return out_k[:n_new], out_w[:n_new]


def _apply(g: Graph, net: _Net, in_place: bool) -> Graph:
    """:func:`apply_updates` of a replayed batch."""
    keys, w = _merge(g, net)
    new = _rebuild(keys, w, real_vertices(g), g.num_vertices, g.num_edges,
                   version=g.version + 1)
    if not in_place:
        return new
    object.__setattr__(g, "row_ptr", new.row_ptr)
    object.__setattr__(g, "col_idx", new.col_idx)
    object.__setattr__(g, "edge_w", new.edge_w)
    g.bump_version()
    object.__setattr__(g, "_edge_keys_cache", (g.version, keys,
                                               new.edge_w[:keys.shape[0]]))
    return g


def apply_updates(g: Graph, batch: UpdateBatch,
                  in_place: bool = False) -> Graph:
    """Apply one :class:`UpdateBatch` to a streaming-shaped graph.

    The CSR is rebuilt on the graph's device at its existing (V, E)
    shapes (col_idx / edge_w padding targets the sentinel vertex); only
    an edge-capacity overflow grows E, to the next bucket.  The result's
    :attr:`Graph.version` is the input's plus one, which invalidates the
    memoized reverse CSR, pull enumerations, captured programs and edge
    set.

    ``in_place=False`` (default) returns a NEW Graph and leaves ``g``
    untouched (the serve layer drains in-flight queries on the old
    snapshot); ``in_place=True`` swaps the arrays underneath ``g`` and
    bumps its version.  Requires a graph produced by
    :func:`streaming_graph` (or a prior ``apply_updates``)."""
    return _apply(g, _replay(g, batch), in_place)


def diff_batch(g: Graph, batch: UpdateBatch) -> NetDelta:
    """Classify the net delta ``batch`` would cause on ``g`` WITHOUT
    applying it (pure)."""
    return _replay(g, batch).delta


# ---------------------------------------------------------------------------
# Incremental label repair
# ---------------------------------------------------------------------------

def _tight(app: str, lu: int, lv: int, w: int) -> bool:
    """Does an edge (u, v, w) support label[v], given ``lu = label[u]``
    and ``lv = label[v]``?  At a min-combine fixpoint every edge
    satisfies ``lv <= msg(lu)``; removing or worsening a tight one (with
    equality) may invalidate ``lv``, which resumption cannot raise."""
    if app == "bfs":
        return lu < int(INF) and lu + 1 == lv
    if app == "sssp":
        return lu < int(INF) and lu + w == lv
    return lu == lv                     # cc: min-label propagation


def _endpoint_labels(labels: torch.Tensor, edges) -> dict:
    """``{vertex: label}`` over the endpoints of ``edges`` (tuples led by
    ``u, v``): one gather and one fetch of at most 2K values."""
    vs = sorted({x for e in edges for x in e[:2]})
    if not vs:
        return {}
    idx = torch.tensor(vs, dtype=torch.int64, device=labels.device)
    return dict(zip(vs, labels[idx].cpu().tolist()))


@dataclasses.dataclass
class UpdateReport:
    """What one :func:`stream_update` did: ``rounds`` of relax work
    (0 for a semantic no-op), whether it had to ``full_recompute``, how
    many changed edges ``seeds`` the incremental frontier started from,
    and the graph ``version`` the labels now correspond to."""
    rounds: int
    full_recompute: bool
    seeds: int
    version: int


@dataclasses.dataclass
class StreamState:
    """A live label fixpoint riding a mutating graph: the graph, the app
    (key into :data:`STREAM_APPS`), the current labels (full padded
    ``[V]`` on the graph's device; the semantic slice is
    ``real_labels``), the query source (None for cc), and the balancer
    config / execution mode the repair rounds run with."""
    g: Graph
    app: str
    labels: torch.Tensor
    source: Optional[int]
    cfg: BalancerConfig
    mode: str
    version: int

    @property
    def real_labels(self) -> np.ndarray:
        """Host copy of the labels over REAL vertices only."""
        return self.labels[: real_vertices(self.g)].cpu().numpy()


def _full_compute(g: Graph, app: str, source: Optional[int],
                  cfg: BalancerConfig, mode: str):
    """From-scratch driver run — ``stream_init`` and the fallback."""
    if app == "bfs":
        return drivers.bfs(g, source, cfg, mode=mode)
    if app == "sssp":
        return drivers.sssp(g, source, cfg, mode=mode)
    if app == "cc":
        return drivers.cc(g, cfg, mode=mode)
    raise ValueError(f"unknown streaming app {app!r} "
                     f"(have {sorted(STREAM_APPS)})")


def stream_init(g: Graph, app: str, source: Optional[int] = None,
                cfg: BalancerConfig = BalancerConfig(),
                mode: str = "host") -> StreamState:
    """Start maintaining ``app`` labels over a mutating graph: wraps
    ``g`` to streaming shape if needed, runs the from-scratch driver
    once, and returns the :class:`StreamState` that
    :func:`stream_update` advances.  ``source`` is required for bfs/sssp
    and must be omitted for cc."""
    if app not in STREAM_APPS:
        raise ValueError(f"unknown streaming app {app!r} "
                         f"(have {sorted(STREAM_APPS)})")
    if (source is None) != (app == "cc"):
        raise ValueError("bfs/sssp require a source; cc forbids one")
    if "_v_real" not in g.__dict__:
        g = streaming_graph(g)
    res = _full_compute(g, app, source, cfg, mode)
    return StreamState(g=g, app=app, labels=res.labels, source=source,
                       cfg=cfg, mode=mode, version=g.version)


def stream_update(state: StreamState, batch: UpdateBatch,
                  in_place: bool = False,
                  max_rounds: int = 10_000) -> UpdateReport:
    """Apply a batch to the state's graph and repair its labels to the
    new fixpoint; mutates ``state`` and returns an :class:`UpdateReport`.

    Any removed edge (or, for sssp, weight-increased edge) that is
    *tight* under the current labels forces a full recompute; otherwise
    the added edges (plus sssp weight decreases) seed a frontier
    (``seed_from_edges``) and the round loop resumes from the current
    labels; a semantic no-op costs zero rounds.  Host work is the
    batch's replay and, when edges were removed or reweighted, one fetch
    of their endpoints' labels."""
    net = _replay(state.g, batch)
    delta = net.delta
    g2 = _apply(state.g, net, in_place)
    app = state.app
    checked = delta.removed + (delta.reweighted if app == "sssp" else [])
    lab = _endpoint_labels(state.labels, checked)

    full = any(_tight(app, lab[u], lab[v], w)
               for (u, v, w) in delta.removed)
    seeds = [(u, v) for (u, v, _) in delta.added]
    if app == "sssp" and not full:
        for (u, v, wp, wn) in delta.reweighted:
            if wn > wp and _tight("sssp", lab[u], lab[v], wp):
                full = True
                break
            if wn < wp:
                seeds.append((u, v))

    if full:
        res = _full_compute(g2, app, state.source, state.cfg, state.mode)
        labels, rounds = res.labels, res.rounds
    elif seeds:
        k = batch.capacity              # one shape per stream capacity
        sdm = np.zeros((3, k), np.int64)          # src, dst, mask
        sdm[:2, :len(seeds)] = np.asarray(seeds, np.int64).T
        sdm[2, :len(seeds)] = 1
        s, d, m = torch.from_numpy(sdm).to(g2.device)
        frontier = seed_from_edges(s, d, m > 0, g2.num_vertices)
        res = drivers.resume_loop(g2, state.labels, frontier, state.cfg,
                                  STREAM_APPS[app], max_rounds=max_rounds,
                                  mode=state.mode)
        labels, rounds = res.labels, res.rounds
    else:
        labels, rounds = state.labels, 0

    state.g = g2
    state.labels = labels
    state.version = g2.version
    return UpdateReport(rounds=rounds, full_recompute=full,
                        seeds=len(seeds), version=g2.version)
