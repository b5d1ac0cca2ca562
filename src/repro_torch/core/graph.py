"""CSR graph container + synthetic graph generators (PyTorch).

Port of ``repro/core/graph.py``.  The generators are the same host
numpy code, so one seed gives byte-identical CSR arrays in both
packages; only the final hand-off differs (``torch`` tensors on the
requested device instead of ``jax`` arrays).  The CSR is this system's
state on the device: ``row_ptr``, ``col_idx`` and ``edge_w``, all int32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Sentinel "infinity" for int32 distance labels.  We avoid INT32_MAX so
# that INF + weight does not wrap around.
INF = np.int32(1 << 30)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when CUDA is asked for (or defaulted to) and
    no CUDA device exists — the port never falls back to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless the caller passes "
            "device='cpu', and no CUDA device is available")
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """Device-resident CSR graph.

    row_ptr : int32[V+1]   prefix of out-degrees
    col_idx : int32[E]     destination vertex of each edge
    edge_w  : int32[E]     edge weights (all-ones for unweighted apps)
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    edge_w: torch.Tensor

    def __post_init__(self):
        for name in ("row_ptr", "col_idx", "edge_w"):
            t = getattr(self, name)
            if t.dtype != torch.int32 or t.ndim != 1:
                raise ValueError(f"Graph.{name} must be a 1-D int32 "
                                 f"tensor; got {t.dtype} {tuple(t.shape)}")
            if t.device != self.row_ptr.device:
                raise ValueError("Graph arrays must share one device")
        if self.col_idx.shape != self.edge_w.shape:
            raise ValueError("col_idx and edge_w must have one length")

    @classmethod
    def from_numpy(cls, row_ptr, col_idx, edge_w, device=None) -> "Graph":
        """Build a graph from host CSR arrays (anything ``np.asarray``
        accepts, e.g. the JAX package's graph arrays), moved to
        ``device`` — how both packages compute on the same state."""
        dev = resolve_device(device)

        def put(a):
            # a private, writable copy: the source may be read-only
            return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

        return cls(put(row_ptr), put(col_idx), put(edge_w))

    # ---- basic properties ------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.col_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def version(self) -> int:
        """Monotonically increasing topology version, the key of every
        structure memoized on the graph (see ``repro.core.graph``)."""
        return self.__dict__.get("_version", 0)

    def bump_version(self) -> None:
        """Advance :attr:`version` after an in-place topology change."""
        object.__setattr__(self, "_version", self.version + 1)

    def out_degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def max_out_degree(self) -> int:
        return int(self.out_degrees().max())

    def reverse(self) -> "Graph":
        """Memoized :func:`reverse_graph` (in-edges become out-edges),
        rebuilt when :attr:`version` has moved since it was cached."""
        cached = self.__dict__.get("_reverse_cache")
        if cached is None or cached[0] != self.version:
            cached = (self.version, reverse_graph(self))
            object.__setattr__(self, "_reverse_cache", cached)
        return cached[1]


# ---------------------------------------------------------------------------
# Construction helpers (host side, numpy) — same code as repro.core.graph
# ---------------------------------------------------------------------------

def from_edge_list(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   weights: np.ndarray | None = None,
                   dedup: bool = True, device=None) -> Graph:
    """Build a CSR Graph from a COO edge list (host-side).

    ``dedup=True`` collapses parallel edges deterministically: each
    (src, dst) pair keeps the **minimum** weight among its duplicates.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dedup and len(src):
        key = src * np.int64(num_vertices) + dst
        if weights is None:
            _, keep = np.unique(key, return_index=True)
            src, dst = src[keep], dst[keep]
        else:
            weights = np.asarray(weights)
            # sort by (key, weight): the first edge of each key run is
            # its minimum-weight duplicate
            by_w = np.lexsort((weights, key))
            key, src, dst, weights = (key[by_w], src[by_w], dst[by_w],
                                      weights[by_w])
            keep = np.concatenate([[True], key[1:] != key[:-1]])
            src, dst, weights = src[keep], dst[keep], weights[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if weights is None:
        weights = np.ones(len(src), dtype=np.int32)
    else:
        weights = np.asarray(weights, dtype=np.int32)[order]
    counts = np.bincount(src, minlength=num_vertices).astype(np.int32)
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph.from_numpy(row_ptr, dst.astype(np.int32), weights,
                            device=device)


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         weighted: bool = True, max_weight: int = 100,
         device=None) -> Graph:
    """RMAT generator (Chakrabarti et al.), the paper's power-law inputs:
    ~2**scale vertices, edge_factor * 2**scale directed edges before
    dedup, power-law out-degree."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        # pick quadrant: 0=a 1=b 2=c 3=d
        quad = np.select(
            [r < a, r < ab, r < abc], [0, 1, 2], default=3)
        src = (src << 1) | (quad >= 2)
        dst = (dst << 1) | (quad & 1)
    w = rng.integers(1, max_weight + 1, size=m) if weighted else None
    return from_edge_list(src, dst, n, weights=w, device=device)


def road_grid(side: int, seed: int = 0, weighted: bool = True,
              max_weight: int = 100, device=None) -> Graph:
    """2-D grid graph: constant degree <= 4, diameter 2*side."""
    rng = np.random.default_rng(seed)
    n = side * side
    vs = np.arange(n).reshape(side, side)
    srcs, dsts = [], []
    # bidirectional horizontal + vertical edges
    srcs += [vs[:, :-1].ravel(), vs[:, 1:].ravel(),
             vs[:-1, :].ravel(), vs[1:, :].ravel()]
    dsts += [vs[:, 1:].ravel(), vs[:, :-1].ravel(),
             vs[1:, :].ravel(), vs[:-1, :].ravel()]
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    w = rng.integers(1, max_weight + 1, size=len(src)) if weighted else None
    return from_edge_list(src, dst, n, weights=w, device=device)


def uniform_random(num_vertices: int, avg_degree: int = 8, seed: int = 0,
                   weighted: bool = True, max_weight: int = 100,
                   device=None) -> Graph:
    """Uniform random digraph (no skew) — the balanced control input."""
    rng = np.random.default_rng(seed)
    m = num_vertices * avg_degree
    src = rng.integers(0, num_vertices, size=m)
    dst = rng.integers(0, num_vertices, size=m)
    w = rng.integers(1, max_weight + 1, size=m) if weighted else None
    return from_edge_list(src, dst, num_vertices, weights=w, device=device)


def to_coo(g: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side COO expansion ``(src, dst, weight)`` of a CSR graph
    (only the ``row_ptr[-1]`` edges owned by some vertex)."""
    row_ptr = g.row_ptr.cpu().numpy().astype(np.int64)  # repro: allow[host-sync] -- one-time host export of the CSR, on no round path
    e_real = int(row_ptr[-1])
    dst = g.col_idx[:e_real].cpu().numpy().astype(np.int64)  # repro: allow[host-sync] -- one-time host export of the CSR, on no round path
    w = g.edge_w[:e_real].cpu().numpy()  # repro: allow[host-sync] -- one-time host export of the CSR, on no round path
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int64),
                    row_ptr[1:] - row_ptr[:-1])
    return src, dst, w


# ---------------------------------------------------------------------------
# Derived graphs, built on the graph's own device
# ---------------------------------------------------------------------------
# The JAX package builds these on the host with numpy lexsorts; here the
# same orderings come from stable torch sorts on the graph's device, so
# the arrays are byte-identical and a 65 M-edge graph is transposed on
# the card instead of in a host sort.

def _edge_sources(g: Graph, e_real: int) -> torch.Tensor:
    """int32 source vertex of each of the first ``e_real`` edges."""
    return torch.repeat_interleave(
        torch.arange(g.num_vertices, dtype=torch.int32, device=g.device),
        g.out_degrees(), output_size=e_real)


def _csr_from_sorted(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                     num_vertices: int) -> Graph:
    """CSR of edges already in (src, dst) order."""
    counts = torch.bincount(src, minlength=num_vertices)
    row_ptr = torch.zeros(num_vertices + 1, dtype=torch.int32,
                          device=src.device)
    row_ptr[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    return Graph(row_ptr, dst.to(torch.int32).contiguous(),
                 w.to(torch.int32).contiguous())


def reverse_graph(g: Graph) -> Graph:
    """CSC view (incoming edges) as a CSR graph, for pull rounds.

    Edges come in CSR order, so their sources are already ascending; a
    stable sort by destination therefore yields (dst, src, edge order),
    the order of ``repro.core.graph.reverse_graph``'s lexsort.  Padding
    past ``row_ptr[-1]`` is reproduced as there: filler edges to vertex
    ``V - 1`` with weight ``INF``."""
    e_real = int(g.row_ptr[-1])
    src = _edge_sources(g, e_real)
    dst = g.col_idx[:e_real]
    order = torch.sort(dst, stable=True).indices
    rg = _csr_from_sorted(dst[order], src[order], g.edge_w[:e_real][order],
                          g.num_vertices)
    pad = g.num_edges - e_real
    if pad > 0:
        rg = Graph(rg.row_ptr,
                   torch.cat([rg.col_idx, torch.full(
                       (pad,), g.num_vertices - 1, dtype=torch.int32,
                       device=g.device)]),
                   torch.cat([rg.edge_w, torch.full(
                       (pad,), int(INF), dtype=torch.int32,
                       device=g.device)]))
    if "_v_real" in g.__dict__:
        object.__setattr__(rg, "_v_real", g.__dict__["_v_real"])
    return rg


def symmetrized(g: Graph) -> Graph:
    """Undirected view: every edge plus its reverse, deduplicated with
    the minimum weight kept, as ``repro.core.graph.symmetrized``.

    Its ``lexsort((w, key))`` is two stable sorts here: by weight, then
    by the int64 key ``src * V + dst`` (below 2**62 for any int32 V).
    The first edge of each key run is then the minimum-weight one, and
    the runs are already in (src, dst) order."""
    e_real = int(g.row_ptr[-1])
    s = _edge_sources(g, e_real)
    d = g.col_idx[:e_real]
    w = g.edge_w[:e_real]
    src, dst, w = torch.cat([s, d]), torch.cat([d, s]), torch.cat([w, w])
    by_w = torch.sort(w, stable=True).indices
    key = src.to(torch.int64)[by_w] * g.num_vertices + dst[by_w]
    key, by_key = torch.sort(key, stable=True)
    order = by_w[by_key]
    del by_w, by_key
    keep = torch.ones_like(key, dtype=torch.bool)
    keep[1:] = key[1:] != key[:-1]
    order = order[keep]
    return _csr_from_sorted(src[order], dst[order], w[order],
                            g.num_vertices)


def highest_out_degree_vertex(g: Graph) -> int:
    """Paper's bfs/sssp source for power-law graphs (first vertex of
    maximal out-degree, computed on the host)."""
    return int(np.argmax(np.diff(g.row_ptr.cpu().numpy())))  # repro: allow[host-sync] -- one-time benchmark-setup source pick


def to_device(g: Graph, device) -> Graph:
    """``g`` on ``device``: ``g`` itself when it is there already, else a
    copy of its CSR that keeps its :attr:`Graph.version` and streaming
    vertex count (``core.streaming.real_vertices``).  Derived caches
    stay behind; the copy builds its own."""
    dev = torch.device(device)
    if g.device == dev:
        return g
    out = Graph(g.row_ptr.to(dev), g.col_idx.to(dev), g.edge_w.to(dev))
    for attr in ("_version", "_v_real"):
        if attr in g.__dict__:
            object.__setattr__(out, attr, g.__dict__[attr])
    return out


# ---------------------------------------------------------------------------
# Padding
# ---------------------------------------------------------------------------

def pad_graph(g: Graph, v_multiple: int = 8, e_multiple: int = 1024) -> Graph:
    """Pad V and E to multiples (``repro.core.graph.pad_graph``).

    Padded vertices have degree 0.  Padded edges target the padded
    vertex ``vp - 1`` with weight ``INF``: an executor that enumerates
    edge ids over the padded span may relax them under a weight-blind
    operator (cc, kcore), and only that vertex's never-read label is
    written.  So whenever edge padding exists, vertex padding is forced
    to exist too (``vp > v``)."""
    v, e = g.num_vertices, g.num_edges
    vp = -(-v // v_multiple) * v_multiple
    ep = -(-e // e_multiple) * e_multiple
    if ep > e and vp == v:
        vp = v + v_multiple           # guarantee a padded-edge target
    if vp == v and ep == e:
        return g

    def tail(t, n, fill):
        return torch.cat([t, torch.full((n,), int(fill), dtype=torch.int32,
                                        device=g.device)])

    return Graph(tail(g.row_ptr, vp - v, g.row_ptr[-1]),
                 tail(g.col_idx, ep - e, vp - 1),
                 tail(g.edge_w, ep - e, INF))
