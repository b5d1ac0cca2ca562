"""The benchmark's graphs, made on the device from a seed.

The generators follow the semantics of ``repro_torch.core.graph``'s
host NumPy ``rmat``, ``uniform_random`` and ``from_edge_list`` (one
uniform draw a bit picks the Kronecker quadrant; duplicates keep their
minimum weight; rows in ``(src, dst)`` order), rewritten in torch so a
graph of a billion arcs is built on the card in seconds instead of in a
host sort.  They add what the GAP Benchmark Suite's synthetic graphs
need: the undirected build (every edge stored both ways, self-loops
dropped), Graph500's vertex scramble for ``kron``, and integer weights
uniform in ``1..max_weight``.

The whole graph comes from one ``torch.Generator`` on the device seeded
with ``--seed``: the same seed gives the same CSR on the same card.
"""
from __future__ import annotations

import torch


def kron_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               gen: torch.Generator, device):
    """Graph500 Kronecker edges: ``edge_factor * 2**scale`` int32
    ``(src, dst)`` pairs, one draw a bit choosing quadrant a, b, c or d
    (src bit set in c and d, dst bit in b and d)."""
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        src.mul_(2).add_(r >= ab)
        dst.mul_(2).add_(((r >= a) & (r < ab)) | (r >= abc))
    return src, dst


def urand_edges(scale: int, edge_factor: int, gen: torch.Generator, device):
    """Uniform random edges: ``edge_factor * 2**scale`` pairs, both ends
    uniform over the ``2**scale`` vertices."""
    n, m = 1 << scale, edge_factor << scale
    src = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    return src, dst


#: arcs sorted at once: the sort's buffers stay a few GB at any scale
SORT_CHUNK = 1 << 28


def undirected_csr(edges: list, num_vertices: int, max_weight: int,
                   chunk: int = SORT_CHUNK):
    """Symmetric CSR ``(row_ptr, col_idx, edge_w)``, all int32, of the
    edge list ``edges = [src, dst, w]`` (emptied, so the caller's arrays
    are freed as they are used): self-loops dropped, each edge stored
    both ways, each ``(src, dst)`` pair keeping its minimum weight, rows
    in ``(src, dst)`` order.

    Each arc is one int64 word ``src | dst | weight`` (high to low), so
    one sort orders the arcs by ``(src, dst)`` with the minimum weight
    first in each run; a run's first word is the kept arc.  The words
    are sorted in buckets of equal source ranges, about ``chunk`` words
    each, so that the sort's buffers do not grow with the graph."""
    vbits = max(1, (num_vertices - 1).bit_length())
    wbits = int(max_weight).bit_length()
    if 2 * vbits + wbits > 63:
        raise ValueError(f"{num_vertices} vertices and weights up to "
                         f"{max_weight} do not pack into one int64 word")
    src, dst, w = edges
    edges.clear()
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    m = src.numel()
    words = torch.empty(2 * m, dtype=torch.int64, device=src.device)
    for half, (s, d) in enumerate(((src, dst), (dst, src))):
        out = words[half * m:(half + 1) * m]
        out.copy_(s)
        out.bitwise_left_shift_(vbits).add_(d)
        out.bitwise_left_shift_(wbits).add_(w)
    del src, dst, w, keep
    shift = vbits + wbits
    buckets = max(1, -(-words.numel() // chunk))
    bounds = [num_vertices * k // buckets for k in range(buckets + 1)]
    cols, weights, ptrs, base = [], [], [], 0
    for lo, hi in zip(bounds, bounds[1:]):
        sel = words[(words >= lo << shift) & (words < hi << shift)]
        sel = torch.sort(sel).values
        first = torch.ones(sel.numel(), dtype=torch.bool, device=sel.device)
        pair = sel >> wbits
        torch.ne(pair[1:], pair[:-1], out=first[1:])
        del pair
        sel = sel[first]
        del first
        starts = torch.arange(lo, hi, dtype=torch.int64,
                              device=sel.device) << shift
        ptrs.append(torch.searchsorted(sel, starts) + base)
        base += sel.numel()
        weights.append((sel & ((1 << wbits) - 1)).to(torch.int32))
        cols.append(((sel >> wbits) & ((1 << vbits) - 1)).to(torch.int32))
        del sel
    del words
    if base >= 1 << 31:
        raise ValueError(f"{base} arcs overflow int32 row offsets")
    ptrs.append(torch.tensor([base], dtype=torch.int64,
                             device=ptrs[0].device))
    row_ptr = torch.cat(ptrs).to(torch.int32)
    return row_ptr, torch.cat(cols), torch.cat(weights)


def make_edges(cfg: dict, seed: int, device):
    """The configuration's edge list from ``seed``: ``([src, dst, w],
    num_vertices, max_weight, generator)``, the generator going on to
    draw the sources."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    n = 1 << scale
    kind = cfg["generator"]
    if kind == "kron":
        src, dst = kron_edges(scale, ef, cfg["a"], cfg["b"], cfg["c"], gen,
                              device)
    elif kind == "urand":
        src, dst = urand_edges(scale, ef, gen, device)
    else:
        raise ValueError(f"unknown generator {kind!r}")
    if cfg.get("permute", False):
        perm = torch.randperm(n, generator=gen, device=device).to(
            torch.int32)
        src, dst = perm[src.long()], perm[dst.long()]
        del perm
    lo, hi = cfg["weights"]
    w = torch.randint(int(lo), int(hi) + 1, (src.numel(),), generator=gen,
                      device=device, dtype=torch.int32)
    return [src, dst, w], n, int(hi), gen


def make_graph(cfg: dict, seed: int, device):
    """The configuration's graph from ``seed``: ``(row_ptr, col_idx,
    edge_w)`` on ``device`` and the generator, which draws the sources
    next."""
    edges, n, max_weight, gen = make_edges(cfg, seed, device)
    return undirected_csr(edges, n, max_weight), gen


def draw_sources(row_ptr, count: int, gen: torch.Generator) -> list:
    """``count`` distinct vertices drawn uniformly from those of degree
    > 0 (GAP's and Graph500's rule for roots), as host ints."""
    deg = row_ptr[1:] - row_ptr[:-1]
    cand = torch.nonzero(deg > 0).flatten()
    if cand.numel() < count:
        raise ValueError(f"{count} sources asked for, but only "
                         f"{cand.numel()} vertices have an edge")
    pick = torch.randperm(cand.numel(), generator=gen,
                          device=cand.device)[:count]
    return cand[pick].tolist()
