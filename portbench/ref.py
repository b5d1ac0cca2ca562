"""The plain reference: the benchmark's own traversals in torch operations.

It imports torch alone (nothing of the program, of ``jax`` or of
``repro``) and takes only the CSR arrays the benchmark made, so what it
answers is independent of the code under test:

* :func:`sssp` — synchronous data-driven Bellman-Ford over ``[B, V]``
  rows in lockstep: each round relaxes the out-arcs of the vertices
  whose label improved in the round before, against the labels the round
  started from.  Its fixpoint is the exact distance (hops with
  ``weighted=False``), and its rounds are the algorithm whose bytes
  ``work.py`` counts;
* :func:`pagerank` — the pull power iteration of the port's driver
  (``(1 - d) / n + d * (acc + dangling / n)``, stopping once the largest
  change is under ``tol``) on a symmetric CSR, in float64;
* :func:`components` — connected components by min-label propagation
  with pointer jumping, for the edge count of each source's component.

Every pass walks the arcs in blocks of at most ``chunk`` arcs, so that it
fits beside the graph.
"""
from __future__ import annotations

import torch

INF = 1 << 30          # unreached, as the port's int32 labels have it
CHUNK = 1 << 27


def _steps(chunk: int, total: int, device):
    """The multiples of ``chunk`` below ``total``, int64."""
    return torch.arange(chunk, max(total, chunk), chunk, device=device)


def _blocks(row_ptr, verts, chunk: int):
    """``(pos, arc)`` blocks of the out-arcs of ``verts`` (int64 vertex
    ids), at most ``chunk`` arcs a block unless one vertex has more:
    ``arc`` the arc ids, ``pos`` the index in ``verts`` of each arc's
    source."""
    if verts.numel() == 0:
        return
    start = row_ptr[verts].long()
    deg = row_ptr[verts + 1].long() - start
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1])
    if total == 0:
        return
    cuts = torch.searchsorted(cum, _steps(chunk, total, cum.device),
                              right=True)
    bounds = sorted({0, verts.numel(), *cuts.tolist()})
    for i, j in zip(bounds, bounds[1:]):
        d = deg[i:j]
        n = int(cum[j - 1] - (cum[i - 1] if i else 0))
        if n == 0:
            continue
        seg = torch.repeat_interleave(
            torch.arange(j - i, device=d.device), d, output_size=n)
        base = start[i:j] - (torch.cumsum(d, 0) - d)
        yield seg + i, base[seg] + torch.arange(n, device=d.device)


def _row_blocks(row_ptr, chunk: int):
    """``(lo, hi, rows, a0, a1)``: consecutive vertex ranges whose arcs,
    ``a0..a1``, number at most ``chunk`` unless one row has more, with
    the int64 row id of each of those arcs."""
    v = row_ptr.numel() - 1
    ends = torch.searchsorted(
        row_ptr.long(), _steps(chunk, int(row_ptr[-1]), row_ptr.device),
        right=True)
    bounds = sorted({0, v, *[min(max(int(e) - 1, 1), v)
                             for e in ends.tolist()]})
    for lo, hi in zip(bounds, bounds[1:]):
        a0, a1 = int(row_ptr[lo]), int(row_ptr[hi])
        rows = torch.repeat_interleave(
            torch.arange(lo, hi, device=row_ptr.device),
            (row_ptr[lo + 1:hi + 1] - row_ptr[lo:hi]).long(),
            output_size=a1 - a0)
        yield lo, hi, rows, a0, a1


def sssp(row_ptr, col_idx, edge_w, sources, weighted: bool = True,
         dtype=torch.int32, chunk: int = CHUNK):
    """Exact distances from each of ``sources`` (``[B, V]`` int32, INF
    where unreached) and the rounds the synchronous algorithm took, each
    a dict of counts: ``f_union`` / ``a_union`` the vertices of the
    rows' union frontier and their out-arcs, and per row ``f``, ``a``,
    ``c``: frontier vertices, their out-arcs, labels changed.

    ``dtype`` other than int32 holds the labels and sums in that type
    (the control: a 16-bit float rounds large distances); its labels
    come back as int32, INF where unreached."""
    dev = row_ptr.device
    v, b = row_ptr.numel() - 1, len(sources)
    is_int = not dtype.is_floating_point
    inf = (min(INF, torch.iinfo(dtype).max) if is_int else float("inf"))
    lab = torch.full((b, v), inf, dtype=dtype, device=dev)
    src = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    lab[rows, src] = 0
    fr = torch.zeros((b, v), dtype=torch.bool, device=dev)
    fr[rows, src] = True
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    rounds = []
    while bool(fr.any()):
        union = fr.any(0)
        rec = {"f_union": int(union.sum()),
               "a_union": int(deg[union].sum()), "f": [], "a": [], "c": []}
        new = lab.clone()
        for r in range(b):
            verts = torch.nonzero(fr[r]).flatten()
            rec["f"].append(verts.numel())
            rec["a"].append(int(deg[verts].sum()))
            for pos, arc in _blocks(row_ptr, verts, chunk):
                step = edge_w[arc].to(dtype) if weighted else 1
                cand = lab[r][verts[pos]] + step
                new[r].scatter_reduce_(0, col_idx[arc].long(), cand, "amin")
        fr = new < lab
        rec["c"] = fr.sum(1).tolist()
        lab = new
        rounds.append(rec)
    if dtype != torch.int32:
        unreached = lab == inf
        lab = torch.where(unreached, INF, lab.float().round().to(
            torch.int32))
    return lab, rounds


def pagerank(row_ptr, col_idx, damping: float, tol: float, max_rounds: int,
             dtype=torch.float64, acc_dtype=torch.float64,
             chunk: int = CHUNK):
    """Pull PageRank on a symmetric CSR: ``(rank, deltas)``, the ranks
    (as float32) once the largest change of a round is under ``tol`` or
    ``max_rounds`` rounds have run, and each round's largest change.
    Ranks are held in ``dtype`` and neighbour sums accumulated in
    ``acc_dtype``."""
    dev = row_ptr.device
    n = row_ptr.numel() - 1
    outdeg = (row_ptr[1:] - row_ptr[:-1]).to(acc_dtype)
    inv_out = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1.0), 0.0)
    sink = outdeg == 0
    rank = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    deltas = []
    while len(deltas) < max_rounds and (not deltas or deltas[-1] >= tol):
        contrib = (rank.to(acc_dtype) * inv_out).to(dtype)
        dangling = torch.where(sink, rank.to(acc_dtype), 0.0).sum()
        acc = torch.zeros(n, dtype=acc_dtype, device=dev)
        for _, _, rows, a0, a1 in _row_blocks(row_ptr, chunk):
            acc.index_add_(0, rows, contrib[col_idx[a0:a1].long()].to(
                acc_dtype))
        new = ((1.0 - damping) / n + damping * (acc + dangling / n)).to(
            dtype)
        deltas.append(float((new.to(acc_dtype) - rank.to(acc_dtype))
                            .abs().max()))
        rank = new
    return rank.float(), deltas


def components(row_ptr, col_idx, chunk: int = CHUNK):
    """Each vertex's connected component, named by its least vertex id
    (int32 ``[V]``), on a symmetric CSR."""
    v = row_ptr.numel() - 1
    lab = torch.arange(v, dtype=torch.int32, device=row_ptr.device)
    while True:
        new = lab.clone()
        for _, _, rows, a0, a1 in _row_blocks(row_ptr, chunk):
            new.scatter_reduce_(0, rows, lab[col_idx[a0:a1].long()], "amin")
        new = new[new.long()]
        if torch.equal(new, lab):
            return lab
        lab = new


def component_edges(row_ptr, comp) -> torch.Tensor:
    """Undirected edges of each component, indexed by its name (int64
    ``[V]``, 0 where no component is named): half its vertices'
    degrees."""
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    out = torch.zeros(deg.numel(), dtype=torch.int64, device=deg.device)
    return out.index_add_(0, comp.long(), deg) // 2
