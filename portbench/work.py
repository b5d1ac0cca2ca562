"""The algorithm's bytes: the least traffic a round has to move, counted
from the reference's own rounds (``ref.py``), never from the program's.

Each input byte is read once and each output byte written once, with
int32 ids, weights and labels and float32 ranks.  What an implementation
chooses to read besides, such as a dense ``[V]`` frontier mask or a bin
listing, is not counted, so a rewritten kernel is judged against the
same work.

Min-combine round (sssp, bfs) over frontier ``F`` with out-arcs ``A``,
changing the labels of ``C``::

    12 |F|   two row_ptr entries and the vertex's own label
    12 |A|   the destination id, the weight and the destination's label
             (8 for bfs, which reads no weight)
     8 |C|   the new label and the next worklist's entry

A batched round over rows ``b`` reads the arcs the rows share once and
label bytes once a row: with ``U`` the rows' union frontier and ``A_U``
its out-arcs, ``8 |U| + 8 |A_U|`` (4 for bfs) for row_ptr and the arcs,
plus ``4 |F_b| + 4 |A_b| + 8 |C_b|`` for each row.  For one row this is
the single-source count above.

PageRank round (pull, over every vertex and arc of a graph with ``V``
vertices and ``E`` arcs)::

    4 (V + 1)   row_ptr
    8 E         the neighbour id and the neighbour's contribution
    12 V        the vertex's rank and inverse out-degree read, its new
                rank written
"""
from __future__ import annotations


def min_round_bytes(rec: dict, weighted: bool = True) -> int:
    """Bytes of one min-combine round, from a ``ref.sssp`` round record."""
    arc = 8 if weighted else 4
    shared = 8 * rec["f_union"] + arc * rec["a_union"]
    return shared + sum(4 * f + 4 * a + 8 * c
                        for f, a, c in zip(rec["f"], rec["a"], rec["c"]))


def min_query_bytes(rounds: list, weighted: bool = True) -> int:
    """Bytes of a whole min-combine query: the sum over its rounds."""
    return sum(min_round_bytes(rec, weighted) for rec in rounds)


def pagerank_round_bytes(num_vertices: int, num_arcs: int) -> int:
    """Bytes of one pull PageRank round over the whole graph."""
    return 4 * (num_vertices + 1) + 8 * num_arcs + 12 * num_vertices
