"""The port's own spans of the profiled queries: the traversal records
that ``repro_torch.core.spans`` keeps in memory for each driver call made
while a profiler records (its host spans, its loop and each round's
phases as the card stamped them, all on the profiler's host clock).

:func:`spans` returns them, empty for a program that keeps none.  The
readers of the per-layer metrics built on them take :func:`profiled`:
the records of ``run.profiled``, in order, or None where they are not
all there (a program without spans, a query whose record lost rounds).
Times in the records are nanoseconds.
"""
from __future__ import annotations


def spans() -> list:
    """The port's records of the traversals traced in this process,
    oldest first; empty if none were, or the port keeps no spans."""
    try:
        from repro_torch.core import spans as port
    except ImportError:
        return []
    return port.records()


def profiled(run):
    """The records of ``run``'s profiled queries, in order (the last as
    many traced in this process, each with its query's rounds, all of
    them stamped), or None."""
    queries = run.profiled
    recs = spans()[-len(queries):] if queries else []
    if not queries or len(recs) != len(queries):
        return None
    for rec, q in zip(recs, queries):
        if rec.total_rounds != q.rounds or rec.overflow or \
                len(rec.rounds) != q.rounds or rec.loop is None:
            return None
    return recs


def per_round_ns(recs, prefixes) -> float:
    """Mean over the records' rounds of the summed time of the phases
    whose names start with one of ``prefixes``."""
    rounds = [r for rec in recs for r in rec.rounds]
    total = sum(b - a for r in rounds for name, (a, b) in r.phases.items()
                if name.startswith(tuple(prefixes)))
    return total / len(rounds)


#: the phases of the graph kernels (the listing, each bin, the LB pass)
KERNELS = ("list", "bin.", "lb")
#: the round's own control: the inspector and the loop's turn
CONTROL = ("inspect", "turn")


def layer_us(run, prefixes):
    """:func:`per_round_ns` of ``run``'s profiled queries in
    microseconds, or None."""
    recs = profiled(run)
    if recs is None or not any(rec.rounds for rec in recs):
        return None
    return per_round_ns(recs, prefixes) / 1e3
