"""``round_us`` (layer: round and device control flow): the profiled
queries' device spans over their rounds (``AppResult.rounds``)."""


def read(run):
    qs = [q for q in run.profiled if q.span_s is not None]
    rounds = sum(q.rounds for q in qs)
    return sum(q.span_s for q in qs) / rounds * 1e6 if rounds else None
