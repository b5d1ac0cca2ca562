"""``driver_gap_ms`` (layer: driver loop): per profiled query, the
driver call's host span (``repro.<app>``) less its loop's device span
(the first and last stamp of the fused loop), on the one clock of the
port's spans (``spans.py``); mean over those queries, in ms."""
from portbench import spans


def read(run):
    recs = spans.profiled(run)
    if recs is None:
        return None
    gaps = []
    for rec in recs:
        top = rec.host_span(f"repro.{rec.app}")
        if top is None:
            return None
        gaps.append((top[2] - top[1]) - (rec.loop[1] - rec.loop[0]))
    return sum(gaps) / len(gaps) / 1e6
