"""``query_ms_p95``: the 95th percentile of every query's latency in the
window, host clock, from the driver call to its return once the labels
are synchronised (linear interpolation between order statistics)."""
import statistics


def read(run):
    lat = [q.latency_s * 1e3 for q in run.queries]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
