"""``host_gap_ms`` (layer: driver loop): per profiled query, the host
latency less the device span (first to last device activity inside the
query's host range, from the trace), mean over those queries: what the
driver adds around the device's work."""


def read(run):
    gaps = [q.latency_s - q.span_s for q in run.profiled
            if q.span_s is not None]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
