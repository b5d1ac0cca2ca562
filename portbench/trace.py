"""Reading a ``torch.profiler`` trace of the traced queries.

:func:`collect` turns a finished profile into plain intervals (device
activity, host operations, the benchmark's own ``portbench.query``
ranges on the host and on the device); :func:`summarize` reduces them,
with no profiler in sight, to what the per-layer readers and the result
line take: the traced window, the device's busy time, each query's
device span, the device operations that took most time and the idle
gaps by what the host was doing meanwhile.  Times are in seconds.

The profiler sees only part of the kernels that a fused traversal's
CUDA graph runs inside its conditional (WHILE / IF) nodes.  It does
record, on the device, each ``portbench.query`` range from the first
to the last device operation the query issued: that is the query's
device span, and it counts as busy time, the fused launch being one
operation on the device whose inner gaps the trace cannot show.
"""
from __future__ import annotations

import dataclasses

QUERY = "portbench.query"
#: the device ranges' entry among the device operations
SPAN = "portbench.query device spans (kernels the trace misses included)"
TOP = 10
NAME = 120          # characters of an operation's name kept


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    spans_s: list          # per query, None where it shows no activity
    device_ops: list       # [[name, seconds], ...], most time first
    idle_gaps: list        # [[host op, seconds], ...], most time first


def collect(prof):
    """``(device, host, queries, ranges)`` intervals in microseconds from
    a finished profile: device operations ``(name, start, end)``, host
    operations ``(name, start, end)``, the host's ``portbench.query``
    ranges and their device-side ranges ``(start, end)``."""
    from torch.autograd import DeviceType
    device, host, queries, ranges = [], [], [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        on_device = e.device_type == DeviceType.CUDA
        if e.name == QUERY:
            (ranges if on_device else queries).append((t0, t1))
        elif on_device:
            device.append((e.name, t0, t1))
        else:
            host.append((e.name, t0, t1))
    return device, host, sorted(queries), sorted(ranges)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_at(host, a, b):
    """The host operation that overlaps ``(a, b)`` most (the innermost
    of equals), or ``"host: no operation"``."""
    best, best_key = "host: no operation", None
    for name, h0, h1 in host:
        if h0 >= b:
            break
        ov = min(b, h1) - max(a, h0)
        if ov <= 0:
            continue
        key = (ov, -(h1 - h0))
        if best_key is None or key > best_key:
            best, best_key = name, key
    return best


def summarize(device, host, queries, ranges=()) -> Trace:
    """Reduce :func:`collect`'s intervals (microseconds) to a
    :class:`Trace` over the window from the first query's start to the
    last one's end.  A query's span is its device-side range where the
    trace has one, else its first to last device operation; busy time is
    the union of the device operations and the ranges."""
    if not queries:
        raise ValueError("the trace holds no portbench.query range")
    w0, w1 = queries[0][0], queries[-1][1]

    def clip(ivs):
        return [(max(a, w0), min(b, w1)) for a, b in ivs
                if b > w0 and a < w1]

    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    ranges = clip(ranges)
    busy = _union([(a, b) for _, a, b in inside] + ranges)
    by_name: dict = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    if ranges:
        by_name[SPAN] = sum(b - a for a, b in _union(ranges))
    spans = []
    for q0, q1 in queries:
        own = [(a, b) for a, b in ranges if q0 <= a < q1]
        ev = own or [(a, b) for _, a, b in inside if q0 <= a < q1]
        spans.append((max(b for _, b in ev) - min(a for a, _ in ev)) / 1e6
                     if ev else None)
    host = sorted((h for h in host if h[2] > w0 and h[1] < w1),
                  key=lambda h: h[1])
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            name = _host_at(host, a, b)
            gaps[name] = gaps.get(name, 0.0) + (b - a)

    def top(d):
        return [[n[:NAME], t / 1e6] for n, t in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Trace(window_s=(w1 - w0) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 spans_s=spans, device_ops=top(by_name),
                 idle_gaps=top(gaps))
