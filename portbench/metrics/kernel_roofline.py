"""``kernel_roofline`` (layer: graph kernels): the algorithm's bytes of
the profiled queries (``work.py``, from the reference's rounds) at the
card's HBM bandwidth, over those queries' device spans, in percent.

The span (the query's device-side range in the trace) stands for the
kernels' time: the profiler sees only part of the kernels a fused
traversal's CUDA graph runs in its conditional nodes, so it cannot sum
them.  The span also holds the torch operations of the round and the
graph's own gaps, so this share is a lower bound of the kernels' own."""
from portbench import peaks


def read(run):
    bw = peaks.peak(run.device_name, "hbm_bytes_per_s")
    spans = [q.span_s for q in run.profiled]
    if not run.work_bytes or not bw or not spans or None in spans:
        return None
    return run.work_bytes / bw / sum(spans) * 100
