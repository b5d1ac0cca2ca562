"""``relax_roofline`` (layer: graph kernels): the algorithm's bytes of
the profiled queries (``work.py``) at the card's HBM bandwidth, over the
summed ``list``, ``bin.*`` and ``lb`` phases of their rounds (the port's
device stamps, ``spans.py``), in percent: the kernels' own share, which
``kernel_roofline`` bounds from below over the whole device span."""
from portbench import peaks, spans


def read(run):
    bw = peaks.peak(run.device_name, "hbm_bytes_per_s")
    recs = spans.profiled(run)
    if not run.work_bytes or not bw or recs is None:
        return None
    rounds = sum(len(rec.rounds) for rec in recs)
    kernel_s = spans.per_round_ns(recs, spans.KERNELS) * rounds / 1e9
    return run.work_bytes / bw / kernel_s * 100 if kernel_s > 0 else None
