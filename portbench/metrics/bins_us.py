"""``bins_us`` (layer: graph kernels): the ``bin.small``, ``bin.medium``
and ``bin.large`` phases of a round (each bin's ``twc_bin_relax``
launch), summed, mean per round over the profiled queries, from the
port's device stamps (``spans.py``)."""
from portbench import spans


def read(run):
    return spans.layer_us(run, ("bin.",))
