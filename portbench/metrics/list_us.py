"""``list_us`` (layer: graph kernels): the ``list`` phase of a round (the
``twc_bin_list`` launch), mean per round over the profiled queries, from
the port's device stamps (``spans.py``)."""
from portbench import spans


def read(run):
    return spans.layer_us(run, ("list",))
