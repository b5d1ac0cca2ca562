"""``lb_us`` (layer: graph kernels): the ``lb`` phase of a round (the
``edge_lb_relax`` or ``merge_path_relax`` launch), mean per round over
the profiled queries, from the port's device stamps (``spans.py``)."""
from portbench import spans


def read(run):
    return spans.layer_us(run, ("lb",))
