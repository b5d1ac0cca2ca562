"""``control_us`` (layer: round and device control flow): the
``inspect`` phase (the union frontier, ``n_f``, ``m_f``, the direction
rule, the round's labels copy) plus the ``turn`` phase (the frontier
update, the loop condition, the WHILE turn) of a round, mean per round
over the profiled queries, from the port's device stamps
(``spans.py``)."""
from portbench import spans


def read(run):
    return spans.layer_us(run, spans.CONTROL)
