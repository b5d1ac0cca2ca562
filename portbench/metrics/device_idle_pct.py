"""``device_idle_pct`` (layer: device): the share of the traced window
in which no operation ran on the card (one less the union of its
activity in the profiler's trace), in percent."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
