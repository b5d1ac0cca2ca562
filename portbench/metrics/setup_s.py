"""``setup_s``: process start to the first timed dispatch: imports, the
port's kernel libraries (built on a checkout's first run), the graph
made on the card, component counts, sources, the capture and warm-up of
the cell's shape.  Host clock."""


def read(run):
    return run.setup_s
