"""The benchmark of the port ``repro_torch``: GAP graph traversals on the
card, driven by data (``BENCHMARK.json``, ``configs/``, ``traffic/``,
``metrics/``).  ``run.py`` is the command; ``PERF.md`` at the root of
the repository says what each cell and metric is for."""
