"""Shared set-up of the benchmark's CPU tests: the checkout's ``src`` and
root on the path, and a copy of ``BENCHMARK.json`` whose configurations
are cut to scale 10, so a whole run fits on the CPU in seconds."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_SCALE = 10


#: the pagerank mix's cell, kept for a later benchmark PR (PERF.md §7):
#: its path is tested here though no cell of BENCHMARK.json runs it yet
PAGERANK_CELL = {"name": "kron26-pr", "config": "gap-kron-s26",
                 "traffic": "pagerank", "chips": 1,
                 "why": "pull pagerank, GAP's 20 rounds a query"}


def tiny_copy(dest: Path) -> Path:
    """``dest`` made a root holding ``BENCHMARK.json`` with every
    configuration at :data:`TINY_SCALE`; the cells, mixes and metrics
    are the real ones, with :data:`PAGERANK_CELL` added."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if all(w["name"] != PAGERANK_CELL["name"] for w in spec["workloads"]):
        spec["workloads"].append(dict(PAGERANK_CELL))
    for conf in spec["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        cfg["scale"] = TINY_SCALE
        path = dest / conf["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
