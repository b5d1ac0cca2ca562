"""The whole run on the card at scale 10: the fused path, the trace and
the per-layer readers (skipped without a CUDA card).  On the card:
``python -m pytest -q -m gpu portbench/tests``."""
import json

import pytest
import torch

from portbench import harness

CELLS = ["kron26-sssp", "urand26-sssp", "kron26-sssp-b8", "kron26-pr"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_on_the_card(tiny_root, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(workload, 2**31 + 3, 1.0, True, "cuda", 0.0,
                      tiny_root)
    assert out["correct"]
    assert out["device"]["busy_s"] > 0
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_for(spec, workload, True)}
