"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: each checked in a fresh
interpreter, top-level module names compared whole."""
import json

from conftest import tiny_copy
from portbench import imports


def test_names_compare_whole():
    assert imports.forbidden(["repro_torch.core.graph", "reprox"]) == set()
    assert imports.forbidden(["repro.core", "jax.numpy", "flax"]) == {
        "repro", "jax", "flax"}


def test_a_whole_run_loads_no_jax(tmp_path):
    root = tiny_copy(tmp_path)
    names = imports.loaded(
        "from pathlib import Path\n"
        "from portbench import harness, run, control, imports\n"
        f"for w in ('kron26-sssp', 'kron26-sssp-b8', 'kron26-pr'):\n"
        f"    harness.run(w, 5, 0.2, True, 'cpu', 0.0, Path({str(root)!r}))\n")
    assert imports.PORT in names           # the port did run
    assert imports.forbidden(names) == set()


def test_the_reference_loads_nothing_of_the_program():
    names = imports.loaded(
        "import torch\n"
        "from portbench import ref, work\n"
        "rp = torch.tensor([0, 1, 2], dtype=torch.int32)\n"
        "ci = torch.tensor([1, 0], dtype=torch.int32)\n"
        "ref.sssp(rp, ci, ci + 1, [0]); ref.pagerank(rp, ci, .85, 1e-4, 5)\n"
        "ref.component_edges(rp, ref.components(rp, ci))\n")
    assert "torch" in names
    assert imports.PORT not in names
    assert imports.forbidden(names) == set()


def test_run_checks_its_own_process(monkeypatch, tmp_path, capsys):
    """``run.py`` refuses to print a result once a forbidden module is
    loaded, whatever loaded it."""
    import sys
    import types
    from portbench import harness, run
    monkeypatch.setattr(run, "ROOT", tiny_copy(tmp_path))
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)

    def fake_run(workload, seed, seconds, traced, device, t0, root):
        sys.modules["jax"] = types.ModuleType("jax")
        return {"correct": True, "checks": {}}
    monkeypatch.setattr(harness, "run", fake_run)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert run.main(["--workload", "kron26-sssp", "--seed", "1",
                     "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    json.dumps(out.err)
