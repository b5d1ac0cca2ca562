"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the port (``src/repro_torch``).  Needs as many CUDA
cards as the cell asks for; without them it prints no result and exits
with 2.  Prints the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``) as the last line of standard output,
one JSON object, and each number compared for ``correct`` beside its
limit as the last lines of standard error.  Exits with 3, printing no
result, if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program and of torch inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, imports
    t_import = time.perf_counter()
    _, cell, _, _ = harness.load_cell(args.workload, ROOT)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    harness.log(f"imports {t_import - T_START:.3f} s, CUDA driver "
                f"{time.perf_counter() - t_import:.3f} s")
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, ROOT)
    found = imports.forbidden(sys.modules)
    if found:
        print(f"portbench: the run loaded {sorted(found)}: the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
