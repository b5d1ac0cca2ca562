"""The control: the reference put in the program's place, in a lower
precision, run through the rest of a benchmark run.  Its answers must
come out not correct, or the comparison in ``check.py`` has no teeth.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 2]

The configurations state no floating precision: their guarantee is
exact int32 distances (and float32 ranks).  The control holds the labels
(ranks) in bfloat16, the 16-bit type that would halve the label traffic,
the largest share of the algorithm's bytes; it holds integers exactly
only up to 256.  (int16 and float16 hold every distance of these graphs
exactly, as ``PERF.md`` records, so they break no guarantee here.)
PageRank's control sums its neighbours in float32.

One process runs every seed, each with a window of ``--seconds`` at the
cell's own load; the benchmark's own runs never run it.  Prints one JSON
line a seed with the checks.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

LOWER = "bfloat16"


def entry(traffic: dict, csr, dtype=None):
    """``call(sources) -> (labels, rounds)`` answering with the reference
    held in ``dtype`` (default: :data:`LOWER`)."""
    import torch
    from portbench import check, program
    dtype = dtype or getattr(torch, LOWER)
    one = program.APPS[traffic["app"]][0] == "one"

    def call(sources):
        labels, records = check.reference(traffic, csr, sources, dtype)
        return (labels[0] if one else labels), len(records)
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = harness.run(args.workload, seed, args.seconds, False, "cuda",
                          time.perf_counter(), ROOT, entry=entry)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": LOWER, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
