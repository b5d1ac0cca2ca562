"""CLI for the port's invariant linter.

  PYTHONPATH=src python -m repro_torch.analysis --check src/repro_torch
  PYTHONPATH=src python -m repro_torch.analysis --check --relaxed tests/
  PYTHONPATH=src python -m repro_torch.analysis --list-rules
  PYTHONPATH=src python -m repro_torch.analysis --write-baseline src/

Exit codes: 0 clean, 1 findings (or baseline hygiene violations),
2 usage error (bad flag or nonexistent path).  Findings print one
per line as ``file:line rule-id message``.

Suppressions, in order of preference:

* fix the code;
* a per-line pragma with a mandatory justification:
  ``# repro: allow[<rule>] -- <why this site is intentional>``;
* a baseline entry in ``baseline.txt`` beside this module
  (grandfathered legacy findings only — never allowed for
  src/repro_torch/core or src/repro_torch/serve, which this tool exists
  to protect).
"""
from __future__ import annotations

import argparse
import os
import sys

from .baseline import (apply_baseline, load_baseline,
                       protected_violations, render_baseline)
from .linter import analyze_paths
from .registry import get_rules

#: the committed baseline, inside the package (it holds only its header)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.txt")


def _rule_table() -> str:
    lines = ["rules:"]
    for r in get_rules():
        star = " (relaxed profile)" if r.relaxed else ""
        lines.append(f"  {r.id:<20} {r.description}{star}")
    lines.append("")
    lines.append("relaxed profile (--relaxed, for tests/): only the "
                 "rules marked above run")
    return "\n".join(lines)


def main(argv=None) -> int:
    """Parse arguments, lint, report; returns the exit code."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__,
        epilog=_rule_table(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint")
    ap.add_argument("--check", action="store_true",
                    help="lint and exit 1 on findings (the default "
                         "action; spelled out for CI clarity)")
    ap.add_argument("--relaxed", action="store_true",
                    help="run only the relaxed-profile rules "
                         "(for tests/)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of grandfathered findings "
                         "(default: baseline.txt in this package; "
                         "missing file = empty baseline)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline "
                         "file and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_rule_table())
        return 0
    if not args.paths:
        ap.print_usage(sys.stderr)
        print("error: no paths given (try `--check src/repro_torch`)",
              file=sys.stderr)
        return 2

    try:
        findings = analyze_paths(args.paths, relaxed=args.relaxed)
    except FileNotFoundError as e:
        print(f"error: no such file or directory: {e.args[0]}",
              file=sys.stderr)
        return 2

    if args.write_baseline:
        text = render_baseline(findings)
        with open(args.baseline, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.baseline} ({len(findings)} entries)")
        return 0

    baseline = (load_baseline(args.baseline)
                if not args.no_baseline else {})
    bad_entries = protected_violations(baseline)
    kept, matched, stale = apply_baseline(findings, baseline)

    for f in kept:
        print(f.format())
    for entry in bad_entries:
        print(f"baseline error: protected path may not be "
              f"grandfathered: {entry}", file=sys.stderr)
    if stale:
        print(f"note: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} matched nothing "
              f"(refresh with --write-baseline)", file=sys.stderr)

    n_rules = len(get_rules(relaxed=args.relaxed))
    if kept or bad_entries:
        print(f"{len(kept)} finding(s) ({matched} baselined) across "
              f"{n_rules} rule(s)", file=sys.stderr)
        return 1
    print(f"OK: 0 findings ({matched} baselined) across "
          f"{n_rules} rule(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
