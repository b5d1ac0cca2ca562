"""Committed baseline of grandfathered findings.

The baseline file (``baseline.txt`` in this package) lists
pre-existing findings that are tolerated until someone fixes them.
Entries are tab-separated ``path<TAB>rule<TAB>message`` — no line
numbers, so unrelated edits that shift code do not churn the file.
Duplicate lines grandfather that many occurrences.

Two hygiene properties are enforced at load/apply time:

* ``src/repro_torch/core`` and ``src/repro_torch/serve`` may never be
  baselined — the engine and the serving layer carry the invariants
  this linter exists to protect, so violations there are fixed or
  pragma'd with a justification, never grandfathered.
* Stale entries (no longer matching any finding) are reported so the
  baseline only ever shrinks; refresh with ``--write-baseline``.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Tuple

from .findings import Finding

# "src/repro_torch/core" subsumes every file under core/ (wire.py
# included); "src/repro_torch/serve" likewise covers serve/fleet.
PROTECTED_PREFIXES = ("src/repro_torch/core", "src/repro_torch/serve")


def load_baseline(path) -> Counter:
    """Parse a baseline file into a ``Counter`` of baseline keys.

    Missing file -> empty baseline.  Blank lines and ``#`` comments
    are skipped; anything else must be the three tab-separated
    fields.
    """
    counts: Counter = Counter()
    try:
        text = open(path, "r", encoding="utf-8").read()
    except FileNotFoundError:
        return counts
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) != 3:
            raise ValueError(
                f"{path}:{lineno}: malformed baseline entry "
                f"(want path<TAB>rule<TAB>message): {line!r}")
        counts[tuple(parts)] += 1
    return counts


def protected_violations(baseline: Counter) -> List[str]:
    """Baseline entries that illegally grandfather protected paths."""
    bad = []
    for (path, rule, message), n in sorted(baseline.items()):
        norm = path.replace("\\", "/").lstrip("./")
        if any(norm.startswith(p) for p in PROTECTED_PREFIXES):
            bad.append(f"{path}\t{rule}\t{message}")
    return bad


def apply_baseline(
    findings: Iterable[Finding],
    baseline: Counter,
) -> Tuple[List[Finding], int, List[tuple]]:
    """Filter ``findings`` through the baseline.

    Returns ``(kept, matched, stale)``: findings not covered by the
    baseline, how many were grandfathered, and baseline keys that
    matched nothing (candidates for deletion).
    """
    remaining = Counter(baseline)
    kept: List[Finding] = []
    matched = 0
    for f in findings:
        if remaining.get(f.baseline_key, 0) > 0:
            remaining[f.baseline_key] -= 1
            matched += 1
        else:
            kept.append(f)
    stale = sorted(k for k, n in remaining.items() if n > 0)
    return kept, matched, stale


def render_baseline(findings: Iterable[Finding]) -> str:
    """Serialize ``findings`` as baseline file text."""
    lines = [
        "# repro_torch.analysis baseline — grandfathered findings.",
        "# path<TAB>rule<TAB>message; regenerate with",
        "#   PYTHONPATH=src python -m repro_torch.analysis "
        "--write-baseline <paths>",
        "# src/repro_torch/core and src/repro_torch/serve may not appear "
        "here.",
    ]
    for key in sorted(f.baseline_key for f in findings):
        lines.append("\t".join(key))
    return "\n".join(lines) + "\n"
