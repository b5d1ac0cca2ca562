"""Per-line pragma suppressions: ``# repro: allow[<rule>] -- why``.

A pragma suppresses findings of the named rule(s) on its own line.
The justification after ``--`` is mandatory — a pragma without one is
itself a finding (rule ``bad-pragma``), as is a pragma naming a rule
that does not exist.  Multiple rules may be listed, comma-separated:

    n = int(torch.sum(f))  # repro: allow[host-sync] -- one-time seed

The grammar is deliberately rigid (no bare ``allow``, no free-form
prose before the bracket) so suppressions stay greppable.
"""
from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, Iterator, List, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*repro:\s*(?P<body>.*)$")
ALLOW_RE = re.compile(
    r"^allow\[(?P<rules>[^\]]*)\]\s*(?:--\s*(?P<why>.*))?$")


def _comments(source: str) -> Iterator[Tuple[int, str]]:
    """``(lineno, text)`` for every comment token.  Tokenizing (not
    line-scanning) means pragma-shaped text inside string literals and
    docstrings is ignored."""
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, SyntaxError):
        return  # unparseable tail: the linter reports parse-error


def parse_pragmas(
    source: str,
    known_rules: Set[str],
) -> Tuple[Dict[int, Set[str]], List[Tuple[int, str]]]:
    """Scan ``source`` for ``# repro:`` pragmas.

    Returns ``(allows, problems)`` where ``allows`` maps 1-based line
    numbers to the set of rule ids suppressed on that line and
    ``problems`` lists ``(line, message)`` pairs for malformed
    pragmas: unparseable body, empty rule list, unknown rule id, or a
    missing/empty justification.
    """
    allows: Dict[int, Set[str]] = {}
    problems: List[Tuple[int, str]] = []
    for lineno, text in _comments(source):
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        body = m.group("body").strip()
        am = ALLOW_RE.match(body)
        if not am:
            problems.append(
                (lineno,
                 "malformed pragma: expected "
                 "`# repro: allow[<rule>] -- <justification>`"))
            continue
        rules = [r.strip() for r in am.group("rules").split(",")
                 if r.strip()]
        if not rules:
            problems.append(
                (lineno, "pragma allows no rules: `allow[]`"))
            continue
        unknown = [r for r in rules if r not in known_rules]
        if unknown:
            problems.append(
                (lineno,
                 f"pragma names unknown rule(s): "
                 f"{', '.join(sorted(unknown))}"))
            continue
        why = (am.group("why") or "").strip()
        if not why:
            problems.append(
                (lineno,
                 "pragma is missing its mandatory justification "
                 "(`-- <why>`)"))
            continue
        allows.setdefault(lineno, set()).update(rules)
    return allows, problems
