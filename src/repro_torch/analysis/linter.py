"""Lint driver: parse files once, run every rule, apply pragmas.

:func:`analyze_source` is the unit tests' entry point (lint a string
under an arbitrary virtual path); :func:`analyze_paths` is the CLI's
(walk files/directories, share one :class:`Session` so cross-file
lookups like the scatter combine registry are parsed once).
"""
from __future__ import annotations

import ast
import os
from functools import cached_property
from typing import Dict, Iterable, List, Optional, Sequence

from . import astutil
from .findings import Finding
from .pragmas import parse_pragmas
from .registry import Rule, get_rules, rule_ids


class Session:
    """Per-run shared state (cross-file caches for rules)."""

    def __init__(self) -> None:
        self.memo: Dict = {}


class FileContext:
    """One parsed source file handed to every rule's ``check``."""

    def __init__(self, path: str, source: str, tree: ast.AST,
                 session: Session) -> None:
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.tree = tree
        self.session = session

    @cached_property
    def pragma_info(self):
        """``(allows, problems)`` from :func:`parse_pragmas`."""
        return parse_pragmas(self.source, set(rule_ids()))

    @cached_property
    def scopes(self) -> astutil.Scopes:
        """Lexical lookups (enclosing functions, defs by name)."""
        return astutil.Scopes(self.tree)

    @cached_property
    def capture_bindings(self):
        """Functions handed to ``graph_loop.run`` / ``while_`` /
        ``cond`` in this module."""
        return astutil.collect_capture_bindings(self.tree, self.scopes)

    def in_dir(self, *parts: str) -> bool:
        """Whether the file lives under ``.../parts[0]/parts[1]/...``
        anywhere in its path (e.g. ``ctx.in_dir("repro_torch", "serve")``)."""
        needle = "/" + "/".join(parts) + "/"
        return needle in "/" + self.path

    def finding(self, node, rule: str, message: str) -> Finding:
        """Build a :class:`Finding` at ``node`` (or an int line)."""
        line = node if isinstance(node, int) else node.lineno
        return Finding(path=self.path, line=line, rule=rule,
                       message=message)


def analyze_source(
    source: str,
    path: str,
    rules: Optional[Sequence[Rule]] = None,
    session: Optional[Session] = None,
    relaxed: bool = False,
) -> List[Finding]:
    """Lint one source string as if it lived at ``path``.

    Runs the selected rules, then applies per-line pragma
    suppressions.  Syntax errors produce a single ``parse-error``
    finding rather than raising.
    """
    if rules is None:
        rules = get_rules(relaxed=relaxed)
    if session is None:
        session = Session()
    norm = path.replace(os.sep, "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(path=norm, line=e.lineno or 1,
                        rule="parse-error",
                        message=f"cannot parse file: {e.msg}")]
    ctx = FileContext(norm, source, tree, session)
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    allows, _problems = ctx.pragma_info
    findings = [f for f in findings
                if f.rule not in allows.get(f.line, ())]
    return sorted(findings)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``.py`` files.

    Raises ``FileNotFoundError`` for a path that does not exist (a
    misspelled CLI argument must not silently lint nothing).
    """
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in {"__pycache__", ".git"})
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        else:
            raise FileNotFoundError(p)
    return sorted(dict.fromkeys(out))


def analyze_paths(
    paths: Iterable[str],
    rules: Optional[Sequence[Rule]] = None,
    relaxed: bool = False,
) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` with one shared
    :class:`Session`; returns all findings, sorted."""
    session = Session()
    findings: List[Finding] = []
    for fp in iter_python_files(paths):
        with open(fp, "r", encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(fp) if not os.path.isabs(fp) else fp
        findings.extend(analyze_source(
            source, rel, rules=rules, session=session,
            relaxed=relaxed))
    return sorted(findings)
