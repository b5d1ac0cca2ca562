"""Rule registry: id -> ``Rule`` with a check callable.

Rules self-register at import time via :func:`register_rule` (the
``repro_torch.analysis.rules`` package imports every rule module).  Each
rule declares whether it participates in the *relaxed* profile used
for ``tests/`` — test code legitimately syncs results to the host and
stores writable arrays, so only structural rules (capture keys,
capture purity, pragma hygiene) run there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

# checked by ``__init__.analyze_source``; declared here so rule
# modules and the CLI share one source of truth
RELAXED_PROFILE_DOC = (
    "relaxed profile (tests/): only rules marked `relaxed` run")


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered lint pass."""

    id: str
    """Stable identifier used in findings, pragmas and the baseline."""

    description: str
    """One-line summary shown by ``--help`` / ``--list-rules``."""

    check: Callable
    """``check(ctx: FileContext) -> list[Finding]``."""

    relaxed: bool = False
    """Whether the rule also runs under the relaxed (tests/) profile."""


_RULES: Dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    """Add ``rule`` to the registry (idempotent per id)."""
    existing = _RULES.get(rule.id)
    if existing is not None and existing is not rule:
        raise ValueError(f"duplicate rule id: {rule.id!r}")
    _RULES[rule.id] = rule
    return rule


def all_rules() -> List[Rule]:
    """Every registered rule, sorted by id."""
    _ensure_loaded()
    return [_RULES[k] for k in sorted(_RULES)]


def get_rules(relaxed: bool = False) -> List[Rule]:
    """Rules for a profile: all of them, or only the relaxed subset."""
    rules = all_rules()
    if relaxed:
        rules = [r for r in rules if r.relaxed]
    return rules


def rule_ids() -> List[str]:
    """Sorted ids of every registered rule."""
    return [r.id for r in all_rules()]


def _ensure_loaded() -> None:
    # rule modules register on import; tolerate being imported first
    from . import rules  # noqa: F401
