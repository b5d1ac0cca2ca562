"""``bad-pragma``: suppression pragmas must be well-formed.

A ``# repro:`` comment that fails to parse, names a rule that does
not exist, or omits the mandatory ``-- justification`` is a finding
in its own right — otherwise a typo'd pragma silently suppresses
nothing (or the author believes it suppresses something).
"""
from __future__ import annotations

from typing import List

from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "bad-pragma"


def check(ctx) -> List[Finding]:
    """Emit a finding for each malformed pragma in the file."""
    _allows, problems = ctx.pragma_info
    return [ctx.finding(line, RULE_ID, message)
            for line, message in problems]


register_rule(Rule(
    id=RULE_ID,
    description="`# repro:` pragmas must parse, name real rules, and "
                "carry a justification",
    check=check,
    relaxed=True,
))
