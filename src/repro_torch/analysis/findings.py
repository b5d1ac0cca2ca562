"""The ``Finding`` record every lint rule emits.

A finding is one violation at one source line.  Findings render as
``file:line rule-id message`` (the format CI greps and editors jump
to) and carry a line-number-free :attr:`Finding.baseline_key` so the
committed baseline file survives unrelated edits that shift code
around.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location."""

    path: str
    """File the finding is in (repo-relative, ``/``-separated)."""

    line: int
    """1-based line number of the violating expression."""

    rule: str
    """Id of the rule that fired (e.g. ``host-sync``)."""

    message: str
    """Human-readable description of the violation."""

    def format(self) -> str:
        """Render as ``file:line rule-id message`` (the CLI format)."""
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    @property
    def baseline_key(self) -> tuple:
        """Line-number-free identity used by the baseline file.

        Keyed on (path, rule, message) so grandfathered findings stay
        matched when unrelated edits move them to a different line.
        """
        return (self.path, self.rule, self.message)
