"""Replayable routing trace (DESIGN.md section 13).

Every executed routing decision — initial placements and hedge
launches alike — appends one :class:`TraceRow` holding the FULL
:class:`~repro_torch.serve.fleet.router.DecisionInputs` plus the decision
the live router took.  Because :func:`repro_torch.serve.fleet.router.decide`
is a pure function of those inputs, :func:`replay` can re-derive every
decision offline and compare it bitwise against the recorded output:
zero divergences is the fleet's determinism witness (the analog of
the engine's ``admission_log``), and any corruption of a row — or any
drift between the deployed ``decide`` and the one that produced the
trace — is reported with its sequence number.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .router import DecisionInputs, decide


@dataclasses.dataclass(frozen=True)
class TraceRow:
    """One executed routing decision: its pure inputs and the output
    the live router chose."""
    inputs: DecisionInputs
    choice: int                     # replica id the query went to
    reason: str                     # affinity | spill | p2c | hedge


@dataclasses.dataclass(frozen=True)
class Divergence:
    """One replay mismatch: the recorded decision vs what ``decide``
    derives from the recorded inputs."""
    seq: int
    recorded: Tuple[int, str]
    derived: Tuple[int, str]


class RoutingTrace:
    """Append-only log of executed routing decisions."""

    def __init__(self) -> None:
        self.rows: List[TraceRow] = []

    def append(self, inputs: DecisionInputs, choice: int,
               reason: str) -> None:
        """Record one executed decision (inputs + output)."""
        self.rows.append(TraceRow(inputs=inputs, choice=choice,
                                  reason=reason))

    def __len__(self) -> int:
        return len(self.rows)


def replay(rows: List[TraceRow]) -> List[Divergence]:
    """Re-derive every recorded decision from its recorded inputs and
    return the divergences (empty == the trace is exactly
    reproducible).  This is the offline half of the routing-replay
    gate: it never touches a fleet, only the pure ``decide``."""
    out: List[Divergence] = []
    for row in rows:
        derived = decide(row.inputs)
        if derived != (row.choice, row.reason):
            out.append(Divergence(seq=row.inputs.seq,
                                  recorded=(row.choice, row.reason),
                                  derived=derived))
    return out


def ceiling_violations(rows: List[TraceRow]) -> List[int]:
    """Sequence numbers of decisions whose chosen replica exceeded the
    bounded-load ceiling ``ceil(c * (total + 1) / n)`` AFTER admission
    — the structural half of the bounded-load gate (must be empty)."""
    from .router import load_ceiling
    bad = []
    for row in rows:
        ceil_ = load_ceiling(row.inputs.loads,
                             row.inputs.capacity_factor)
        if row.inputs.loads[row.choice] + 1 > ceil_:
            bad.append(row.inputs.seq)
    return bad
