"""Admission policy: which queries enter which slots each round.

The scheduler is pure policy — it sees per-slot occupancy views and
the pending depth, and returns a :class:`Decision`; the engine applies
it to device state.  Keeping it side-effect free makes admission
deterministic and directly testable (DESIGN.md section 8).

Two rules:

* **FIFO admission.**  Free slots are filled in ascending slot order
  from the front of the pending queue (lowest qid first).  Same
  submissions => same admission sequence, always.
* **Round-budget fairness.**  With ``round_budget=k``, a query that
  has held its slot for k consecutive rounds *while other queries
  wait* is preempted: its ``[V]`` labels/frontier rows are snapshotted
  to the host and it re-enters the FIFO at the back.  Restoring the
  snapshot on re-admission is exact, so preemption never perturbs
  results — it only reorders rounds — and a giant-diameter query can
  delay the queue by at most ``k`` rounds per visit instead of its
  whole eccentricity.  ``round_budget=None`` disables preemption
  (run-to-completion).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class SlotView:
    """What the scheduler may know about one slot: its index, the
    occupying query (None = idle), and how many consecutive rounds that
    query has held the slot since (re-)admission."""
    slot: int
    qid: Optional[int]
    slot_rounds: int


@dataclasses.dataclass(frozen=True)
class Decision:
    """One round's admission plan: ``preempt`` lists slots whose
    occupant yields to the queue; ``admit`` lists the slots to fill
    from the pending FIFO (both in the order the engine must apply
    them)."""
    preempt: tuple
    admit: tuple


class Scheduler:
    """Deterministic FIFO admission with optional round-budget
    preemption (see module docstring)."""

    def __init__(self, round_budget: Optional[int] = None) -> None:
        if round_budget is not None and round_budget < 1:
            raise ValueError("round_budget must be >= 1 (or None)")
        self.round_budget = round_budget

    def plan(self, slots: List[SlotView], pending: int) -> Decision:
        """Decide this round's preemptions and admissions.

        Preempt only what the queue actually needs: at most
        ``pending - idle`` over-budget slots (idle slots absorb queued
        work for free, and preempting more than ``pending`` would idle
        slots), longest-residency first (ties: lowest slot) so the
        query that has delayed the queue the longest yields first.
        Then admit into every free slot, ascending.
        """
        idle = [s.slot for s in slots if s.qid is None]
        preempt: list = []
        need = pending - len(idle)
        if self.round_budget is not None and need > 0:
            over = [s for s in slots if s.qid is not None
                    and s.slot_rounds >= self.round_budget]
            over.sort(key=lambda s: (-s.slot_rounds, s.slot))
            preempt = [s.slot for s in over[:need]]
        free = sorted(idle + preempt)
        n_admit = min(len(free), pending + len(preempt))
        return Decision(preempt=tuple(preempt),
                        admit=tuple(free[:n_admit]))
