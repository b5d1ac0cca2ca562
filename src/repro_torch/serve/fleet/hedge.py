"""SLO-conditional hedging of stragglers (DESIGN.md section 13).

Every served result is deterministic and bitwise-reproducible (the
engine's parity invariant), so a hedge is FREE to race its primary:
whichever finisher lands first is published and the other is
cancelled — the answers could not have differed.  What hedging must
still control is overhead, so it is conditional three ways:

* **SLO-conditional** — a query becomes hedgeable only after
  ``hedge_after`` fleet steps in system (the threshold the feedback
  controller lowers under p95 pressure and restores when calm);
* **bounded per query** — at most ``max_hedges`` hedge copies;
* **capacity-conditional** — a hedge launches only if its target
  would stay under the bounded-load ceiling, so hedge traffic can
  never stampede an already-loaded fleet (and every EXECUTED
  assignment, hedge or not, respects the ceiling — the structural
  gate ``trace.ceiling_violations`` checks).

The cancel-on-first-finish half lives in the fleet engine: the winner
is published through the ``publish.freeze`` choke point exactly once,
the loser is cancelled via :meth:`QueryService.cancel` (or, if it
finished in the same step, simply dropped — never double-published).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Static hedging knobs (``hedge_after`` itself is adaptive and
    lives on the router's feedback controller)."""
    enabled: bool = True
    max_hedges: int = 1             # hedge copies per query, ever


def hedgeable(rec, step: int, hedge_after: int,
              policy: HedgePolicy) -> bool:
    """Whether a fleet query record is eligible for (another) hedge at
    ``step``: hedging on, still in flight, over the SLO age threshold,
    under its per-query hedge budget, and with at least one replica
    not already holding it."""
    return (policy.enabled
            and rec.status == "running"
            and step - rec.submit_step >= hedge_after
            and rec.hedges < policy.max_hedges)
