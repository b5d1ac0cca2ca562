"""Pure routing policy of the serving fleet (DESIGN.md section 13).

Every routing decision is a PURE function of a
:class:`DecisionInputs` record — loads, tail-risk scores, rendezvous
ranks, the sampled power-of-two pair — so any decision can be
re-derived offline from a recorded trace
(:mod:`repro_torch.serve.fleet.trace`) and compared bitwise against
the live run.  Three rules compose:

* **Cache-affinity (rendezvous hashing).**  Each key
  ``(graph_id, app, source)`` owns a deterministic preference order
  over replicas — highest-random-weight (HRW) hashing via blake2b, so
  the order is stable across processes and immune to
  ``PYTHONHASHSEED``.  Removing a replica remaps only the keys it
  owned; adding one steals ~1/N of the keyspace.  Routing repeats of
  a key to its affinity replica is what makes the per-replica LRU
  result caches effective.
* **Bounded-load redirection.**  The affinity replica is used only
  while its assigned load stays under the ceiling
  ``ceil(c * (total_load + 1) / n)`` (classic bounded-load consistent
  hashing); past it the query spills to the power-of-two choice, and
  if that too is over the ceiling, to the globally least-loaded
  replica — which is provably under the ceiling, so no executed
  assignment ever exceeds it.
* **Power-of-two-choices admission.**  Two distinct replicas are
  sampled (by the fleet's seeded generator — the PAIR is an input,
  not the randomness) and the lower tail-risk score wins; ties break
  to the lower replica id.  The score is
  ``load + w_tail * rounds_remaining + w_age * queue_head_age``
  (the ALPHA1 composite: queue depth, EWMA'd work left, head-of-line
  age), with the weights nudged by :class:`FeedbackController`
  against a p95 rounds-in-system target.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence, Tuple

_HASH_BYTES = 8


def _hrw_weight(key_repr: str, replica: int) -> int:
    """Deterministic 64-bit HRW weight of (key, replica)."""
    h = hashlib.blake2b(f"{key_repr}|{replica}".encode(),
                        digest_size=_HASH_BYTES)
    return int.from_bytes(h.digest(), "big")


def rendezvous_order(key: tuple, num_replicas: int) -> Tuple[int, ...]:
    """Replica ids sorted best-affinity-first for ``key`` (highest
    blake2b HRW weight wins; ties — astronomically unlikely — break to
    the lower id).  ``order[0]`` is the key's affinity replica."""
    key_repr = repr(tuple(key))
    return tuple(sorted(range(num_replicas),
                        key=lambda r: (-_hrw_weight(key_repr, r), r)))


def load_ceiling(loads: Sequence[int], capacity_factor: float) -> int:
    """Bounded-load ceiling after admitting one more query:
    ``ceil(c * (total + 1) / n)``.  With ``c >= 1`` at least one
    replica (the least loaded) is always strictly under it."""
    total = sum(loads)
    return int(math.ceil(capacity_factor * (total + 1) / len(loads)))


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Static routing policy knobs (the adaptive weights start from
    these and are clamped around them)."""
    capacity_factor: float = 1.25   # c of the bounded-load ceiling
    affinity: bool = True           # False => pure P2C (the ablation
    #                                 pairing the hit-rate gate runs)
    w_tail: float = 1.0             # weight on rounds_remaining
    w_age: float = 0.5              # weight on queue_head_age
    p95_target: float = 50.0        # rounds-in-system SLO the
    #                                 feedback controller steers to
    hedge_after: int = 12           # fleet steps in system before a
    #                                 query becomes hedgeable
    min_hedge_after: int = 2        # controller floor for hedge_after
    max_weight_gain: float = 8.0    # controller clamp: weights stay in
    #                                 [initial, initial * gain]


@dataclasses.dataclass(frozen=True)
class DecisionInputs:
    """Everything a routing decision is a function of — recorded
    verbatim into the trace, so replay is exact by construction."""
    seq: int                        # trace sequence number
    fqid: int                       # fleet query id
    kind: str                       # "route" | "hedge"
    key: tuple                      # (graph_id, app, source)
    loads: Tuple[int, ...]          # assigned load per replica
    scores: Tuple[float, ...]       # tail-risk score per replica
    order: Tuple[int, ...]          # rendezvous order, best first
    pair: Tuple[int, ...]           # sampled P2C candidates (1 or 2)
    capacity_factor: float
    affinity: bool
    exclude: Tuple[int, ...] = ()   # replicas already holding the
    #                                 query (hedges never re-land on
    #                                 their origin)


def decide(inp: DecisionInputs) -> Tuple[int, str]:
    """The routing decision: ``(replica_id, reason)`` with reason in
    ``{"affinity", "spill", "p2c", "hedge"}``.  Pure and total over
    its inputs — the trace replayer calls exactly this function."""
    n = len(inp.loads)
    ceiling = load_ceiling(inp.loads, inp.capacity_factor)
    allowed = [r for r in range(n) if r not in inp.exclude]
    if inp.kind == "hedge":
        reason = "hedge"
    elif inp.affinity:
        aff = inp.order[0]
        if inp.loads[aff] + 1 <= ceiling:
            return aff, "affinity"
        reason = "spill"
    else:
        reason = "p2c"
    cand: Optional[int] = min(
        (r for r in inp.pair if r in allowed),
        key=lambda r: (inp.scores[r], r), default=None)
    if cand is None or inp.loads[cand] + 1 > ceiling:
        # bounded-load fallback: the least-loaded allowed replica is
        # at most the mean, hence strictly under the ceiling (always
        # true when nothing is excluded; hedges re-check the ceiling
        # before launching)
        cand = min(allowed, key=lambda r: (inp.loads[r], r))
    return cand, reason


class FeedbackController:
    """Nudges the live router weights against the p95 rounds-in-system
    target (DESIGN.md section 13).

    Above target: the score leans harder on the tail terms (spread
    away from backed-up replicas) and queries become hedgeable
    earlier.  Well below target (< half): decay back toward the
    configured defaults so the fleet does not stay over-corrected.
    Weights are clamped to ``[initial, initial * max_weight_gain]``
    and ``hedge_after`` to ``[min_hedge_after, initial]``, so the
    controller can never run away.
    """

    def __init__(self, cfg: RouterConfig) -> None:
        self.cfg = cfg
        self.w_tail = cfg.w_tail
        self.w_age = cfg.w_age
        self.hedge_after = cfg.hedge_after

    def update(self, p95: float) -> None:
        """One feedback step against the observed fleet-wide p95
        rounds-in-system (0.0 — the empty-window sentinel — reads as
        'no pressure')."""
        cfg = self.cfg
        if p95 > cfg.p95_target:
            self.w_tail = min(self.w_tail * 1.25,
                              cfg.w_tail * cfg.max_weight_gain)
            self.w_age = min(self.w_age * 1.25,
                             cfg.w_age * cfg.max_weight_gain)
            self.hedge_after = max(cfg.min_hedge_after,
                                   self.hedge_after - 1)
        elif p95 < 0.5 * cfg.p95_target:
            self.w_tail = max(self.w_tail * 0.9, cfg.w_tail)
            self.w_age = max(self.w_age * 0.9, cfg.w_age)
            self.hedge_after = min(cfg.hedge_after,
                                   self.hedge_after + 1)
