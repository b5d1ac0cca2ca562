"""Service-level instrumentation.

Where :class:`repro_torch.core.balancer.RoundStats` measures one balancer
round, :class:`ServiceStats` measures the *service*: how many queries
were served (and how many straight from cache), the distribution of
rounds-in-system (queue wait + slot residency, the service's latency
in its natural unit), and how full the slot array ran (occupancy = the
fraction of slot-rounds that held a query — the utilization that
continuous batching exists to maximize, DESIGN.md section 8).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# EWMA smoothing factor for the rounds-remaining estimate the fleet
# router scores replicas by (DESIGN.md section 13)
EWMA_ALPHA = 0.25


@dataclasses.dataclass
class ServiceStats:
    """Counters accumulated by a :class:`repro_torch.serve.QueryService`."""
    queries_served: int = 0        # completed, including cache hits
    cache_hits: int = 0            # served with NO device work: LRU
    #                                hits + single-flight coalesced
    cache_misses: int = 0          # actually computed on the device
    steps: int = 0                 # service rounds executed
    slot_rounds_total: int = 0     # B per step (the capacity offered)
    slot_rounds_busy: int = 0      # ... of which held a RUNNING query
    preemptions: int = 0
    cancellations: int = 0         # queries withdrawn before completion
    #                                (the fleet's hedge losers)
    host_transfers: int = 0        # device->host syncs during stepping
    #                                (balancer round counts + liveness
    #                                probes; fused mode amortizes them
    #                                over whole chunks of rounds)
    ewma_rounds: float = 0.0       # EWMA of rounds-in-system over
    #                                COMPUTED completions — the
    #                                rounds-remaining estimate the
    #                                fleet router's tail-risk score
    #                                consumes (DESIGN.md section 13)
    queue_head_age: int = 0        # steps the oldest pending query has
    #                                waited (refreshed every step; 0
    #                                when the queue is empty)
    rounds_in_system: List[int] = dataclasses.field(default_factory=list)

    def record_step(self, busy: int, total: int) -> None:
        """Account one service round offering ``total`` slot-rounds of
        which ``busy`` were occupied."""
        self.steps += 1
        self.slot_rounds_total += total
        self.slot_rounds_busy += busy

    def record_done(self, rounds_in_system: int,
                    from_cache: bool) -> None:
        """Account one completed query.  Computed (non-cache)
        completions also advance ``ewma_rounds``, the rounds-remaining
        estimate served to the fleet router — cache hits are excluded
        because their 0 rounds say nothing about the cost of the work
        still in the system."""
        self.queries_served += 1
        if from_cache:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
            r = float(rounds_in_system)
            self.ewma_rounds = (
                r if self.cache_misses == 1
                else (1.0 - EWMA_ALPHA) * self.ewma_rounds
                + EWMA_ALPHA * r)
        self.rounds_in_system.append(int(rounds_in_system))

    @property
    def occupancy(self) -> float:
        """Busy slot-rounds / offered slot-rounds (0.0 before any
        step)."""
        if self.slot_rounds_total == 0:
            return 0.0
        return self.slot_rounds_busy / self.slot_rounds_total

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of completed queries answered from the cache."""
        if self.queries_served == 0:
            return 0.0
        return self.cache_hits / self.queries_served

    def latency_percentile(self, p: float) -> float:
        """p-th percentile of rounds-in-system over completed queries.

        Empty and single-sample windows are well-defined sentinels —
        ``0.0`` before any completion, the sample itself after one —
        never NaN: the fleet layer aggregates per-replica percentiles
        into its feedback controller (DESIGN.md section 13), and a
        just-started replica must read as "no observed latency", not
        poison every mean/comparison it joins."""
        if not self.rounds_in_system:
            return 0.0
        return float(np.percentile(np.asarray(self.rounds_in_system), p))

    def summary(self) -> dict:
        """One flat dict for logging/benchmark emission."""
        return {
            "queries_served": self.queries_served,
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "steps": self.steps,
            "occupancy": round(self.occupancy, 4),
            "preemptions": self.preemptions,
            "cancellations": self.cancellations,
            "host_transfers": self.host_transfers,
            "ewma_rounds": round(self.ewma_rounds, 3),
            "lat_rounds_p50": self.latency_percentile(50),
            "lat_rounds_p95": self.latency_percentile(95),
        }
