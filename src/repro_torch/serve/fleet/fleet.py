"""The SLO-aware multi-replica serving fleet (PyTorch port of
``repro/serve/fleet/fleet.py``; DESIGN.md section 13).

:class:`Fleet` scales the continuous-batching
:class:`~repro_torch.serve.engine.QueryService` one level up: N engine
replicas (optionally pinned across devices, each holding every
registered graph on its own device) behind a router that composes
cache-affinity rendezvous hashing, bounded-load redirection, and
power-of-two-choices admission scored by a tail-risk estimate — with
SLO-conditional hedging of stragglers and cancel-on-first-finish.
Every executed routing decision is recorded into a replayable
:class:`~repro_torch.serve.fleet.trace.RoutingTrace`; because
:func:`~repro_torch.serve.fleet.router.decide` is pure over the recorded
inputs, the whole run's routing can be re-derived offline and
compared bitwise (the fleet's determinism witness).

Determinism end to end: replica stepping order is fixed, the P2C
sampler is a seeded generator whose draws are recorded as decision
inputs, every replica result is bitwise equal to its standalone run
(the engine's parity invariant), and the winning finisher of a hedged
pair is published through :func:`repro_torch.serve.publish.freeze` exactly
once — the loser is cancelled, or dropped if it finished in the same
step, never double-published.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph, to_device
from repro_torch.core.balancer import BalancerConfig

from ..engine import QueryService
from ..queue import DONE, RUNNING
from ..publish import freeze
from .replica import ReplicaHandle
from .router import (RouterConfig, DecisionInputs, decide,
                     rendezvous_order, load_ceiling,
                     FeedbackController)
from .hedge import HedgePolicy, hedgeable
from .trace import RoutingTrace


@dataclasses.dataclass
class FleetQuery:
    """One fleet-level query and its full lifecycle record: the
    replica submissions fanned out for it (primary first, then
    hedges), the winner, and the published result."""
    fqid: int
    graph_id: str
    app: str
    source: int
    status: str = RUNNING           # running | done (fleet-level)
    result: Optional[np.ndarray] = None
    from_cache: bool = False
    submit_step: int = 0
    done_step: Optional[int] = None
    submissions: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)      # (replica id, replica qid)
    winner: Optional[int] = None    # replica id that answered
    hedges: int = 0

    @property
    def steps_in_system(self) -> Optional[int]:
        """Fleet steps from submission to publication (0 for a hit
        answered at submission)."""
        if self.done_step is None:
            return None
        return self.done_step - self.submit_step


class Fleet:
    """N :class:`QueryService` replicas behind the adaptive router.

    ``num_replicas`` engine replicas are built from the same
    ``cfg``/``mode``/``num_slots`` (the per-replica knobs of
    :class:`QueryService`); ``devices`` optionally pins replica i to the
    torch device ``devices[i % len(devices)]`` (its graphs and slot
    banks live there); ``router``/``hedge`` configure the
    policy; ``seed`` fixes the P2C sampler, so identical submission
    sequences produce identical routing traces run to run.

    Typical use::

        fleet = Fleet(num_replicas=3, num_slots=4)
        fleet.register_graph("social", g)
        fqid = fleet.submit("social", "bfs", source=17)
        fleet.run()                      # drain all replicas
        labels = fleet.poll(fqid).result # bitwise == bfs(g, 17)
        assert not trace_replay(fleet)   # every decision re-derivable
    """

    def __init__(self, num_replicas: int = 3,
                 cfg: BalancerConfig = BalancerConfig(),
                 num_slots: int = 4,
                 mode: str = "host",
                 round_budget: Optional[int] = None,
                 cache_capacity: int = 256,
                 router: RouterConfig = RouterConfig(),
                 hedge: HedgePolicy = HedgePolicy(),
                 devices: Optional[list] = None,
                 seed: int = 0) -> None:
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self.router_cfg = router
        self.hedge_policy = hedge
        self.controller = FeedbackController(router)
        self.replicas: List[ReplicaHandle] = []
        for rid in range(num_replicas):
            dev = (devices[rid % len(devices)]
                   if devices else None)
            self.replicas.append(ReplicaHandle(
                rid,
                QueryService(num_slots=num_slots, cfg=cfg, mode=mode,
                             round_budget=round_budget,
                             cache_capacity=cache_capacity),
                device=dev))
        self.trace = RoutingTrace()
        self._rng = np.random.default_rng(seed)
        self._records: Dict[int, FleetQuery] = {}
        self._loads = [0] * num_replicas   # assigned in-flight per
        #                                    replica (the bounded-load
        #                                    quantity)
        self._next_fqid = 0
        self._step = 0
        self._seq = 0
        self.hedges_launched = 0
        self.hedges_cancelled = 0

    # ---- graph registry --------------------------------------------------

    def register_graph(self, graph_id: str, g: Graph) -> None:
        """Bind ``graph_id`` on EVERY replica: any replica can serve
        any registered graph (affinity only concentrates repeats, it
        never partitions correctness).  Each replica binds ``g`` on its
        own device: one copy per device, shared by the replicas there
        (``g`` itself for replicas on ``g``'s device or unpinned)."""
        copies = {}
        for rep in self.replicas:
            dev = g.device if rep.device is None else torch.device(
                rep.device)
            if dev not in copies:
                copies[dev] = to_device(g, dev)
            rep.svc.register_graph(graph_id, copies[dev])

    # ---- routing ---------------------------------------------------------

    def _scores(self) -> Tuple[float, ...]:
        """Live tail-risk score per replica: assigned load plus the
        controller-weighted rounds-remaining EWMA and queue-head age
        (the ALPHA1 composite, DESIGN.md section 13)."""
        c = self.controller
        return tuple(
            float(self._loads[r.rid]
                  + c.w_tail * r.rounds_remaining()
                  + c.w_age * r.queue_head_age())
            for r in self.replicas)

    def _sample_pair(self, allowed: List[int]) -> Tuple[int, ...]:
        """Draw the P2C candidates from ``allowed`` (2 when possible,
        1 when only one replica is eligible).  The draw is consumed
        here; the SAMPLED PAIR is what enters the trace, so replay
        never needs the generator state."""
        if len(allowed) == 1:
            return (allowed[0],)
        picks = self._rng.choice(len(allowed), size=2, replace=False)
        return tuple(sorted(allowed[int(i)] for i in picks))

    def _route(self, fqid: int, key: tuple, kind: str,
               exclude: Tuple[int, ...] = ()) -> Tuple[int, str]:
        """Build the decision inputs, decide, and record the executed
        decision into the trace."""
        allowed = [r.rid for r in self.replicas
                   if r.rid not in exclude]
        inputs = DecisionInputs(
            seq=self._seq, fqid=fqid, kind=kind, key=key,
            loads=tuple(self._loads), scores=self._scores(),
            order=rendezvous_order(key, len(self.replicas)),
            pair=self._sample_pair(allowed),
            capacity_factor=self.router_cfg.capacity_factor,
            affinity=self.router_cfg.affinity, exclude=exclude)
        choice, reason = decide(inputs)
        if kind == "hedge":
            # capacity-conditional: a hedge that would break the
            # bounded-load ceiling is skipped, not forced
            ceil_ = load_ceiling(inputs.loads,
                                 inputs.capacity_factor)
            if inputs.loads[choice] + 1 > ceil_:
                return -1, "skipped"
        self.trace.append(inputs, choice, reason)
        self._seq += 1
        return choice, reason

    # ---- submit / poll ---------------------------------------------------

    def submit(self, graph_id: str, app: str, source: int) -> int:
        """Route one point query into the fleet; returns its fleet
        qid.  A replica-level cache hit (LRU or single-flight answered
        at submission) completes the fleet record immediately."""
        fqid = self._next_fqid
        self._next_fqid += 1
        key = (graph_id, app, int(source))
        rec = FleetQuery(fqid=fqid, graph_id=graph_id, app=app,
                         source=int(source), submit_step=self._step)
        self._records[fqid] = rec
        rid, _ = self._route(fqid, key, kind="route")
        rqid = self.replicas[rid].svc.submit(graph_id, app, source)
        rec.submissions.append((rid, rqid))
        q = self.replicas[rid].svc.poll(rqid)
        if q.status == DONE:                   # answered at submission
            self._publish(rec, rid, q)
        else:
            self._loads[rid] += 1
        return fqid

    def poll(self, fqid: int) -> FleetQuery:
        """The fleet query's live record (status, result, winner,
        hedges)."""
        return self._records[fqid]

    # ---- the fleet loop --------------------------------------------------

    def step(self) -> bool:
        """One fleet round: advance every replica (honoring straggler
        throttles), publish first finishers and cancel their losers,
        launch due hedges, and run one feedback-controller update.
        Returns False when nothing is left in flight anywhere."""
        self._step += 1
        did_work = False
        for rep in self.replicas:
            did_work |= rep.step()
        self._collect()
        self._maybe_hedge()
        self.controller.update(self._aggregate_p95())
        inflight = any(rec.status == RUNNING
                       for rec in self._records.values())
        return did_work or inflight

    def run(self, max_steps: int = 1_000_000) -> dict:
        """Drain: step until every fleet query is published (bounded
        by ``max_steps`` as a divergence guard).  Returns
        :meth:`summary`."""
        for _ in range(max_steps):
            if not self.step():
                return self.summary()
        raise RuntimeError(f"fleet did not drain in {max_steps} steps")

    # ---- internals -------------------------------------------------------

    def _publish(self, rec: FleetQuery, rid: int, q) -> None:
        """Publish the FIRST finisher of a fleet query through the
        freeze() choke point and retire every other submission: still-
        running losers are cancelled, an already-finished loser is
        dropped here — either way the record is published exactly
        once."""
        labels = freeze(q.result)
        rec.result = labels
        rec.status = DONE
        rec.from_cache = q.from_cache
        rec.done_step = self._step
        rec.winner = rid
        for orid, orqid in rec.submissions:
            if orid == rid:          # each replica holds a query at
                continue             # most once (hedges exclude
            #                          holders), so rid IDs the winner
            if self.replicas[orid].svc.cancel(orqid):
                self.hedges_cancelled += 1
            self._loads[orid] -= 1

    def _collect(self) -> None:
        """Publish every in-flight record whose submissions include a
        finisher (submission order breaks same-step ties, so the
        primary wins deterministically when both land together)."""
        for rec in self._records.values():
            if rec.status != RUNNING:
                continue
            for rid, rqid in rec.submissions:
                q = self.replicas[rid].svc.poll(rqid)
                if q.status == DONE:
                    self._loads[rid] -= 1
                    self._publish(rec, rid, q)
                    break

    def _maybe_hedge(self) -> None:
        """Launch a hedge for every SLO-late record that still has a
        replica not holding it (and capacity under the ceiling)."""
        for rec in self._records.values():
            if not hedgeable(rec, self._step,
                             self.controller.hedge_after,
                             self.hedge_policy):
                continue
            holding = tuple(rid for rid, _ in rec.submissions)
            if len(holding) >= len(self.replicas):
                continue
            key = (rec.graph_id, rec.app, rec.source)
            rid, _ = self._route(rec.fqid, key, kind="hedge",
                                 exclude=holding)
            if rid < 0:                        # ceiling-skipped
                continue
            rqid = self.replicas[rid].svc.submit(
                rec.graph_id, rec.app, rec.source)
            rec.submissions.append((rid, rqid))
            rec.hedges += 1
            self.hedges_launched += 1
            q = self.replicas[rid].svc.poll(rqid)
            if q.status == DONE:               # hedge hit a warm cache
                self._publish(rec, rid, q)
            else:
                self._loads[rid] += 1

    def _aggregate_p95(self) -> float:
        """Fleet-wide p95 rounds-in-system aggregated from every
        replica's ServiceStats (the controller's feedback signal).
        Relies on the percentile sentinel: a just-started replica
        contributes nothing rather than NaN."""
        samples: List[int] = []
        for rep in self.replicas:
            samples.extend(rep.svc.stats.rounds_in_system)
        if not samples:
            return 0.0
        return float(np.percentile(np.asarray(samples), 95))

    def summary(self) -> dict:
        """One flat dict of fleet-level accounting.  Each fleet query
        counts ONCE regardless of hedging; device work appears in
        ``device_computations`` (the sum of per-replica cache misses,
        where a hedge's duplicate computation is visible instead)."""
        recs = list(self._records.values())
        served = sum(rec.status == DONE for rec in recs)
        hits = sum(rec.status == DONE and rec.from_cache
                   for rec in recs)
        return {
            "queries_served": served,
            "fleet_hit_rate": hits / served if served else 0.0,
            "device_computations": sum(
                rep.svc.stats.cache_misses for rep in self.replicas),
            "hedges_launched": self.hedges_launched,
            "hedges_cancelled": self.hedges_cancelled,
            "steps": self._step,
            "p95_rounds": self._aggregate_p95(),
            "per_replica_load": tuple(self._loads),
            "per_replica_served": tuple(
                rep.svc.stats.queries_served
                for rep in self.replicas),
            "w_tail": self.controller.w_tail,
            "hedge_after": self.controller.hedge_after,
        }
