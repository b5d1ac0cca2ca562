"""Query objects and the submit/poll queue of the serving layer.

A :class:`Query` is one point lookup — "run ``app`` from ``source`` on
the graph registered as ``graph_id``" — moving through the lifecycle

    QUEUED -> RUNNING -> DONE          (or QUEUED -> DONE on cache hit)
         ^       |
         +-------+   (preempted: back of the queue, slot state saved)

with a third terminal state, CANCELLED, reached from QUEUED or RUNNING
via :meth:`QueryService.cancel` — the fleet layer (DESIGN.md
section 13) cancels the losing finisher of a hedged query.

:class:`QueryQueue` is the bookkeeping half of the service: it assigns
monotonically increasing query ids (the FIFO admission key the
scheduler orders by, so admission is deterministic — DESIGN.md
section 8), holds the pending deque, and answers ``poll``.  It never
touches the device; slot state lives in ``repro_torch.serve.engine``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"


@dataclasses.dataclass
class Query:
    """One submitted point query and its full service-side record."""
    qid: int
    graph_id: str
    app: str                       # key into apps.drivers.QUERY_APPS
    source: int
    status: str = QUEUED
    result: Optional[np.ndarray] = None   # final labels[V] (host copy)
    from_cache: bool = False
    submit_step: int = 0           # service step at submission
    done_step: Optional[int] = None
    slot: Optional[int] = None     # occupied slot while RUNNING
    slot_rounds: int = 0           # consecutive rounds in current slot
    preemptions: int = 0
    # preemption snapshot: (labels_row[V], frontier_row[V]) host copies
    saved_state: Optional[tuple] = None
    # graph version the query is bound to: stamped at submission,
    # rebound at admission if the graph mutated while it queued
    # (DESIGN.md section 10) — results are cached only when this
    # matches the graph's current version
    version: int = 0
    # single-flight registration key (includes the version), popped by
    # the engine when the query completes or is rebound
    inflight_key: Optional[tuple] = None

    @property
    def rounds_in_system(self) -> Optional[int]:
        """Service steps from submission to completion (queue wait +
        slot residency; 0 for a cache hit served at submission)."""
        if self.done_step is None:
            return None
        return self.done_step - self.submit_step


class QueryQueue:
    """Submit/poll bookkeeping: id assignment, the pending FIFO, and
    the qid -> :class:`Query` table."""

    def __init__(self) -> None:
        self._next_qid = 0
        self._queries: dict[int, Query] = {}
        self._pending: deque[int] = deque()

    def submit(self, graph_id: str, app: str, source: int,
               step: int, enqueue: bool = True) -> Query:
        """Create a QUEUED query and (unless ``enqueue=False`` — the
        cache-hit path, answered at submission) append it to the
        pending FIFO."""
        q = Query(qid=self._next_qid, graph_id=graph_id, app=app,
                  source=int(source), submit_step=step)
        self._next_qid += 1
        self._queries[q.qid] = q
        if enqueue:
            self._pending.append(q.qid)
        return q

    def poll(self, qid: int) -> Query:
        """Look up a query's current record (status, result, timings)."""
        return self._queries[qid]

    def requeue(self, q: Query) -> None:
        """Preemption path: a RUNNING query goes to the BACK of the
        FIFO (round-robin fairness) with its slot state saved."""
        q.status = QUEUED
        q.slot = None
        q.slot_rounds = 0
        self._pending.append(q.qid)

    def next_pending(self, graph_id: str, app: str) -> Optional[Query]:
        """Pop the earliest pending query of the ``(graph_id, app)``
        slot bank (FIFO by qid); None when that bank has no queued
        work.  Banks are per (graph, app) because a balancer round
        applies ONE operator to the whole batch."""
        for i, qid in enumerate(self._pending):
            q = self._queries[qid]
            if q.graph_id == graph_id and q.app == app:
                del self._pending[i]
                return q
        return None

    def remove_pending(self, qid: int) -> None:
        """Withdraw a QUEUED query from the pending FIFO (the
        cancellation path); raises ``ValueError`` when the qid is not
        pending — e.g. a single-flight follower, which was never
        enqueued."""
        self._pending.remove(qid)

    def enqueue_existing(self, q: Query) -> None:
        """Re-enqueue an already-registered query at the back of the
        FIFO: the promotion path for a single-flight follower whose
        primary was cancelled (it must now be computed for real)."""
        q.status = QUEUED
        self._pending.append(q.qid)

    def head_submit_step(self) -> Optional[int]:
        """Submission step of the OLDEST pending query (the queue-head
        age numerator of the fleet router's tail-risk score, DESIGN.md
        section 13); None when nothing is pending."""
        return min((self._queries[qid].submit_step
                    for qid in self._pending), default=None)

    def active_count(self) -> int:
        """Queries currently QUEUED or RUNNING (the replica's assigned
        load as the fleet router sees it)."""
        return sum(q.status in (QUEUED, RUNNING)
                   for q in self._queries.values())

    def pending_count(self, graph_id: str, app: str) -> int:
        """How many queries are queued for the ``(graph_id, app)``
        bank."""
        return sum(1 for qid in self._pending
                   if self._queries[qid].graph_id == graph_id
                   and self._queries[qid].app == app)

    def banks_with_pending(self) -> list:
        """``(graph_id, app)`` bank keys with queued work, in
        first-submission order."""
        seen: dict[tuple, None] = {}
        for qid in self._pending:
            q = self._queries[qid]
            seen.setdefault((q.graph_id, q.app))
        return list(seen)

    def in_flight(self, graph_id: str) -> bool:
        """True while any query for ``graph_id`` is QUEUED/RUNNING."""
        return any(q.graph_id == graph_id
                   and q.status in (QUEUED, RUNNING)
                   for q in self._queries.values())

    def __len__(self) -> int:
        return len(self._pending)
