"""The continuous-batching query service (PyTorch port of
``repro/serve/engine.py``; DESIGN.md section 8).

:class:`QueryService` runs the ALB round loop as a *service*: queries
arrive continuously via ``submit``, each occupies one row (a **slot**)
of a ``[B, V]`` slot bank, and the bank advances one balancer round
per ``step``.  A row whose frontier empties has converged — it is
retired and its slot refilled from the queue *mid-loop*, at fixed
``[B, V]`` shapes, so admission never recompiles or restarts the loop.
Because batch rows are independent (inactive rows scatter only the
combiner's identity), every served query is bitwise equal to its
standalone ``bfs``/``sssp`` run regardless of what shared its batch.

Composition (one class per module in this package):

* :class:`repro_torch.serve.queue.QueryQueue` — submit/poll bookkeeping,
  FIFO pending order;
* :class:`repro_torch.serve.scheduler.Scheduler` — deterministic admission +
  round-budget preemption (snapshot/resume, exact);
* :class:`repro_torch.serve.cache.ResultCache` — LRU over
  (graph_id, app, source, strategy), invalidated per graph on
  re-registration; the same key drives single-flight coalescing of
  identical in-flight submissions;
* :class:`repro_torch.serve.stats.ServiceStats` — queries served, p50/p95
  rounds-in-system, slot occupancy, cache hit rate.

Slot banks are keyed ``(graph_id, app)`` — a balancer round applies
one operator to its whole batch — and created lazily on first demand.
A bank lives on its graph's device.  The host transfers of a step are
the JAX engine's, one for one: the round's own (one a round in host
mode) and ONE fetch of the round count and the ``bool[B]`` liveness;
on a step where queries retire, only their rows are fetched.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.graph import Graph, INF
from repro_torch.core.balancer import (BalancerConfig, run_fused,
                                       host_transfer_count,
                                       _note_host_transfer)
from repro_torch.core.frontier import (rows_active, refill_rows,
                                       load_rows)
from repro_torch.core.apps.drivers import QUERY_APPS, step_batch
from repro_torch.core.streaming import (UpdateBatch, apply_updates,
                                        diff_batch)

from .queue import (Query, QueryQueue, QUEUED, RUNNING, DONE,
                    CANCELLED)
from .scheduler import Scheduler, SlotView, Decision
from .cache import ResultCache
from .publish import freeze
from .stats import ServiceStats


class _SlotBank:
    """Device state of one (graph_id, app) batch: ``[B, V]`` labels +
    frontier on the graph's device, plus the host-side slot -> query
    map.

    ``stale=True`` marks a bank pinned to a superseded graph version
    (DESIGN.md section 10): it admits and preempts nothing, its
    occupants drain to completion against the pre-update snapshot it
    holds in ``self.g``, and the engine deletes it once empty."""

    def __init__(self, g: Graph, app: str, num_slots: int) -> None:
        self.g = g
        self.app = app
        self.op, self.fill = QUERY_APPS[app]
        self.stale = False
        v = g.num_vertices
        self.labels = torch.full((num_slots, v), int(self.fill),
                                 dtype=torch.int32, device=g.device)
        self.frontier = torch.zeros((num_slots, v), dtype=torch.bool,
                                    device=g.device)
        self.slot_q: list = [None] * num_slots      # Query | None

    @property
    def num_slots(self) -> int:
        return len(self.slot_q)

    def views(self) -> list:
        """Scheduler-facing occupancy views, ascending slot order."""
        return [SlotView(slot=s,
                         qid=None if q is None else q.qid,
                         slot_rounds=0 if q is None else q.slot_rounds)
                for s, q in enumerate(self.slot_q)]

    def busy(self) -> int:
        return sum(q is not None for q in self.slot_q)


class QueryService:
    """Continuous-batching BFS/SSSP service over registered graphs.

    ``num_slots`` fixes B (per slot bank); ``cfg``/``mode`` select the
    balancer strategy and round implementation for every bank —
    including the traversal direction (``cfg.direction``, DESIGN.md
    section 9), which therefore also joins the result-cache key: A/B
    deployments of push vs adaptive configs never share entries;
    ``round_budget`` enables preemptive fairness (see
    :class:`repro_torch.serve.scheduler.Scheduler`); ``cache_capacity``
    bounds the LRU result cache (0 disables it).

    ``mode="fused"`` advances each bank by a device-resident CHUNK of
    up to ``fused_rounds`` balancer rounds per service step (one
    ``balancer.run_fused`` dispatch: on the card one graph launch): admission,
    retirement, and preemption then happen at chunk granularity, while
    every served result stays bitwise equal to host mode (fused rounds
    are the same SPMD rounds).  ``ServiceStats.host_transfers`` makes
    the amortization observable — one fused observation per step
    instead of one blocking sync per round.

    Typical use::

        svc = QueryService(num_slots=8)
        svc.register_graph("social", g)
        qid = svc.submit("social", "bfs", source=17)
        svc.run()                       # drain queue + slots
        labels = svc.poll(qid).result   # np.ndarray[V], bitwise ==
                                        # apps.bfs(g, 17).labels.cpu()
    """

    def __init__(self, num_slots: int = 8,
                 cfg: BalancerConfig = BalancerConfig(),
                 mode: str = "host",
                 round_budget: Optional[int] = None,
                 cache_capacity: int = 256,
                 fused_rounds: int = 8) -> None:
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if mode == "fused" and fused_rounds < 1:
            raise ValueError("fused_rounds must be >= 1")
        self.num_slots = num_slots
        self.cfg = cfg
        self.mode = mode
        self.fused_rounds = fused_rounds
        self.queue = QueryQueue()
        self.scheduler = Scheduler(round_budget=round_budget)
        self.cache = ResultCache(capacity=cache_capacity)
        self.stats = ServiceStats()
        self._graphs: Dict[str, Graph] = {}
        self._banks: Dict[tuple, _SlotBank] = {}
        self._step = 0
        # single-flight coalescing: cache-key -> primary qid of the
        # in-flight computation identical submissions attach to
        self._inflight: Dict[tuple, int] = {}
        self._followers: Dict[int, list] = {}
        # (step, qid, slot) admission trace — the determinism witness
        self.admission_log: list = []

    # ---- graph registry --------------------------------------------------

    def register_graph(self, graph_id: str, g: Graph) -> None:
        """Bind ``graph_id`` to a CSR graph.  Re-registering an id
        invalidates its cache entries (the binding changed) and drops
        its idle slot banks; it is an error while queries for the id
        are still in flight."""
        if graph_id in self._graphs:
            if self.queue.in_flight(graph_id):
                raise ValueError(
                    f"cannot re-register {graph_id!r}: queries in flight")
            self.cache.invalidate_graph(graph_id)
            for key in [k for k in self._banks if k[0] == graph_id]:
                del self._banks[key]
        self._graphs[graph_id] = g

    def apply_updates(self, graph_id: str, batch: UpdateBatch) -> int:
        """Mutate a registered graph with a streaming
        :class:`~repro_torch.core.streaming.UpdateBatch` (DESIGN.md
        section 10), WITHOUT quiescing the service.  Returns how many
        cache entries the update evicted.

        Unlike :meth:`register_graph`, this is legal while queries are
        in flight — the binding advances *functionally*:

        * the new CSR (same shapes, version + 1) replaces the binding
          for all FUTURE admissions;
        * busy slot banks keep their pre-update ``Graph`` snapshot and
          are marked stale: they stop admitting and preempting, drain
          their occupants against the topology those queries were
          submitted under, and are deleted once empty (queued work for
          the bank then admits into a fresh bank on the new version);
        * cache eviction is fine-grained: only entries whose
          reachability tag intersects the update's changed-edge
          sources are dropped (:meth:`ResultCache.invalidate_delta`),
          so untouched regions keep their hit rate across the bump;
        * single-flight coalescing keys on the graph version, so a
          post-update submitter never attaches to (or is answered by)
          a pre-update in-flight computation.
        """
        if graph_id not in self._graphs:
            raise ValueError(f"unknown graph {graph_id!r}")
        g = self._graphs[graph_id]
        delta = diff_batch(g, batch)
        self._graphs[graph_id] = apply_updates(g, batch, in_place=False)
        evicted = self.cache.invalidate_delta(graph_id, delta.sources())
        for key in [k for k in self._banks if k[0] == graph_id]:
            bank = self._banks[key]
            if bank.busy():
                bank.stale = True
            else:
                del self._banks[key]
        return evicted

    # ---- submit / poll ---------------------------------------------------

    def submit(self, graph_id: str, app: str, source: int) -> int:
        """Enqueue one point query; returns its qid.

        Two short-circuits keep repeat traffic off the device: a
        **cache hit** is answered immediately (status DONE,
        ``from_cache=True``, rounds-in-system 0), and a submission
        identical to one still in flight is **coalesced** onto it
        (single-flight): it never occupies a slot, and completes —
        also marked ``from_cache`` — the moment its primary does."""
        if graph_id not in self._graphs:
            raise ValueError(f"unknown graph {graph_id!r}")
        if app not in QUERY_APPS:
            raise ValueError(
                f"unknown app {app!r} (have {sorted(QUERY_APPS)})")
        g = self._graphs[graph_id]
        if not 0 <= int(source) < g.num_vertices:
            raise ValueError(f"source {source} out of range "
                             f"[0, {g.num_vertices})")
        cached = self.cache.get(graph_id, app, source, self.cfg)
        # single-flight keys include the graph VERSION (DESIGN.md
        # section 10): a submission after apply_updates never coalesces
        # onto a computation still draining against the old topology
        key = self.cache.key(graph_id, app, source, self.cfg) \
            + (g.version,)
        primary = None if cached is not None else self._inflight.get(key)
        q = self.queue.submit(
            graph_id, app, source, step=self._step,
            enqueue=cached is None and primary is None)
        q.version = g.version
        q.inflight_key = key
        if cached is not None:
            self._finish(q, cached, from_cache=True)
        elif primary is not None:
            self._followers.setdefault(primary, []).append(q)
        else:
            self._inflight[key] = q.qid
        return q.qid

    def poll(self, qid: int) -> Query:
        """The query's live record: ``status``
        (queued/running/done/cancelled), ``result`` (host labels once
        done), ``rounds_in_system``, ``from_cache``."""
        return self.queue.poll(qid)

    def cancel(self, qid: int) -> bool:
        """Withdraw a query before completion (DESIGN.md section 13:
        the fleet cancels the losing finisher of a hedged pair).
        Returns True when the query was cancelled, False when it had
        already completed — its result stands, and the caller (the
        fleet's publication point) is responsible for dropping it.

        A QUEUED query leaves the pending FIFO (a coalesced follower
        is instead detached from its primary); a RUNNING query's slot
        is cleared on the device (labels row filled with the app's
        fill, frontier row zeroed; nothing crosses from the host).  A
        cancelled *primary* promotes its first follower into the
        pending FIFO so coalesced submitters are still answered."""
        q = self.queue.poll(qid)
        if q.status in (DONE, CANCELLED):
            return False
        if q.status == QUEUED:
            try:
                self.queue.remove_pending(qid)
            except ValueError:
                # single-flight follower: never enqueued — detach it
                # from its primary's fan-out list
                primary = self._inflight.get(q.inflight_key)
                fs = self._followers.get(primary, [])
                if q in fs:
                    fs.remove(q)
        else:                                      # RUNNING
            bank = self._banks[(q.graph_id, q.app)]
            bank.labels[q.slot].fill_(int(bank.fill))   # the bank's own
            bank.frontier[q.slot].fill_(False)          # rows, in place
            bank.slot_q[q.slot] = None
            if bank.stale and not bank.busy():
                del self._banks[(q.graph_id, q.app)]
        # release the single-flight registration; a waiting follower
        # is promoted to a real pending computation
        key = q.inflight_key
        if key is not None and self._inflight.get(key) == q.qid:
            del self._inflight[key]
            followers = self._followers.pop(q.qid, [])
            if followers:
                heir = followers[0]
                self.queue.enqueue_existing(heir)
                self._inflight[key] = heir.qid
                if len(followers) > 1:
                    self._followers[heir.qid] = followers[1:]
        q.status = CANCELLED
        q.slot = None
        q.saved_state = None
        q.done_step = self._step
        self.stats.cancellations += 1
        return True

    # ---- fleet-facing load signals (DESIGN.md section 13) ----------------

    def load(self) -> int:
        """Assigned load: queries currently QUEUED or RUNNING — the
        quantity the fleet router's bounded-load rule budgets."""
        return self.queue.active_count()

    def queue_head_age(self) -> int:
        """Service steps the oldest pending query has waited (0 when
        nothing is pending) — the head-of-line-blocking term of the
        fleet router's tail-risk score."""
        head = self.queue.head_submit_step()
        return 0 if head is None else self._step - head

    def rounds_remaining(self) -> float:
        """Estimated balancer rounds of work still in this service:
        for each RUNNING query, the EWMA of completed rounds-in-system
        minus the rounds it has already run (floored at 1 — an
        admitted query always costs at least its current round), plus
        one full EWMA per pending query.  This is the
        ``work_remaining`` term of the fleet router's tail-risk score
        (DESIGN.md section 13); 0.0 on an idle, just-started
        replica."""
        ewma = self.stats.ewma_rounds
        rem = 0.0
        for bank in self._banks.values():
            for q in bank.slot_q:
                if q is not None:
                    rem += max(ewma - q.slot_rounds, 1.0)
        rem += len(self.queue) * max(ewma, 1.0)
        return rem

    # ---- the serving loop ------------------------------------------------

    def step(self) -> bool:
        """One service round: for every slot bank with work — admit
        (after any preemptions), run one balancer round, retire
        converged slots.  Returns False when nothing was left to do
        (queue empty, all slots idle)."""
        self._step += 1
        self.stats.queue_head_age = self.queue_head_age()
        did_work = False
        for key in self._bank_keys_with_work():
            did_work |= self._step_bank(key)
        return did_work

    def run(self, max_steps: int = 1_000_000) -> ServiceStats:
        """Drain: step until every submitted query is DONE (bounded by
        ``max_steps`` as a divergence guard).  Returns the accumulated
        :class:`ServiceStats`."""
        for _ in range(max_steps):
            if not self.step():
                return self.stats
        raise RuntimeError(f"service did not drain in {max_steps} steps")

    # ---- internals -------------------------------------------------------

    def _bank_keys_with_work(self) -> list:
        keys = list(self._banks)    # insertion order: deterministic
        keys = [k for k in keys if self._banks[k].busy()
                or self.queue.pending_count(*k)]
        for k in self.queue.banks_with_pending():
            if k not in keys:
                keys.append(k)
        return keys

    def _bank(self, key: tuple) -> _SlotBank:
        if key not in self._banks:
            graph_id, app = key
            self._banks[key] = _SlotBank(self._graphs[graph_id], app,
                                         self.num_slots)
        return self._banks[key]

    def _finish(self, q: Query, labels: np.ndarray,
                from_cache: bool) -> None:
        """Complete a query and fan its labels out to any coalesced
        followers.  The ndarray is SHARED — one object between the LRU
        entry, this query's ``poll().result`` and every follower's — so
        it is frozen here (:func:`repro_torch.serve.publish.freeze`): a
        caller mutating a result raises instead of silently corrupting
        every future cache hit."""
        labels = freeze(labels)
        q.status = DONE
        q.result = labels
        q.from_cache = from_cache
        q.done_step = self._step
        q.slot = None
        q.saved_state = None
        self.stats.record_done(q.rounds_in_system, from_cache)
        key = q.inflight_key
        if key is not None and self._inflight.get(key) == q.qid:
            del self._inflight[key]
        for f in self._followers.pop(q.qid, ()):
            self._finish(f, labels, from_cache=True)

    def _step_bank(self, key: tuple) -> bool:
        bank = self._bank(key)
        graph_id, app = key
        b = bank.num_slots

        # 1. plan admissions/preemptions against current occupancy.
        #    A stale bank (superseded graph version) plans NOTHING: no
        #    admissions — queued work waits for a fresh bank on the new
        #    version — and no preemptions, so its occupants run to
        #    completion on the snapshot they started on.
        if bank.stale:
            decision = Decision(preempt=(), admit=())
        else:
            decision = self.scheduler.plan(
                bank.views(), self.queue.pending_count(graph_id, app))

        # 2. preempt: snapshot the preempted rows to the host (one
        #    gather of those rows), requeue at the back
        if decision.preempt:
            l_host = _host_rows(bank.labels, decision.preempt)
            f_host = _host_rows(bank.frontier, decision.preempt)
            for i, slot in enumerate(decision.preempt):
                q = bank.slot_q[slot]
                q.saved_state = (l_host[i].copy(), f_host[i].copy())
                q.preemptions += 1
                self.stats.preemptions += 1
                self.queue.requeue(q)
                bank.slot_q[slot] = None

        # 3. admit: fresh queries reset their row, resumed queries
        #    restore their snapshot — one fixed-K scatter each, so the
        #    loop shapes never change
        fresh, resumed = [], []
        for slot in decision.admit:
            q = self.queue.next_pending(graph_id, app)
            if q is None:
                break
            q.status = RUNNING
            q.slot = slot
            q.slot_rounds = 0
            if q.version != bank.g.version:
                # the graph mutated while this query queued: rebind it
                # to the version this bank actually computes against —
                # re-key its single-flight registration and drop any
                # preemption snapshot (taken on the old topology)
                if (q.inflight_key is not None and
                        self._inflight.get(q.inflight_key) == q.qid):
                    del self._inflight[q.inflight_key]
                q.version = bank.g.version
                if q.inflight_key is not None:
                    q.inflight_key = (q.inflight_key[:-1]
                                      + (bank.g.version,))
                    self._inflight.setdefault(q.inflight_key, q.qid)
                q.saved_state = None
            bank.slot_q[slot] = q
            self.admission_log.append((self._step, q.qid, slot))
            (resumed if q.saved_state is not None else fresh).append(
                (slot, q))
        if fresh:
            slots = np.full((b,), b, np.int32)
            srcs = np.zeros((b,), np.int32)
            for i, (slot, q) in enumerate(fresh):
                slots[i], srcs[i] = slot, q.source
            bank.labels, bank.frontier = refill_rows(
                bank.labels, bank.frontier, slots, srcs, bank.fill)
        if resumed:
            slots = np.asarray([slot for slot, _ in resumed], np.int32)
            lrows = np.stack([q.saved_state[0] for _, q in resumed])
            frows = np.stack([q.saved_state[1] for _, q in resumed])
            for _, q in resumed:
                q.saved_state = None
            bank.labels, bank.frontier = load_rows(
                bank.labels, bank.frontier, slots, lrows, frows)

        busy = bank.busy()
        if busy == 0:
            return False

        # 4. one balancer round for the whole bank — or, in fused
        #    mode, a CHUNK of up to ``fused_rounds`` rounds as ONE
        #    device dispatch (one graph launch on the card): the
        #    chunk's round loop runs with zero host syncs, and the
        #    per-step observation below amortizes over the whole chunk.
        t_sync = host_transfer_count()
        if self.mode == "fused":
            bank.labels, bank.frontier, r_dev, _ = run_fused(
                bank.g, bank.labels, bank.frontier, self.cfg, bank.op,
                max_rounds=self.fused_rounds)
        else:
            bank.labels, bank.frontier, _ = step_batch(
                bank.g, bank.labels, bank.frontier, self.cfg, bank.op,
                mode=self.mode)
            r_dev = bank.labels.new_ones(())
        self.stats.record_step(busy=busy, total=b)

        # 5. retire: occupied rows whose frontier emptied have
        #    converged — publish, cache, free the slot.  The steady
        #    per-step transfer is only the chunk's round count plus the
        #    ``bool[B]`` liveness vector (ONE fetch of one stacked
        #    tensor); the retired rows' labels (one gather) only on
        #    steps where something actually retired.
        seen = torch.cat([r_dev.reshape(1).to(torch.int32),
                          rows_active(bank.frontier).to(torch.int32)])
        seen = seen.cpu().numpy()
        _note_host_transfer()
        rounds_ran, act = int(seen[0]), seen[1:] > 0
        for q in bank.slot_q:
            if q is not None:
                q.slot_rounds += rounds_ran
        self.stats.host_transfers += host_transfer_count() - t_sync
        done = [slot for slot, q in enumerate(bank.slot_q)
                if q is not None and not act[slot]]
        if done:
            l_host = _host_rows(bank.labels, done)
            cur = self._graphs.get(graph_id)
            for i, slot in enumerate(done):
                q = bank.slot_q[slot]
                labels = l_host[i].copy()
                # cache only results for the CURRENT graph version (a
                # stale bank's drain products answer their submitters
                # but must not poison future hits), tagged with the
                # query's reachable region so streaming updates can
                # evict at delta granularity (DESIGN.md section 10)
                if cur is not None and q.version == cur.version:
                    self.cache.put(graph_id, app, q.source, self.cfg,
                                   labels, region=labels < INF)
                self._finish(q, labels, from_cache=False)
                bank.slot_q[slot] = None
        if bank.stale and not bank.busy():
            del self._banks[key]
        return True


def _host_rows(t: torch.Tensor, slots) -> np.ndarray:
    """Rows ``slots`` of a ``[B, V]`` bank tensor on the host: one
    gather on the device, one fetch."""
    return torch.stack([t[s] for s in slots]).cpu().numpy()  # repro: allow[host-sync] -- the answer rows of retired or preempted queries, only on steps that have them; uncounted as in the JAX package
