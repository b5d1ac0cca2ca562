"""LRU result cache of the serving layer.

Point queries are deterministic — the batched engine guarantees every
served query is bitwise equal to its standalone run — so a repeat
(graph, app, source) lookup can be answered from memory without
touching the device.  Keys are ``(graph_id, app, source, strategy)``
where ``strategy`` is the frozen :class:`BalancerConfig` (hashable by
construction): results are strategy-independent by the parity
invariant, but keying on the config keeps the cache trivially correct
if a future strategy ever trades exactness for speed, and lets A/B
deployments coexist (DESIGN.md section 8).

Re-registering a graph id invalidates every entry for that id — the
binding ``graph_id -> CSR`` changed, so cached labels may be stale.
Streaming updates (DESIGN.md section 10) are finer-grained: each entry
may carry a **region tag** — the query's reachable set ``labels <
INF`` — and :meth:`invalidate_delta` evicts only entries whose region
intersects the update's changed-edge sources.  An edge change at
``(u, v)`` can alter labels-from-``s`` only if ``u`` is reachable from
``s``, so an entry whose tag misses every changed source provably
still holds for the NEW graph version and survives the bump — the
serving hit rate never resets to zero on a localized mutation.

Published arrays are **read-only**: ``put`` freezes the ndarray
(``setflags(write=False)``) before it becomes shared state.  The same
object is handed to every future ``get`` — and, via the engine, to the
primary's ``poll().result`` and all coalesced followers — so a caller
mutating a result in place would otherwise silently corrupt every
future cache hit.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np

from .publish import freeze


class ResultCache:
    """Bounded LRU map ``(graph_id, app, source, strategy) ->
    labels[V]`` with hit/miss counters; ``capacity=0`` disables
    caching entirely (every ``get`` is a miss)."""

    def __init__(self, capacity: int = 256) -> None:
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(graph_id: str, app: str, source: int,
            strategy: Hashable) -> tuple:
        """The canonical cache key (DESIGN.md section 8)."""
        return (graph_id, app, int(source), strategy)

    def get(self, graph_id: str, app: str, source: int,
            strategy: Hashable) -> Optional[np.ndarray]:
        """Cached labels for the query, refreshing its LRU position;
        None (and a counted miss) when absent."""
        k = self.key(graph_id, app, source, strategy)
        if k not in self._entries:
            self.misses += 1
            return None
        self._entries.move_to_end(k)
        self.hits += 1
        return self._entries[k][0]

    def put(self, graph_id: str, app: str, source: int,
            strategy: Hashable, labels: np.ndarray,
            region: Optional[np.ndarray] = None) -> None:
        """Insert/refresh an entry, evicting the least recently used
        entry when over capacity.  The array is frozen
        (``setflags(write=False)``) — it becomes shared state served to
        every future hit, so in-place mutation must raise rather than
        corrupt the cache.

        ``region`` optionally tags the entry with the query's
        reachability summary (``bool[V]``, typically ``labels < INF``)
        for :meth:`invalidate_delta`; an untagged entry is treated as
        reaching everywhere, i.e. evicted by every delta."""
        if self.capacity == 0:
            return
        labels = freeze(labels)
        if region is not None:
            region = freeze(np.asarray(region, dtype=bool))
        k = self.key(graph_id, app, source, strategy)
        self._entries[k] = (labels, region)
        self._entries.move_to_end(k)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def invalidate_graph(self, graph_id: str) -> int:
        """Drop every entry of ``graph_id`` (its CSR binding changed);
        returns how many entries were dropped."""
        stale = [k for k in self._entries if k[0] == graph_id]
        for k in stale:
            del self._entries[k]
        return len(stale)

    def invalidate_delta(self, graph_id: str, delta_vertices) -> int:
        """Fine-grained streaming eviction (DESIGN.md section 10):
        drop only the ``graph_id`` entries whose region tag intersects
        ``delta_vertices`` (the changed-edge source endpoints, e.g.
        ``NetDelta.sources()``).  Entries without a region tag are
        conservatively evicted; entries whose tag misses every delta
        vertex remain valid for the mutated graph and are KEPT.
        Returns how many entries were dropped."""
        delta = np.asarray(list(delta_vertices), dtype=np.int64)
        stale = []
        for k, (_, region) in self._entries.items():
            if k[0] != graph_id:
                continue
            if region is None or (len(delta) and
                                  bool(region[delta].any())):
                stale.append(k)
        for k in stale:
            del self._entries[k]
        return len(stale)

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses); 0.0 before any lookup."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._entries)
