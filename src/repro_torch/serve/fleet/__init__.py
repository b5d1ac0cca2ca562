"""Adaptive serving fleet: replicated query engines behind a
tail-aware router (PyTorch port of ``repro/serve/fleet``; DESIGN.md
section 13).

The fleet layer runs N :class:`~repro_torch.serve.engine.QueryService`
replicas behind a router that composes cache-affinity rendezvous
hashing, bounded-load redirection, and power-of-two-choices admission
scored by a tail-risk estimate; stragglers are hedged conditionally
on the SLO and cancelled on first finish; a feedback controller
steers the scoring weights against a p95 rounds-in-system target; and
every executed routing decision lands in a replayable
:class:`RoutingTrace` — the fleet's determinism witness.

Entry points: build a :class:`Fleet`, :meth:`~Fleet.register_graph`,
:meth:`~Fleet.submit`, :meth:`~Fleet.run`, then audit
``replay(fleet.trace.rows)`` and ``ceiling_violations(...)``.
"""
from .router import (RouterConfig, DecisionInputs, decide,
                     rendezvous_order, load_ceiling,
                     FeedbackController)
from .trace import (TraceRow, Divergence, RoutingTrace, replay,
                    ceiling_violations)
from .replica import ReplicaHandle
from .hedge import HedgePolicy, hedgeable
from .fleet import Fleet, FleetQuery

__all__ = [
    "RouterConfig", "DecisionInputs", "decide", "rendezvous_order",
    "load_ceiling", "FeedbackController",
    "TraceRow", "Divergence", "RoutingTrace", "replay",
    "ceiling_violations",
    "ReplicaHandle", "HedgePolicy", "hedgeable",
    "Fleet", "FleetQuery",
]
