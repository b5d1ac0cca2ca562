"""Continuous-batching query service over the ALB round loop (PyTorch
port of ``repro/serve``; DESIGN.md section 8).

Public surface: :class:`QueryService` (the engine), plus the pieces it
composes — :class:`QueryQueue`/:class:`Query`, :class:`Scheduler`,
:class:`ResultCache`, :class:`ServiceStats` — each usable standalone.
"""
from .queue import (Query, QueryQueue, QUEUED, RUNNING, DONE,
                    CANCELLED)
from .scheduler import Scheduler, SlotView, Decision
from .cache import ResultCache
from .stats import ServiceStats
from .engine import QueryService

__all__ = ["QueryService", "Query", "QueryQueue", "Scheduler",
           "SlotView", "Decision", "ResultCache", "ServiceStats",
           "QUEUED", "RUNNING", "DONE", "CANCELLED"]
