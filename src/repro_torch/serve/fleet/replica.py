"""One engine replica of the fleet (PyTorch port of
``repro/serve/fleet/replica.py``; DESIGN.md section 13).

A :class:`ReplicaHandle` wraps a :class:`repro_torch.serve.QueryService`
with the two things the fleet needs on top of the engine API: the
load signals the router scores (assigned load, rounds-remaining
estimate, queue-head age — exported by the engine's fleet-facing
hooks), and execution placement/pacing.  ``device`` is the replica's
``torch.device``: the fleet binds its graphs there, so its slot banks
and rounds run there, and a step runs with that CUDA device current.
``throttle=k`` advances the
underlying service only every k-th fleet step — the deterministic
straggler knob the hedging tests and benchmarks use to force a slow
replica without touching wall clock.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..engine import QueryService


class ReplicaHandle:
    """A fleet-managed engine replica: id + service + placement."""

    def __init__(self, rid: int, svc: QueryService,
                 device=None, throttle: int = 1) -> None:
        if throttle < 1:
            raise ValueError("throttle must be >= 1")
        self.rid = rid
        self.svc = svc
        self.device = device
        self.throttle = throttle
        self._ticks = 0

    def _ctx(self):
        if self.device is not None and \
                torch.device(self.device).type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def step(self) -> bool:
        """Advance the replica one service step — unless its throttle
        says to skip this fleet step (the straggler simulation).
        Returns whether the service did any work."""
        self._ticks += 1
        if (self._ticks - 1) % self.throttle != 0:
            return False
        with self._ctx():
            return self.svc.step()

    # ---- router-facing load signals ----------------------------------

    def load(self) -> int:
        """Assigned load: the replica's QUEUED + RUNNING queries."""
        return self.svc.load()

    def rounds_remaining(self) -> float:
        """Estimated rounds of work left in this replica (the EWMA
        export of :meth:`QueryService.rounds_remaining`)."""
        return self.svc.rounds_remaining()

    def queue_head_age(self) -> int:
        """Steps the replica's oldest pending query has waited."""
        return self.svc.queue_head_age()
