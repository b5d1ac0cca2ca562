"""The single choke point for publishing arrays as shared state.

Every ndarray that leaves the serving layer's private buffers —
``ResultCache`` entries, ``poll().result``, anything hung off
``ServiceStats`` — is aliased, not copied: the same object is handed
to every cache hit and every coalesced follower.  :func:`freeze`
makes that safe by marking the array read-only before publication,
so an in-place mutation by any caller raises instead of silently
corrupting every other caller's answer.

Every store into those sinks flows through this helper; keeping it a
one-liner in its own module keeps that rule textual (the JAX package's
static publish-freeze pass checks it there).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def freeze(arr: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Mark ``arr`` read-only (``setflags(write=False)``) and return
    it; ``None`` passes through for optional fields."""
    if arr is not None:
        arr.setflags(write=False)
    return arr
