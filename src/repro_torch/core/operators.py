"""Operator algebra for vertex programs (port of ``repro/core/operators.py``).

An operator is factored into a ``direction`` (``push``/``pull``), a
``msg`` (candidate from the propagated value and the edge weight) and a
``combine`` (``min``/``add``).  Operators are module-level singletons;
``as_pull`` memoizes each push operator's pull twin by identity.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Operator:
    name: str
    direction: str                    # 'push' | 'pull'
    combine: str                      # 'min'  | 'add'
    msg: Callable                     # (value, weight) -> candidate
    uses_weight: bool = True
    #: wire narrowings this operator's combine tolerates exactly,
    #: narrowest-preferred-last (the same declarations as the JAX
    #: package; ``core.wire``'s quantize codec reads them)
    wire_narrow: tuple = ()


# Scatter combines that are commutative AND associative on the value
# domains the apps use, so a scatter with duplicate targets is
# order-free and therefore deterministic.
COMMUTATIVE_COMBINES = frozenset({"min", "max", "add"})


# sssp relaxation: dist[dst] = min(dist[dst], dist[src] + w)
SSSP_RELAX = Operator("sssp_relax", "push", "min",
                      lambda v, w: v + w)

# bfs: level[dst] = min(level[dst], level[src] + 1)
BFS_HOP = Operator("bfs_hop", "push", "min",
                   lambda v, w: v + 1, uses_weight=False,
                   wire_narrow=("uint16", "int8"))

# connected components: comp[dst] = min(comp[dst], comp[src])
CC_MIN = Operator("cc_min", "push", "min",
                  lambda v, w: v, uses_weight=False)

# kcore: when a vertex dies, its (symmetrized) neighbours lose a degree
KCORE_DEC = Operator("kcore_dec", "push", "add",
                     lambda v, w: torch.full_like(v, -1),
                     uses_weight=False, wire_narrow=("uint16",))

# pagerank (pull): acc[v] += contrib[u] for in-neighbours u
PR_PULL = Operator("pr_pull", "pull", "add",
                   lambda v, w: v, uses_weight=False)


# ``msg`` of each built-in operator as the fused relax kernels take it
# (``kernels/csrc/relax.cuh``, enum ``Msg``): the index is the enum value
MSG_KINDS = ("v+w", "v+1", "v", "-1")
_MSG_KIND = {SSSP_RELAX: 0, BFS_HOP: 1, CC_MIN: 2, KCORE_DEC: 3, PR_PULL: 2}

_PULL_TWINS: dict = {}
_PUSH_OF: dict = {}                   # pull twin -> its push operator


def has_msg_kind(op: Operator) -> bool:
    """Whether ``op`` (or, for a pull twin, its push operator) is in the
    table of :func:`msg_kind`."""
    return _PUSH_OF.get(op, op) in _MSG_KIND


def msg_kind(op: Operator) -> int:
    """The relax kernels' ``Msg`` value for ``op.msg`` (an index into
    :data:`MSG_KINDS`); a pull twin takes its push operator's.  Raises
    for an operator outside the table: the kernels cannot run an
    arbitrary ``msg`` callable."""
    kind = _MSG_KIND.get(_PUSH_OF.get(op, op))
    if kind is None:
        raise ValueError(f"operator {op.name!r} has no msg kind for the "
                         f"fused relax kernels (known: "
                         f"{sorted(o.name for o in _MSG_KIND)} and their "
                         f"pull twins)")
    return kind


def as_pull(op: Operator) -> Operator:
    """The pull twin of a push min-combine operator (memoized)."""
    if op.direction != "push" or op.combine != "min":
        raise ValueError(
            f"direction-optimized rounds need a push min-combine "
            f"operator; got {op.name} (direction={op.direction!r}, "
            f"combine={op.combine!r})")
    if op not in _PULL_TWINS:
        _PULL_TWINS[op] = Operator(op.name + "@pull", "pull",
                                   op.combine, op.msg, op.uses_weight,
                                   op.wire_narrow)
        _PUSH_OF[_PULL_TWINS[op]] = op
    return _PULL_TWINS[op]
