"""``publish-freeze``: arrays become shared state only via freeze().

The serve layer publishes ndarrays into aliased, long-lived
structures: ``ResultCache`` entries (shared by every cache hit and
coalesced follower), ``q.result`` (returned verbatim from
``poll()``), and ``ServiceStats`` fields.  A writable array published
there lets one caller corrupt every other caller's answer — a bug
class this repo has already shipped and re-fixed once.  Every value
stored into those sinks must flow through
:func:`repro_torch.serve.publish.freeze` (which calls
``setflags(write=False)``) first: either the stored expression is a
``freeze(...)`` call, or it is a name that was frozen earlier in the
same function (``x = freeze(x)`` / ``x.setflags(write=False)``).  A
tensor fetched to the host (``t.cpu().numpy()``) is an ndarray like any
other: it is frozen before it is published too.
"""
from __future__ import annotations

import ast
from typing import List, Set

from .. import astutil
from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "publish-freeze"

_FREEZE_FNS = {"freeze"}
_ARRAYISH = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
             "np.copy", "numpy.copy"}


def _is_freeze_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (astutil.dotted(node.func) or "").split(".")[-1]
            in _FREEZE_FNS)


def _frozen_names(fn: ast.AST) -> Set[str]:
    """Names frozen somewhere in ``fn``: ``x = freeze(...)``,
    ``freeze(x)``, or ``x.setflags(write=False)``."""
    frozen: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_freeze_call(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    frozen.add(t.id)
        if isinstance(node, ast.Call):
            if _is_freeze_call(node):
                for a in node.args:
                    if isinstance(a, ast.Name):
                        frozen.add(a.id)
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "setflags"
                    and isinstance(node.func.value, ast.Name)):
                frozen.add(node.func.value.id)
    return frozen


def _value_ok(value: ast.AST, frozen: Set[str]) -> bool:
    """Whether a published value is provably frozen (or array-free)."""
    if _is_freeze_call(value):
        return True
    if isinstance(value, ast.Name):
        return value.id in frozen
    if isinstance(value, ast.Constant):
        return True  # None / scalars
    if isinstance(value, (ast.Tuple, ast.List)):
        return all(_value_ok(el, frozen) for el in value.elts)
    if isinstance(value, ast.IfExp):
        return (_value_ok(value.body, frozen)
                and _value_ok(value.orelse, frozen))
    return False


def _is_cache_sink(target: ast.AST) -> bool:
    # self._entries[...] = ...  (ResultCache storage dict)
    if isinstance(target, ast.Subscript):
        return (astutil.dotted(target.value) or "").endswith(
            "._entries")
    return False


def _is_result_sink(target: ast.AST) -> bool:
    # q.result = ... (what poll() hands back)
    return isinstance(target, ast.Attribute) \
        and target.attr == "result"


def _is_stats_sink(target: ast.AST, value: ast.AST) -> bool:
    # an ndarray-producing expression stored on a *stats attribute
    if not isinstance(target, ast.Attribute):
        return False
    d = astutil.dotted(target) or ""
    if ".stats." not in "." + d + ".":
        owner = astutil.dotted(target.value) or ""
        if not owner.endswith("stats"):
            return False
    for node in ast.walk(value):
        if isinstance(node, ast.Call):
            fd = astutil.dotted(node.func) or ""
            if fd in _ARRAYISH or fd.endswith(".copy") or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "numpy"):
                return True  # .numpy() ends a .cpu().numpy() fetch
    return False


def check(ctx) -> List[Finding]:
    """Run the publish-freeze pass over one file (serve/ only)."""
    if not ctx.in_dir("repro_torch", "serve"):
        return []
    out: List[Finding] = []
    fns = [n for n in ast.walk(ctx.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in fns:
        frozen = _frozen_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                sink = None
                if _is_cache_sink(target):
                    sink = "ResultCache entry"
                elif _is_result_sink(target):
                    sink = "poll() result"
                elif _is_stats_sink(target, node.value):
                    sink = "ServiceStats field"
                if sink is None:
                    continue
                if not _value_ok(node.value, frozen):
                    out.append(ctx.finding(
                        node, RULE_ID,
                        f"{sink} published without freeze(): shared "
                        f"ndarrays must pass through "
                        f"repro_torch.serve.publish.freeze "
                        f"(setflags(write=False)) first"))
    return out


register_rule(Rule(
    id=RULE_ID,
    description="ndarrays stored into ResultCache / poll() results / "
                "ServiceStats must flow through the freeze() helper",
    check=check,
))
