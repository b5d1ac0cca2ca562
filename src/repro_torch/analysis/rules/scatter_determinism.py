"""``scatter-determinism``: executor scatters need a registered
commutative-associative combine.

Executor code (``core/balancer.py``, ``core/scatter.py`` and
``kernels/``) scatters edge contributions with ``index_add_`` /
``scatter_add_`` / ``scatter_reduce_`` / ``index_reduce_`` where the
index holds duplicates — every frontier bin maps many edges onto the
same target vertex.  The result is deterministic only when the combine
is order-free, i.e. commutative and associative on the value domain
the apps use.  ``operators.py`` declares exactly which combines qualify
(``COMMUTATIVE_COMBINES``); this pass parses that registry *statically*
(AST only — the linter never imports torch) and flags any scatter whose
combine is unregistered: ``index_add(_)`` / ``scatter_add(_)`` combine
with ``add``; ``scatter_reduce(_)`` / ``index_reduce(_)`` with their
literal ``reduce`` (``sum``, ``amin``, ``amax``, ``prod``, ``mean`` map
to ``add``, ``min``, ``max``, ``mul``, ``mean``).  An overwrite —
``index_put(_)`` without ``accumulate=True``, ``scatter(_)`` without a
``reduce``, ``index_copy(_)`` — is last-writer-wins, which depends on
scatter order under duplicate indices, so each needs a pragma arguing
its indices are unique.
"""
from __future__ import annotations

import ast
import os
from typing import FrozenSet, List, Optional

from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "scatter-determinism"

REGISTRY_NAME = "COMMUTATIVE_COMBINES"

#: used when no operators.py registry can be located (e.g. fixture
#: trees) — deliberately minimal so the linkage is observable
DEFAULT_COMBINES: FrozenSet[str] = frozenset({"min", "max"})

#: ``reduce=`` spellings of the torch scatters, as combines
_REDUCE = {"sum": "add", "add": "add", "amin": "min", "amax": "max",
           "prod": "mul", "multiply": "mul", "mean": "mean"}
_ADD_METHODS = {"index_add", "index_add_", "scatter_add", "scatter_add_"}
_REDUCE_METHODS = {"scatter_reduce", "scatter_reduce_", "index_reduce",
                   "index_reduce_"}
_PUT_METHODS = {"index_put", "index_put_"}
_SET_METHODS = {"scatter", "scatter_", "index_copy", "index_copy_"}


def _parse_registry(source: str) -> FrozenSet[str]:
    """Extract ``COMMUTATIVE_COMBINES`` from operators.py source."""
    tree = ast.parse(source)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == REGISTRY_NAME
                   for t in stmt.targets):
            continue
        value = stmt.value
        if isinstance(value, ast.Call) and value.args:
            value = value.args[0]  # frozenset({...}) / set((...))
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            names = []
            for el in value.elts:
                if isinstance(el, ast.Constant) \
                        and isinstance(el.value, str):
                    names.append(el.value)
            return frozenset(names)
    return DEFAULT_COMBINES


def _combine_registry(ctx) -> FrozenSet[str]:
    """Locate and parse the nearest ``operators.py`` (cached per
    directory in the session); fall back to the default set."""
    d = os.path.dirname(ctx.path)
    key = ("scatter-registry", d)
    if key in ctx.session.memo:
        return ctx.session.memo[key]
    combines = DEFAULT_COMBINES
    for rel in ("operators.py",
                os.path.join("..", "core", "operators.py"),
                os.path.join("..", "operators.py")):
        cand = os.path.normpath(os.path.join(d, rel))
        if os.path.isfile(cand):
            with open(cand, "r", encoding="utf-8") as fh:
                combines = _parse_registry(fh.read())
            break
    ctx.session.memo[key] = combines
    return combines


def _in_scope(ctx) -> bool:
    path = ctx.path
    return (path.endswith(("/balancer.py", "/scatter.py"))
            or ctx.in_dir("kernels"))


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _combine(call: ast.Call, method: str) -> Optional[str]:
    """The combine a scatter call applies: a registry name, ``set`` for
    an overwrite, ``?`` for a ``reduce`` that is not a literal, or None
    when the call is no scatter."""
    if method in _ADD_METHODS:
        return "add"
    if method in _REDUCE_METHODS or method in _SET_METHODS:
        red = _kwarg(call, "reduce")
        if red is None and method in _REDUCE_METHODS and len(call.args) > 3:
            red = call.args[3]
        if red is None:
            return "set" if method in _SET_METHODS else "?"
        if isinstance(red, ast.Constant) and isinstance(red.value, str):
            return _REDUCE.get(red.value, red.value)
        return "?"
    if method in _PUT_METHODS:
        acc = _kwarg(call, "accumulate")
        if acc is None and len(call.args) > 2:
            acc = call.args[2]
        if isinstance(acc, ast.Constant) and acc.value is True:
            return "add"
        return "set"
    return None


def check(ctx) -> List[Finding]:
    """Run the scatter-determinism pass over one executor file."""
    if not _in_scope(ctx):
        return []
    combines = _combine_registry(ctx)
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        method = node.func.attr
        comb = _combine(node, method)
        if comb is None or comb in combines:
            continue
        if comb == "?":
            what = "its reduce is not a string literal"
        else:
            what = (f"combine {comb!r} is not registered commutative-"
                    f"associative in operators.py ({REGISTRY_NAME})")
        out.append(ctx.finding(
            node, RULE_ID,
            f"`.{method}` scatter: {what} — result depends on scatter "
            f"order under duplicate indices"))
    return out


register_rule(Rule(
    id=RULE_ID,
    description="executor scatters (index_add_, scatter_reduce_, "
                "index_put_ ...) must use a combine registered "
                "commutative-associative in operators.py",
    check=check,
))
