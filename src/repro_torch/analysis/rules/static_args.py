"""``static-argnames``: a capture key must hold every value the captured
function reads.

``graph_loop.run(owner, key, fn, *inputs)`` captures ``fn`` once per
``key`` (and the inputs' shapes and dtypes) and replays that program
for every later call with an equal key.  A Python value that ``fn``
reads but the key omits is frozen at its first value: a call with a
different value replays a stale program, silently, and only on the
card (on CPU tensors ``run`` calls ``fn`` eagerly).  So every
*parameter of an enclosing function* that ``fn`` reads must appear in
``key``, be ``owner``, or reach ``fn`` as one of ``*inputs``.

This pass resolves ``key`` to a tuple literal, or to a name bound once
to one in an enclosing function, and ``fn`` to a lambda or a def,
following one level of call into a local def
(``lambda la: trav(graphs, la)``).  Locals of the enclosing functions
(values derived from the owner, say) are not parameters and are not
checked.  A key that is not a literal is a finding in itself when
``fn`` reads any such parameter (the check cannot verify it); an ``fn``
the AST cannot resolve is skipped, not guessed.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .. import astutil
from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "static-argnames"


def _literal(node: ast.AST) -> bool:
    return isinstance(node, (ast.Tuple, ast.Constant))


def _resolve_key(ctx, key: ast.AST, call: ast.Call) -> Optional[ast.AST]:
    """The key's tuple (or constant) literal, or None when it is not
    one."""
    if _literal(key):
        return key
    if not isinstance(key, ast.Name):
        return None
    fn = ctx.scopes.binder(key.id, call)
    if fn is None or key.id in astutil.param_names(fn):
        return None
    binds = [n for n in astutil.own_scope(fn)
             if key.id in astutil.names_bound_by([n])]
    if (len(binds) == 1 and isinstance(binds[0], ast.Assign)
            and len(binds[0].targets) == 1
            and _literal(binds[0].value)):
        return binds[0].value
    return None


def _names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _param_reads(ctx, fn: ast.AST) -> Set[str]:
    """Parameters of enclosing functions that ``fn`` reads."""
    out = set()
    for name, where in _reads(ctx, fn):
        binder = ctx.scopes.binder(name, where)
        if binder is not None and name in astutil.param_names(binder):
            out.add(name)
    return out


def _reads(ctx, fn: ast.AST):
    """``(name, where)`` for each free name of ``fn``, and of each local
    def it calls directly: ``where`` is the node to resolve the name
    from (the def that reads it)."""
    out = [(n, fn) for n in astutil.free_names(fn)]
    for node in astutil.own_scope(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
            callee = ctx.scopes.resolve_def(node.func.id, node)
            if (callee is not None and callee is not fn
                    and ctx.scopes.is_local_def(callee)):
                out += [(n, callee) for n in astutil.free_names(callee)]
    return out


def check(ctx) -> List[Finding]:
    """Run the capture key pass over one file."""
    out: List[Finding] = []
    for b in ctx.capture_bindings:
        if b.kind != "run" or len(b.call.args) < 3:
            continue
        if b.func is None:
            continue
        owner, key = b.call.args[0], b.call.args[1]
        read = _param_reads(ctx, b.func)
        tup = _resolve_key(ctx, key, b.call)
        if tup is None:
            if read:
                out.append(ctx.finding(
                    key, RULE_ID,
                    f"capture key of `{b.func_name}` is not a tuple "
                    f"literal (or a name bound once to one) — the check "
                    f"cannot verify that it holds "
                    f"{', '.join(sorted(read))}, which the captured "
                    f"function reads"))
            continue
        allowed = _names(tup) | _names(owner)
        for arg in b.call.args[3:]:
            allowed |= _names(arg)
        for name in sorted(read - allowed):
            out.append(ctx.finding(
                key, RULE_ID,
                f"capture key of `{b.func_name}` omits {name!r}, a "
                f"parameter the captured function reads — a call with "
                f"another value replays a stale program; add it to the "
                f"key or pass it as an input"))
    return out


register_rule(Rule(
    id=RULE_ID,
    description="a graph_loop.run capture key must hold every "
                "enclosing parameter the captured function reads (a "
                "missing one replays a stale program)",
    check=check,
    relaxed=True,
))
