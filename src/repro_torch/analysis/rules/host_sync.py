"""``host-sync``: blocking device->host transfers must be registered.

``.cpu()`` and ``.numpy()`` on anything, ``.item()`` on anything not
built by numpy, ``.tolist()``, ``int()``/``bool()``/``float()`` and
``np.asarray()``/``np.array()`` on a torch expression (or on a local
that was assigned one), and ``torch.cuda.synchronize()`` or a stream's
or event's ``.synchronize()``, each blocks the host until the card
catches up: the per-round round-trip that fused mode exists to remove.
On a CPU tensor none of them waits for anything, but the lint is
structural: the same line runs on the card.  Inside
``src/repro_torch/core`` and ``src/repro_torch/serve`` every such sync
must be a *registered* transfer: the enclosing statement (or an
adjacent one in the same block) calls ``_note_host_transfer(...)``, so
the ``host_transfers`` counter and this lint's allowlist are literally
the same lines.  Intentional one-time syncs (pre-loop seeding, set-up,
timing fences) carry a ``# repro: allow[host-sync] -- why`` pragma
instead.
"""
from __future__ import annotations

import ast
import copy
from typing import List, Set

from .. import astutil
from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "host-sync"

#: the instrumentation hook (``core/balancer.py``) — a statement
#: adjacent to a call of this is a registered transfer site
NOTE_NAME = "_note_host_transfer"

_SYNC_BUILTINS = {"int", "bool", "float"}
_ASARRAY = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_FETCH_ALWAYS = {"cpu", "numpy"}
#: calls whose result is host data: each is flagged where it is, and
#: what it returns taints nothing
_FETCHES = {"cpu", "numpy", "tolist", "item"}


class _HostFetches(ast.NodeTransformer):
    """Replaces each fetch call by a constant (its result is host data)."""

    def visit_Call(self, node):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _FETCHES):
            return ast.copy_location(ast.Constant(value=None), node)
        return self.generic_visit(node)


def _host_view(expr: ast.AST) -> ast.AST:
    return _HostFetches().visit(copy.deepcopy(expr))


def _is_note_stmt(stmt: ast.stmt) -> bool:
    if not isinstance(stmt, ast.Expr):
        return False
    call = stmt.value
    return (isinstance(call, ast.Call)
            and (astutil.dotted(call.func) or "").split(".")[-1]
            == NOTE_NAME)


def _propagates_taint(value: ast.AST, tainted: Set[str]) -> bool:
    """Whether assigning ``value`` taints its targets: the expression
    syntactically builds a tensor, or aliases/slices an
    already-tainted name.  What a fetch (``.cpu()``, ``.numpy()``,
    ``.tolist()``, ``.item()``) returns is host data: the fetch is
    flagged where it is, and its result taints nothing.  A user
    *function call* over tainted names
    does NOT propagate — its result type is unknowable statically, and
    the round primitives deliberately return host-side data (e.g.
    ``relax_round(..., return_active=True)``) whose transfer is
    already accounted inside the callee."""
    value = _host_view(value)
    if astutil.contains_torch(value):
        return True
    if isinstance(value, ast.Call):
        return False
    if any(isinstance(sub, ast.Call) and not astutil.contains_torch(sub)
           for sub in ast.walk(value)):
        # e.g. `x = f(tainted) + 1`: be conservative only about the
        # non-call parts
        stripped = [sub for sub in ast.iter_child_nodes(value)
                    if not isinstance(sub, ast.Call)]
        return any(astutil.references_names(sub, tainted)
                   for sub in stripped)
    return astutil.references_names(value, tainted)


def _walk_scope(scope: ast.AST):
    """Walk ``scope`` without descending into nested function/class
    defs — those are their own taint scopes (a nested captured body
    reusing a name must not taint the enclosing driver's)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _torch_tainted_names(scope: ast.AST) -> Set[str]:
    """Locals assigned (directly or transitively) from torch
    expressions within ``scope`` — flow-insensitive fixpoint."""
    tainted: Set[str] = set()
    assigns = []
    for node in _walk_scope(scope):
        if isinstance(node, ast.Assign):
            assigns.append((node.targets, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            assigns.append(([node.target], node.value))
    for _ in range(4):  # bounded fixpoint for chained assignments
        changed = False
        for targets, value in assigns:
            if _propagates_taint(value, tainted):
                bound: Set[str] = set()
                for t in targets:
                    astutil.target_names(t, bound)
                if not bound <= tainted:
                    tainted |= bound
                    changed = True
        if not changed:
            break
    return tainted


def _numpy_built(expr: ast.AST) -> bool:
    return any((astutil.dotted(sub) or "").startswith(("np.", "numpy."))
               for sub in ast.walk(expr))


def _sync_calls(stmt_expr: ast.AST, tainted: Set[str]):
    """Yield ``(node, what)`` for blocking syncs in an expression."""
    inner = set()       # the .cpu() of a .cpu().numpy(): one finding
    for node in ast.walk(stmt_expr):
        if not isinstance(node, ast.Call) or id(node) in inner:
            continue
        fd = astutil.dotted(node.func)
        if fd in _SYNC_BUILTINS and len(node.args) == 1:
            if _device_derived(node.args[0], tainted):
                yield node, f"{fd}() on a torch expression"
            continue
        if fd in _ASARRAY and node.args:
            if _device_derived(node.args[0], tainted):
                yield node, f"{fd}() on a torch expression"
            continue
        if fd == "torch.cuda.synchronize":
            yield node, "torch.cuda.synchronize()"
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        attr, recv = node.func.attr, node.func.value
        if attr in _FETCH_ALWAYS and not node.args:
            what = f".{attr}()"
            if (attr == "numpy" and isinstance(recv, ast.Call)
                    and isinstance(recv.func, ast.Attribute)
                    and recv.func.attr == "cpu"):
                inner.add(id(recv))
                what = ".cpu().numpy()"
            yield node, what
        elif attr == "item" and not node.args:
            if not _numpy_built(recv):
                yield node, ".item()"
        elif attr == "tolist" and not node.args:
            if _device_derived(recv, tainted):
                yield node, ".tolist() on a torch expression"
        elif attr == "synchronize":
            yield node, ".synchronize() on a stream or event"


def _device_derived(expr: ast.AST, tainted: Set[str]) -> bool:
    expr = _host_view(expr)
    return (astutil.contains_torch(expr)
            or astutil.references_names(expr, tainted))


def _child_blocks(stmt: ast.stmt):
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if block:
            yield block
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body


def _header_exprs(stmt: ast.stmt):
    """Expressions evaluated *by* a statement, excluding nested
    statement blocks (those get their own adjacency context)."""
    if isinstance(stmt, (ast.If, ast.While)):
        yield stmt.test
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        yield stmt.iter
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            yield item.context_expr
    elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        return  # nested scope: walked separately
    elif isinstance(stmt, ast.Try):
        return  # only blocks
    else:
        yield stmt


def _walk_block(block, tainted, out, ctx):
    noted_idx = {i for i, s in enumerate(block) if _is_note_stmt(s)}
    for i, stmt in enumerate(block):
        noted = bool(noted_idx & {i - 1, i, i + 1})
        for expr in _header_exprs(stmt):
            for node, what in _sync_calls(expr, tainted):
                if noted:
                    continue
                out.append(ctx.finding(
                    node, RULE_ID,
                    f"blocking host sync: {what} — register it with "
                    f"{NOTE_NAME}() on an adjacent line, or pragma "
                    f"an intentional one-time transfer"))
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # nested scope: visited with its own taint set
        for sub in _child_blocks(stmt):
            _walk_block(sub, tainted, out, ctx)


def check(ctx) -> List[Finding]:
    """Run the host-sync pass over one file (core/ and serve/ only)."""
    if not (ctx.in_dir("repro_torch", "core")
            or ctx.in_dir("repro_torch", "serve")):
        return []
    out: List[Finding] = []
    # each function scope gets its own taint set; module scope too
    scopes = [n for n in ast.walk(ctx.tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in scopes:
        tainted = _torch_tainted_names(fn)
        _walk_block(fn.body, tainted, out, ctx)
    module_stmts = [s for s in ctx.tree.body
                    if not isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef))]
    _walk_block(module_stmts, _torch_tainted_names(ast.Module(
        body=module_stmts, type_ignores=[])), out, ctx)
    # class bodies hold methods (already covered) — skip their
    # remaining statements (field defaults are rule-exempt)
    return out


register_rule(Rule(
    id=RULE_ID,
    description="blocking device->host syncs in core/ and serve/ "
                "must sit next to _note_host_transfer() or carry a "
                "justified pragma",
    check=check,
))
