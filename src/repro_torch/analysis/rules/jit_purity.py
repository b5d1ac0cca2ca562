"""``jit-purity``: captured functions must be pure and capture-stable.

A function handed to ``graph_loop.run`` / ``while_`` / ``cond`` (any
of the forms in :mod:`repro_torch.analysis.astutil`) runs eagerly on
CPU tensors but is *recorded* on CUDA tensors: its Python runs once,
at capture, and the card replays what it recorded.  So inside it, and
inside every def of the same module it calls (followed transitively):

* Python ``if``/``while``/ternaries may not branch on captured values
  — a tensor parameter or a local derived from one or from a
  ``torch`` expression.  Every parameter of a function handed to
  ``graph_loop`` is a tensor (``graph_loop`` passes only tensors); a
  callee's parameter is captured where its argument is.  Branching on
  ``x.ndim`` / ``x.shape`` / ``x.dtype`` / ``x.device`` /
  ``x.numel()`` metadata, ``len()``, ``isinstance()``, ``x is None``
  or the emptiness of a ``*args`` pack is fine (all static at capture
  time).  Use ``graph_loop.cond`` /
  ``graph_loop.while_`` / ``torch.where``.
* ``print(...)`` fires once, at capture, not per replay.
* Mutating a module-level name (or declaring ``global``) bakes a
  capture-time side effect into a replayed program.
* Wall-clock / RNG calls (``time.*``, ``datetime.*``, ``random.*``,
  ``np.random.*``, ``uuid`` ...) are capture-time constants: the
  replay silently reuses the first value forever.

Calls the AST cannot resolve (methods, imports) are not followed.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .. import astutil
from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "jit-purity"

_NONDET_EXACT = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
}
_NONDET_PREFIX = ("random.", "np.random.", "numpy.random.")


def _traced_locals(fn: ast.AST, traced_params: Set[str]) -> Set[str]:
    """Locals derived from captured params or torch expressions
    (flow-insensitive fixpoint, includes nested defs)."""
    traced = set(traced_params)
    assigns = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            assigns.append((node.targets, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            assigns.append(([node.target], node.value))
    for _ in range(4):
        changed = False
        for targets, value in assigns:
            if astutil.contains_torch(value) or \
                    astutil.references_names(value, traced):
                bound: Set[str] = set()
                for t in targets:
                    astutil.target_names(t, bound)
                if not bound <= traced:
                    traced |= bound
                    changed = True
        if not changed:
            break
    return traced


def _packs(fn: ast.AST) -> Set[str]:
    """``*args`` / ``**kwargs`` names of ``fn`` and the scopes in it: a
    tuple or dict of tensors, whose truthiness (its length) is static."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for a in (node.args.vararg, node.args.kwarg):
                if a is not None:
                    out.add(a.arg)
    return out


def _test_is_traced(test: ast.AST, traced: Set[str],
                    packs: Set[str]) -> bool:
    if astutil.is_none_comparison(test):
        return False
    bare = test.operand if (isinstance(test, ast.UnaryOp)
                            and isinstance(test.op, ast.Not)) else test
    if isinstance(bare, ast.Name) and bare.id in packs:
        return False  # `if rows:` asks whether the pack is empty
    return astutil.references_names(test, traced)


def _arg_traced(arg: ast.AST, traced: Set[str]) -> bool:
    return astutil.contains_torch(arg) or \
        astutil.references_names(arg, traced)


def _callee_params(call: ast.Call, callee: ast.AST,
                   traced: Set[str]) -> Set[str]:
    """Parameters of ``callee`` that ``call`` passes a captured value."""
    a = callee.args
    positional = [p.arg for p in getattr(a, "posonlyargs", []) + a.args]
    names = set(astutil.param_names(callee))
    out: Set[str] = set()
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            if _arg_traced(arg.value, traced):
                out.update(positional[i:])
                if a.vararg:
                    out.add(a.vararg.arg)
            break
        if not _arg_traced(arg, traced):
            continue
        if i < len(positional):
            out.add(positional[i])
        elif a.vararg:
            out.add(a.vararg.arg)
    for kw in call.keywords:
        if kw.arg is None or not _arg_traced(kw.value, traced):
            continue
        if kw.arg in names:
            out.add(kw.arg)
        elif a.kwarg:
            out.add(a.kwarg.arg)
    return out


def _captured_functions(ctx) -> Dict[int, Tuple[ast.AST, str, Set[str]]]:
    """``id(def) -> (def, name, captured params)`` for every function
    handed to ``graph_loop`` and every same-module def those call,
    transitively (a fixpoint over the union of captured params)."""
    found: Dict[int, Tuple[ast.AST, str, Set[str]]] = {}
    work = [(b.func, b.func_name, set(astutil.param_names(b.func)))
            for b in ctx.capture_bindings if b.func is not None]
    while work:
        fn, name, params = work.pop()
        have = found.get(id(fn))
        if have is not None and params <= have[2]:
            continue
        params = params | (have[2] if have else set())
        found[id(fn)] = (fn, name, params)
        traced = _traced_locals(fn, params)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            callee = ctx.scopes.resolve_def(node.func.id, node)
            if callee is None or callee is fn:
                continue
            work.append((callee, callee.name,
                         _callee_params(node, callee, traced)))
    return found


def _check_fn(ctx, fn, fname, traced_params, module_names, out) -> None:
    params = set(astutil.param_names(fn))
    traced = _traced_locals(fn, traced_params)
    local_names = params | astutil.assigned_names(fn)
    packs = _packs(fn)
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While)):
            kw = "while" if isinstance(node, ast.While) else "if"
            if _test_is_traced(node.test, traced, packs):
                out.append(ctx.finding(
                    node, RULE_ID,
                    f"Python `{kw}` on a captured value inside "
                    f"`{fname}` — use graph_loop.cond/graph_loop.while_/"
                    f"torch.where, or pass a Python value"))
        elif isinstance(node, ast.IfExp):
            if _test_is_traced(node.test, traced, packs):
                out.append(ctx.finding(
                    node, RULE_ID,
                    f"ternary on a captured value inside `{fname}` — "
                    f"use torch.where/graph_loop.cond"))
        elif isinstance(node, ast.Call):
            fd = astutil.dotted(node.func) or ""
            if fd == "print":
                out.append(ctx.finding(
                    node, RULE_ID,
                    f"print() inside captured `{fname}` fires at "
                    f"capture time only"))
            elif fd in _NONDET_EXACT or \
                    fd.startswith(_NONDET_PREFIX):
                out.append(ctx.finding(
                    node, RULE_ID,
                    f"nondeterministic call {fd}() inside captured "
                    f"`{fname}` is frozen at capture time"))
        elif isinstance(node, ast.Global):
            out.append(ctx.finding(
                node, RULE_ID,
                f"`global` inside captured `{fname}`: capture-time side "
                f"effect on module state"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                root = astutil.root_name(t)
                if (root is not None and root in module_names
                        and root not in local_names
                        and not isinstance(t, ast.Name)):
                    out.append(ctx.finding(
                        node, RULE_ID,
                        f"mutation of module-level `{root}` inside "
                        f"captured `{fname}`: capture-time side effect"))


def check(ctx) -> List[Finding]:
    """Run the capture purity pass over one file."""
    out: List[Finding] = []
    module_names = astutil.module_level_names(ctx.tree)
    for fn, name, params in _captured_functions(ctx).values():
        _check_fn(ctx, fn, name, params, module_names, out)
    # a def reached along two paths, nested in another captured def,
    # reports each node once
    return sorted(set(out))


register_rule(Rule(
    id=RULE_ID,
    description="no Python control flow on captured tensors, print, "
                "global mutation, or wall-clock/RNG calls inside "
                "functions handed to graph_loop.run/while_/cond",
    check=check,
    relaxed=True,
))
