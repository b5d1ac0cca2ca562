"""Shared ``ast`` helpers for the lint rules.

The interesting piece is :func:`collect_capture_bindings`.  The port's
device control flow (``core.graph_loop``) takes functions three ways:

* ``graph_loop.run(owner, key, fn, *inputs)``: ``fn`` is captured once
  per ``key`` (and the inputs' shapes) on the card and replayed;
* ``graph_loop.while_(cond_fn, body_fn, carry)``;
* ``graph_loop.cond(pred, true_fn, false_fn)``.

Each function may be a lambda, a local def or a module def, and the
module may be imported under any alias (or the three functions by
name).  On CPU tensors the three run eagerly, so what a captured
function gets wrong (a Python branch on a tensor, a key that misses a
value it reads) shows only on the card; each site resolves, as far as
the AST allows, to a :class:`CaptureBinding`, which the capture purity
(``jit-purity``) and capture key (``static-argnames``) rules consume.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

#: attribute accesses (and method calls) on a tensor that yield
#: *static* metadata, known without reading the device: branching on
#: these is capture-safe (``if labels.ndim == 2:``,
#: ``x.device.type == "cpu"``, ``x.size(0)``, ``x.numel()``)
STATIC_ATTRS = {"ndim", "shape", "dtype", "size", "itemsize", "device",
                "is_cuda", "numel", "dim", "element_size", "data_ptr"}
#: builtins whose result is static Python whatever they are given
STATIC_CALLS = {"len", "isinstance"}

#: ``torch.*`` names that are host metadata, not tensors
_TORCH_STATIC = {"torch.device", "torch.Size", "torch.dtype",
                 "torch.iinfo", "torch.finfo", "torch.is_tensor",
                 "torch.get_default_dtype", "torch.Tensor"}
_TORCH_STATIC_PREFIX = ("torch.cuda.", "torch.backends.",
                        "torch.version.", "torch.distributed.",
                        "torch.utils.")
#: dtype names (``torch.int32``, ``torch.bool`` ...): static values
_DTYPE_NAMES = {
    "bool", "uint8", "int8", "int16", "int32", "int64", "uint16",
    "uint32", "uint64", "float16", "bfloat16", "float32", "float64",
    "half", "float", "double", "short", "int", "long", "complex64",
    "complex128", "cfloat", "cdouble"}
#: methods only a tensor has, whose result is a tensor (or, for
#: ``.numpy()``, an array just fetched from one)
TENSOR_METHODS = {"cpu", "cuda", "numpy", "to"}

#: the three primitives of ``core.graph_loop`` and the positions of
#: the functions each takes
CAPTURE_ROLES: Dict[str, Tuple[Tuple[int, str], ...]] = {
    "run": ((2, "fn"),),
    "while_": ((0, "cond_fn"), (1, "body_fn")),
    "cond": ((1, "true_fn"), (2, "false_fn")),
}
GRAPH_LOOP_MODULE = "graph_loop"

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted(node: ast.AST) -> Optional[str]:
    """Dotted name of a ``Name``/``Attribute`` chain, else ``None``.

    ``torch.any`` -> ``"torch.any"``; anything with a non-name base
    (calls, subscripts) -> ``None``.
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _static_torch(name: str) -> bool:
    return (name in _TORCH_STATIC or name.startswith(_TORCH_STATIC_PREFIX)
            or (name.count(".") == 1
                and name.split(".")[1] in _DTYPE_NAMES))


def contains_torch(node: ast.AST) -> bool:
    """Whether the expression syntactically produces or consumes a
    tensor: a ``torch.*`` reference (dtypes, devices and other host
    metadata excepted) or a tensor-only method call (``.cpu()``,
    ``.cuda()``, ``.numpy()``, ``.to(...)``)."""
    d = dotted(node)
    if d is not None:
        return ((d == "torch" or d.startswith("torch."))
                and not _static_torch(d))
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in TENSOR_METHODS):
        return True
    return any(contains_torch(c) for c in ast.iter_child_nodes(node))


def is_none_comparison(node: ast.AST) -> bool:
    """``x is None`` / ``x is not None`` — static structure checks
    that are safe on captured values (``None`` is never a tensor)."""
    return (isinstance(node, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in node.ops))


def references_names(node: ast.AST, names: Set[str]) -> bool:
    """Whether ``node`` reads any of ``names`` in a *traced* position.

    Reads reached only through static metadata (``x.ndim``,
    ``x.shape``, ``x.device``, ``x.numel()``, ``x.data_ptr()``...),
    ``len()``, ``isinstance()`` or an ``is None`` comparison do not
    count: those are capture-safe.
    """
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return False
    if is_none_comparison(node):
        return False
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in STATIC_CALLS):
        return False  # len() / isinstance() of anything is static Python
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                         ast.DictComp)):
        # iterating a pack of tensors takes a static number of steps:
        # the result is traced only where what it keeps is
        inner = set(names)
        for gen in node.generators:
            if references_names(gen.iter, inner):
                target_names(gen.target, inner)
        parts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                 else [node.elt])
        parts += [c for gen in node.generators for c in gen.ifs]
        return any(references_names(p, inner) for p in parts)
    return any(references_names(child, names)
               for child in ast.iter_child_nodes(node))


def param_names(fn: ast.AST) -> List[str]:
    """All parameter names of a function def or lambda, in order."""
    a = fn.args
    params = [p.arg for p in
              getattr(a, "posonlyargs", []) + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


def own_scope(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes evaluated in ``fn``'s own scope: its body, without the
    bodies of nested defs, lambdas and classes (those nodes themselves
    are yielded, and their defaults and decorators walked, since those
    run in ``fn``)."""
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    stack = list(reversed(body))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPES + (ast.ClassDef,)):
            outer = list(getattr(node, "decorator_list", []))
            if not isinstance(node, ast.ClassDef):
                outer += node.args.defaults + [
                    d for d in node.args.kw_defaults if d is not None]
            stack.extend(reversed(outer))
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def target_names(t: ast.AST, out: Set[str]) -> None:
    """Add the names an assignment target binds to ``out``."""
    # only true bindings: a subscript/attribute store mutates an
    # existing object, it does not bind the root name
    if isinstance(t, ast.Name):
        out.add(t.id)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for el in t.elts:
            target_names(el, out)
    elif isinstance(t, ast.Starred):
        target_names(t.value, out)


def names_bound_by(nodes) -> Set[str]:
    """Names the given statements and expressions bind (not walked
    into: pass ``ast.walk(node)`` for everything under ``node``)."""
    out: Set[str] = set()
    for sub in nodes:
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                target_names(t, out)
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign,
                              ast.For, ast.AsyncFor, ast.NamedExpr)):
            target_names(sub.target, out)
        elif isinstance(sub, ast.comprehension):
            target_names(sub.target, out)
        elif isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if item.optional_vars is not None:
                    target_names(item.optional_vars, out)
        elif isinstance(sub, (ast.Import, ast.ImportFrom)):
            for a in sub.names:
                out.add((a.asname or a.name).split(".")[0])
        elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            out.add(sub.name)
    return out


def assigned_names(node: ast.AST) -> Set[str]:
    """Names bound anywhere inside ``node`` (assignments, loop and
    ``with`` targets, comprehensions, local defs)."""
    return names_bound_by(ast.walk(node))


def local_names(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn``'s own scope: its parameters and what its
    body assigns, not what nested scopes do."""
    return set(param_names(fn)) | names_bound_by(own_scope(fn))


def free_names(fn: ast.AST) -> Set[str]:
    """Names ``fn`` (or a scope nested in it) reads but does not bind:
    what it takes from enclosing functions, the module or builtins."""
    reads: Set[str] = set()
    for node in own_scope(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            reads.add(node.id)
        elif isinstance(node, _SCOPES):
            reads |= free_names(node)
    return reads - local_names(fn)


def module_level_names(tree: ast.AST) -> Set[str]:
    """Names assigned at module top level (mutable-global candidates)."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        out.add(sub.id)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(stmt.target, ast.Name):
                out.add(stmt.target.id)
    return out


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost ``Name`` of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


class Scopes:
    """Lexical lookups over one module: the functions enclosing a node,
    and the def a name refers to there."""

    def __init__(self, tree: ast.AST) -> None:
        self.tree = tree
        self.parent: Dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[id(child)] = node
        self.module_defs: Dict[str, ast.AST] = {
            s.name: s for s in tree.body if isinstance(s, _DEFS)}

    def enclosing(self, node: ast.AST) -> List[ast.AST]:
        """Functions and lambdas around ``node``, innermost first."""
        out = []
        cur = self.parent.get(id(node))
        while cur is not None:
            if isinstance(cur, _SCOPES):
                out.append(cur)
            cur = self.parent.get(id(cur))
        return out

    def binder(self, name: str, node: ast.AST) -> Optional[ast.AST]:
        """The innermost function around ``node`` that binds ``name``
        (None: a module global or a builtin)."""
        for fn in self.enclosing(node):
            if name in local_names(fn):
                return fn
        return None

    def resolve_def(self, name: str, node: ast.AST) -> Optional[ast.AST]:
        """The def that ``name`` refers to at ``node``: a def in an
        enclosing function's own scope, else a module-level def.  None
        when it is bound some other way (a parameter, an assignment, an
        import) or not at all."""
        fn = self.binder(name, node)
        if fn is None:
            return self.module_defs.get(name)
        for sub in own_scope(fn):
            if isinstance(sub, _DEFS) and sub.name == name:
                return sub
        return None

    def is_local_def(self, fn: ast.AST) -> bool:
        """Whether ``fn`` is defined inside another function."""
        return bool(self.enclosing(fn))


@dataclasses.dataclass
class CaptureBinding:
    """One function handed to a ``graph_loop`` primitive, resolved as
    far as the AST allows."""

    func: Optional[ast.AST]
    """The ``FunctionDef`` or ``Lambda``, if it is in this module."""

    func_name: str
    """Name it was referenced by (``<lambda>`` for a lambda)."""

    kind: str
    """The primitive: ``"run"``, ``"while_"`` or ``"cond"``."""

    role: str
    """Which argument: ``fn``, ``cond_fn``, ``body_fn``, ``true_fn``
    or ``false_fn``."""

    call: ast.Call
    """The primitive's call."""


def graph_loop_aliases(tree: ast.AST) -> Tuple[Set[str], Dict[str, str]]:
    """``(modules, functions)``: the dotted names the module binds to
    ``graph_loop`` (``from . import graph_loop as gl`` -> ``gl``), and
    names bound to its primitives (``from .graph_loop import while_``)
    mapped to the primitive."""
    modules: Set[str] = set()
    funcs: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            last = (node.module or "").split(".")[-1]
            for a in node.names:
                if a.name == GRAPH_LOOP_MODULE:
                    modules.add(a.asname or a.name)
                elif last == GRAPH_LOOP_MODULE and a.name in CAPTURE_ROLES:
                    funcs[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] == GRAPH_LOOP_MODULE:
                    modules.add(a.asname or a.name)
    return modules, funcs


def capture_primitive(call: ast.Call, modules: Set[str],
                      funcs: Dict[str, str]) -> Optional[str]:
    """Which ``graph_loop`` primitive ``call`` calls, if any."""
    f = call.func
    if isinstance(f, ast.Name):
        return funcs.get(f.id)
    if (isinstance(f, ast.Attribute) and f.attr in CAPTURE_ROLES
            and dotted(f.value) in modules):
        return f.attr
    return None


def collect_capture_bindings(tree: ast.AST,
                             scopes: Optional[Scopes] = None
                             ) -> List[CaptureBinding]:
    """Every function handed to ``graph_loop.run`` / ``while_`` /
    ``cond`` in the module (see module doc)."""
    modules, funcs = graph_loop_aliases(tree)
    if not modules and not funcs:
        return []
    scopes = scopes or Scopes(tree)
    out: List[CaptureBinding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        kind = capture_primitive(node, modules, funcs)
        if kind is None:
            continue
        for pos, role in CAPTURE_ROLES[kind]:
            if pos >= len(node.args):
                continue
            arg = node.args[pos]
            if isinstance(arg, ast.Lambda):
                out.append(CaptureBinding(arg, "<lambda>", kind, role,
                                          node))
            elif isinstance(arg, ast.Name):
                out.append(CaptureBinding(
                    scopes.resolve_def(arg.id, node), arg.id, kind, role,
                    node))
    return out
