"""``dtype-narrowing``: a narrowing cast in core/ must be a
declared-safe wire narrowing.

The wire codec layer (``core/wire.py``) ships sync payloads in narrow
dtypes only where an operator *declares* the narrowing exact for its
combine (``core.operators.Operator.wire_narrow``).  A narrowing cast
anywhere else in ``core/`` is how silent precision loss enters a label
path — an int32 hop count squeezed through ``uint8`` truncates without
any error.  This pass parses the ``wire_narrow=`` declarations from
``operators.py`` *statically* (AST only — the linter never imports
torch) and flags every cast in ``core/`` whose statically-known target
dtype is narrower than 32 bits and not in the declared union:
``.to(torch.uint8)`` / ``.to(dtype=...)`` / ``.type(...)``, the
shorthands ``.half()``, ``.bfloat16()``, ``.char()``, ``.byte()``,
``.short()``, and numpy's ``.astype(np.uint8)`` (or ``"uint8"``).
Dynamically-chosen dtypes (``.to(some_var)``) are the codec layer's
own dispatch and cannot be resolved statically; they are not flagged.
Justified exceptions carry a pragma:
``# repro: allow[dtype-narrowing] -- why``.
"""
from __future__ import annotations

import ast
import os
from typing import FrozenSet, List, Optional

from ..findings import Finding
from ..registry import Rule, register_rule

RULE_ID = "dtype-narrowing"

DECLARATION_KEYWORD = "wire_narrow"

#: dtype names narrower than the 32-bit label/payload word
NARROW_NAMES: FrozenSet[str] = frozenset({
    "int8", "uint8", "int16", "uint16", "float16", "bfloat16"})

#: torch's narrowing shorthands and the dtype each casts to
_SHORTHANDS = {"half": "float16", "bfloat16": "bfloat16", "char": "int8",
               "byte": "uint8", "short": "int16"}
#: torch's aliases of the narrow dtypes
_ALIASES = {"half": "float16", "short": "int16"}


def _parse_declarations(source: str) -> FrozenSet[str]:
    """The union of every ``wire_narrow=("...", ...)`` literal tuple
    passed to an ``Operator(...)`` call in operators.py."""
    declared: set = set()
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg != DECLARATION_KEYWORD:
                continue
            if isinstance(kw.value, (ast.Tuple, ast.List, ast.Set)):
                for el in kw.value.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        declared.add(el.value)
    return frozenset(declared)


def _declared_narrowings(ctx) -> FrozenSet[str]:
    """Locate and parse the nearest ``operators.py`` (cached per
    directory in the session); no registry found means NO narrowing
    is declared safe."""
    d = os.path.dirname(ctx.path)
    key = ("wire-narrow-registry", d)
    if key in ctx.session.memo:
        return ctx.session.memo[key]
    declared: FrozenSet[str] = frozenset()
    for rel in ("operators.py",
                os.path.join("..", "core", "operators.py"),
                os.path.join("..", "operators.py")):
        cand = os.path.normpath(os.path.join(d, rel))
        if os.path.isfile(cand):
            with open(cand, "r", encoding="utf-8") as fh:
                declared = _parse_declarations(fh.read())
            break
    ctx.session.memo[key] = declared
    return declared


def _static_dtype_name(node) -> Optional[str]:
    """The dtype name of a cast's argument when statically resolvable:
    ``torch.uint16`` / ``np.int8`` attributes, ``"uint16"`` string
    constants, or bare ``uint16`` names."""
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value
    elif isinstance(node, ast.Name):
        name = node.id
    else:
        return None
    return _ALIASES.get(name, name)


def _cast_targets(call: ast.Call):
    """Dtype names a cast call may cast to (static ones only)."""
    method = call.func.attr
    if method in _SHORTHANDS and not call.args and not call.keywords:
        return [_SHORTHANDS[method]]
    if method in ("to", "type", "astype"):
        args = list(call.args) + [kw.value for kw in call.keywords
                                  if kw.arg == "dtype"]
        return [_static_dtype_name(a) for a in args]
    return []


def check(ctx) -> List[Finding]:
    """Run the dtype-narrowing pass over one core/ file."""
    if not ctx.in_dir("core"):
        return []
    declared = _declared_narrowings(ctx)
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        for name in _cast_targets(node):
            if name is None or name not in NARROW_NAMES \
                    or name in declared:
                continue
            out.append(ctx.finding(
                node, RULE_ID,
                f"`.{node.func.attr}(...)` casts to {name}, below the "
                f"32-bit payload word, but {name!r} is not in any "
                f"operator's declared safe-narrowing set "
                f"({DECLARATION_KEYWORD}= in operators.py) — silent "
                f"truncation on a label path"))
            break
    return out


register_rule(Rule(
    id=RULE_ID,
    description="narrowing casts in core/ (.to, .type, .half, .byte, "
                ".astype ...) must be a wire_narrow-declared safe "
                "narrowing from operators.py",
    check=check,
))
