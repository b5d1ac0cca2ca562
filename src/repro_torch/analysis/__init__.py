"""Static analysis for the port's structural invariants.

A stdlib-``ast`` lint framework (no dependencies; it imports neither
torch, nor jax, nor the JAX package) that turns the port's runtime
disciplines — fused rounds pay zero host syncs, a captured program
never replays stale on a Python value, served arrays are frozen before
they are shared, executor scatters are order-free — into checked
program structure.  See DESIGN.md section 12.  It keeps the JAX
package's seven rule ids, finding format and pragma grammar; the rules
read torch and ``core.graph_loop`` captures where the JAX package's
read ``jnp`` and ``jax.jit``.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis --check src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --check --relaxed tests/

Findings print as ``file:line rule-id message``.  Suppress a single
line with ``# repro: allow[<rule>] -- <justification>``; grandfather
legacy findings in ``baseline.txt`` beside this module (never for
``src/repro_torch/core`` or ``src/repro_torch/serve``).
"""
from .baseline import (PROTECTED_PREFIXES, apply_baseline,
                       load_baseline, protected_violations,
                       render_baseline)
from .findings import Finding
from .linter import (FileContext, Session, analyze_paths,
                     analyze_source, iter_python_files)
from .pragmas import parse_pragmas
from .registry import Rule, all_rules, get_rules, register_rule, rule_ids

__all__ = [
    "Finding", "Rule", "Session", "FileContext",
    "analyze_source", "analyze_paths", "iter_python_files",
    "all_rules", "get_rules", "register_rule", "rule_ids",
    "parse_pragmas",
    "load_baseline", "apply_baseline", "render_baseline",
    "protected_violations", "PROTECTED_PREFIXES",
]
