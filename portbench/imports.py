"""What the benchmark may not load: JAX and the JAX package.

Names are compared by their top-level part, whole: ``repro_torch`` is
the port and allowed, ``repro`` is the JAX package and is not.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
PORT = "repro_torch"
ROOT = Path(__file__).resolve().parents[1]


def tops(names) -> set:
    """The top-level names of dotted module names."""
    return {n.split(".", 1)[0] for n in names}


def forbidden(names) -> set:
    """The forbidden top-level names among ``names`` (module names, or a
    ``sys.modules``)."""
    return tops(names) & FORBIDDEN


def loaded(code: str, env=None) -> set:
    """Top-level names of every module a fresh interpreter holds after
    running ``code``, with the checkout's ``src`` and root on its path,
    as ``run.py`` sets them."""
    prog = (f"import sys\nsys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, env=env, timeout=600)
    return tops(json.loads(out.stdout.strip().splitlines()[-1]))
