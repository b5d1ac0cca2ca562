"""Port parity: the invariant lint (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``).

Four parts:

* the language-neutral pieces (pragma parsing, the finding format, the
  baseline file, ``bad-pragma``, the rule ids) give equal outputs from
  the two packages on the same inputs;
* a parity table: for each fixture of ``tests/test_analysis.py``, a
  torch twin of the same invariant gives, under ``repro_torch.analysis``,
  the same set of ``(line, rule)`` findings that the JAX fixture gives
  under ``repro.analysis`` (near-misses included), and both equal the
  pinned set;
* seeded regressions in real port files: each file is clean as
  committed and flagged by its rule once seeded;
* the CLI's exit codes and the import check (the port's lint imports
  neither torch, nor jax, nor the JAX package).

Both linters are stdlib-only; only the one case that runs a twin's code
on the CPU imports torch.
"""
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

import repro.analysis as J
import repro_torch.analysis as T
from repro.analysis.rules import dtype_narrowing as j_narrow
from repro.analysis.rules import scatter_determinism as j_scatter
from repro_torch.analysis.rules import dtype_narrowing as t_narrow
from repro_torch.analysis.rules import scatter_determinism as t_scatter

REPO = Path(__file__).resolve().parent.parent

J_CORE = "src/repro/core/somefile.py"
T_CORE = "src/repro_torch/core/somefile.py"
J_SERVE = "src/repro/serve/somefile.py"
T_SERVE = "src/repro_torch/serve/somefile.py"
J_KERNEL = "src/repro/kernels/somekernel.py"
T_KERNEL = "src/repro_torch/kernels/somekernel.py"
NO_TREE_BAL = "no/such/tree/core/balancer.py"
NO_TREE_WIRE = "no/such/tree/core/wire.py"


def lines_rules(findings):
    return {(f.line, f.rule) for f in findings}


def lint(pkg, source, path, **kw):
    return pkg.analyze_source(textwrap.dedent(source), path, **kw)


# ---------------------------------------------------------------------------
# language-neutral parts, compared directly

def test_rule_ids_equal():
    assert set(T.rule_ids()) == set(J.rule_ids())
    assert len(T.all_rules()) == len(J.all_rules()) == 7
    assert ({r.id for r in T.get_rules(relaxed=True)}
            == {r.id for r in J.get_rules(relaxed=True)}
            == {"jit-purity", "static-argnames", "bad-pragma"})


PRAGMA_SOURCES = [
    "x = 1  # repro: allow[host-sync] -- one-time seed\n",
    "x = 1  # repro: allow[host-sync, jit-purity] -- two at once\n",
    "x = 1  # repro: allow[host-sync]\n",
    "x = 1  # repro: allow[host-sync] --   \n",
    "x = 1  # repro: allow[] -- nothing\n",
    "x = 1  # repro: allow[no-such-rule] -- because\n",
    "x = 1  # repro: suppress host-sync\n",
    "x = 1  #repro:allow[dtype-narrowing]--tight spacing\n",
    'def f():\n    """# repro: allow[<rule>] -- in a docstring"""\n',
    "s = '# repro: allow[host-sync]'  # plain comment\n",
    "def broken(:\n  # repro: allow[host-sync] -- after a syntax error\n",
    "a = 1\nb = 2  # repro: allow[publish-freeze] -- line two\n",
]


@pytest.mark.parametrize("source", PRAGMA_SOURCES)
def test_parse_pragmas_equal(source):
    known = set(J.rule_ids())
    assert T.parse_pragmas(source, known) == J.parse_pragmas(source, known)


@pytest.mark.parametrize("source", PRAGMA_SOURCES)
def test_bad_pragma_findings_equal(source):
    (jr,) = [r for r in J.all_rules() if r.id == "bad-pragma"]
    (tr,) = [r for r in T.all_rules() if r.id == "bad-pragma"]
    path = "src/anywhere/mod.py"
    got = T.analyze_source(source, path, rules=[tr])
    want = J.analyze_source(source, path, rules=[jr])
    assert [f.format() for f in got] == [f.format() for f in want]


def test_finding_format_and_key_equal():
    args = dict(path="src/x/y.py", line=12, rule="host-sync",
                message="blocking host sync: .item()")
    t, j = T.Finding(**args), J.Finding(**args)
    assert t.format() == j.format() == (
        "src/x/y.py:12 host-sync blocking host sync: .item()")
    assert t.baseline_key == j.baseline_key
    more = [dict(args, line=3), dict(args, rule="bad-pragma"), args]
    assert ([(f.path, f.line, f.rule) for f in sorted(
        T.Finding(**a) for a in more)]
            == [(f.path, f.line, f.rule) for f in sorted(
                J.Finding(**a) for a in more)])


BASELINE_TEXT = (
    "# a comment\n"
    "\n"
    "src/repro_torch/models/a.py\tjit-purity\tprint() inside\n"
    "src/repro_torch/models/a.py\tjit-purity\tprint() inside\n"
    "src/repro/models/b.py\thost-sync\tblocking\n"
    "src/repro_torch/core/c.py\thost-sync\tgrandfathered\n"
    "src/repro/core/d.py\thost-sync\tgrandfathered\n")


def test_baseline_load_apply_render_equal(tmp_path):
    bl = tmp_path / "baseline.txt"
    bl.write_text(BASELINE_TEXT)
    tb, jb = T.load_baseline(bl), J.load_baseline(bl)
    assert tb == jb and sum(tb.values()) == 5
    rows = [("src/repro_torch/models/a.py", 3, "jit-purity",
             "print() inside"),
            ("src/repro_torch/models/a.py", 9, "jit-purity",
             "print() inside"),
            ("src/repro_torch/models/a.py", 20, "jit-purity",
             "print() inside"),
            ("src/repro/models/b.py", 1, "host-sync", "new")]
    tk = T.apply_baseline([T.Finding(*r) for r in rows], tb)
    jk = J.apply_baseline([J.Finding(*r) for r in rows], jb)
    assert [f.format() for f in tk[0]] == [f.format() for f in jk[0]]
    assert tk[1:] == jk[1:] == (2, sorted(
        k for k in jb if k[0] != "src/repro_torch/models/a.py"))

    def entries(text):
        return [ln for ln in text.splitlines() if not ln.startswith("#")]

    assert (entries(T.render_baseline([T.Finding(*r) for r in rows]))
            == entries(J.render_baseline([J.Finding(*r) for r in rows])))
    # each package protects its own engine and serving layer
    assert T.protected_violations(tb) == [
        "src/repro_torch/core/c.py\thost-sync\tgrandfathered"]
    assert J.protected_violations(jb) == [
        "src/repro/core/d.py\thost-sync\tgrandfathered"]
    bad = tmp_path / "bad.txt"
    bad.write_text("only\ttwo\n")
    for pkg in (T, J):
        with pytest.raises(ValueError, match="malformed baseline"):
            pkg.load_baseline(bad)
    assert T.load_baseline(tmp_path / "missing.txt") == Counter()


def test_registries_parse_the_same_declarations():
    t_ops = (REPO / "src/repro_torch/core/operators.py").read_text()
    j_ops = (REPO / "src/repro/core/operators.py").read_text()
    assert (t_scatter._parse_registry(t_ops)
            == j_scatter._parse_registry(j_ops) == {"min", "max", "add"})
    assert (t_narrow._parse_declarations(t_ops)
            == j_narrow._parse_declarations(j_ops) == {"uint16", "int8"})


# ---------------------------------------------------------------------------
# the parity table: JAX fixture and torch twin, one pinned finding set

# (id, jax source, jax path, torch source, torch path, pinned set)
HS, JP, SA = "host-sync", "jit-purity", "static-argnames"
PF, SD, DN, BP = ("publish-freeze", "scatter-determinism",
                  "dtype-narrowing", "bad-pragma")

PARITY = [
    ("format_host_sync", """
        import jax.numpy as jnp
        def probe(frontier):
            return bool(jnp.any(frontier))
    """, J_CORE, """
        import torch
        def probe(frontier):
            return bool(torch.any(frontier))
    """, T_CORE, {(4, HS)}),
    ("parse_error", "def broken(:\n", J_CORE, "def broken(:\n", T_CORE,
     {(1, "parse-error")}),
    ("host_sync_bool_any", """
        import jax.numpy as jnp
        def loop(frontier):
            while bool(jnp.any(frontier)):
                frontier = step(frontier)
    """, J_CORE, """
        import torch
        def loop(frontier):
            while bool(torch.any(frontier)):
                frontier = step(frontier)
    """, T_CORE, {(4, HS)}),
    ("host_sync_tainted_local", """
        import jax, jax.numpy as jnp
        def f(frontier):
            total = jnp.sum(frontier)
            a = int(total)
            b = total.item()
            c = jax.device_get(frontier)
            return a, b, c
    """, J_CORE, """
        import torch
        def f(frontier):
            total = torch.sum(frontier)
            a = int(total)
            b = total.item()
            c = frontier.cpu()
            return a, b, c
    """, T_CORE, {(5, HS), (6, HS), (7, HS)}),
    ("host_sync_near_miss", """
        import numpy as np
        def loop(g, frontier, cfg):
            new, st, active = _round(g, frontier, cfg)
            if not bool(np.any(active)):
                return new
            n = int(st.frontier_size)
            return new
    """, J_CORE, """
        import numpy as np
        def loop(g, frontier, cfg):
            new, st, active = _round(g, frontier, cfg)
            if not bool(np.any(active)):
                return new
            n = int(st.frontier_size)
            k = np.int64(n).item() + int(len(new))
            host = np.zeros(3)
            return new, int(host[0]), float(cfg.tol), k
    """, T_CORE, set()),
    ("host_sync_noted", """
        import jax.numpy as jnp
        def probe(frontier):
            _note_host_transfer()
            return bool(jnp.any(frontier))
    """, J_CORE, """
        import torch
        def probe(frontier):
            _note_host_transfer()
            return frontier.any().cpu().numpy()
    """, T_CORE, set()),
    ("host_sync_out_of_scope", """
        import jax.numpy as jnp
        def probe(frontier):
            return bool(jnp.any(frontier))
    """, "src/repro/models/layer.py", """
        import torch
        def probe(frontier):
            return bool(torch.any(frontier))
    """, "src/repro_torch/models/layer.py", set()),
    # the torch twin runs cleanly on the CPU (graph_loop is eager there)
    # yet replays wrong on the card: see test_flagged_case_runs_on_cpu
    ("jit_if_on_traced", """
        import jax
        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
    """, J_CORE, """
        from repro_torch.core import graph_loop
        def drain(fr, n):
            def body(fr, n):
                if fr.any():
                    n = n + 1
                return fr & (n < 3), n
            return graph_loop.while_(lambda fr, n: fr.any(), body, (fr, n))
    """, T_CORE, {(5, JP)}),
    ("jit_partial_application", """
        import jax
        from functools import partial
        def _impl(x, cfg):
            while x.sum() > 0:
                x = x - 1
            return x
        run = partial(jax.jit, static_argnames=("cfg",))(_impl)
    """, J_CORE, """
        from repro_torch.core import graph_loop as gl
        from functools import partial
        def _impl(x, cfg):
            while x.sum() > 0:
                x = x - 1
            return x
        run = lambda g, t, cfg: gl.run(g, ("i", cfg), lambda x: _impl(x, cfg), t)
    """, T_CORE, {(5, JP)}),
    ("jit_print_nondet_global", """
        import jax, time
        _CACHE = {}
        @jax.jit
        def f(x):
            print(x)
            t = time.time()
            _CACHE[0] = x
            return x + t
    """, J_CORE, """
        import time
        from repro_torch.core.graph_loop import run
        _CACHE = {}
        def f(x):
            print(x)
            t = time.time()
            _CACHE[0] = x
            return x + t
        out = run(owner, ("f",), f, x0)
    """, T_CORE, {(6, JP), (7, JP), (8, JP)}),
    ("jit_near_miss_static", """
        import jax, jax.numpy as jnp
        from functools import partial
        @partial(jax.jit, static_argnames=("cfg",))
        def f(x, cfg, acc):
            if cfg.direction == "push":
                x = x + 1
            if x.ndim == 2:
                x = x[0]
            if acc is None:
                acc = jnp.zeros_like(x)
            outs = (x, acc)
            return outs[0] if len(outs) == 1 else outs
        def host_loop(frontier):
            if frontier.any():
                return 1
            return 0
    """, J_CORE, """
        import torch
        from repro_torch.core import graph_loop
        def f(x, cfg, acc):
            if cfg.direction == "push":
                x = x + 1
            if x.ndim == 2:
                x = x[0]
            if acc is None:
                acc = torch.zeros_like(x)
            outs = (x, acc)
            if x.device.type == "cpu" and x.numel() > 0 and x.size(0) > 1:
                x = x + 0
            if isinstance(x, torch.Tensor) and x.dtype == torch.int32:
                x = x + 0
            ptrs = {t.data_ptr() for t in outs}
            if x.data_ptr() in ptrs and len(outs) == 2:
                x = x + 0
            return outs[0] if len(outs) == 1 else outs
        def host_loop(frontier):
            if frontier.any():
                return 1
            return 0
        def launch(g, x, cfg):
            return graph_loop.run(
                g, ("f", cfg), lambda x, *a: f(x, cfg, a[0] if a else None), x)
    """, T_CORE, set()),
    ("jit_kernel_defs", """
        import functools
        import jax.experimental.pallas as pl
        def _kernel(x_ref, o_ref, *, tile):
            if x_ref[0] > 0:
                o_ref[0] = x_ref[0]
        def launch(x, tile):
            kern = functools.partial(_kernel, tile=tile)
            return pl.pallas_call(kern, grid=(1,))(x)
    """, J_KERNEL, """
        from repro_torch.core import graph_loop as gl
        _cond = lambda x, o: x.any()
        def _body(x, o):
            if x[0] > 0:
                o = x
            return x - 1, o
        def launch(x, o):
            return gl.while_(_cond, _body, (x, o))
    """, T_KERNEL, {(5, JP)}),
    ("static_argnames_missing", """
        import jax
        from functools import partial
        def _impl(x, width, op):
            return x
        run = partial(jax.jit, static_argnames=("width", "opp"))(_impl)
    """, J_CORE, """
        from repro_torch.core import graph_loop
        def _impl(x, width, op):
            return x
        def launch(g, x, width, op):
            return graph_loop.run(g, ("l", width), lambda t: _impl(t, width, op), x)
    """, T_CORE, {(6, SA)}),
    ("static_argnames_matching", """
        import jax
        from functools import partial
        @partial(jax.jit, static_argnames=("width", "op"))
        def f(x, width, op):
            return x
        def _impl(y, cfg):
            return y
        g = jax.jit(_impl, static_argnames="cfg")
    """, J_CORE, """
        from repro_torch.core import graph_loop
        def launch(g, x, width, op):
            key = ("launch", width, op)
            return graph_loop.run(g, key, lambda t: _impl(t, width, op), x)
        def launch2(g, x, cfg):
            def trav(t):
                return t + cfg.offset
            return graph_loop.run(g, ("trav", cfg), lambda t: trav(t), x)
        def launch3(g, x, n):
            return graph_loop.run(g, "plain", lambda t, m: t * m, x, n)
        def launch4(g, x, k):
            rg = g.reverse(k)
            return graph_loop.run(g, ("rev",), lambda t: t + rg.n, x)
        def launch5(g, x, steps):
            steps = int(steps)
            return graph_loop.run(g, ("s", steps), lambda t: t * steps, x)
    """, T_CORE, set()),
    ("publish_unfrozen", """
        import numpy as np
        class Engine:
            def finish(self, q, labels):
                q.result = np.asarray(labels)
            def put(self, k, labels):
                self._entries[k] = labels
    """, J_SERVE, """
        import numpy as np
        class Engine:
            def finish(self, q, labels):
                q.result = labels.clone()
            def put(self, k, labels):
                self._entries[k] = labels
    """, T_SERVE, {(5, PF), (7, PF)}),
    ("publish_frozen", """
        import numpy as np
        from .publish import freeze
        class Engine:
            def finish(self, q, labels):
                labels = freeze(labels)
                q.result = labels
            def put(self, k, labels, region):
                labels.setflags(write=False)
                self._entries[k] = (labels, freeze(region))
            def reset(self, q):
                q.result = None
    """, J_SERVE, """
        import numpy as np
        from .publish import freeze
        class Engine:
            def finish(self, q, labels):
                labels = freeze(labels)
                q.result = labels
            def put(self, k, labels, region):
                labels.setflags(write=False)
                self._entries[k] = (labels, freeze(region))
            def reset(self, q):
                q.result = None
    """, T_SERVE, set()),
    ("publish_serve_only", """
        def f(q, labels):
            q.result = labels
    """, J_CORE, """
        def f(q, labels):
            q.result = labels
    """, T_CORE, set()),
    ("publish_serve_scope", """
        def f(q, labels):
            q.result = labels
    """, J_SERVE, """
        def f(q, labels):
            q.result = labels
    """, T_SERVE, {(3, PF)}),
    ("scatter_unregistered", """
        import jax.numpy as jnp
        def apply(labels, idx, vals):
            return labels.at[idx].add(vals)
    """, NO_TREE_BAL, """
        import torch
        def apply(labels, idx, vals):
            return labels.index_add(0, idx, vals)
    """, NO_TREE_BAL, {(4, SD)}),
    ("scatter_set", """
        def apply(labels, idx, vals):
            return labels.at[idx].set(vals)
    """, J_KERNEL, """
        def apply(labels, idx, vals):
            return labels.index_put_((idx,), vals)
    """, T_KERNEL, {(3, SD)}),
    ("scatter_out_of_scope", """
        def apply(labels, idx, vals):
            return labels.at[idx].set(vals)
    """, "src/repro/core/frontier.py", """
        def apply(labels, idx, vals):
            return labels.index_put_((idx,), vals)
    """, "src/repro_torch/core/frontier.py", set()),
    ("narrow_flagged", """
        import jax.numpy as jnp
        def pack(labels):
            return labels.astype(jnp.uint8)
    """, NO_TREE_WIRE, """
        import torch
        def pack(labels):
            return labels.to(torch.uint8)
    """, NO_TREE_WIRE, {(4, DN)}),
    ("narrow_string_dtype", """
        def pack(labels):
            return labels.astype("int16")
    """, NO_TREE_WIRE, """
        def pack(labels):
            return labels.short()
    """, NO_TREE_WIRE, {(3, DN)}),
    ("narrow_out_of_core", """
        import jax.numpy as jnp
        def quantize(g):
            return g.astype(jnp.int8)
    """, "src/repro/optim/grad_compress.py", """
        import torch
        def quantize(g):
            return g.to(torch.int8)
    """, "src/repro_torch/optim/grad_compress.py", set()),
    ("narrow_dynamic", """
        import jax.numpy as jnp
        def pack(labels, ndt):
            a = labels.astype(ndt)
            return labels.astype(jnp.int32)    # widening is fine
    """, NO_TREE_WIRE, """
        import torch
        def pack(labels, ndt, dev):
            a = labels.to(ndt).to(dev, non_blocking=True)
            return labels.to(dtype=torch.int32)    # widening is fine
    """, NO_TREE_WIRE, set()),
    ("narrow_pragma", """
        import jax.numpy as jnp
        def pack(labels):
            return labels.astype(jnp.uint8)  # repro: allow[dtype-narrowing] -- scratch buffer, not a label path
    """, NO_TREE_WIRE, """
        import torch
        def pack(labels):
            return labels.to(torch.uint8)  # repro: allow[dtype-narrowing] -- scratch buffer, not a label path
    """, NO_TREE_WIRE, set()),
    ("pragma_suppresses", """
        import jax.numpy as jnp
        def seed(frontier):
            return int(jnp.sum(frontier))  # repro: allow[host-sync] -- one-time seed
    """, J_CORE, """
        import torch
        def seed(frontier):
            return int(torch.sum(frontier))  # repro: allow[host-sync] -- one-time seed
    """, T_CORE, set()),
    ("pragma_no_justification", """
        import jax.numpy as jnp
        def seed(frontier):
            return int(jnp.sum(frontier))  # repro: allow[host-sync]
    """, J_CORE, """
        import torch
        def seed(frontier):
            return int(torch.sum(frontier))  # repro: allow[host-sync]
    """, T_CORE, {(4, BP), (4, HS)}),
    ("pragma_unknown_rule", """
        def f():
            return 1  # repro: allow[no-such-rule] -- because
    """, J_CORE, """
        def f():
            return 1  # repro: allow[no-such-rule] -- because
    """, T_CORE, {(3, BP)}),
    ("pragma_in_docstring", '''
        def f():
            """Suppress with `# repro: allow[<rule>] -- why`."""
            return 1
    ''', J_CORE, '''
        def f():
            """Suppress with `# repro: allow[<rule>] -- why`."""
            return 1
    ''', T_CORE, set()),
]


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_parity_table(case):
    _, j_src, j_path, t_src, t_path, pinned = case
    want = lines_rules(lint(J, j_src, j_path))
    got = lines_rules(lint(T, t_src, t_path))
    assert want == pinned
    assert got == want


def test_flagged_case_runs_on_cpu():
    """The ``jit_if_on_traced`` twin: on CPU tensors ``graph_loop`` runs
    it eagerly and it returns the right answer, so no CPU test catches
    it; only the lint does."""
    import torch
    (case,) = [c for c in PARITY if c[0] == "jit_if_on_traced"]
    scope = {}
    exec(textwrap.dedent(case[3]), scope)
    fr, n = scope["drain"](torch.ones(4, dtype=torch.bool),
                           torch.zeros((), dtype=torch.int32))
    assert not bool(fr.any()) and int(n) == 3
    assert lines_rules(lint(T, case[3], case[4])) == {(5, JP)}


REGISTRY_CASES = [
    ("scatter_registered", "operators.py",
     'COMMUTATIVE_COMBINES = frozenset({"min", "max", "add"})\n',
     "balancer.py", """
        import jax.numpy as jnp
        def apply(labels, idx, vals):
            a = labels.at[idx].add(vals)
            b = labels.at[idx].min(vals)
            return a, b
     """, """
        import torch
        def apply(labels, idx, vals):
            a = labels.index_add(0, idx, vals)
            b = labels.scatter_reduce(0, idx, vals, "amin")
            return a, b
     """, set()),
    ("narrow_declared", "core/operators.py",
     'Operator("bfs", wire_narrow=("uint16", "int8"))\n',
     "core/wire.py", """
        import jax.numpy as jnp
        def pack(labels):
            ok = labels.astype(jnp.uint16)      # declared
            also = labels.astype(jnp.int8)      # declared
            return labels.astype(jnp.uint8)     # NOT declared
     """, """
        import torch
        def pack(labels):
            ok = labels.to(torch.uint16)        # declared
            also = labels.char()                # declared
            return labels.byte()                # NOT declared
     """, {(6, DN)}),
]


@pytest.mark.parametrize("case", REGISTRY_CASES,
                         ids=[c[0] for c in REGISTRY_CASES])
def test_parity_registry_on_disk(tmp_path, case):
    """The registry linkage: an ``operators.py`` beside the file decides
    which combines and narrowings pass, in both packages alike."""
    _, reg_rel, reg_src, mod_rel, j_src, t_src, pinned = case
    sets = []
    for pkg, src in ((J, j_src), (T, t_src)):
        root = tmp_path / pkg.__name__
        reg, mod = root / reg_rel, root / mod_rel
        mod.parent.mkdir(parents=True, exist_ok=True)
        reg.write_text(reg_src)
        mod.write_text(textwrap.dedent(src))
        sets.append(lines_rules(pkg.analyze_paths([str(mod)])))
    assert sets[0] == sets[1] == pinned


# torch-only pins beside the twins
def test_capture_key_rule_messages_and_non_literal_key():
    findings = lint(T, """
        from repro_torch.core import graph_loop
        def launch(g, x, width, op):
            return graph_loop.run(g, ("l", width), lambda t: t + op, x)
        def launch2(g, x, cfg):
            key = make_key(cfg)
            return graph_loop.run(g, key, lambda t: t + cfg.bias, x)
        def launch3(g, x, cfg):
            key = ("a", cfg)
            key = key + ("b",)
            return graph_loop.run(g, key, lambda t: t * 2, x)
    """, T_CORE)
    assert [(f.line, f.rule) for f in findings] == [(4, SA), (7, SA)]
    assert "omits 'op'" in findings[0].message
    assert "not a tuple literal" in findings[1].message
    assert "cfg" in findings[1].message


def test_capture_bindings_resolve_every_form():
    from repro_torch.analysis import astutil
    import ast
    tree = ast.parse(textwrap.dedent("""
        import repro_torch.core.graph_loop as G
        from repro_torch.core.graph_loop import cond as branch
        def mod_body(x):
            return x
        def f(p, x):
            def local_body(x):
                return x
            G.while_(lambda x: x.any(), local_body, (x,))
            branch(p, lambda: x, mod_body)
            G.run(p, ("k",), mod_body, x)
            G.repeat(mod_body, x, 0, 3)
            G.run(p, ("k",), imported_fn, x)
    """))
    got = [(b.kind, b.role, b.func_name, type(b.func).__name__)
           for b in astutil.collect_capture_bindings(tree)]
    assert sorted(got) == sorted([
        ("while_", "cond_fn", "<lambda>", "Lambda"),
        ("while_", "body_fn", "local_body", "FunctionDef"),
        ("cond", "true_fn", "<lambda>", "Lambda"),
        ("cond", "false_fn", "mod_body", "FunctionDef"),
        ("run", "fn", "mod_body", "FunctionDef"),
        ("run", "fn", "imported_fn", "NoneType")])


def test_host_sync_torch_forms():
    findings = lint(T, """
        import torch
        import numpy as np
        def f(x, stream, ev):
            a = x.cpu()
            b = x.numpy()
            c = torch.sum(x).tolist()
            d = np.asarray(x.to(torch.float32))
            torch.cuda.synchronize()
            stream.synchronize()
            h = x.cpu().numpy()
            return float(h[0]) + int(x.shape[0]) + len(x)
    """, T_CORE)
    assert [(f.line, f.message.split(" — ")[0]) for f in findings] == [
        (5, "blocking host sync: .cpu()"),
        (6, "blocking host sync: .numpy()"),
        (7, "blocking host sync: .tolist() on a torch expression"),
        (8, "blocking host sync: np.asarray() on a torch expression"),
        (9, "blocking host sync: torch.cuda.synchronize()"),
        (10, "blocking host sync: .synchronize() on a stream or event"),
        (11, "blocking host sync: .cpu().numpy()")]


def test_scatter_torch_forms():
    findings = lint(T, """
        def f(out, idx, src, r):
            out.index_add_(0, idx, src)
            out.scatter_add_(0, idx, src)
            out.scatter_reduce_(0, idx, src, "amax", include_self=True)
            out.index_reduce_(0, idx, src, reduce="amin")
            out.index_put_((idx,), src, accumulate=True)
            out.scatter_reduce_(0, idx, src, "prod")
            out.index_reduce_(0, idx, src, r)
            out.index_copy_(0, idx, src)
            out.scatter_(0, idx, src)
            return out.index_put((idx,), src)
    """, T_KERNEL)
    assert [(f.line, f.message.split(":")[0]) for f in findings] == [
        (8, "`.scatter_reduce_` scatter"), (9, "`.index_reduce_` scatter"),
        (10, "`.index_copy_` scatter"), (11, "`.scatter_` scatter"),
        (12, "`.index_put` scatter")]
    assert "'mul'" in findings[0].message
    assert "not a string literal" in findings[1].message


def test_dtype_narrowing_torch_forms():
    findings = lint(T, """
        import numpy as np
        import torch
        def f(x, dt):
            a = x.half()
            b = x.bfloat16()
            c = x.type(torch.uint8)
            d = x.to(x.device, torch.int16)
            e = np.zeros(3).astype(np.uint8)
            return x.to(dt), x.to(torch.bool), x.float(), x.long()
    """, NO_TREE_WIRE)
    assert [(f.line, f.rule) for f in findings] == [
        (5, DN), (6, DN), (7, DN), (8, DN), (9, DN)]
    assert "float16" in findings[0].message


def test_publish_freeze_stats_fetch():
    findings = lint(T, """
        def step(self, t):
            self.stats.hist = t.cpu().numpy()
            self.stats.count = 3
    """, T_SERVE)
    # a fetch in serve/ is a host sync too, and an array to freeze
    assert [(f.line, f.rule) for f in findings] == [(3, HS), (3, PF)]


# ---------------------------------------------------------------------------
# seeded regressions in real port files

SEEDS = [
    ("src/repro_torch/core/apps/drivers.py",
     "        old = labels\n        new, st, active = relax_round(",
     "        old = labels\n        if not frontier.any().item():\n"
     "            break\n        new, st, active = relax_round(", HS),
    ("src/repro_torch/core/gluon.py",
     "        def body(r, lab, fr):\n            values = values_of(lab)\n",
     "        def body(r, lab, fr):\n            if fr.any():\n"
     "                lab = lab + 0\n            values = values_of(lab)\n",
     JP),
    ("src/repro_torch/core/balancer.py",
     '("fused", cfg, op, max_rounds, collect_stats)',
     '("fused", cfg, op, collect_stats)', SA),
    ("src/repro_torch/kernels/ops.py",
     "    return _relax.twc_bin_relax(values, labels,",
     "    labels.index_put_((bvidx,), bdeg)\n"
     "    return _relax.twc_bin_relax(values, labels,", SD),
    ("src/repro_torch/core/gluon.py",
     "return ((labels >= k).to(torch.int32),)",
     "return ((labels >= k).to(torch.uint8),)", DN),
    ("src/repro_torch/serve/engine.py",
     "        q.result = labels\n",
     "        q.result = labels.copy()\n", PF),
]


@pytest.mark.parametrize("seed", SEEDS, ids=[s[3] for s in SEEDS])
def test_seeded_regression_in_real_file(seed):
    rel, anchor, seeded, rule = seed
    path = REPO / rel
    src = path.read_text()
    assert src.count(anchor) == 1, anchor
    clean = T.analyze_source(src, str(path))
    assert clean == [], [f.format() for f in clean]
    flagged = T.analyze_source(src.replace(anchor, seeded), str(path))
    assert [f.rule for f in flagged] == [rule], \
        [f.format() for f in flagged]


def test_committed_baseline_is_empty():
    bl = T.load_baseline(REPO / "src/repro_torch/analysis/baseline.txt")
    assert T.protected_violations(bl) == []
    assert sum(bl.values()) == 0


def test_protected_prefixes_are_the_ports():
    assert T.PROTECTED_PREFIXES == ("src/repro_torch/core",
                                    "src/repro_torch/serve")
    bl = Counter({("src/repro_torch/core/balancer.py", "host-sync",
                   "x"): 1,
                  ("src/repro_torch/serve/fleet/router.py", "host-sync",
                   "x"): 1,
                  ("src/repro_torch/models/x.py", "jit-purity", "ok"): 1})
    assert len(T.protected_violations(bl)) == 2


# ---------------------------------------------------------------------------
# CLI and imports

def run_cli(*args, cwd=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd or REPO, env=env)


def test_cli_port_tree_is_clean():
    p = run_cli("--check", "src/repro_torch")
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip().splitlines()[-1] == (
        "OK: 0 findings (0 baselined) across 7 rule(s)")


def test_cli_relaxed_tests_tree_is_clean():
    p = run_cli("--check", "--relaxed", "tests/")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "across 3 rule(s)" in p.stdout


def test_cli_findings_exit_one_with_expected_format(tmp_path):
    f = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    f.parent.mkdir(parents=True)
    f.write_text("import torch\n"
                 "def probe(fr):\n"
                 "    return bool(torch.any(fr))\n")
    p = run_cli("--check", "--no-baseline", "src", cwd=tmp_path)
    assert p.returncode == 1
    assert "src/repro_torch/core/bad.py:3 host-sync" in p.stdout
    # a protected path may not be grandfathered
    bl = tmp_path / "bl.txt"
    bl.write_text("src/repro_torch/core/bad.py\thost-sync\tx\n")
    p = run_cli("--check", "--baseline", str(bl), "src", cwd=tmp_path)
    assert p.returncode == 1
    assert "protected path may not be grandfathered" in p.stderr


@pytest.mark.parametrize("args", [("--check", "no/such/dir"), ("--check",),
                                  ("--no-such-flag", "src")])
def test_cli_usage_errors_exit_two(args):
    p = run_cli(*args)
    assert p.returncode == 2
    if "no/such/dir" in args:
        assert "no such file" in p.stderr


def test_cli_help_and_list_rules_name_every_rule():
    for flag in ("--help", "--list-rules"):
        p = run_cli(flag)
        assert p.returncode == 0
        for rid in T.rule_ids():
            assert rid in p.stdout
    assert "python -m repro_torch.analysis" in run_cli("--help").stdout


def test_cli_relaxed_profile_drops_host_sync(tmp_path):
    f = tmp_path / "tests" / "test_x.py"
    f.parent.mkdir()
    f.write_text("import torch\n"
                 "def check(fr):\n"
                 "    assert bool(torch.any(fr))\n")
    strict = run_cli("--check", "--no-baseline", "tests", cwd=tmp_path)
    relaxed = run_cli("--check", "--relaxed", "--no-baseline", "tests",
                      cwd=tmp_path)
    assert relaxed.returncode == strict.returncode == 0
    assert "across 3 rule(s)" in relaxed.stdout
    assert "across 7 rule(s)" in strict.stdout


def test_cli_write_baseline_round_trip(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "models"
    pkg.mkdir(parents=True)
    (pkg / "legacy.py").write_text(
        "from repro_torch.core import graph_loop\n"
        "def f(x):\n    print(x)\n    return x\n"
        "y = graph_loop.run(o, ('f',), f, x0)\n")
    bl = str(tmp_path / "bl.txt")
    p1 = run_cli("--check", "--baseline", bl, "src", cwd=tmp_path)
    assert p1.returncode == 1 and ":3 jit-purity" in p1.stdout
    p2 = run_cli("--write-baseline", "--baseline", bl, "src", cwd=tmp_path)
    assert p2.returncode == 0
    p3 = run_cli("--check", "--baseline", bl, "src", cwd=tmp_path)
    assert p3.returncode == 0, p3.stdout + p3.stderr
    assert "(1 baselined)" in p3.stdout
    (pkg / "legacy.py").write_text("x = 1\n")
    p4 = run_cli("--check", "--baseline", bl, "src", cwd=tmp_path)
    assert p4.returncode == 0 and "1 stale baseline entry" in p4.stderr


def test_main_runs_in_process():
    from repro_torch.analysis.__main__ import main
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert main(["--check", "src/repro_torch"]) == 0
    finally:
        os.chdir(cwd)


def test_import_pulls_in_neither_torch_nor_jax():
    code = ("import sys, repro_torch.analysis as a\n"
            "a.analyze_paths(['src/repro_torch/core/gluon.py'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro', 'numpy'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
