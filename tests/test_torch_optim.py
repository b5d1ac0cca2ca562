"""Port parity of the training path's host and optimizer pieces
(``repro_torch.data``, ``repro_torch.optim``) against ``repro.data`` and
``repro.optim`` on the same numpy inputs: synthetic batches bitwise, the
lr schedules within float32 rounding, ``adamw_update`` and
``global_norm`` within a few ulp, int8 gradient compression bitwise
(``compressed_psum`` over a 4-slot CPU mesh against JAX's under
``shard_map`` with 4 forced host devices, in one JAX subprocess)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticDataset as JDataset
from repro.data import synthetic_batch as jbatch
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedules as jsched
from repro_torch.core import collectives
from repro_torch.data import SyntheticDataset, synthetic_batch
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedules as tsched

REPO = Path(__file__).resolve().parents[1]


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def ulps(got, want) -> float:
    """Largest distance in float32 units in the last place of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    spacing = np.spacing(np.abs(want).astype(np.float32))
    return float(np.max(np.abs(got - want) / spacing))


def tensor_ulps(got, want) -> float:
    """Largest distance in float32 ulps of ``want``'s largest magnitude:
    the error scale of an update whose terms may cancel."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))
                 / np.spacing(np.float32(np.abs(want).max())))


# ---- data ------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
@pytest.mark.parametrize("codebooks", [1, 4])
def test_synthetic_batches_bitwise(seed, step, codebooks):
    want = jbatch(seed, step, 4, 33, 1000, codebooks)
    got = synthetic_batch(seed, step, 4, 33, 1000, codebooks)
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    a = SyntheticDataset(seed, 2, 16, 102400).batch(step)
    b = JDataset(seed, 2, 16, 102400).batch(step)
    assert a["tokens"].shape == (2, 16)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---- schedules -------------------------------------------------------------------

SCHEDULES = {
    "cosine": ((3e-4, 5, 100), {}),
    "cosine_min": ((1e-3, 1, 10), {"min_ratio": 0.0}),
    "wsd": ((3e-4, 5, 70, 20), {}),
    "wsd_short": ((1e-2, 1, 3, 1), {"min_ratio": 0.1}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """lr at steps 0..120 from a Python int and from an int32 tensor
    step: float32, within 8 ulp of JAX's, eager (vmapped) and jitted.
    JAX's own two forms differ by up to 7 ulp (XLA reassociates the
    jitted products and computes cos / pow its own way); measured
    against the port: at most 4 ulp eager, 7 jitted."""
    args, kw = SCHEDULES[name]
    fam = name.split("_")[0]
    jf = getattr(jsched, f"{fam}_schedule")(*args, **kw)
    tf = getattr(tsched, f"{fam}_schedule")(*args, **kw)
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    want_jit = np.array([np.asarray(jax.jit(jf)(jnp.int32(s)))
                         for s in steps])
    got = np.array([float(tf(int(s))) for s in steps], np.float32)
    got_t = np.array([float(tf(torch.tensor(s, dtype=torch.int32)))
                      for s in steps], np.float32)
    assert tf(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_array_equal(got, got_t)
    assert ulps(got, want) <= 8, (got, want)
    assert ulps(got, want_jit) <= 8, (got, want_jit)


# ---- adamw ----------------------------------------------------------------------

SHAPES = {"w": (6, 40), "experts": (3, 8, 5), "gain": (40,),
          "bias": (7,)}


def _state(seed, master: bool, dtype=np.float32):
    params = {n: rnd(seed + i, s, 0.5) for i, (n, s) in
              enumerate(sorted(SHAPES.items()))}
    grads = {n: rnd(seed + 10 + i, s, 0.3) for i, (n, s) in
             enumerate(sorted(SHAPES.items()))}
    mu = {n: rnd(seed + 20 + i, s, 0.01) for i, (n, s) in
          enumerate(sorted(SHAPES.items()))}
    nu = {n: np.abs(rnd(seed + 30 + i, s, 1e-3)) for i, (n, s) in
          enumerate(sorted(SHAPES.items()))}
    return params, grads, mu, nu


def _jax_step(params, grads, mu, nu, step, cfg, master: bool):
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    state = {"mu": {n: jnp.asarray(a) for n, a in mu.items()},
             "nu": {n: jnp.asarray(a) for n, a in nu.items()},
             "step": jnp.asarray(step, jnp.int32)}
    if master:
        state["master"] = dict(jp)
        jp = {n: a.astype(jnp.bfloat16) if a.ndim > 1 else a
              for n, a in jp.items()}
    jg = {n: jnp.asarray(a).astype(jp[n].dtype) for n, a in grads.items()}
    return jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, cfg))(
        jp, jg, state)


def _torch_step(params, grads, mu, nu, step, cfg, master: bool):
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    state = {"mu": {n: torch.from_numpy(a.copy()) for n, a in mu.items()},
             "nu": {n: torch.from_numpy(a.copy()) for n, a in nu.items()},
             "step": torch.tensor(step, dtype=torch.int32)}
    if master:
        state["master"] = {n: t.clone() for n, t in tp.items()}
        tp = {n: t.bfloat16() if t.ndim > 1 else t for n, t in tp.items()}
    tg = {n: torch.from_numpy(a).to(tp[n].dtype) for n, a in grads.items()}
    return tadamw.adamw_update(tp, tg, state, cfg)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_adamw_update_matches_jax(master, clip, lr):
    """One update from step 3 with non-zero moments, the clip active
    (1.0) and not (100.0), a constant and a scheduled lr; with master
    weights the matrices are bf16 and their gradients too.  Moments,
    masters and parameters within 2 ulp of each tensor's largest
    magnitude, the grad norm within 2 ulp (summed in another order).
    Measured: at most 1.75 and 2.  Elementwise the moments differ by up
    to 174 ulp of a small element: XLA contracts ``b1 * mu + (1 - b1) *
    g`` into an FMA, so where the two terms cancel the one rounding of a
    product the port makes is many ulps of what is left."""
    lr_v = 1e-2 if lr == "const" else None
    args = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                clip_norm=clip, master_weights=master)
    jcfg = jadamw.OptConfig(lr=lr_v or jsched.cosine_schedule(1e-2, 2, 10),
                            **args)
    tcfg = tadamw.OptConfig(lr=lr_v or tsched.cosine_schedule(1e-2, 2, 10),
                            **args)
    params, grads, mu, nu = _state(0, master)
    jp, js, jn = _jax_step(params, grads, mu, nu, 3, jcfg, master)
    tp, ts, tn = _torch_step(params, grads, mu, nu, 3, tcfg, master)
    assert int(ts["step"]) == int(js["step"]) == 4
    assert ts["step"].dtype == torch.int32
    assert ulps(tn, jn) <= 2
    for n in SHAPES:
        for part in ("mu", "nu") + (("master",) if master else ()):
            assert tensor_ulps(ts[part][n].numpy(), js[part][n]) <= 2, \
                (part, n)
        want = np.asarray(jp[n].astype(jnp.float32))
        assert tp[n].dtype == (torch.bfloat16 if master and len(SHAPES[n])
                               > 1 else torch.float32)
        assert tensor_ulps(tp[n].float().numpy(), want) <= 2, n
    # weight decay reaches matrices only: a zero gradient and zero
    # moments leave a 1-D parameter as it was
    zero = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    tp, _, _ = _torch_step(params, zero, zero, zero, 0, tcfg, False)
    np.testing.assert_array_equal(tp["gain"].numpy(), params["gain"])
    assert not np.array_equal(tp["w"].numpy(), params["w"])


def test_global_norm_and_init():
    leaves = [rnd(i, s) for i, s in enumerate(SHAPES.values())]
    want = float(jadamw.global_norm([jnp.asarray(a) for a in leaves]))
    got = tadamw.global_norm([torch.from_numpy(a) for a in leaves])
    assert got.dtype == torch.float32 and got.ndim == 0
    assert ulps(float(got), want) <= 2
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": torch.ones(4)}
    st = tadamw.adamw_init(params, master_weights=True)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert st["mu"]["a"].dtype == st["master"]["a"].dtype == torch.float32
    assert set(st) == {"mu", "nu", "step", "master"}
    assert "master" not in tadamw.adamw_init(params)


# ---- int8 gradient compression -------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 11, 5), (1,)])
def test_quantize_dequantize_bitwise(shape):
    x = rnd(1, shape, 10.0)
    x.reshape(-1)[0] = 0.0
    jq, js, jmeta = jgc.quantize(jnp.asarray(x))
    tq, ts, tmeta = tgc.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tmeta == (tuple(jmeta[0]), jmeta[1])
    np.testing.assert_array_equal(
        tgc.dequantize(tq, ts, tmeta).numpy(),
        np.asarray(jgc.dequantize(jq, js, jmeta)))


_PSUM_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.optim.grad_compress import compressed_psum
    data = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("dev",))
    out = {}
    for name, x in data.items():           # x: [4, ...], one row a slot
        f = shard_map(lambda g: compressed_psum(g[0], "dev")[None],
                      mesh=mesh, in_specs=P("dev"), out_specs=P("dev"))
        out[name] = np.asarray(jax.jit(f)(jnp.asarray(x)))
    np.savez(sys.argv[2], **out)
""")


def test_compressed_psum_matches_shard_map(tmp_path):
    """Four slots' gradients (a matrix, a ragged vector, a 3-D tensor)
    reduced over a 4-slot CPU mesh: bitwise the JAX package's
    ``compressed_psum`` under ``shard_map`` on 4 forced host devices,
    each slot's result the same; a bf16 gradient comes back bf16."""
    tree = {"w": rnd(2, (4, 6, 64), 3.0), "v": rnd(3, (4, 300)),
            "e": rnd(4, (4, 2, 3, 50), 0.1)}
    tree["v"][2, 17] = 40.0                       # one block's outlier
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **tree)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _PSUM_SCRIPT, str(src),
                           str(dst)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(dst))
    mesh = collectives.device_mesh(4, devices=["cpu"] * 4)
    slots = [{k: torch.from_numpy(v[d]) for k, v in tree.items()}
             for d in range(4)]
    for d in range(4):
        slots[d]["b"] = torch.from_numpy(tree["w"][d]).bfloat16()
    got = tgc.compressed_psum(slots, mesh)
    assert len(got) == 4
    for d in range(4):
        for k in tree:
            assert got[d][k].dtype == torch.float32
            np.testing.assert_array_equal(got[d][k].numpy(), want[k][d])
        assert got[d]["b"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="slots"):
        tgc.compressed_psum(slots[:3], mesh)


def test_decay_follows_jax_stacked_leaves():
    """JAX decays by the ndim of its leaf, and a layer's norm gain is a
    row of a ``[L, d]`` leaf: the port decays ``layers.<i>.norm1`` (1-D
    here) and not ``final_norm``, and matches JAX's update of the
    stacked tree within 2 ulp of each tensor's largest magnitude."""
    gains = rnd(5, (2, 16), 0.5)
    final = rnd(6, (16,), 0.5)
    g_gains, g_final = rnd(7, (2, 16), 0.1), rnd(8, (16,), 0.1)
    cfg = dict(lr=1e-2, weight_decay=0.5)
    jt_ = {"layers": {"norm1": jnp.asarray(gains)},
           "final_norm": jnp.asarray(final)}
    jg = {"layers": {"norm1": jnp.asarray(g_gains)},
          "final_norm": jnp.asarray(g_final)}
    jp, _, _ = jadamw.adamw_update(jt_, jg, jadamw.adamw_init(jt_),
                                   jadamw.OptConfig(**cfg))
    tp = {"layers.0.norm1": torch.from_numpy(gains[0].copy()),
          "layers.1.norm1": torch.from_numpy(gains[1].copy()),
          "final_norm": torch.from_numpy(final.copy())}
    tg = {"layers.0.norm1": torch.from_numpy(g_gains[0]),
          "layers.1.norm1": torch.from_numpy(g_gains[1]),
          "final_norm": torch.from_numpy(g_final)}
    tp, _, _ = tadamw.adamw_update(tp, tg, tadamw.adamw_init(tp),
                                   tadamw.OptConfig(**cfg))
    for i in range(2):
        assert tensor_ulps(tp[f"layers.{i}.norm1"].numpy(),
                           np.asarray(jp["layers"]["norm1"][i])) <= 2
    assert tensor_ulps(tp["final_norm"].numpy(),
                       np.asarray(jp["final_norm"])) <= 2
    assert tadamw.leaf_ndim("layers.3.norm1", tp["final_norm"]) == 2
    assert tadamw.leaf_ndim("final_norm", tp["final_norm"]) == 1
