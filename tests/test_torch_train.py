"""Port parity of the training path (``repro_torch.models.transformer.
forward``, ``repro_torch.train.steps``, ``moe_plan`` under autograd)
against ``repro.models`` / ``repro.train`` on the same numpy inputs.

* ``moe_plan``'s hand-written gate backward against autograd through its
  plain version and against ``jax.grad`` of JAX's ``dispatch_plan``
  gates (kept and rebalanced slots, ties, a clamped row, several
  groups, ``adaptive`` on and off), within float32 rounding;
* ``moe_apply``'s gradients (router, experts, shared MLP, ``x``) for one
  and two dispatch groups, and the SMOKE configs' ``forward``, loss and
  every parameter's gradient against ``jax.value_and_grad`` of JAX's
  ``make_loss_fn``, each dispatch plan bitwise;
* ``remat=True`` against ``remat=False``, and five train steps.

Two compute dtypes: the production bf16, where the products round
differently in XLA and torch (tolerances relative to each tensor's
largest magnitude, measured below), and float32 on both sides (the
packages' ``COMPUTE_DTYPE`` patched), where the same math must agree to
float32 rounding: that is the check of the gradient's math.  bf16 near
ties can swap two experts, so each arch takes a seed whose routing the
test asserts equal (the MoE SMOKE config's seeds 2 and 4 do; 0, 1, 3
route a few slots differently in bf16).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import MoEConfig
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.optim import OptConfig as JOptConfig
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import kernels as tk
from repro_torch.data import SyntheticDataset
from repro_torch.kernels import moe_plan as tmp
from repro_torch.kernels import ref as tref
from repro_torch.models import convert
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.optim import OptConfig
from repro_torch.train import steps as tsteps

ARCHS = ["deepseek-moe-16b", "llama3-8b"]
SEED = {"deepseek-moe-16b": 2, "llama3-8b": 0}
B, S = 2, 32
# bf16 tolerances, of each tensor's largest magnitude (measured: MoE
# 0.033 for the worst gradient, dense 0.012; loss 2.3e-4 relative)
GRAD_TOL = {"bfloat16": {"moe": 0.1, "dense": 0.04}, "float32": 1e-5}
LOSS_RTOL = {"bfloat16": 2e-3, "float32": 1e-6}


@contextlib.contextmanager
def compute_dtype(name: str):
    """Both packages' products in ``name`` (bf16 is their default)."""
    mods = ((jl, jnp), (jmoe, jnp), (jt, jnp), (tl, torch), (tmoe, torch),
            (tt, torch))
    old = [m.COMPUTE_DTYPE for m, _ in mods]
    for m, lib in mods:
        m.COMPUTE_DTYPE = getattr(lib, name)
    try:
        yield
    finally:
        for (m, _), o in zip(mods, old):
            m.COMPUTE_DTYPE = o


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def batch_of(arch, step=0):
    cfg = tconfigs.get_smoke_config(arch)
    return SyntheticDataset(SEED[arch], B, S, cfg.vocab_size).batch(step)


@contextlib.contextmanager
def record_plans(store):
    """(flat_expert, pos, keep) of every plan of either package's
    ``dispatch_plan`` (JAX's through an ordered debug callback)."""
    real = jmoe.dispatch_plan, tmoe.dispatch_plan

    def host(fe, pos, keep):
        store.append(tuple(np.asarray(a) for a in (fe, pos, keep)))

    def rec_j(probs, m, t, **kw):
        out = real[0](probs, m, t, **kw)
        jax.debug.callback(host, out[0], out[1], out[3], ordered=True)
        return out

    def rec_t(probs, m, t, **kw):
        out = real[1](probs, m, t, **kw)
        host(out[0], out[1], out[3])
        return out
    jmoe.dispatch_plan, tmoe.dispatch_plan = rec_j, rec_t
    try:
        yield
    finally:
        jmoe.dispatch_plan, tmoe.dispatch_plan = real


@functools.cache
def jax_ref(arch: str, compute: str):
    """JAX's forward (with its plans), loss and gradients (remat, as it
    trains) on the arch's seed and first batch."""
    cfg = jax_smoke(arch)
    with compute_dtype(compute):
        params = jt.init(jax.random.PRNGKey(SEED[arch]), cfg)
        batch = {k: jnp.asarray(v) for k, v in batch_of(arch).items()}
        plans = []
        with record_plans(plans):
            logits, aux = jax.jit(lambda p, t: jt.forward(
                p, cfg, t, remat=False))(params, batch["tokens"])
            jax.effects_barrier()
        loss_fn = jsteps.make_loss_fn(cfg, remat=True)
        (loss, ce), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, batch)
    return {"params": jax.tree.map(np.asarray, params),
            "logits": np.asarray(logits), "aux": float(aux),
            "plans": plans, "loss": float(loss), "ce": float(ce),
            "grads": dict(leaves(jax.tree.map(np.asarray, grads)))}


def port_model(arch, ref):
    return convert.params_from_jax(ref["params"],
                                   tconfigs.get_smoke_config(arch),
                                   device="cpu", param_dtype=torch.float32
                                   ).requires_grad_()


def port_loss_grads(model, cfg, batch, remat=True, **kw):
    loss, ce = tsteps.make_loss_fn(cfg, remat=remat, **kw)(model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    tree = convert.jax_tree(dict(zip(named, grads)))
    return float(loss), float(ce), dict(leaves(tree))


def torch_batch(arch, step=0):
    return {k: torch.from_numpy(v) for k, v in batch_of(arch, step).items()}


# ---- moe_plan under autograd ---------------------------------------------------

def plan_probs(kind, g, tg, e, k, seed):
    """float32 ``[G, Tg, E]``: softmax rows where the first K experts
    take most (slots overflow and the rebalance moves them); rows with
    exact ties; and a row whose top-k sum is under 1e-9 (clamped)."""
    rng = np.random.default_rng(seed)
    x = rng.random((g, tg, e)).astype(np.float32)
    if kind == "skewed":
        x[..., :k] += 3.0
        x = x / x.sum(-1, keepdims=True)
    elif kind == "tied":
        x = np.round(x * 4.0) / 4.0 + 0.25
        x[..., 1] = x[..., 0]
        x = x / x.sum(-1, keepdims=True)
    else:                                   # clamped
        x = x / x.sum(-1, keepdims=True)
        x[:, 0] = x[:, 0] * 1e-11
    return x.astype(np.float32)


def jax_gate_grad(probs, w, m, tg):
    """``jax.grad`` of ``sum(w * gate_flat)`` of JAX's jnp plan, per
    group (``vmap``, as ``moe_apply`` plans its groups)."""
    def f(p):
        gates = jax.vmap(lambda q: jmoe.dispatch_plan(q, m, tg)[2])(p)
        return jnp.sum(gates * w)
    return np.asarray(jax.grad(f)(jnp.asarray(probs)))


@pytest.mark.parametrize("kind", ["skewed", "tied", "clamped"])
@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("adaptive", [True, False])
def test_moe_plan_gate_backward(kind, groups, adaptive):
    """The Function's hand-written backward (``moe_plan.gate_grad``)
    against autograd through ``moe_plan_ref`` and against JAX, on the
    same probs and weights: within 1e-6 of the gradient's largest
    magnitude (float32 rounding of ``1 / D`` and ``v / D**2`` in other
    orders; measured at most 1.5e-7).  The plans are equal; the skewed
    rebalanced case has moved slots and the clamped case a clamped
    row."""
    e, k, tg = 8, 2, 24
    m = MoEConfig(num_experts=e, top_k=k, num_shared_experts=0,
                  d_expert=4, capacity_factor=1.0, adaptive=adaptive)
    cap = tmoe._cap_of(m, tg)
    probs = plan_probs(kind, groups, tg, e, k, seed=groups)
    w = np.random.default_rng(7).standard_normal(
        (groups, tg * k)).astype(np.float32)
    kw = dict(top_k=k, cap=cap, groups=groups, adaptive=adaptive)
    outs, grads = [], []
    for plan in (tmp.moe_plan, tref.moe_plan_ref):
        p = torch.from_numpy(probs).requires_grad_()
        out = plan(p, **kw)
        (out[2] * torch.from_numpy(w)).sum().backward()
        outs.append(out)
        grads.append(p.grad.numpy())
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    fe = outs[0][0].reshape(groups, tg, k)
    top = tref._top_k(torch.from_numpy(probs), k)[1]
    moved = int((fe != top).sum())
    if kind == "skewed":
        assert (moved > 0) == adaptive
    if kind == "clamped":
        assert float(tref._top_k(torch.from_numpy(probs), k)[0][:, 0]
                     .sum(-1).max()) < 1e-9
    want = jax_gate_grad(probs, w, m, tg)
    assert rel_err(grads[0], grads[1]) <= 1e-6
    assert rel_err(grads[0], want) <= 1e-6
    assert rel_err(grads[1], want) <= 1e-6


def test_moe_plan_integer_outputs_take_no_gradient():
    p = torch.from_numpy(plan_probs("skewed", 1, 8, 8, 2, 0)) \
        .requires_grad_()
    fe, pos, gate, keep = tmp.moe_plan(p, top_k=2, cap=4, groups=1,
                                       adaptive=True)
    assert gate.requires_grad
    assert not (fe.requires_grad or pos.requires_grad or keep.requires_grad)
    with torch.no_grad():
        assert not tmp.moe_plan(p, top_k=2, cap=4, groups=1,
                                adaptive=True)[2].requires_grad


# ---- moe_apply -----------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("use_pallas_dispatch", [True, False])
def test_moe_apply_gradients_match_jax(groups, use_pallas_dispatch):
    """One MoE layer of the SMOKE config (float32 compute, capacity 1.0
    so slots overflow and move): the output, the aux loss and the
    gradients of ``sum(out * w) + aux`` for the router, the experts, the
    shared MLP and ``x`` within 1e-5 of JAX's (measured at most 5.1e-7),
    for one and two dispatch groups, through ``moe_plan``'s backward and
    through autograd over the plain version."""
    base = jax_smoke("deepseek-moe-16b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch_groups=groups, capacity_factor=1.0))
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    with compute_dtype("float32"):
        jp = jmoe.moe_init(jax.random.PRNGKey(5), cfg)

        def jf(p, xx):
            out, aux = jmoe.moe_apply(p, xx, cfg)
            return jnp.sum(out * w) + aux, (out, aux)
        (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
        mod = convert.load_jax_tree(
            tmoe.MoE(cfg, device="cpu", dtype=torch.float32),
            jax.tree.map(np.asarray, jp)).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        out, aux = tmoe.moe_apply(mod, tx, cfg,
                                  use_pallas_dispatch=use_pallas_dispatch)
        (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    assert rel_err(out.detach().numpy(), jout) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert rel_err(tx.grad.numpy(), jgx) <= 1e-5
    got = dict(leaves(convert.jax_tree(
        {n: p.grad for n, p in mod.named_parameters()})))
    want = dict(leaves(jax.tree.map(np.asarray, jgp)))
    assert sorted(got) == sorted(want)
    for name in want:
        assert rel_err(got[name], want[name]) <= 1e-5, name
    assert float(np.abs(want["router"]).max()) > 0


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_gradients_match_jax(act):
    """The MLP of either activation (``jax.nn.gelu`` is the tanh
    approximation by default, and so is the port's), float32 compute:
    output and the gradients of ``sum(out * w)`` within 1e-5 of JAX's
    largest magnitude."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((2, 5, 16)).astype(np.float32)
    with compute_dtype("float32"):
        jp = jl.mlp_init(jax.random.PRNGKey(1), 16, 24, act)

        def jf(p, xx):
            out = jl.mlp_apply(p, xx, act)
            return jnp.sum(out * w), out
        (_, jout), (jgp, jgx) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
        mod = convert.load_jax_tree(
            tl.MLP(16, 24, act, device="cpu", dtype=torch.float32),
            jax.tree.map(np.asarray, jp)).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        out = tl.mlp_apply(mod, tx, act)
        torch.sum(out * torch.from_numpy(w)).backward()
    assert rel_err(out.detach().numpy(), jout) <= 1e-5
    assert rel_err(tx.grad.numpy(), jgx) <= 1e-5
    for name, p in mod.named_parameters():
        assert rel_err(p.grad.numpy(), jgp[name]) <= 1e-5, name


# ---- forward, loss and gradients of the SMOKE configs ----------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Logits float32 ``[B, S, Vp]`` within 1/20 of their largest
    magnitude (bf16 products; measured 1/58 on the MoE config), aux
    within 1e-3 relative,
    each MoE layer's plan (flat_expert, pos, keep) bitwise."""
    ref = jax_ref(arch, "bfloat16")
    cfg = tconfigs.get_smoke_config(arch)
    model = port_model(arch, ref)
    plans = []
    with record_plans(plans), torch.no_grad():
        logits, aux = tt.forward(model, cfg, torch_batch(arch)["tokens"],
                                 remat=False)
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert rel_err(logits.numpy(), ref["logits"]) <= 1 / 20
    assert abs(float(aux) - ref["aux"]) <= 1e-3 * max(abs(ref["aux"]), 1e-3)
    assert len(plans) == len(ref["plans"]) == (
        cfg.num_layers if cfg.family == "moe" else 0)
    for got, want in zip(plans, ref["plans"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, compute):
    """Loss, ce and every parameter's gradient (remat on both sides)
    against ``jax.value_and_grad`` of JAX's ``make_loss_fn``.  bf16:
    loss within 2e-3 relative, each gradient within ``GRAD_TOL`` of its
    largest magnitude; float32 compute: loss within 1e-6, gradients
    within 1e-5 (measured 1.6e-6).  The router takes a gradient."""
    ref = jax_ref(arch, compute)
    cfg = tconfigs.get_smoke_config(arch)
    with compute_dtype(compute):
        loss, ce, grads = port_loss_grads(port_model(arch, ref), cfg,
                                          torch_batch(arch))
    rtol = LOSS_RTOL[compute]
    assert abs(loss - ref["loss"]) <= rtol * abs(ref["loss"])
    assert abs(ce - ref["ce"]) <= rtol * abs(ref["ce"])
    tol = GRAD_TOL[compute]
    tol = tol[cfg.family] if isinstance(tol, dict) else tol
    assert sorted(grads) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        assert rel_err(grads[name], want) <= tol, (name, rel_err(
            grads[name], want))
    if cfg.family == "moe":
        assert np.abs(grads["layers/moe/router"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    """``remat=True`` (each block under ``torch.utils.checkpoint``)
    gives the loss and gradients of ``remat=False`` bitwise on the CPU,
    and runs each MoE layer's plan twice."""
    ref = jax_ref(arch, "bfloat16")
    cfg = tconfigs.get_smoke_config(arch)
    model = port_model(arch, ref)
    runs = []
    for remat in (True, False):
        calls = []
        real = tmp._plan

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)
        tmp._plan = counted
        try:
            runs.append(port_loss_grads(model, cfg, torch_batch(arch),
                                        remat=remat))
        finally:
            tmp._plan = real
        per = 2 if remat else 1
        assert len(calls) == (per * cfg.num_layers
                              if cfg.family == "moe" else 0)
    (la, ca, ga), (lb, cb, gb) = runs
    assert la == lb and ca == cb
    for name in ga:
        np.testing.assert_array_equal(ga[name], gb[name], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_refuses_flash_and_unported(arch):
    cfg = tconfigs.get_smoke_config(arch)
    model, _ = tsteps.init_train_state(cfg, generator=torch.Generator(),
                                       device="cpu")
    assert all(p.requires_grad and (p.dtype == torch.float32)
               for p in model.parameters())
    serving = tt.init(cfg, generator=torch.Generator(), device="cpu")
    assert not any(p.requires_grad for p in serving.parameters())
    assert serving.embed.dtype == torch.bfloat16
    tok = torch.zeros((1, 4), dtype=torch.int32)
    # the training forward takes no attention switch: it never reaches
    # the flash kernel, which has no backward
    with pytest.raises(TypeError, match="attn_impl"):
        tt.forward(model, cfg, tok, attn_impl="flash")
    # every family trains now (tests/test_torch_arch.py): the SSM model
    # takes the same call
    ssm = tconfigs.get_smoke_config("mamba2-2.7b")
    logits, _ = tt.forward(tsteps.init_train_state(
        ssm, generator=torch.Generator(), device="cpu")[0], ssm, tok)
    assert logits.shape == (1, 4, ssm.padded_vocab)


# ---- training trajectory ---------------------------------------------------------

@functools.cache
def jax_trajectory(arch: str, compute: str, steps: int = 5):
    cfg = jax_smoke(arch)
    with compute_dtype(compute):
        params = jt.init(jax.random.PRNGKey(SEED[arch]), cfg)
        from repro.optim import adamw_init
        opt = adamw_init(params)
        step = jax.jit(jsteps.make_train_step(cfg, JOptConfig(lr=3e-3)))
        out = []
        for i in range(steps):
            batch = {k: jnp.asarray(v) for k, v in batch_of(arch, i).items()}
            params, opt, m = step(params, opt, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


# (loss, grad norm) relative tolerances of steps 1.. (step 0 is the
# same state: LOSS_RTOL, and the gradients' tolerance).  float32
# compute: measured at most 4.3e-7 and 3.1e-6.  bf16: Adam's first
# update is +-lr a parameter, so bf16 noise in a gradient near 0 flips
# whole steps of lr; dense measured 5.4e-4 and 0.6%; the MoE config
# also swaps near-tie experts from step 1 on, so its path leaves JAX's
# (measured 2.4% and 29% at step 3) and only its fall is held.
TRAJ_TOL = {("bfloat16", "dense"): (2e-3, 0.02),
            ("bfloat16", "moe"): (0.05, 0.5),
            ("float32", "dense"): (1e-5, 1e-4),
            ("float32", "moe"): (1e-5, 1e-4)}


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_track_jax(arch, compute):
    """Five ``make_train_step`` steps (AdamW, lr 3e-3, the pipeline's
    batches 0..4) from the same converted parameters against JAX's
    ``make_train_step``: each step's loss and grad norm within
    ``TRAJ_TOL`` (parameters are not compared elementwise: see there),
    the metrics float32 device scalars with no graph, and the loss
    falls from step 0 to step 4."""
    want = jax_trajectory(arch, compute)
    cfg = tconfigs.get_smoke_config(arch)
    with compute_dtype(compute):
        model = port_model(arch, jax_ref(arch, compute))
        from repro_torch.optim import adamw_init
        opt = adamw_init(model)
        step = tsteps.make_train_step(cfg, OptConfig(lr=3e-3))
        got = []
        for i in range(len(want)):
            model, opt, m = step(model, opt, torch_batch(arch, i))
            assert set(m) == {"loss", "ce", "grad_norm"}
            assert all(v.dtype == torch.float32 and v.ndim == 0
                       and not v.requires_grad for v in m.values())
            got.append((float(m["loss"]), float(m["grad_norm"])))
    assert int(opt["step"]) == len(want)
    (l0, n0), (w0, v0) = got[0], want[0]
    assert abs(l0 - w0) <= LOSS_RTOL[compute] * w0
    assert abs(n0 - v0) <= 1e-3 * v0
    lt, nt = TRAJ_TOL[(compute, cfg.family)]
    for (gl, gn), (wl, wn) in zip(got[1:], want[1:]):
        assert abs(gl - wl) <= lt * wl, (got, want)
        assert abs(gn - wn) <= nt * wn, (got, want)
    assert got[-1][0] < got[0][0], got
