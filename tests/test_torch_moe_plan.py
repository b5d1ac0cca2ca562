"""Port parity of the fused MoE dispatch plan (``repro_torch.kernels.
moe_plan.moe_plan`` and its plain version ``ref.moe_plan_ref``) against
``repro.models.moe.dispatch_plan``, bitwise, on the same numpy ``probs``.

JAX's plan runs both ways: with ``use_pallas_dispatch=True`` (the Pallas
``positions_in_expert_kernel`` in interpret mode) and with ``False``
(the one-hot cumsum).  Each group of the port's one call is held against
JAX's plan of that group alone.  On CPU tensors ``moe_plan`` computes
its plain version and counts no launch; the CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import MoEConfig
from repro.models import moe as jmoe
from repro_torch import kernels as tk
from repro_torch.kernels import moe_plan as tmp
from repro_torch.kernels import ref as tref
from repro_torch.models import convert
from repro_torch.models import moe as tmoe

# the (E, K) of chip_smoke.py's phase-2 sweep: deepseek-moe-16b (64, 6),
# llama4-scout (16, 1), the SMOKE configs' (8, 2), and the kernel's limits
EK = [(8, 2), (16, 1), (64, 6), (256, 16)]
KINDS = ["uniform", "skewed", "ties", "overflow"]
GROUPS = [1, 2, 4]


def probs_of(kind, g, t, e, k, seed):
    """float32 ``[G, T, E]`` rows that sum to one: uniform noise; skewed
    (the first K experts take almost everything, so most slots overflow);
    exact ties (quantized values, and column 1 equal to column 0)."""
    rng = np.random.default_rng(seed)
    x = rng.random((g, t, e)).astype(np.float32)
    if kind in ("skewed", "overflow"):
        x[..., :k] += 50.0
    elif kind == "ties":
        x = np.round(x * 4.0) / 4.0 + 0.25
        x[..., 1] = x[..., 0]
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def mk_moe(e, k, adaptive, cf):
    return MoEConfig(num_experts=e, top_k=k, num_shared_experts=0,
                     d_expert=16, capacity_factor=cf, adaptive=adaptive)


def assert_plans_equal(got, want, name):
    for what, a, b in zip(("flat_expert", "pos", "gate_flat", "keep"), got,
                          want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, (name, what)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{name} {what}")


@pytest.mark.parametrize("ek", EK)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("adaptive", [True, False])
def test_moe_plan_matches_jax_dispatch_plan(ek, kind, adaptive):
    """Every (E, K) meets every G across the kinds.  ``overflow`` takes a
    capacity small enough that the overflow exceeds ``total_free``."""
    e, k = ek
    g = GROUPS[(EK.index(ek) + KINDS.index(kind)) % 3]
    t = 256 if kind == "overflow" else 64
    m = mk_moe(e, k, adaptive, 0.25 if kind == "overflow" else 1.25)
    probs = probs_of(kind, g, t, e, k, seed=e + k + t + g)
    cap = tmoe._cap_of(m, t)
    got_kernel = tmp.moe_plan(torch.from_numpy(probs.copy()), top_k=k,
                              cap=cap, groups=g, adaptive=adaptive)
    got_ref = tref.moe_plan_ref(torch.from_numpy(probs.copy()), top_k=k,
                                cap=cap, groups=g, adaptive=adaptive)
    if kind == "overflow" and adaptive:
        # more overflow slots than free places: some stay dropped
        n_over = int((np.asarray(got_ref[1]) >= cap).sum())
        assert n_over > 0 and not bool(got_ref[3].all())
    for gi in range(g):
        for use_pallas in (True, False):
            want = jmoe.dispatch_plan(jnp.asarray(probs[gi]), m, t,
                                      use_pallas_dispatch=use_pallas)
            assert want[4] == cap
            for name, got in (("moe_plan", got_kernel),
                              ("moe_plan_ref", got_ref)):
                assert_plans_equal([a[gi] for a in got], want[:4],
                                   f"{name} group {gi} pallas={use_pallas}")


def test_top_k_order_nan_first_and_signed_zeros_tie():
    """The order the kernel mirrors: a NaN before every number, equal
    values (+0.0 and -0.0 too) by the lower index."""
    probs = torch.tensor([[[0.0, -0.0, float("nan"), 0.5, 0.0]]])
    fe, _, gate, _ = tmp.moe_plan(probs, top_k=4, cap=4, groups=1,
                                  adaptive=False)
    assert fe.tolist() == [[2, 3, 0, 1]]
    assert bool(torch.isnan(gate).all())       # the NaN sum poisons all


def _pair(seed, groups):
    jc = jax_smoke("deepseek-moe-16b")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, dispatch_groups=groups))
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    tp = convert.load_jax_tree(tmoe.MoE(jc, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    return jc, jp, tp


@pytest.mark.parametrize("groups,seed", [(1, 0), (2, 1), (4, 1)])
def test_grouped_moe_apply_matches_jax(groups, seed):
    """deepseek-moe-16b SMOKE, as tests/test_torch_moe.py holds
    ``moe_apply``: each group's routing through the port's one grouped
    plan call equals JAX's per-group plan; the outputs of both dispatch
    routes agree within 1/32 of their largest magnitude (bf16 products
    round differently in XLA and torch)."""
    cfg, jp, tp = _pair(seed, groups)
    x = np.random.default_rng(seed).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    t, m = 64, cfg.moe
    tg = t // groups
    xb = jnp.asarray(x).reshape(t, -1).astype(jnp.bfloat16)
    jprobs = jax.nn.softmax((xb @ jp["router"].astype(jnp.bfloat16))
                            .astype(jnp.float32), axis=-1)
    tprobs = tmoe.router_probs(tp, torch.from_numpy(x).reshape(t, -1)
                               .bfloat16())
    plan = tmp.moe_plan(tprobs.reshape(groups, tg, -1), top_k=m.top_k,
                        cap=tmoe._cap_of(m, tg), groups=groups,
                        adaptive=m.adaptive)
    for g in range(groups):
        jplan = jmoe.dispatch_plan(jprobs[g * tg:(g + 1) * tg], m, tg)
        for i in (0, 1, 3):                # flat_expert, pos, keep
            np.testing.assert_array_equal(plan[i][g].numpy(),
                                          np.asarray(jplan[i]))
    jout, _ = jmoe.moe_apply(jp, jnp.asarray(x), cfg)
    jo = np.asarray(jout)
    for use_pallas in (True, False):
        tout, _ = tmoe.moe_apply(tp, torch.from_numpy(x), cfg,
                                 use_pallas_dispatch=use_pallas)
        np.testing.assert_allclose(tout.numpy(), jo, rtol=0,
                                   atol=np.abs(jo).max() / 32)


def test_moe_plan_refuses_what_the_kernel_does_not_take():
    ok = torch.full((1, 4, 8), 0.125)

    def plan(probs=ok, **kw):
        args = dict(top_k=2, cap=4, groups=1, adaptive=True)
        return tmp.moe_plan(probs, **{**args, **kw})
    with pytest.raises(ValueError, match="E must be"):
        plan(torch.full((1, 4, 257), 1 / 257))
    with pytest.raises(ValueError, match="top_k"):
        plan(torch.full((1, 4, 64), 1 / 64), top_k=17)
    with pytest.raises(ValueError, match="top_k"):
        plan(top_k=9)                        # K > E
    with pytest.raises(ValueError, match="top_k"):
        plan(top_k=0)
    with pytest.raises(TypeError, match="float32"):
        plan(ok.double())
    with pytest.raises(ValueError, match="contiguous"):
        plan(ok[0])                          # [T, E]: no group axis
    with pytest.raises(ValueError, match="contiguous"):
        plan(groups=2)
    with pytest.raises(ValueError, match="contiguous"):
        plan(torch.full((1, 8, 4), 0.125).transpose(1, 2))
    with pytest.raises(ValueError, match="cap"):
        plan(cap=-1)
    with pytest.raises(ValueError, match="on cuda or cpu"):
        plan(ok.to("meta"))


def test_moe_plan_counts_no_launch_on_cpu():
    tk.reset_launch_counts()
    probs = torch.from_numpy(probs_of("skewed", 4, 16, 8, 2, seed=0))
    tmp.moe_plan(probs, top_k=2, cap=4, groups=4, adaptive=True)
    tmoe.dispatch_plan(probs[0], mk_moe(8, 2, True, 1.25), 16,
                       use_pallas_dispatch=True)
    assert tk.launch_counts()["moe_plan"] == 0
    assert tk.KERNELS["moe_plan"] is tmp.moe_plan
    assert set(tmp.moe_plan.launches_by_cluster.values()) == {0}
    # an empty group plans nothing
    out = tmp.moe_plan(torch.zeros((2, 0, 8)), top_k=2, cap=4, groups=2,
                       adaptive=True)
    assert [tuple(a.shape) for a in out] == [(2, 0)] * 4


def test_cluster_size_grows_with_the_slots():
    sizes = [tmp.cluster_size(n) for n in (1, 24, 2048, 2049, 6144, 16383,
                                           24_576, 65_536)]
    assert sizes == [1, 1, 1, 2, 3, 8, 8, 8]
    assert all(tmp.cluster_size(n) == 1 + (n - 1) // tmp.SLOTS_PER_CTA
               for n in range(1, 8 * tmp.SLOTS_PER_CTA + 1, 97))
