"""Port parity of the ALB-adaptive MoE layer (``repro_torch.models.moe``)
against ``repro.models.moe``: the dispatch plan bitwise from the same
numpy ``probs`` (both position routes), ``moe_apply`` at a stated
tolerance with the routing asserted equal, and the behaviours of
tests/test_moe_alb.py on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import moe as jmoe
from repro_torch.kernels import ref as tref
from repro_torch.models import convert
from repro_torch.models import moe as tmoe


def mk_moe(adaptive, num_experts=8, top_k=2, cap=1.0):
    """tests/test_moe_alb.py's MoEConfig (one frozen dataclass serves
    both packages: the port's copy has the same fields)."""
    return MoEConfig(num_experts=num_experts, top_k=top_k,
                     num_shared_experts=0, d_expert=16,
                     capacity_factor=cap, adaptive=adaptive)


def mk_cfg(moe):
    return ModelConfig(name="t", family="moe", num_layers=1, d_model=32,
                       num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
                       moe=moe)


def probs_of(kind, t, e, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "skewed":                   # three hot experts
        logits[:, :3] += 4.0
    elif kind == "ties":                   # exact ties among the top k
        logits = np.round(logits * 2.0) / 2.0
        logits[::3, 1] = logits[::3, 0]
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def assert_kept_slots_unique(flat_expert, pos, keep):
    """The dispatch store's premise: kept slots have unique (e, pos)."""
    fe, p, k = (np.asarray(a) for a in (flat_expert, pos, keep))
    pairs = set(zip(fe[k].tolist(), p[k].tolist()))
    assert len(pairs) == int(k.sum())


@pytest.mark.parametrize("e,k,t", [(8, 2, 64), (64, 6, 512), (16, 4, 300)])
@pytest.mark.parametrize("kind", ["balanced", "skewed", "ties"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_dispatch_plan_bitwise(e, k, t, kind, adaptive):
    """flat_expert, pos, gate_flat, keep and cap equal JAX's bitwise,
    through the kernel route and the one-hot route."""
    m = mk_moe(adaptive, e, k, cap=1.25)
    probs = probs_of(kind, t, e, seed=e + k + t)
    want = jmoe.dispatch_plan(jnp.asarray(probs), m, t)
    for use_pallas in (True, False):
        got = tmoe.dispatch_plan(torch.from_numpy(probs.copy()), m, t,
                                 use_pallas_dispatch=use_pallas)
        assert got[4] == want[4]
        for name, a, b in zip(("flat_expert", "pos", "gate_flat", "keep"),
                              got[:4], want[:4]):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert_kept_slots_unique(*got[:2], got[3])


def test_top_k_ties_lowest_index_first():
    """``lax.top_k`` returns ties lowest index first; so does the port."""
    probs = np.array([[0.25] * 4, [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    _, tidx = tref._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx.tolist() == [[0, 1], [1, 2], [0, 2]]


def test_rebalance_is_the_identity_without_overflow():
    """The port runs the executor unconditionally (no sync for
    ``any(overflow)``): with ample capacity it changes nothing."""
    m = mk_moe(True, cap=4.0)
    probs = torch.from_numpy(probs_of("balanced", 64, 8, seed=1).copy())
    on = tmoe.dispatch_plan(probs, m, 64)
    off = tmoe.dispatch_plan(probs, dataclasses.replace(m, adaptive=False),
                             64)
    assert bool(on[3].all())
    for a, b in zip(on[:4], off[:4]):
        assert torch.equal(a, b)


def _pair(seed, groups):
    jc = jax_smoke("deepseek-moe-16b")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, dispatch_groups=groups))
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    tp = convert.load_jax_tree(tmoe.MoE(jc, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    return jc, jp, tp


@pytest.mark.parametrize("groups,seed", [(1, 0), (4, 1)])
def test_moe_apply_matches_jax(groups, seed):
    """deepseek-moe-16b SMOKE (8 experts, top-2, one shared expert).
    Routing is asserted equal first; then the outputs agree within 1/32
    of their largest magnitude (bf16 products round differently in XLA
    and torch: measured at most 1/111, one or two bf16 ulps)."""
    cfg, jp, tp = _pair(seed, groups)
    x = np.random.default_rng(seed).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    t = 64
    xb = jnp.asarray(x).reshape(t, -1).astype(jnp.bfloat16)
    jprobs = jax.nn.softmax((xb @ jp["router"].astype(jnp.bfloat16))
                            .astype(jnp.float32), axis=-1)
    tprobs = tmoe.router_probs(tp, torch.from_numpy(x).reshape(t, -1)
                               .bfloat16())
    for g in range(groups):
        sl = slice(g * t // groups, (g + 1) * t // groups)
        jplan = jmoe.dispatch_plan(jprobs[sl], cfg.moe, t // groups)
        tplan = tmoe.dispatch_plan(tprobs[sl], cfg.moe, t // groups)
        for i in (0, 1, 3):                # flat_expert, pos, keep
            np.testing.assert_array_equal(tplan[i].numpy(),
                                          np.asarray(jplan[i]))
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg)   # eager, as the
    # plans above: under jit XLA keeps the router product in float32
    for use_pallas in (True, False):
        tout, taux = tmoe.moe_apply(tp, torch.from_numpy(x), cfg,
                                    use_pallas_dispatch=use_pallas)
        assert tout.dtype == torch.float32 and tout.shape == x.shape
        jo = np.asarray(jout)
        np.testing.assert_allclose(tout.numpy(), jo, rtol=0,
                                   atol=np.abs(jo).max() / 32)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _routed_fraction(m, x, router):
    """Fraction of token-slots that land inside capacity (the port's
    plan on the port's router probabilities)."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ router
    probs = torch.softmax(logits.float(), dim=-1)
    keep = tmoe.dispatch_plan(probs, m, t)[3]
    return float(keep.float().mean())


def test_adaptive_rescues_overflow_tokens():
    """Under skew (all tokens nearly identical: one hot expert) the
    executor re-deals overflow to free capacity, so strictly more slots
    survive (tests/test_moe_alb.py::test_adaptive_rescues_overflow_tokens)."""
    rng = np.random.default_rng(0)
    router = torch.from_numpy((rng.standard_normal((32, 8)) / np.sqrt(32))
                              .astype(np.float32))
    base = rng.standard_normal((1, 1, 32))
    x = torch.from_numpy((base + 0.01 * rng.standard_normal((4, 64, 32)))
                         .astype(np.float32))
    kept_adaptive = _routed_fraction(mk_moe(True), x, router)
    kept_static = _routed_fraction(mk_moe(False), x, router)
    assert kept_adaptive > kept_static
    assert kept_static < 0.5


def test_adaptive_noop_when_balanced():
    """Balanced routing with ample capacity: the same output with and
    without the executor (tests/test_moe_alb.py::test_adaptive_noop_when_balanced)."""
    cfg_a, cfg_s = mk_cfg(mk_moe(True, cap=4.0)), mk_cfg(mk_moe(False,
                                                               cap=4.0))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), cfg_a)
    tp = convert.load_jax_tree(tmoe.MoE(cfg_a, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, cfg_a.d_model)).astype(np.float32))
    out_a, _ = tmoe.moe_apply(tp, x, cfg_a)
    out_s, _ = tmoe.moe_apply(tp, x, cfg_s)
    assert torch.equal(out_a, out_s)


def test_moe_output_finite_and_grouped_matches_global():
    """Grouped dispatch equals global dispatch when nothing overflows
    (tests/test_moe_alb.py::test_grouped_dispatch_matches_global_when_ample_capacity)."""
    cfg1 = mk_cfg(mk_moe(True, cap=4.0))
    cfgg = dataclasses.replace(cfg1, moe=dataclasses.replace(
        cfg1.moe, dispatch_groups=4))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), cfg1)
    tp = convert.load_jax_tree(tmoe.MoE(cfg1, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 32, cfg1.d_model)).astype(np.float32))
    out1, aux = tmoe.moe_apply(tp, x, cfg1)
    outg, _ = tmoe.moe_apply(tp, x, cfgg)
    assert out1.shape == x.shape and bool(torch.isfinite(out1).all())
    assert float(aux) >= 0.0
    torch.testing.assert_close(out1, outg, rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="dispatch groups"):
        tmoe.moe_apply(tp, x[:1, :3], cfgg)
