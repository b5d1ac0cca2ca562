"""Port parity of the LM serving path (``repro_torch.models``) against
``repro.models``: the layers, ``params_from_jax``, and prefill + 4
decode steps of the deepseek-moe-16b and llama3-8b SMOKE configs on the
same numpy inputs, with the MoE routing asserted equal; plus the port's
structural rules for the LM stack."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.core import graph as tg
from repro_torch.models import convert
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

ARCHS = ["deepseek-moe-16b", "llama3-8b"]


def rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_registry(arch):
    for mine, theirs in ((tconfigs.get_config(arch), jax_config(arch)),
                         (tconfigs.get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_unported_arch_names_roadmap():
    with pytest.raises(KeyError, match="ROADMAP"):
        tconfigs.get_config("mamba2-2.7b")


# ---- layers --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    """float32 math, returned in the input dtype.  Tolerance: float32
    1e-6 (transcendental rounding); bf16 one rounding of the result
    (measured: equal)."""
    x = rnd(0, (2, 12, 4, 16))
    gamma = rnd(1, (16,)) * 0.1
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    got = tl.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(gamma))
    want = jl.rms_norm(jnp.asarray(x, jd), jnp.asarray(gamma))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    pos = np.arange(5, 17, dtype=np.int32)[None, :]
    got = tl.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                        10000.0)
    want = jl.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * 4)


@pytest.mark.parametrize("q_offset,kv_len,sq", [(0, None, 12), (9, 10, 1),
                                                 (20, 21, 1), (5, 17, 12)])
@pytest.mark.parametrize("impl", ["chunked", "plain"])
def test_torch_attention_matches_jax(q_offset, kv_len, sq, impl):
    """chunked (chunk 8: several blocks, a padded last one) and plain
    attention with q_offset / kv_len, GQA 4:2, float32, 2e-6."""
    skv = 24 if kv_len is not None else sq
    q, k, v = rnd(1, (2, sq, 4, 16)), rnd(2, (2, skv, 2, 16)), \
        rnd(3, (2, skv, 2, 16))
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, chunk=8)
    fn = jl.chunked_attention if impl == "chunked" else jl.plain_attention
    want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = tl.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                       impl=impl, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


def test_chunked_attention_fully_masked_rows_are_zero():
    q, k = rnd(4, (1, 3, 2, 8)), rnd(5, (1, 6, 2, 8))
    got = tl.chunked_attention(*(torch.from_numpy(a) for a in (q, k, k)),
                               causal=True, q_offset=0, kv_len=0, chunk=4)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
def test_gqa_apply_with_cache_matches_jax(attn_impl):
    """Prefill of 10 positions into a 16-slot cache, then one decode
    step, against ``layers.gqa_apply``; outputs within 2 bf16 ulps of
    their magnitude, caches equal to the same tolerance."""
    cfg = jax_smoke("llama3-8b")
    jp = jl.gqa_init(jax.random.PRNGKey(0), cfg)
    tp = convert.load_jax_tree(tl.GQA(cfg, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    hd = cfg.resolved_head_dim
    shape = (2, 16, cfg.num_kv_heads, hd)
    jcache = {"k": jnp.zeros(shape, jnp.bfloat16),
              "v": jnp.zeros(shape, jnp.bfloat16)}
    tcache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
              "v": torch.zeros(shape, dtype=torch.bfloat16)}
    x = rnd(6, (2, 11, cfg.d_model))
    for ci, s in ((0, 10), (10, 1)):
        xs = x[:, ci:ci + s]
        pos = np.arange(ci, ci + s, dtype=np.int32)[None, :]
        jout, jcache = jl.gqa_apply(jp, jnp.asarray(xs, jnp.bfloat16), cfg,
                                    positions=jnp.asarray(pos),
                                    cache=jcache, cache_index=ci)
        tout, tcache = tl.gqa_apply(tp, torch.from_numpy(xs).bfloat16(), cfg,
                                    positions=torch.from_numpy(pos),
                                    cache=tcache, cache_index=ci,
                                    attn_impl=attn_impl)
        jo = np.asarray(jout, np.float32)
        np.testing.assert_allclose(tout.float().numpy(), jo, rtol=0,
                                   atol=np.abs(jo).max() / 64)
        for n in ("k", "v"):
            jc = np.asarray(jcache[n], np.float32)
            np.testing.assert_allclose(tcache[n].float().numpy(), jc,
                                       rtol=0, atol=np.abs(jc).max() / 64)


# ---- params_from_jax --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(arch):
    """Every leaf carried, unstacked per layer, matrices bf16 by
    round-to-nearest-even (equal to XLA's astype), gains float32."""
    cfg = tconfigs.get_smoke_config(arch)
    params = jt.init(jax.random.PRNGKey(0), jax_smoke(arch))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    assert len(model.layers) == cfg.num_layers
    n_leaves = sum(a.size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_leaves
    wq = np.asarray(params["layers"]["attn"]["wq"][1].astype(jnp.bfloat16),
                    np.float32)
    assert model.layers[1].attn.wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.layers[1].attn.wq.float().numpy(), wq)
    assert model.layers[0].norm1.dtype == torch.float32
    if cfg.family == "moe":
        w = np.asarray(params["layers"]["moe"]["w_up"][0]
                       .astype(jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(
            model.layers[0].moe.w_up.float().numpy(), w)
    bad = dict(jax.tree.map(np.asarray, params), extra=np.zeros(3))
    with pytest.raises(KeyError, match="extra"):
        convert.params_from_jax(bad, cfg, device="cpu")


# ---- prefill + decode against JAX ------------------------------------------------

def _record_plans(monkeypatch, module, store):
    """Record (flat_expert, keep) of every dispatch plan; inside JAX's
    compiled layer scan through an ordered debug callback."""
    real = module.dispatch_plan

    def keep_host(fe, keep):
        store.append((np.asarray(fe), np.asarray(keep)))

    def rec(probs, m, t, **kw):
        out = real(probs, m, t, **kw)
        if module is jmoe:
            jax.debug.callback(keep_host, out[0], out[3], ordered=True)
        else:
            keep_host(out[0], out[3])
        return out
    monkeypatch.setattr(module, "dispatch_plan", rec)


@pytest.mark.parametrize("arch,seed", [("deepseek-moe-16b", 1),
                                       ("llama3-8b", 0)])
def test_prefill_decode_matches_jax(monkeypatch, arch, seed):
    """Prefill of 2 x 16 tokens and 4 greedy decode steps: every MoE
    layer's routing (flat_expert, keep) equal, greedy tokens equal,
    ``cache["index"]`` equal, logits within 1/20 of their largest
    magnitude (bf16 products and the residual stream round differently
    in XLA and torch: measured at most 1/56, about 3 bf16 ulps).  The
    routers' logits are bf16, so near-equal ones are common and a
    one-ulp difference can swap two experts: of seeds 0-7 of the MoE
    SMOKE config, 1, 4 and 7 route identically, and the test takes one
    of those and asserts it."""
    b, p, gen = 2, 16, 4
    jcfg, tcfg = jax_smoke(arch), tconfigs.get_smoke_config(arch)
    params = jt.init(jax.random.PRNGKey(seed), jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (b, p)).astype(np.int32)
    jplans, tplans = [], []
    _record_plans(monkeypatch, jmoe, jplans)
    _record_plans(monkeypatch, tmoe, tplans)
    jcache = jt.zeros_cache(jcfg, b, p + gen)
    tcache = tt.zeros_cache(tcfg, b, p + gen, device="cpu")
    jlog, jcache = jt.prefill(params, jcfg, jnp.asarray(toks), jcache)
    tlog, tcache = tt.prefill(model, tcfg, torch.from_numpy(toks), tcache)
    for step in range(gen + 1):
        assert tlog.dtype == torch.float32 and tlog.shape == (
            b, 1, tcfg.padded_vocab)
        jo = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jo, rtol=0,
                                   atol=np.abs(jo).max() / 20)
        assert tcache["index"] == int(jcache["index"]) == p + step
        jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))[:, None] \
            .astype(np.int32)
        np.testing.assert_array_equal(tlog[:, -1].argmax(-1)[:, None]
                                      .numpy(), jtok)
        if step < gen:
            jlog, jcache = jt.decode_step(params, jcfg, jnp.asarray(jtok),
                                          jcache)
            tlog, tcache = tt.decode_step(model, tcfg,
                                          torch.from_numpy(jtok), tcache)
    jax.effects_barrier()
    expect = tcfg.num_layers * (gen + 1) if tcfg.family == "moe" else 0
    assert len(jplans) == len(tplans) == expect
    for (je, jk), (te, tk) in zip(jplans, tplans):
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tk, jk)
    for n in ("k", "v"):
        jc = np.asarray(jcache["kv"][n], np.float32)
        np.testing.assert_allclose(tcache["kv"][n].float().numpy(), jc,
                                   rtol=0, atol=np.abs(jc).max() / 20)


def test_decode_routes_agree_on_the_port():
    """The kernel route (flash prefill, kernel dispatch) and the torch
    route (chunked attention, one-hot dispatch) of the port give the
    same greedy tokens on the SMOKE MoE config."""
    cfg = tconfigs.get_smoke_config("deepseek-moe-16b")
    gen = torch.Generator().manual_seed(3)
    model = tt.init(cfg, generator=gen, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    outs = []
    for kw in ({}, {"use_pallas_dispatch": False, "attn_impl": "chunked"}):
        cache = tt.zeros_cache(cfg, 2, 13, device="cpu")
        logits, cache = tt.prefill(model, cfg, toks, cache, **kw)
        seq = []
        for _ in range(4):
            tok = logits[:, -1].argmax(-1)[:, None]
            seq.append(tok)
            logits, cache = tt.decode_step(model, cfg, tok, cache, **kw)
        outs.append(torch.cat(seq, 1))
    assert torch.equal(outs[0], outs[1])


# ---- structural rules --------------------------------------------------------------

def test_serving_path_raises_for_what_is_not_ported(monkeypatch):
    for arch in ("mamba2-2.7b", "zamba2-2.7b", "minicpm3-4b",
                 "musicgen-large"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt.Transformer(jax_smoke(arch), device="cpu")
    cfg = tconfigs.get_smoke_config("llama3-8b")
    model = tt.init(cfg, generator=torch.Generator(), device="cpu")
    cache = tt.zeros_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="prefix_emb"):
        tt.prefill(model, cfg, torch.zeros((1, 2), dtype=torch.int32),
                   cache, prefix_emb=torch.zeros((1, 1, cfg.d_model)))
    with pytest.raises(ValueError, match="do not fit"):
        tt.prefill(model, cfg, torch.zeros((1, 5), dtype=torch.int32), cache)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.zeros_cache(cfg, 1, 4)
    assert tg.resolve_device("cpu").type == "cpu"


def test_cache_layout():
    cfg = tconfigs.get_config("deepseek-moe-16b")
    shapes = tt.init_cache(cfg, 4, 1056)
    want = jt.init_cache(jax_config("deepseek-moe-16b"), 4, 1056)
    for n in ("k", "v"):
        assert shapes["kv"][n][0] == want["kv"][n].shape
        assert shapes["kv"][n][1] == torch.bfloat16
    assert shapes["index"] == ((), torch.int32)
