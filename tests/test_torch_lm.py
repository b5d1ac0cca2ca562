"""Port parity of the LM serving path (``repro_torch.models``) against
``repro.models``: the configs, the layers (GQA, MLA, the multi-codebook
embedding and head), ``params_from_jax``, and prefill + 4 decode steps
of every SMOKE config on the same numpy inputs, with the MoE routing
asserted equal; plus the port's structural rules for the LM stack."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
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

ARCHS = list(JAX_ARCH_IDS)


def rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_registry(arch):
    for mine, theirs in ((tconfigs.get_config(arch), jax_config(arch)),
                         (tconfigs.get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_registry_is_jax_registry():
    """Every arch of ``repro.configs`` in its order; the port's config
    modules are its own (``minicpm-2b`` keeps ``LR_SCHEDULE``)."""
    assert tconfigs.ARCH_IDS == tuple(ARCHS)
    assert tconfigs._MODULES["minicpm-2b"].LR_SCHEDULE == "wsd"
    assert all(m.__name__.startswith("repro_torch.configs.")
               for m in tconfigs._MODULES.values())


def test_unknown_arch_raises_keyerror():
    for get in (tconfigs.get_config, tconfigs.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch 'gpt-9'"):
            get("gpt-9")


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


def test_mla_apply_with_cache_matches_jax():
    """minicpm3's MLA: prefill of 10 positions into a 16-slot latent
    cache, then two decode steps, against ``layers.mla_apply`` (its
    chunked attention at chunk 4: several blocks); outputs and the
    latent cache within 2 bf16 ulps of their magnitude (1/64)."""
    cfg = jax_smoke("minicpm3-4b")
    jp = jl.mla_init(jax.random.PRNGKey(0), cfg)
    tp = convert.load_jax_tree(tl.MLA(cfg, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    shapes = tl.mla_cache_shape(cfg, 2, 16)
    assert {n: sd[0] for n, sd in shapes.items()} == {
        n: sd.shape for n, sd in jl.mla_cache_shape(cfg, 2, 16).items()}
    jcache = {n: jnp.zeros(sh, jnp.bfloat16) for n, (sh, _) in shapes.items()}
    tcache = {n: torch.zeros(sh, dtype=dt) for n, (sh, dt) in shapes.items()}
    x = rnd(7, (2, 12, cfg.d_model))
    for ci, s in ((0, 10), (10, 1), (11, 1)):
        xs = x[:, ci:ci + s]
        pos = np.arange(ci, ci + s, dtype=np.int32)[None, :]
        jout, jcache = jl.mla_apply(jp, jnp.asarray(xs, jnp.bfloat16), cfg,
                                    positions=jnp.asarray(pos), cache=jcache,
                                    cache_index=ci, attn_chunk=4)
        tout, tcache = tl.mla_apply(tp, torch.from_numpy(xs).bfloat16(), cfg,
                                    positions=torch.from_numpy(pos),
                                    cache=tcache, cache_index=ci,
                                    attn_chunk=4)
        jo = np.asarray(jout, np.float32)
        np.testing.assert_allclose(tout.float().numpy(), jo, rtol=0,
                                   atol=np.abs(jo).max() / 64)
        for n in ("ckv", "k_rope"):
            jc = np.asarray(jcache[n], np.float32)
            np.testing.assert_allclose(tcache[n].float().numpy(), jc,
                                       rtol=0, atol=np.abs(jc).max() / 64)
    # the cache-less call (training) equals the prefill's output
    jout, _ = jl.mla_apply(jp, jnp.asarray(x, jnp.bfloat16), cfg,
                           positions=jnp.arange(12)[None, :])
    tout, _ = tl.mla_apply(tp, torch.from_numpy(x).bfloat16(), cfg,
                           positions=torch.arange(12)[None, :])
    jo = np.asarray(jout, np.float32)
    np.testing.assert_allclose(tout.float().numpy(), jo, rtol=0,
                               atol=np.abs(jo).max() / 64)


def test_multicodebook_embed_and_head_match_jax():
    """musicgen's ``[B, S, ncb]`` tokens: the left-to-right bf16 sum of
    the ``ncb`` tables bitwise JAX's ``_embed``; the ``bsnv`` head in
    float32 within one bf16 rounding of the logits (1/128 of their
    magnitude), shape ``[B, S, ncb, Vp]``."""
    jcfg = jax_smoke("musicgen-large")
    tcfg = tconfigs.get_smoke_config("musicgen-large")
    params = jt.init(jax.random.PRNGKey(2), jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    assert model.embed.shape == (2, tcfg.padded_vocab, tcfg.d_model)
    assert model.lm_head.shape == (2, tcfg.d_model, tcfg.padded_vocab)
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 5, 2)).astype(np.int32)
    je = jt._embed(params, jcfg, jnp.asarray(toks))
    te = tt._embed(model, tcfg, torch.from_numpy(toks))
    assert te.dtype == torch.bfloat16
    np.testing.assert_array_equal(te.float().numpy(),
                                  np.asarray(je, np.float32))
    x = rnd(8, (2, 5, tcfg.d_model))
    jh = np.asarray(jt._head(params, jcfg, jnp.asarray(x, jnp.bfloat16)))
    th = tt._head(model, tcfg, torch.from_numpy(x).bfloat16())
    assert th.dtype == torch.float32 and th.shape == (
        2, 5, 2, tcfg.padded_vocab)
    np.testing.assert_allclose(th.numpy(), jh, rtol=0,
                               atol=np.abs(jh).max() / 128)


# ---- params_from_jax --------------------------------------------------------------

def jax_row(params, name, group):
    """The JAX leaf (row) of the port's parameter ``name``: hybrid
    layer leaves are ``[G, attn_every, ...]``."""
    node = params
    parts = name.split(".")
    row = None
    if parts[0] == "layers":
        li = int(parts[1])
        row = divmod(li, group) if group else li
        parts = ["layers"] + parts[2:]
    for k in parts:
        node = node[k]
    return node if row is None else node[row]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(arch):
    """Every leaf carried, unstacked per layer (row ``[g, l]`` of a
    hybrid's ``[G, attn_every, ...]`` leaves, ``shared_attn`` whole),
    matrices (and the qkv biases, which JAX casts at use) bf16 by
    round-to-nearest-even (bitwise XLA's astype), the Mamba2 vectors and
    every gain float32 (bitwise)."""
    cfg = tconfigs.get_smoke_config(arch)
    params = jt.init(jax.random.PRNGKey(0), jax_smoke(arch))
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    group = cfg.attn_every if cfg.family == "hybrid" else 0
    assert tt.layer_stack(cfg) == ((cfg.num_layers // group, group) if group
                                   else (cfg.num_layers,))
    assert len(model.layers) == cfg.num_layers
    n_leaves = sum(a.size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_leaves
    for name, p in model.named_parameters():
        leaf = jax_row(params, name, group)
        want = np.asarray(leaf.astype(jnp.bfloat16) if p.dtype ==
                          torch.bfloat16 else leaf, np.float32)
        bias = name.rsplit(".", 1)[-1] in ("bq", "bk", "bv")  # bf16 at use
        assert p.dtype == (torch.bfloat16 if leaf.ndim > 1 or bias
                           else torch.float32), name
        np.testing.assert_array_equal(p.float().numpy(), want, err_msg=name)
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


# the seed of each arch's params and prompts; the MoE configs take one
# whose bf16 routing agrees (see the test)
SEEDS = {"deepseek-moe-16b": 1, "llama4-scout-17b-a16e": 0}
# bf16 serving tolerance, of each tensor's largest magnitude.  Mamba2
# blocks compound the one-ulp bf16 differences of XLA and torch through
# the SSD's decays (one block: 8.5e-3, tests/test_torch_mamba2.py), so
# the ssm and hybrid SMOKE models drift further than the attention ones
# (measured over seeds 0-3: at most 0.059 of the largest logit and 0.062
# of a cache tensor, against 1/56 for the attention models); with both
# packages computing in float32 the same prefill and decode steps agree
# to 2.7e-6, and tests/test_torch_arch.py holds every family's float32
# forward to 1e-5
SERVE_TOL = {"ssm": 1 / 8, "hybrid": 1 / 8}


def greedy(logits):
    """Next tokens of ``[B, 1, Vp]`` (``[B, 1, ncb, Vp]``) logits:
    ``[B, 1]`` (``[B, 1, ncb]``)."""
    return logits.argmax(-1)


def cache_leaves(cache):
    return {f"{part}/{n}": t for part, ts in cache.items()
            if part != "index" for n, t in ts.items()}


@pytest.mark.parametrize("arch,seed", [(a, SEEDS.get(a, 0)) for a in ARCHS])
def test_prefill_decode_matches_jax(monkeypatch, arch, seed):
    """Prefill of 2 x 16 tokens (behind 8 seeded prefix embeddings for
    paligemma; ``[2, 16, 2]`` codebook tokens for musicgen) and 4
    greedy decode steps: every MoE layer's routing (flat_expert, keep)
    equal, greedy tokens equal, ``cache["index"]`` equal, logits within
    1/20 of their largest magnitude (bf16 products and the residual
    stream round differently in XLA and torch: measured at most 1/56,
    about 3 bf16 ulps; ``SERVE_TOL`` for the Mamba2 families), every
    cache tensor (KV, MLA latent, SSM and conv states) within the same
    share of its largest magnitude.  The routers'
    logits are bf16, so near-equal ones are common and a one-ulp
    difference can swap two experts: of seeds 0-7 of the deepseek MoE
    SMOKE config, 1, 4 and 7 route identically, and the test takes one
    of those (seed 0 for llama4-scout, which routes top-1) and asserts
    it."""
    b, p, gen = 2, 16, 4
    jcfg, tcfg = jax_smoke(arch), tconfigs.get_smoke_config(arch)
    tol = SERVE_TOL.get(tcfg.family, 1 / 20)
    params = jt.init(jax.random.PRNGKey(seed), jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    rng = np.random.default_rng(seed)
    cb = (tcfg.num_codebooks,) if tcfg.num_codebooks > 1 else ()
    toks = rng.integers(0, jcfg.vocab_size, (b, p, *cb)).astype(np.int32)
    pl = tcfg.prefix_len
    jpre = tpre = None
    if pl:
        pre = rng.standard_normal((b, pl, tcfg.d_model)).astype(np.float32)
        jpre = jnp.asarray(pre, jnp.bfloat16)
        tpre = torch.from_numpy(pre).bfloat16()
    jplans, tplans = [], []
    _record_plans(monkeypatch, jmoe, jplans)
    _record_plans(monkeypatch, tmoe, tplans)
    jcache = jt.zeros_cache(jcfg, b, pl + p + gen)
    tcache = tt.zeros_cache(tcfg, b, pl + p + gen, device="cpu")
    jlog, jcache = jt.prefill(params, jcfg, jnp.asarray(toks), jcache,
                              prefix_emb=jpre)
    tlog, tcache = tt.prefill(model, tcfg, torch.from_numpy(toks), tcache,
                              prefix_emb=tpre)
    for step in range(gen + 1):
        assert tlog.dtype == torch.float32 and tlog.shape == (
            b, 1, *cb, tcfg.padded_vocab)
        jo = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), jo, rtol=0,
                                   atol=np.abs(jo).max() * tol)
        assert tcache["index"] == int(jcache["index"]) == pl + p + step
        jtok = np.asarray(greedy(jlog)).astype(np.int32)
        np.testing.assert_array_equal(greedy(tlog).numpy(), jtok)
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
    tleaves = cache_leaves(tcache)
    jleaves = {k: np.asarray(v, np.float32)
               for k, v in cache_leaves(jcache).items()}
    assert sorted(tleaves) == sorted(jleaves)
    for n, jc in jleaves.items():
        assert tuple(tleaves[n].shape) == jc.shape, n
        np.testing.assert_allclose(tleaves[n].float().numpy(), jc, rtol=0,
                                   atol=np.abs(jc).max() * tol, err_msg=n)


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
    cfg = tconfigs.get_smoke_config("llama3-8b")
    model = tt.init(cfg, generator=torch.Generator(), device="cpu")
    cache = tt.zeros_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        tt.prefill(model, cfg, torch.zeros((1, 5), dtype=torch.int32), cache)
    vlm = tconfigs.get_smoke_config("paligemma-3b")
    with pytest.raises(ValueError, match="do not fit"):  # prefix counts
        tt.prefill(tt.init(vlm, generator=torch.Generator(), device="cpu"),
                   vlm, torch.zeros((1, 2), dtype=torch.int32),
                   tt.zeros_cache(vlm, 1, 9, device="cpu"),
                   prefix_emb=torch.zeros((1, vlm.prefix_len, vlm.d_model)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.zeros_cache(cfg, 1, 4)
    assert tg.resolve_device("cpu").type == "cpu"


def test_cache_layout():
    """For every arch, the cache's parts, shapes and dtypes are JAX's
    ``init_cache`` at full size (KV, MLA latent, SSM states stacked
    ``[G, attn_every]`` under hybrid); the port's index is a host int."""
    for arch in ARCHS:
        shapes = tt.init_cache(tconfigs.get_config(arch), 4, 1056)
        want = jt.init_cache(jax_config(arch), 4, 1056)
        assert sorted(shapes) == sorted(want), arch
        for part, tensors in want.items():
            if part == "index":
                assert shapes["index"] == ((), torch.int32)
                continue
            assert sorted(shapes[part]) == sorted(tensors), (arch, part)
            for n, sd in tensors.items():
                got_shape, got_dtype = shapes[part][n]
                assert got_shape == sd.shape, (arch, part, n)
                assert str(got_dtype).split(".")[-1] == str(sd.dtype)
