"""Per-architecture smoke tests of the port (the counterpart of
tests/test_arch_smoke.py, with its four cases for every arch): the
SMOKE config's forward, a train step, prefill then decode, and prefill
+ decode against the forward; plus every family's forward against JAX's
with both packages computing in float32.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as jl
from repro.models import mamba2 as jm
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import convert
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.optim import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step

B, S = 2, 32


def batch_of(cfg, seed=1):
    """Tokens and labels (``[B, S]`` or ``[B, S, ncb]``) and, for vlm,
    bf16 prefix embeddings, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    tokens = rng.integers(0, cfg.vocab_size, (B, S, *cb)).astype(np.int32)
    out = {"tokens": tokens, "labels": tokens}
    if cfg.prefix_len:
        out["prefix_emb"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(cfg, seed=1):
    out = {k: torch.from_numpy(v) for k, v in batch_of(cfg, seed).items()}
    if "prefix_emb" in out:
        out["prefix_emb"] = out["prefix_emb"].bfloat16()
    return out


def model_of(cfg, seed=0, **kw):
    return tt.init(cfg, generator=torch.Generator().manual_seed(seed),
                   device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes_and_finite(arch):
    cfg = get_smoke_config(arch)
    batch = torch_batch(cfg)
    with torch.no_grad():
        logits, aux = tt.forward(model_of(cfg), cfg, batch["tokens"],
                                 batch.get("prefix_emb"), remat=False)
    total_s = S + cfg.prefix_len
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    assert logits.shape == (B, total_s, *cb, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss(arch):
    """Four AdamW steps (lr 3e-3) on one batch: finite, falling loss."""
    cfg = get_smoke_config(arch)
    params, opt = init_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, OptConfig(lr=3e-3))
    batch = torch_batch(cfg)
    losses = []
    for _ in range(4):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode(arch):
    """Prefill (behind the prefix for vlm, which JAX's smoke test
    skips) and two decode steps: finite logits, the index advanced."""
    cfg = get_smoke_config(arch)
    model = model_of(cfg)
    batch = torch_batch(cfg)
    pl = cfg.prefix_len
    cache = tt.zeros_cache(cfg, B, pl + S + 4, device="cpu")
    logits, cache = tt.prefill(model, cfg, batch["tokens"], cache,
                               batch.get("prefix_emb"))
    assert bool(torch.isfinite(logits).all())
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    tok = torch.zeros((B, 1, *cb), dtype=torch.int32)
    for _ in range(2):
        logits, cache = tt.decode_step(model, cfg, tok, cache)
        assert logits.shape == (B, 1, *cb, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
    assert cache["index"] == pl + S + 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_forward(arch):
    """Incremental decoding agrees with the parallel forward pass, at
    tests/test_arch_smoke.py's tolerance (2e-2 relative and absolute):
    prefill of S - 2 positions, then two decode steps.  An MoE layer's
    capacity scales with the tokens of the call, so a decode step and
    the forward drop different slots; the MoE configs run here with
    ``capacity_factor = E / top_k``, a capacity of every token, where
    nothing is dropped and the two must agree (JAX's smoke test leaves
    the MoE configs out of this case)."""
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = model_of(cfg)
    batch = torch_batch(cfg)
    toks, pre = batch["tokens"], batch.get("prefix_emb")
    pl = cfg.prefix_len
    with torch.no_grad():
        full, _ = tt.forward(model, cfg, toks, pre, remat=False)
    cache = tt.zeros_cache(cfg, B, pl + S, device="cpu")
    got, cache = tt.prefill(model, cfg, toks[:, :S - 2], cache, pre)
    for i in (S - 2, S - 1):
        torch.testing.assert_close(got[:, 0], full[:, pl + i - 1],
                                   rtol=2e-2, atol=2e-2)
        got, cache = tt.decode_step(model, cfg, toks[:, i:i + 1], cache)
    torch.testing.assert_close(got[:, 0], full[:, pl + S - 1], rtol=2e-2,
                               atol=2e-2)


# ---- float32 forward against JAX -------------------------------------------------

@contextlib.contextmanager
def float32_compute():
    """Both packages' products in float32 (bf16 is their default)."""
    mods = ((jl, jnp), (jmoe, jnp), (jt, jnp), (jm, jnp), (tl, torch),
            (tmoe, torch), (tt, torch), (tm, torch))
    old = [m.COMPUTE_DTYPE for m, _ in mods]
    for m, lib in mods:
        m.COMPUTE_DTYPE = lib.float32
    try:
        yield
    finally:
        for (m, _), o in zip(mods, old):
            m.COMPUTE_DTYPE = o


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_float32_matches_jax(arch):
    """``forward`` from the same converted float32 parameters, both
    packages computing in float32: logits within 1e-5 of their largest
    magnitude (summation order; measured at most 5.8e-6, mamba2), aux
    within 1e-5 relative (measured 8.4e-8).  This is the check of each
    family's math; a swapped expert would show far above it."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    batch = batch_of(tcfg)
    with float32_compute():
        params = jt.init(jax.random.PRNGKey(3), jcfg)
        pre = batch.get("prefix_emb")
        want, jaux = jax.jit(lambda p, t, e: jt.forward(
            p, jcfg, t, prefix_emb=e, remat=False))(
                params, jnp.asarray(batch["tokens"]),
                None if pre is None else jnp.asarray(pre))
        model = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu",
                                        param_dtype=torch.float32)
        with torch.no_grad():
            got, aux = tt.forward(model, tcfg,
                                  torch.from_numpy(batch["tokens"]),
                                  None if pre is None
                                  else torch.from_numpy(pre), remat=False)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)),
                                                        1e-3)
