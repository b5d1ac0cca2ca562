"""Port parity of the training path for the families the dense / MoE
tests (tests/test_torch_train.py) do not reach: zamba2 (hybrid: Mamba2
groups and the shared block, remat per group), minicpm3 (MLA),
paligemma (vlm: ``prefix_emb`` and the loss from ``prefix_len`` on) and
musicgen (audio: codebook tokens and logits).  Loss and every
parameter's gradient against ``jax.value_and_grad`` of JAX's
``make_loss_fn`` from the same converted parameters, both packages
computing in float32, where the same math must agree to float32
rounding; plus the AdamW bookkeeping of a hybrid's twice-stacked leaves.
"""
import contextlib

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
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import layer_dims, leaf_ndim
from repro_torch.train import steps as tsteps

ARCHS = ["zamba2-2.7b", "minicpm3-4b", "paligemma-3b", "musicgen-large"]
B, S = 2, 32
# float32 compute: loss 1e-6 relative (measured 1.6e-7), each gradient
# 1e-5 of its largest magnitude (measured at most 2.4e-6 on the
# attention families); zamba2 5e-5: ``a_log``'s gradient sums the
# decays' derivative over every position and chunk, in another order
# in XLA (measured 1.6e-5; its other leaves at most 6.8e-6)
LOSS_RTOL = 1e-6
GRAD_TOL = {"hybrid": 5e-5}


@contextlib.contextmanager
def float32_compute():
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


def leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def batch_of(cfg):
    """Next-token batch (labels shifted), codebook-shaped for audio,
    with float32 prefix embeddings for vlm, from numpy seed 5."""
    rng = np.random.default_rng(5)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1, *cb)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.prefix_len:
        out["prefix_emb"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_loss_and_gradients_match_jax(arch):
    """remat on both sides (per layer; per group under hybrid).  Every
    leaf's gradient, the unused ``dt_bias`` included (0 in both)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    batch = batch_of(tcfg)
    with float32_compute():
        params = jt.init(jax.random.PRNGKey(4), jcfg)
        (jloss, jce), jgrads = jax.jit(jax.value_and_grad(
            jsteps.make_loss_fn(jcfg, remat=True), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        model = convert.params_from_jax(
            jax.tree.map(np.asarray, params), tcfg, device="cpu",
            param_dtype=torch.float32).requires_grad_()
        loss, ce = tsteps.make_loss_fn(tcfg, remat=True)(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
    loss, ce = float(loss.detach()), float(ce.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(ce - float(jce)) <= LOSS_RTOL * abs(float(jce))
    got = dict(leaves(convert.jax_tree(dict(zip(named, grads)),
                                       lead=tt.layer_stack(tcfg))))
    want = dict(leaves(jax.tree.map(np.asarray, jgrads)))
    assert sorted(got) == sorted(want)
    tol = GRAD_TOL.get(tcfg.family, 1e-5)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert rel_err(got[name], w) <= tol, (name, rel_err(got[name], w))
    if tcfg.family == "hybrid":
        assert np.abs(want["layers/mamba/dt_bias"]).max() == 0
        assert np.abs(got["shared_attn/attn/wq"]).max() > 0


def test_hybrid_leaf_ndim_and_master_casts_follow_jax():
    """zamba2: a layer parameter is a row of a ``[G, attn_every, ...]``
    leaf (``leaf_ndim`` adds 2), ``shared_attn`` leaves are whole (adds
    0); with H2 master weights the port casts to bf16 exactly the leaves
    JAX's ``init_train_state`` casts."""
    jcfg, tcfg = jax_smoke("zamba2-2.7b"), get_smoke_config("zamba2-2.7b")
    jparams, _ = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg,
                                         master_weights=True)
    jleaves = dict(leaves(jax.tree.map(np.asarray, jparams)))
    jdtypes = _dtypes(jparams)
    model, opt = tsteps.init_train_state(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu",
        master_weights=True)
    assert layer_dims(model) == 2
    tree = convert.jax_tree(dict(model.named_parameters()), shapes_only=True,
                            lead=tt.layer_stack(tcfg))
    got_dtypes = _dtypes(tree)
    assert got_dtypes.keys() == jdtypes.keys()
    for name, p in model.named_parameters():
        path, _ = convert._jax_path(name, tt.layer_stack(tcfg))
        key = "/".join(path)
        assert leaf_ndim(name, p, 2) == jleaves[key].ndim, name
        assert got_dtypes[key] == jdtypes[key], (name, got_dtypes[key])
    assert set(opt["master"]) == set(dict(model.named_parameters()))


def _dtypes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dtypes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = str(v.dtype).split(".")[-1]
    return out
