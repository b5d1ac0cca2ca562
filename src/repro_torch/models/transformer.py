"""Decoder-only LM of the port: the training forward and the serving
path (init -> prefill -> decode_step) of the ``dense`` and ``moe``
families with GQA attention.

Port of ``repro/models/transformer.py``.  The JAX package stacks each
layer's parameters as ``[L, ...]`` leaves under ``lax.scan``; the port
keeps one ``Block`` module per layer in a ``ModuleList`` and loops over
them (``models.convert.params_from_jax`` unstacks a JAX tree).  Not
ported yet (ROADMAP.md, Queue 1 item 10): the ``ssm`` and ``hybrid``
families, MLA attention, multi-codebook heads and ``prefix_emb``;
asking for one raises ``NotImplementedError``.

Entry points:

* ``init(cfg, *, generator, device, param_dtype)`` -> ``Transformer``
* ``forward(params, cfg, tokens, *, remat)``   -> (logits, aux)  (training)
* ``init_cache(cfg, batch, max_len)``          -> shapes and dtypes
* ``zeros_cache(cfg, batch, max_len, device)`` -> cache
* ``prefill(params, cfg, tokens, cache)``      -> (logits, cache)
* ``decode_step(params, cfg, token, cache)``   -> (logits, cache)

Parameters are made frozen.  Serving keeps bf16 matrices (``init``'s
default); training asks for ``param_dtype=torch.float32``, JAX's float32
parameters, cast to bf16 at each use, and turns their gradients on
(``train.steps.init_train_state``).
JAX's ``forward`` also takes ``shard_fn`` and ``unroll``, its pjit
sharding hook and its HLO-cost switch: they come back with the port of
``launch/sharding`` and ``launch/dryrun``, and the port has neither.

The cache is ``{"kv": {"k": [L, B, Smax, Hkv, hd], "v": ...}, "index":
int}``: the KV tensors are updated in place and the index is a host
int, so a decode step needs no device-to-host sync.  The residual
stream is bf16 (``_embed`` casts, as in JAX); logits are float32.

``use_pallas_dispatch=True`` (the default, in training too) computes
every MoE layer's dispatch plan with the hand-written kernel
``moe_plan`` (with its gate gradient under autograd); on the serving
path ``attn_impl="flash"`` (the default) runs prefill attention through
the hand-written kernel ``flash_attention``, which has no backward, so
``forward`` runs the torch ``chunked`` attention, as JAX trains.  On CPU tensors both wrappers compute their plain versions.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.graph import resolve_device
from . import layers as L
from .layers import COMPUTE_DTYPE
from .moe import MoE

_LOGITS_DTYPE = torch.float32
_SEE_ROADMAP = "not ported to repro_torch yet; see ROADMAP.md, Queue 1 item 10"


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is {_SEE_ROADMAP}")
    if cfg.attention != "gqa":
        raise NotImplementedError(f"attention {cfg.attention!r} is "
                                  f"{_SEE_ROADMAP}")
    if cfg.num_codebooks > 1:
        raise NotImplementedError(f"num_codebooks > 1 is {_SEE_ROADMAP}")


# ---------------------------------------------------------------------------
# modules + init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``norm1``, ``attn`` (GQA), ``norm2`` and ``moe`` or
    ``mlp``; the norm gains are float32 zeros (``1 + gamma``)."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm1 = L._zeros_gain(cfg.d_model, device)
        self.norm2 = L._zeros_gain(cfg.d_model, device)
        self.attn = L.GQA(cfg, **kw)
        if cfg.family == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)


class Transformer(nn.Module):
    """``embed [Vp, d]``, ``layers``, ``final_norm [d]`` and, unless the
    embeddings are tied, ``lm_head [d, Vp]`` (the ``transformer.init``
    layout).  Matrices of ``dtype`` (bf16 by default), gains float32."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        vp, d = cfg.padded_vocab, cfg.d_model
        kw = dict(dtype=dtype)
        self.embed = L._matrix((vp, d), generator, device, 0.02, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, generator=generator, device=device, **kw)
            for _ in range(cfg.num_layers))
        self.final_norm = L._zeros_gain(d, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else L._matrix((d, vp), generator, device, **kw))


def init(cfg, *, generator: torch.Generator, device=None,
         param_dtype: torch.dtype = COMPUTE_DTYPE) -> Transformer:
    """Random frozen weights on ``device`` (cuda unless the caller names
    another), drawn from ``generator`` (which must live on that
    device): normal with std ``1/sqrt(shape[0])``, 0.02 for the
    embedding, as ``transformer.init`` draws them in float32, then cast
    to ``param_dtype`` (bf16 to serve, ``torch.float32`` to train)."""
    return Transformer(cfg, generator=generator,
                       device=resolve_device(device), dtype=param_dtype)


# ---------------------------------------------------------------------------
# blocks, embedding, head
# ---------------------------------------------------------------------------

def _dense_block(p, x, cfg, *, positions, cache=None, cache_index=None,
                 use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    attn_in = L.rms_norm(x, p.norm1, cfg.norm_eps)
    a, new_cache = p.attn(attn_in, positions=positions, cache=cache,
                          cache_index=cache_index, attn_impl=attn_impl)
    x = x + a
    ff_in = L.rms_norm(x, p.norm2, cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = p.moe(ff_in, use_pallas_dispatch=use_pallas_dispatch)
    else:
        f, aux = p.mlp(ff_in), 0.0
    return x + f, new_cache, aux


def _embed(p, cfg, tokens, prefix_emb=None):
    if prefix_emb is not None:
        raise NotImplementedError(f"prefix_emb is {_SEE_ROADMAP}")
    # bf16, the residual stream's dtype; cast before the gather, as JAX
    # takes from the cast table (its gradient then sums in bf16 too)
    return L._c(p.embed)[tokens]


def _head(p, cfg, x):
    xn = L.rms_norm(x, p.final_norm, cfg.norm_eps).to(COMPUTE_DTYPE)
    w = L._c(p.embed).T if cfg.tie_embeddings else L._c(p.lm_head)
    return (xn @ w).to(_LOGITS_DTYPE)


# ---------------------------------------------------------------------------
# forward (training: no cache)
# ---------------------------------------------------------------------------

def _train_block(blk, x, cfg, positions, use_pallas_dispatch: bool):
    # chunked attention, as JAX trains: the flash kernel has no backward
    x, _, aux = _dense_block(blk, x, cfg, positions=positions,
                             use_pallas_dispatch=use_pallas_dispatch,
                             attn_impl="chunked")
    if not isinstance(aux, torch.Tensor):            # dense: no aux loss
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def forward(params, cfg, tokens, *, remat: bool = True,
            use_pallas_dispatch: bool = True):
    """tokens: ``[B, S]`` int.  Returns (logits ``[B, S, Vp]`` float32,
    aux), ``aux`` the float32 sum of the MoE layers' load-balancing
    losses (0 for ``dense``).  All positions at once, no cache, under
    autograd.

    ``remat`` runs each block under ``torch.utils.checkpoint`` (as JAX
    wraps the scanned body in ``jax.checkpoint``): the backward
    recomputes the block, so a step launches ``moe_plan`` twice a MoE
    layer.  Attention is the torch ``chunked`` version, JAX's training
    attention: the flash kernel has no backward."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.layers:
        args = (blk, x, cfg, positions, use_pallas_dispatch)
        if remat:            # the block draws no random numbers
            x, a = checkpoint(_train_block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _train_block(*args)
        aux = aux + a
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# inference: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len):
    """``{"kv": {name: (shape, dtype)}, "index": ((), torch.int32)}``:
    the decode state's layout, stacked over layers."""
    check_supported(cfg)
    kv = {n: ((cfg.num_layers, *shape), dt) for n, (shape, dt) in
          L.gqa_cache_shape(cfg, batch, max_len).items()}
    return {"kv": kv, "index": ((), torch.int32)}


def zeros_cache(cfg, batch, max_len, device=None):
    """An empty cache on ``device`` (cuda unless the caller names
    another); its index is the host int 0."""
    dev = resolve_device(device)
    kv = {n: torch.zeros(shape, dtype=dt, device=dev)
          for n, (shape, dt) in init_cache(cfg, batch, max_len)["kv"].items()}
    return {"kv": kv, "index": 0}


def _step(params, cfg, tokens, cache, cache_index: int, *,
          use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    """Shared prefill/decode body: writes the new keys and values into
    the cache in place and returns (logits of the last position, cache
    with the index advanced)."""
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    ci = int(cache_index)
    if ci + s > cache["kv"]["k"].shape[2]:
        raise ValueError(f"cache holds {cache['kv']['k'].shape[2]} "
                         f"positions; {ci} + {s} do not fit")
    positions = ci + torch.arange(s, dtype=torch.int32,
                                  device=x.device)[None, :]
    for li, blk in enumerate(params.layers):
        kv = {n: t[li] for n, t in cache["kv"].items()}
        x, _, _ = _dense_block(blk, x, cfg, positions=positions, cache=kv,
                               cache_index=ci,
                               use_pallas_dispatch=use_pallas_dispatch,
                               attn_impl=attn_impl)
    logits = _head(params, cfg, x[:, -1:])
    return logits, {"kv": cache["kv"], "index": ci + s}


@torch.no_grad()
def prefill(params, cfg, tokens, cache, prefix_emb=None, *,
            use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    """Fill the cache from a prompt ``tokens [B, S]`` (int) from
    position 0.  Returns (logits ``[B, 1, Vp]`` float32, cache)."""
    check_supported(cfg)
    if prefix_emb is not None:
        raise NotImplementedError(f"prefix_emb is {_SEE_ROADMAP}")
    return _step(params, cfg, tokens, cache, 0,
                 use_pallas_dispatch=use_pallas_dispatch,
                 attn_impl=attn_impl)


@torch.no_grad()
def decode_step(params, cfg, token, cache, *,
                use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    """token: ``[B, 1]``.  One autoregressive step at ``cache["index"]``."""
    check_supported(cfg)
    return _step(params, cfg, token, cache, cache["index"],
                 use_pallas_dispatch=use_pallas_dispatch,
                 attn_impl=attn_impl)
