"""Decoder-only LM of the port: the serving path (init -> prefill ->
decode_step) of the ``dense`` and ``moe`` families with GQA attention.

Port of ``repro/models/transformer.py``.  The JAX package stacks each
layer's parameters as ``[L, ...]`` leaves under ``lax.scan``; the port
keeps one ``Block`` module per layer in a ``ModuleList`` and loops over
them (``models.convert.params_from_jax`` unstacks a JAX tree).  Not
ported yet (ROADMAP.md, Queue 1 item 11): the ``ssm`` and ``hybrid``
families, MLA attention, multi-codebook heads, ``prefix_emb`` and the
training ``forward``; asking for one raises ``NotImplementedError``.

Entry points:

* ``init(cfg, *, generator, device)``          -> ``Transformer``
* ``init_cache(cfg, batch, max_len)``          -> shapes and dtypes
* ``zeros_cache(cfg, batch, max_len, device)`` -> cache
* ``prefill(params, cfg, tokens, cache)``      -> (logits, cache)
* ``decode_step(params, cfg, token, cache)``   -> (logits, cache)

The cache is ``{"kv": {"k": [L, B, Smax, Hkv, hd], "v": ...}, "index":
int}``: the KV tensors are updated in place and the index is a host
int, so a decode step needs no device-to-host sync.  The residual
stream is bf16 (``_embed`` casts, as in JAX); logits are float32.

On the serving path ``use_pallas_dispatch=True`` (the default) computes
every MoE layer's arrival ranks with the hand-written kernel
``positions_in_expert``, and ``attn_impl="flash"`` (the default) runs
prefill attention through the hand-written kernel ``flash_attention``;
on CPU tensors both wrappers compute their plain versions.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.graph import resolve_device
from . import layers as L
from .layers import COMPUTE_DTYPE
from .moe import MoE

_LOGITS_DTYPE = torch.float32
_SEE_ROADMAP = "not ported to repro_torch yet; see ROADMAP.md, Queue 1 item 11"


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

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.norm1 = L._zeros_gain(cfg.d_model, device)
        self.norm2 = L._zeros_gain(cfg.d_model, device)
        self.attn = L.GQA(cfg, generator=generator, device=device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, generator=generator, device=device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act,
                             generator=generator, device=device)


class Transformer(nn.Module):
    """``embed [Vp, d]``, ``layers``, ``final_norm [d]`` and, unless the
    embeddings are tied, ``lm_head [d, Vp]`` (the ``transformer.init``
    layout).  Weights are bf16 and take no gradient."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        vp, d = cfg.padded_vocab, cfg.d_model
        self.embed = L._matrix((vp, d), generator, device, 0.02)
        self.layers = nn.ModuleList(
            Block(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.final_norm = L._zeros_gain(d, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else L._matrix((d, vp), generator, device))


def init(cfg, *, generator: torch.Generator, device=None) -> Transformer:
    """Random bf16 weights on ``device`` (cuda unless the caller names
    another), drawn from ``generator`` (which must live on that
    device): normal with std ``1/sqrt(shape[0])``, 0.02 for the
    embedding, as ``transformer.init`` draws them in float32."""
    return Transformer(cfg, generator=generator,
                       device=resolve_device(device))


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
    return p.embed[tokens]                # bf16: the residual stream dtype


def _head(p, cfg, x):
    xn = L.rms_norm(x, p.final_norm, cfg.norm_eps).to(COMPUTE_DTYPE)
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return (xn @ w).to(_LOGITS_DTYPE)


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
