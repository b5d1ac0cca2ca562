"""Decoder-only LM of the port: the training forward and the serving
path (init -> prefill -> decode_step) of every family the JAX package
serves.

Port of ``repro/models/transformer.py``.  Families:

* ``dense`` (and ``vlm``, ``audio``, which JAX serves as ``dense``):
  GQA or MLA attention and a SwiGLU / GELU MLP;
* ``moe``: attention and the ALB-adaptive MoE FFN;
* ``ssm``: Mamba2 (SSD) blocks, no attention;
* ``hybrid`` (zamba2): groups of ``attn_every`` Mamba2 blocks, each
  followed by the one SHARED attention + MLP block (a single weight set
  applied at every group boundary; each group keeps its own KV cache).

Inputs: ``prefix_emb [B, P, d]`` (vlm) is put in front of the token
embeddings; multi-codebook configs (audio) take tokens ``[B, S, ncb]``,
sum the ``ncb`` embedding tables left to right and give logits
``[B, S, ncb, Vp]``.

The JAX package stacks each layer's parameters as ``[L, ...]`` leaves
(``[G, attn_every, ...]`` under hybrid) under ``lax.scan``; the port
keeps one module per layer in a ``ModuleList`` (``layers.{g *
attn_every + l}`` under hybrid) and loops over them
(``models.convert.params_from_jax`` unstacks a JAX tree).

Entry points:

* ``init(cfg, *, generator, device, param_dtype)`` -> ``Transformer``
* ``forward(params, cfg, tokens, prefix_emb, *, remat)`` -> (logits, aux)
* ``init_cache(cfg, batch, max_len)``          -> shapes and dtypes
* ``zeros_cache(cfg, batch, max_len, device)`` -> cache
* ``prefill(params, cfg, tokens, cache, prefix_emb)`` -> (logits, cache)
* ``decode_step(params, cfg, token, cache)``   -> (logits, cache)

Parameters are made frozen.  Serving keeps bf16 matrices (``init``'s
default); training asks for ``param_dtype=torch.float32``, JAX's float32
parameters, cast to bf16 at each use, and turns their gradients on
(``train.steps.init_train_state``).
``shard_fn(name, x)`` (identity by default) is JAX's sharding hook, at
JAX's call points: ``"hidden"`` after the embedding, ``"resid"`` on each
residual add (``"moe_tok"`` / ``"moe_buf"`` inside ``moe_apply``); the
launcher's ``launch.sharding.make_shard_fn`` redistributes a DTensor
activation there, and the model runs on DTensor parameters and inputs
as on tensors (``models.dist``).  JAX's ``unroll`` / ``_step_unrolled``
exist only to make XLA's cost analysis see the layers that ``lax.scan``
hides; the port's layers are a Python loop, so it has neither.  The
logits are float32, JAX's default; :func:`set_logits_dtype` switches
them (``launch.dryrun``'s ``logits_bf16``).

The cache is ``{"kv": {...}, "index": int}`` (dense, moe: ``{"k", "v":
[L, B, Smax, Hkv, hd]}`` under GQA, ``{"ckv": [L, B, Smax, r],
"k_rope": [L, B, Smax, 1, rope]}`` under MLA), ``{"ssm": {"h": [L, B,
H, P, N], "conv": [L, B, d_conv - 1, C]}, "index"}`` (ssm), or
``{"ssm": {"h": [G, A, ...], "conv": [G, A, ...]}, "attn": {"k", "v":
[G, B, Smax, Hkv, hd]}, "index"}`` (hybrid).  Every tensor is updated in
place and the index is a host int, so a decode step needs no
device-to-host sync.  The residual stream is bf16 (``_embed`` casts, as
in JAX).  An SSM prefill runs the chunked scan from no state and keeps
the final state, as JAX's ``_prefill_ssm`` does; its decode steps run
``ssd_step`` with the conv state.

``use_pallas_dispatch=True`` (the default, in training too) computes
every MoE layer's dispatch plan with the hand-written kernel
``moe_plan`` (with its gate gradient under autograd); on the serving
path ``attn_impl="flash"`` (the default) runs GQA prefill attention
through the hand-written kernel ``flash_attention``, which has no
backward, so ``forward`` runs the torch ``chunked`` attention, as JAX
trains.  MLA attention takes the torch ``chunked`` route everywhere
(``layers.mla_apply``).  On CPU tensors both wrappers compute their
plain versions.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.graph import resolve_device
from . import dist as D
from . import layers as L
from . import mamba2 as M
from .layers import COMPUTE_DTYPE
from .moe import MoE

_IDENT = lambda name, x: x

# H4: logits dtype. f32 is the safe default; bf16 halves the dominant
# activation (the [B, S, V] logits) for big-vocab archs — CE still
# reduces in f32 (logsumexp upcasts).
_LOGITS_DTYPE = torch.float32


def set_logits_dtype(dt) -> None:
    global _LOGITS_DTYPE
    _LOGITS_DTYPE = dt


def _as_ssm(cfg):
    return dataclasses.replace(cfg, family="ssm")


def groups(cfg) -> int:
    """Shared-block applications of a hybrid config."""
    return cfg.num_layers // cfg.attn_every


def layer_stack(cfg) -> tuple:
    """The leading dimensions JAX stacks a layer leaf over: ``(G,
    attn_every)`` for a hybrid, else ``(num_layers,)``.  Layer ``i`` of
    the port is row ``np.unravel_index(i, layer_stack(cfg))``."""
    if cfg.family == "hybrid":
        return groups(cfg), cfg.attn_every
    return (cfg.num_layers,)


# ---------------------------------------------------------------------------
# modules + init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One attention layer: ``norm1``, ``attn`` (GQA or MLA), ``norm2``
    and ``moe`` or ``mlp``; the norm gains are float32 zeros
    (``1 + gamma``).  Also the hybrid's shared block."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm1 = L._zeros_gain(cfg.d_model, device)
        self.norm2 = L._zeros_gain(cfg.d_model, device)
        self.attn = L.MLA(cfg, **kw) if cfg.attention == "mla" \
            else L.GQA(cfg, **kw)
        if cfg.family == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)


class SSMBlock(nn.Module):
    """One Mamba2 layer: ``norm`` (float32 zeros) and ``mamba``."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.norm = L._zeros_gain(cfg.d_model, device)
        self.mamba = M.Mamba2(cfg, generator=generator, device=device,
                              dtype=dtype)


class Transformer(nn.Module):
    """``embed [Vp, d]`` (``[ncb, Vp, d]``), ``layers``, ``shared_attn``
    (hybrid), ``final_norm [d]`` and, unless the embeddings are tied,
    ``lm_head [d, Vp]`` (``[ncb, d, Vp]``): the ``transformer.init``
    layout.  Matrices of ``dtype`` (bf16 by default), gains float32."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        vp, d, ncb = cfg.padded_vocab, cfg.d_model, cfg.num_codebooks
        kw = dict(generator=generator, device=device, dtype=dtype)
        cb = (ncb,) if ncb > 1 else ()
        self.embed = L._matrix((*cb, vp, d), generator, device, 0.02,
                               dtype=dtype)
        if cfg.family == "hybrid":
            n_layers, blk_cfg = groups(cfg) * cfg.attn_every, _as_ssm(cfg)
        else:
            n_layers, blk_cfg = cfg.num_layers, cfg
        blk = SSMBlock if blk_cfg.family == "ssm" else Block
        self.layers = nn.ModuleList(blk(blk_cfg, **kw)
                                    for _ in range(n_layers))
        if cfg.family == "hybrid":
            self.shared_attn = Block(cfg, **kw)
        self.final_norm = L._zeros_gain(d, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L._matrix((*cb, d, vp), generator, device,
                                  d ** -0.5, dtype=dtype))


def init(cfg, *, generator: torch.Generator | None, device=None,
         param_dtype: torch.dtype = COMPUTE_DTYPE) -> Transformer:
    """Random frozen weights on ``device`` (cuda unless the caller names
    another), drawn from ``generator`` (which must live on that
    device): normal with std ``1/sqrt(fan_in)``, 0.02 for the
    embedding, as ``transformer.init`` draws them in float32, then cast
    to ``param_dtype`` (bf16 to serve, ``torch.float32`` to train).
    ``generator=None`` draws nothing: the matrices are left
    uninitialized, and on ``device="meta"`` the model holds no memory
    (``launch.dryrun`` builds its shapes so)."""
    return Transformer(cfg, generator=generator,
                       device=resolve_device(device), dtype=param_dtype)


# ---------------------------------------------------------------------------
# blocks, embedding, head
# ---------------------------------------------------------------------------

def _dense_block(p, x, cfg, *, positions, cache=None, cache_index=None,
                 use_pallas_dispatch: bool = True, attn_impl: str = "flash",
                 shard_fn=_IDENT):
    # a sequence-parallel residual (seqpar) is gathered before the
    # products, as Megatron's sequence parallelism all-gathers it
    attn_in = D.unshard(L.rms_norm(x, p.norm1, cfg.norm_eps), 1)
    a, new_cache = p.attn(attn_in, positions=positions, cache=cache,
                          cache_index=cache_index, attn_impl=attn_impl)
    x = x + shard_fn("resid", a)
    ff_in = D.unshard(L.rms_norm(x, p.norm2, cfg.norm_eps), 1)
    if cfg.family == "moe":
        f, aux = p.moe(ff_in, use_pallas_dispatch=use_pallas_dispatch,
                       shard_fn=shard_fn)
    else:
        f, aux = p.mlp(ff_in), 0.0
    return x + shard_fn("resid", f), new_cache, aux


def _ssm_block(p, x, cfg, *, state=None, return_state: bool = False,
               shard_fn=_IDENT):
    h = D.unshard(L.rms_norm(x, p.norm, cfg.norm_eps), 1)
    out, new_state = p.mamba(h, state=state, return_state=return_state)
    return x + shard_fn("resid", out), new_state


def _embed(p, cfg, tokens, prefix_emb=None):
    # bf16, the residual stream's dtype; cast before the gather, as JAX
    # takes from the cast table (its gradient then sums in bf16 too)
    if cfg.num_codebooks > 1:                # tokens [B, S, ncb]
        table = L._c(p.embed)
        x = D.embed_rows(table[0], tokens[..., 0])
        for i in range(1, cfg.num_codebooks):
            x = x + D.embed_rows(table[i], tokens[..., i])
    else:
        x = D.embed_rows(L._c(p.embed), tokens)
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    return x


def _head(p, cfg, x):
    xn = D.unshard(L.rms_norm(x, p.final_norm, cfg.norm_eps), 1) \
        .to(COMPUTE_DTYPE)
    if cfg.tie_embeddings:
        return (xn @ L._c(p.embed).T).to(_LOGITS_DTYPE)
    if cfg.num_codebooks > 1:                # "bsd,ndv->bsnv"
        return torch.matmul(xn[:, None], L._c(p.lm_head)) \
            .transpose(1, 2).to(_LOGITS_DTYPE)
    return (xn @ L._c(p.lm_head)).to(_LOGITS_DTYPE)


# ---------------------------------------------------------------------------
# forward (training: no cache)
# ---------------------------------------------------------------------------

def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _train_block(blk, x, cfg, positions, use_pallas_dispatch: bool,
                 shard_fn):
    # chunked attention, as JAX trains: the flash kernel has no backward
    x, _, aux = _dense_block(blk, x, cfg, positions=positions,
                             use_pallas_dispatch=use_pallas_dispatch,
                             attn_impl="chunked", shard_fn=shard_fn)
    if not isinstance(aux, torch.Tensor):            # dense: no aux loss
        aux = _zero(x)
    return x, aux


def _train_ssm_block(blk, x, cfg, shard_fn):
    return _ssm_block(blk, x, cfg, shard_fn=shard_fn)[0]


def _train_group(params, gi, x, cfg, positions, shard_fn):
    """Group ``gi`` of a hybrid: its Mamba2 blocks, then the shared
    block."""
    a = cfg.attn_every
    for blk in params.layers[gi * a:(gi + 1) * a]:
        x = _train_ssm_block(blk, x, cfg, shard_fn)
    return _dense_block(params.shared_attn, x, cfg, positions=positions,
                        attn_impl="chunked", shard_fn=shard_fn)[0]


def _maybe_remat(remat: bool, fn, *args):
    # no block draws random numbers, so no rng state is kept
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def forward(params, cfg, tokens, prefix_emb=None, shard_fn=_IDENT, *,
            remat: bool = True, use_pallas_dispatch: bool = True):
    """tokens: ``[B, S]`` int (``[B, S, ncb]`` multi-codebook).  Returns
    (logits ``[B, P + S, Vp]`` (``[B, P + S, ncb, Vp]``), aux), ``aux``
    the float32 sum of the MoE layers' load-balancing losses (0 for the
    other families).  All positions at once, no cache, under autograd.

    ``remat`` runs each layer (under hybrid: each group of
    ``attn_every`` Mamba2 blocks and the shared block) under
    ``torch.utils.checkpoint``, as JAX wraps the scanned body in
    ``jax.checkpoint``: the backward recomputes it, so a step launches
    ``moe_plan`` twice a MoE layer.  Attention is the torch ``chunked``
    version, JAX's training attention: the flash kernel has no
    backward."""
    with D.scope(params.embed):
        return _forward(params, cfg, tokens, prefix_emb, shard_fn, remat,
                        use_pallas_dispatch)


def _forward(params, cfg, tokens, prefix_emb, shard_fn, remat: bool,
             use_pallas_dispatch: bool):
    x = shard_fn("hidden", _embed(params, cfg, tokens, prefix_emb))
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    aux = _zero(x)
    if cfg.family == "hybrid":
        for gi in range(groups(cfg)):
            x = _maybe_remat(remat, _train_group, params, gi, x, cfg,
                             positions, shard_fn)
    elif cfg.family == "ssm":
        for blk in params.layers:
            x = _maybe_remat(remat, _train_ssm_block, blk, x, cfg, shard_fn)
    else:
        for blk in params.layers:
            x, a = _maybe_remat(remat, _train_block, blk, x, cfg, positions,
                                use_pallas_dispatch, shard_fn)
            aux = aux + a
    return _head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# inference: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _stack(shapes: dict, *lead) -> dict:
    return {n: ((*lead, *shape), dt) for n, (shape, dt) in shapes.items()}


def init_cache(cfg, batch, max_len):
    """The decode state's layout, ``{name: (shape, dtype)}`` per part
    (stacked over layers, ``[G, attn_every]`` for a hybrid's SSM states),
    and ``"index": ((), torch.int32)``."""
    index = ((), torch.int32)
    lead = layer_stack(cfg)
    if cfg.family == "hybrid":
        return {"ssm": _stack(M.mamba2_state_shape(cfg, batch), *lead),
                "attn": _stack(L.gqa_cache_shape(cfg, batch, max_len),
                               groups(cfg)),
                "index": index}
    if cfg.family == "ssm":
        return {"ssm": _stack(M.mamba2_state_shape(cfg, batch), *lead),
                "index": index}
    shape = (L.mla_cache_shape(cfg, batch, max_len)
             if cfg.attention == "mla"
             else L.gqa_cache_shape(cfg, batch, max_len))
    return {"kv": _stack(shape, *lead), "index": index}


def zeros_cache(cfg, batch, max_len, device=None):
    """An empty cache on ``device`` (cuda unless the caller names
    another); its index is the host int 0."""
    dev = resolve_device(device)
    out = {part: {n: torch.zeros(shape, dtype=dt, device=dev)
                  for n, (shape, dt) in tensors.items()}
           for part, tensors in init_cache(cfg, batch, max_len).items()
           if part != "index"}
    out["index"] = 0
    return out


def _capacity(cache):
    """Positions the cache holds (None: an SSM state holds any)."""
    part = cache.get("kv", cache.get("attn"))
    return None if part is None else next(iter(part.values())).shape[2]


def _rows(tensors: dict, idx) -> dict:
    return {n: t[idx] for n, t in tensors.items()}


def _put(state: dict, new: dict) -> None:
    for n, t in state.items():
        t.copy_(new[n])


def _ssm_layers(params, cfg, x, cache, *, gi=None, stateful: bool,
                shard_fn=_IDENT):
    """The Mamba2 blocks of the ``ssm`` model (``gi`` None) or of
    hybrid group ``gi``, each writing its state into ``cache["ssm"]``:
    ``stateful`` steps from the cached state (decode), else from none,
    keeping the final state (prefill)."""
    if gi is None:
        rows = list(enumerate(params.layers))
    else:
        a = cfg.attn_every
        rows = [((gi, li), params.layers[gi * a + li]) for li in range(a)]
    for idx, blk in rows:
        st = _rows(cache["ssm"], idx)
        x, new = _ssm_block(blk, x, cfg, state=st if stateful else None,
                            return_state=True, shard_fn=shard_fn)
        _put(st, new)
    return x


def _step(params, cfg, tokens, cache, cache_index: int, prefix_emb=None,
          shard_fn=_IDENT, *, stateful: bool,
          use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    """Shared prefill/decode body: writes the new keys and values (and
    SSM states) into the cache in place and returns (logits of the last
    position, cache with the index advanced).  The Mamba2 blocks step
    from the cached state when ``stateful`` (decode), else run the
    chunked scan from no state (prefill)."""
    with D.scope(params.embed):
        return _step_body(params, cfg, tokens, cache, cache_index,
                          prefix_emb, shard_fn, stateful,
                          use_pallas_dispatch, attn_impl)


def _step_body(params, cfg, tokens, cache, cache_index, prefix_emb, shard_fn,
               stateful, use_pallas_dispatch, attn_impl):
    x = shard_fn("hidden", _embed(params, cfg, tokens, prefix_emb))
    s = x.shape[1]
    ci = int(cache_index)
    cap = _capacity(cache)
    if cap is not None and ci + s > cap:
        raise ValueError(f"cache holds {cap} positions; {ci} + {s} do not "
                         f"fit")
    positions = ci + torch.arange(s, dtype=torch.int32,
                                  device=x.device)[None, :]
    if cfg.family == "hybrid":
        for gi in range(groups(cfg)):
            x = _ssm_layers(params, cfg, x, cache, gi=gi, stateful=stateful,
                            shard_fn=shard_fn)
            x, _, _ = _dense_block(params.shared_attn, x, cfg,
                                   positions=positions,
                                   cache=_rows(cache["attn"], gi),
                                   cache_index=ci, attn_impl=attn_impl,
                                   shard_fn=shard_fn)
    elif cfg.family == "ssm":
        x = _ssm_layers(params, cfg, x, cache, stateful=stateful,
                        shard_fn=shard_fn)
    else:
        for li, blk in enumerate(params.layers):
            x, _, _ = _dense_block(blk, x, cfg, positions=positions,
                                   cache=_rows(cache["kv"], li),
                                   cache_index=ci,
                                   use_pallas_dispatch=use_pallas_dispatch,
                                   attn_impl=attn_impl, shard_fn=shard_fn)
    logits = _head(params, cfg, x[:, -1:])
    return logits, {**cache, "index": ci + s}


@torch.no_grad()
def prefill(params, cfg, tokens, cache, prefix_emb=None, shard_fn=_IDENT, *,
            use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    """Fill the cache from a prompt ``tokens [B, S]`` (``[B, S, ncb]``)
    from position 0, behind ``prefix_emb [B, P, d]`` when given (JAX's
    SSM prefill takes no prefix).  Returns (logits ``[B, 1, Vp]``
    (``[B, 1, ncb, Vp]``) float32, cache)."""
    if prefix_emb is not None and cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"the {cfg.family} prefill takes no prefix_emb")
    return _step(params, cfg, tokens, cache, 0, prefix_emb, shard_fn,
                 stateful=False, use_pallas_dispatch=use_pallas_dispatch,
                 attn_impl=attn_impl)


@torch.no_grad()
def decode_step(params, cfg, token, cache, shard_fn=_IDENT, *,
                use_pallas_dispatch: bool = True, attn_impl: str = "flash"):
    """token: ``[B, 1]`` (``[B, 1, ncb]``).  One autoregressive step at
    ``cache["index"]``."""
    return _step(params, cfg, token, cache, cache["index"], None, shard_fn,
                 stateful=True,
                 use_pallas_dispatch=use_pallas_dispatch,
                 attn_impl=attn_impl)
