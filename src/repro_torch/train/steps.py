"""train_step / serve_step factories.

Port of ``repro/train/steps.py``.  A train step is the forward under
autograd (``models.transformer.forward``), ``torch.autograd.grad`` over
every parameter and an in-place AdamW update (``optim.adamw``).  It
returns device tensors and reads nothing back to the host, so the caller
decides when to wait.  Each factory takes JAX's activation hook
``shard_fn`` (``launch.sharding.make_shard_fn``; identity by default);
on DTensor parameters, state and batch the step is the sharded one.
JAX's ``unroll`` is not taken (``models.transformer``'s docstring says
why).
"""
from __future__ import annotations

import torch

from ..models import transformer as T
from ..models.dist import reduced, scope
from ..models.layers import COMPUTE_DTYPE
from ..optim import OptConfig, adamw_init, adamw_update
from ..optim.adamw import layer_dims, leaf_ndim


def cross_entropy(logits, labels):
    """logits: ``[B, S, V]`` (``[B, S, ncb, V]``); labels: int ``[B, S]``
    (``[B, S, ncb]``).  The mean of logsumexp minus the gold logit,
    reduced in float32.  The gold logits are gathered from ``[N, V]``
    rows, the form DTensor gathers from a vocab-sharded DTensor."""
    logz = torch.logsumexp(logits.to(torch.float32), dim=-1)
    v = logits.shape[-1]
    gold = reduced(torch.gather(logits.reshape(-1, v), 1,
                                labels.reshape(-1, 1).long()))
    gold = gold.reshape(labels.shape).to(torch.float32)
    return torch.mean(logz - gold)


def make_loss_fn(cfg, shard_fn=T._IDENT, remat: bool = True,
                 use_pallas_dispatch: bool = True):
    """``loss_fn(params, batch) -> (ce + aux, ce)``; ``use_pallas_dispatch``
    False plans through the plain version (``transformer.forward``).  A
    vlm batch's ``prefix_emb`` goes in front of the tokens, and the
    loss reads the logits from ``cfg.prefix_len`` on, as JAX's does."""
    def loss_fn(params, batch):
        with scope(params.embed):
            return _loss(params, batch)

    def _loss(params, batch):
        logits, aux = T.forward(params, cfg, batch["tokens"],
                                batch.get("prefix_emb"), shard_fn,
                                remat=remat,
                                use_pallas_dispatch=use_pallas_dispatch)
        if cfg.prefix_len:
            logits = logits[:, cfg.prefix_len:]
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux, ce
    return loss_fn


def make_train_step(cfg, opt_cfg: OptConfig, shard_fn=T._IDENT,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce", "grad_norm"})``: ``params`` a ``Transformer`` whose
    parameters take a gradient, updated in place with ``opt_state``;
    the metrics are float32 device scalars."""
    loss_fn = make_loss_fn(cfg, shard_fn, remat)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        with scope(params.embed):
            loss, ce = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            grads = dict(zip(named, grads))
            params, opt_state, gnorm = adamw_update(params, grads,
                                                    opt_state, opt_cfg)
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, shard_fn=T._IDENT, **kw):
    def prefill_step(params, tokens, cache, prefix_emb=None):
        return T.prefill(params, cfg, tokens, cache, prefix_emb=prefix_emb,
                         shard_fn=shard_fn, **kw)
    return prefill_step


def make_decode_step(cfg, shard_fn=T._IDENT, **kw):
    def decode_step(params, token, cache):
        return T.decode_step(params, cfg, token, cache, shard_fn=shard_fn,
                             **kw)
    return decode_step


def init_train_state(cfg, *, generator: torch.Generator, device=None,
                     master_weights: bool = False):
    """``(params, opt_state)``: float32 parameters that take a gradient,
    drawn from ``generator`` (on ``device``, cuda unless the caller names
    another).  With ``master_weights`` (H2), as JAX casts every leaf of
    ``ndim > 1`` to bf16, the matrices and the layers' norm gains
    (stacked leaves in JAX) are bf16, the final norm's gain float32,
    and the optimizer state holds float32 masters."""
    params = T.init(cfg, generator=generator, device=device,
                    param_dtype=torch.float32).requires_grad_()
    if master_weights:
        stacked = layer_dims(params)
        for name, p in params.named_parameters():
            if leaf_ndim(name, p, stacked) > 1:
                p.data = p.data.to(COMPUTE_DTYPE)
    return params, adamw_init(params, master_weights=master_weights)
