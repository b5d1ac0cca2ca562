"""AdamW with global-norm clipping over named parameters.

Port of ``repro/optim/adamw.py``, in its op order: clip by the global
norm, bias-correct with the step counter, decoupled weight decay on
parameters whose leaf has ``ndim > 1`` only.  The leaf is the JAX
tree's (:func:`leaf_ndim`): a layer's parameters are rows of leaves
stacked over layers, so JAX decays a layer's norm gains (leaf ``[L,
d]``) and not the final norm's (``[d]``), and the port does the same.
``torch.optim.AdamW`` is not used: it rounds in another order and
decays every parameter.

The state is a dict: ``mu`` and ``nu`` (float32 moments) and, with the
H2 master weights, ``master`` (float32 copies of bf16 parameters), each
``{name: tensor}`` over the model's parameter names, plus ``step``, an
int32 scalar on the parameters' device.  :func:`adamw_update` updates
the parameters and the state in place and never reads a value back to
the host: the lr, the bias corrections and the clip scale stay tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.transformer import Transformer, layer_stack


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # H2: bf16 model params + f32 master copies in the optimizer state
    master_weights: bool = False


def layer_dims(params) -> int:
    """Dimensions JAX stacks a layer leaf over: those of
    ``transformer.layer_stack`` for a model (2 for a hybrid's ``[G,
    attn_every, ...]``), else 1 (``[L, ...]``)."""
    if isinstance(params, Transformer):
        return len(layer_stack(params.cfg))
    return 1


def leaf_ndim(name: str, p: torch.Tensor, stacked: int = 1) -> int:
    """``p.ndim`` as a leaf of JAX's tree: a module's per-layer parameter
    (``layers.<i>.…``) is one row of a leaf stacked over ``stacked``
    dimensions (:func:`layer_dims`); the others (``shared_attn.…``,
    ``embed``, …) are leaves of their own."""
    return p.ndim + (stacked if name.startswith("layers.") else 0)


def _named(params) -> dict:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params, master_weights: bool = False) -> dict:
    """Zero moments for every parameter of ``params`` (a module or a
    ``{name: tensor}`` dict) and the step counter 0 on their device;
    float32 masters when ``master_weights``."""
    named = _named(params)
    dev = next(iter(named.values())).device
    state = {
        "mu": {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in named.items()},
        "nu": {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if master_weights:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in named.items()}
    return state


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32, summed
    leaf by leaf in the order given (``optim.adamw.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  ``params``: a module or ``{name: tensor}``;
    ``grads``: ``{name: gradient}`` over the same names.  Updates the
    parameters and ``state`` in place; returns ``(params, state,
    grad_norm)``, the norm before clipping as a float32 device scalar.

    Per parameter, as JAX computes it (``m`` is the float32 master, or
    the parameter itself without master weights)::

        g  = g * scale            scale = min(1, clip / max(|g|, 1e-9))
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        delta = mu / (1 - b1**t) / (sqrt(nu / (1 - b2**t)) + eps)
        delta = delta + wd * m    (leaf ndim > 1 only)
        m  = m - lr * delta;  p = m cast to p's dtype
    """
    named = _named(params)
    stacked = layer_dims(params)
    state["step"] += 1
    step = state["step"]
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    gnorm = global_norm(grads[n] for n in named)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    masters = state.get("master")
    for name, p in named.items():
        m = p if masters is None else masters[name]
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].to(torch.float32) * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        mf = m.to(torch.float32)
        if leaf_ndim(name, p, stacked) > 1:
            delta.add_(cfg.weight_decay * mf)
        new_m = mf - lr * delta
        if masters is not None:
            m.copy_(new_m)
        p.copy_(new_m)            # to p's dtype: round to nearest even
    return params, state, gnorm
