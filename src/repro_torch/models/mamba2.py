"""Mamba2 (SSD, state-space duality) block of the port: chunked, with a
decode step.

Port of ``repro/models/mamba2.py``.  The SSD recurrence
``h_t = a_t * h_{t-1} + dt_t * B_t x_t^T``, ``y_t = C_t h_t`` with a
scalar decay per head ``a_t = exp(-dt_t * A_h)`` runs in the chunked
matrix form of arXiv:2405.21060: the terms inside a chunk are batched
products, the state between chunks a short loop over chunks (JAX's
``lax.scan``).  The math follows JAX's op for op:

* every three-operand ``einsum`` of JAX's is two products here, in the
  order XLA contracts them (``jnp.einsum``'s path), so no intermediate
  of shape ``[B, Nc, L, L, H, P]`` is ever made: the largest is
  ``[B, Nc, L, L, H]`` float32 (335 MB for mamba2-2.7b at 4 x 1024
  tokens, chunk 256, 80 heads);
* ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes
  it (``torch.nn.functional.softplus`` switches to the identity above
  20);
* the parameters keep JAX's dtypes at use: ``w_in``, ``conv_w`` and
  ``w_out`` are matrices (bf16 to serve, float32 to train, cast to bf16
  at each use); ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip`` and
  ``out_norm`` are float32, and ``conv_b`` and ``d_skip`` are cast to
  bf16 where JAX casts them.  ``dt_bias`` is a parameter that JAX's
  ``mamba2_apply`` never reads; the port keeps it for the tree's sake.

No Hopper kernel: JAX computes SSD with ``jnp`` and ``lax.scan`` and no
Pallas kernel, so the port runs it in torch ops on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import dist as D
from .dist import split_last
from .layers import (COMPUTE_DTYPE, _c, _matrix, _param, _zeros_gain,
                     rms_norm)


def ssm_dims(cfg):
    """``(d_inner, nheads)``: ``expand * d_model`` and its heads of
    ``ssm.head_dim``."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


class Mamba2(nn.Module):
    """``mamba2_init``'s parameters: ``w_in [d, 2*d_inner + 2*N + H]``
    (the fused projection of z, x, B, C, dt), ``conv_w [d_conv, C]`` and
    ``conv_b [C]`` (C = d_inner + 2N), ``a_log = log(linspace(1, 16,
    H))``, ``dt_bias`` zeros, ``d_skip`` ones, ``out_norm [d_inner]``
    zeros and ``w_out [d_inner, d]``."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        d, s = cfg.d_model, cfg.ssm
        d_inner, nheads = ssm_dims(cfg)
        conv_c = d_inner + 2 * s.d_state
        kw = dict(dtype=dtype)
        self.w_in = _matrix((d, 2 * d_inner + 2 * s.d_state + nheads),
                            generator, device, **kw)
        self.conv_w = _matrix((s.d_conv, conv_c), generator, device,
                              1.0 / math.sqrt(s.d_conv), **kw)
        self.conv_b = _zeros_gain(conv_c, device)
        self.a_log = _param(torch.log(torch.linspace(
            1.0, 16.0, nheads, dtype=torch.float32, device=device)))
        self.dt_bias = _zeros_gain(nheads, device)
        self.d_skip = _param(torch.ones((nheads,), dtype=torch.float32,
                                        device=device))
        self.out_norm = _zeros_gain(d_inner, device)
        self.w_out = _matrix((d_inner, d), generator, device, **kw)

    def forward(self, x, *, state=None, return_state: bool = False):
        return mamba2_apply(self, x, self.cfg, state=state,
                            return_state=return_state)


def _split_proj(cfg, proj):
    """``(z, xbc, dt)`` of the fused projection."""
    d_inner, nheads = ssm_dims(cfg)
    n = cfg.ssm.d_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_inner + 2 * n]
    dt = proj[..., -nheads:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal convolution over time, in ``xbc``'s dtype.
    xbc: ``[B, S, C]``; ``conv_state``: ``[B, d_conv - 1, C]``, the
    trailing context of decode.  Returns ``(silu(out), new_state)``."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * conv_w[0].to(xbc.dtype)  # 0 + first tap: exact
    for i in range(1, k):                       # tiny k (4): unrolled taps
        out = out + xp[:, i:i + s] * conv_w[i].to(xbc.dtype)
    out = out + conv_b.to(xbc.dtype)
    return F.silu(out), xp[:, xp.shape[1] - (k - 1):]


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """SSD scan, chunked matrix form.

    x: ``[B, S, H, P]``; dt: ``[B, S, H]``; b, c: ``[B, S, N]``.
    Returns ``y [B, S, H, P]`` in x's dtype and the final state
    ``[B, H, P, N]`` float32.  S need not be a multiple of ``chunk``:
    the padded steps have ``dt = -1e4`` (softplus 0), so they are the
    identity of the recurrence.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nch = -(-s // chunk)
    pad = nch * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e4)
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))

    a = -torch.exp(a_log.float())                          # [H], negative
    dt = softplus(dt.float())                              # [B, S', H]
    la = dt * a[None, None, :]                             # log decay <= 0

    xc = (x.float() * dt[..., None]).reshape(bsz, nch, chunk, h, p)
    bc = b.float().reshape(bsz, nch, chunk, n)
    cc = c.float().reshape(bsz, nch, chunk, n)
    cum = torch.cumsum(la.reshape(bsz, nch, chunk, h), dim=2)  # [B,Nc,L,H]

    # ---- inside a chunk: decay(tq, tk) = exp(cum[tq] - cum[tk]), tq >= tk
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,Nc,L,L,H]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    # masked BEFORE exp: the upper triangle's rel is large and positive
    rel = rel.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    gamma = torch.exp(rel)
    del rel
    scores = torch.matmul(cc, bc.transpose(-1, -2))         # [B,Nc,L,L]
    # "bzqk,bzqkh,bzkhp->bzqhp": (scores * gamma), then the k sum
    sg = (scores[..., None] * gamma).permute(0, 1, 4, 2, 3)  # [B,Nc,H,q,k]
    del gamma
    y_intra = torch.matmul(sg, xc.permute(0, 1, 3, 2, 4))    # [B,Nc,H,q,P]
    del sg
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                 # [B,Nc,q,H,P]

    # ---- chunk states, then the loop over chunks
    tail = torch.exp(cum[:, :, -1:, :] - cum)               # [B,Nc,L,H]
    # "bzkh,bzkn,bzkhp->bzhpn": (tail * xc), then the k sum with bc
    tx = (tail[..., None] * xc).reshape(bsz, nch, chunk, h * p)
    states = torch.matmul(tx.transpose(-1, -2), bc) \
        .reshape(bsz, nch, h, p, n)
    del tx
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [B,Nc,H]
    h_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
    h_prevs = []
    for z in range(nch):
        h_prevs.append(h_state)
        h_state = h_state * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)                   # [B,Nc,H,P,N]

    # ---- "bzqn,bzqh,bzhpn->bzqhp": the n sum of h_prevs and C first,
    # then the decay exp(cum[t])
    hc = torch.matmul(h_prevs.reshape(bsz, nch, h * p, n),
                      cc.transpose(-1, -2)).reshape(bsz, nch, h, p, chunk)
    y_inter = torch.exp(cum)[..., None] * hc.permute(0, 1, 4, 2, 3)

    y = (y_intra + y_inter).reshape(bsz, nch * chunk, h, p)
    if pad:
        y = y[:, :s]
    return y.to(x.dtype), h_state


def ssd_step(h_state, x, dt, a_log, b, c):
    """One decode step.  x: ``[B, H, P]``; b, c: ``[B, N]``; dt:
    ``[B, H]``; h_state: ``[B, H, P, N]`` float32.  Returns
    ``(y [B, H, P] in x's dtype, new state)``."""
    a = -torch.exp(a_log.float())
    dt = softplus(dt.float())
    decay = torch.exp(dt * a[None, :])                      # [B, H]
    xb = (x.float() * dt[..., None])[..., None] * b.float()[:, None, None, :]
    h_new = h_state * decay[..., None, None] + xb
    y = torch.matmul(h_new, c.float()[:, None, :, None])[..., 0]
    return y.to(x.dtype), h_new


def _on_heads(fn, hdim: int, x, dt, a_log, b, c, h_state=None):
    """``fn`` of the SSD (``ssd_chunked``, or ``ssd_step`` with
    ``h_state`` first); on DTensors on each rank's local shards: batch
    over the data axes, heads (``x``'s dim ``hdim``) over ``model`` when
    it divides them, as GSPMD keeps the per-head scan local."""
    if not D.is_dtensor(x):
        args = (x, dt, a_log, b, c)
        return fn(*args) if h_state is None else fn(h_state, *args)
    mesh = x.device_mesh
    heads = x.shape[hdim] % D.model_size(mesh) == 0
    on = D.Shard(hdim) if heads else D.Replicate()
    xpl = D.batch_and((x, b), on)
    dpl = D.batch_and((x, b), D.Shard(dt.ndim - 1) if heads
                      else D.Replicate())
    apl = tuple(D.Shard(0) if n == D.MODEL_AXIS and heads else D.Replicate()
                for n in mesh.mesh_dim_names)
    bpl = D.batch_and((x, b), D.Replicate())
    hpl = D.batch_and((x, b), D.Shard(1) if heads else D.Replicate())
    ypl = xpl if hdim == 2 else hpl
    # a rank's gradient of what it holds whole is a share of the sum:
    # ``a_log`` over the batch axes, ``b`` and ``c`` over the heads
    names = mesh.mesh_dim_names
    agrad = tuple(D.Partial() if isinstance(q, D.Shard) and
                  n != D.MODEL_AXIS else p
                  for n, p, q in zip(names, apl, xpl))
    bgrad = D.partial_over_model(xpl, names) if heads else bpl
    bgrad = tuple(q if n == D.MODEL_AXIS else p
                  for n, p, q in zip(names, bpl, bgrad))
    grads = (xpl, dpl, agrad, bgrad, bgrad)
    if h_state is None:
        return D.run_local(fn, (ypl, hpl), (xpl, dpl, apl, bpl, bpl),
                           x, dt, a_log, b, c, in_grad_placements=grads)
    return D.run_local(fn, (ypl, hpl), (hpl, xpl, dpl, apl, bpl, bpl),
                       h_state, x, dt, a_log, b, c,
                       in_grad_placements=(hpl, *grads))


def mamba2_apply(p, x, cfg, *, state=None, return_state: bool = False):
    """x: ``[B, S, D]``.  ``state``: None (training, or prefill from
    scratch) or ``{h: [B, H, P, N], conv: [B, d_conv - 1, C]}`` for a
    one-token decode step.  ``return_state`` emits the final state of a
    stateless call (prefill).  Returns ``(out, new_state)``."""
    bsz, s, _ = x.shape
    scfg = cfg.ssm
    d_inner, nheads = ssm_dims(cfg)
    n, pdim = scfg.d_state, scfg.head_dim
    proj = x.to(COMPUTE_DTYPE) @ _c(p.w_in)
    z, xbc, dt = _split_proj(cfg, proj)

    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xs = split_last(xbc[..., :d_inner], nheads, pdim)
    b = xbc[..., d_inner:d_inner + n]
    c = xbc[..., d_inner + n:]

    if state is None:
        y, h_t = _on_heads(
            lambda x, dt, a_log, b, c: ssd_chunked(x, dt, a_log, b, c,
                                                   scfg.chunk),
            2, xs, dt, p.a_log, b, c)
    else:
        if s != 1:
            raise ValueError(f"the stateful Mamba2 path takes one token a "
                             f"step, got {s}")
        y1, h_t = _on_heads(ssd_step, 1, xs[:, 0], dt[:, 0], p.a_log,
                            b[:, 0], c[:, 0], h_state=state["h"])
        y = y1[:, None]
    y = y + xs * p.d_skip.to(y.dtype)[None, None, :, None]
    y = rms_norm(y.reshape(bsz, s, d_inner), p.out_norm, cfg.norm_eps)
    y = y * F.silu(z)
    out = y @ _c(p.w_out)
    new_state = None
    if state is not None or return_state:
        new_state = {"h": h_t, "conv": new_conv.to(COMPUTE_DTYPE)}
    return out.to(x.dtype), new_state


def mamba2_state_shape(cfg, batch):
    """``{name: (shape, dtype)}`` of one layer's decode state."""
    d_inner, nheads = ssm_dims(cfg)
    s = cfg.ssm
    return {"h": ((batch, nheads, s.head_dim, s.d_state), torch.float32),
            "conv": ((batch, s.d_conv - 1, d_inner + 2 * s.d_state),
                     COMPUTE_DTYPE)}
