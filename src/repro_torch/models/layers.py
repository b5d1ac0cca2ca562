"""Transformer building blocks of the port: RMSNorm, RoPE, GQA attention
and the SwiGLU/GELU MLP, in PyTorch, with a KV cache.

Port of ``repro/models/layers.py``: GQA and MLA attention and the MLP.
Conventions, as in the JAX package:

* every matrix is cast to bf16 (``COMPUTE_DTYPE``) at each product, as
  JAX casts its float32 parameters: the serving path stores its
  matrices in bf16 already (cast once, at load or init, so the cast at
  use is a no-op), training stores them in float32 (``param_dtype``)
  and the cast is where the gradient turns float32; norm gains stay
  float32;
* normalization, RoPE and the softmax run in float32;
* the cache is updated in place (JAX returns a new one): the decode
  loop then moves no cache bytes.

Attention: prefill from an empty cache (and the cache-less call) is
causal attention of the prompt over itself, which is the contract of
the hand-written kernel ``kernels.flash_attention``; that is the route
of ``attn_impl="flash"`` (the default).  Decode steps (Sq < Skv) run
``chunked_attention`` in torch ops, as the JAX package does everywhere.
``attn_impl="chunked"`` or ``"plain"`` sends prefill through the torch
versions instead.  MLA attention always takes a torch route (its qk and
v head widths differ), ``chunked`` unless ``"plain"`` is asked for.
On DTensors every route runs on local shards, batch over the data axes
and heads over ``model`` (``models.dist.attend``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention
from .dist import attend, split_last, unshard, write_seq

COMPUTE_DTYPE = torch.bfloat16
ATTN_IMPLS = ("flash", "chunked", "plain")


def _dense_init(shape, generator, device, scale=None,
                dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """``normal * (scale or 1/sqrt(shape[0]))`` drawn in float32 and
    cast to ``dtype`` once (``layers._dense_init``; note fan-in is
    ``shape[0]``, also for the stacked ``[E, d, f]`` expert weights)."""
    scale = scale or 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _matrix(shape, generator, device, scale=None, *,
            dtype=COMPUTE_DTYPE) -> nn.Parameter:
    """A weight of ``dtype`` (bf16 to serve, float32 to train): drawn by
    ``_dense_init`` from ``generator``, or left uninitialized (to be
    loaded) when ``generator`` is None."""
    if generator is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    return _param(_dense_init(shape, generator, device, scale, dtype))


def _zeros_gain(n: int, device) -> nn.Parameter:
    return _param(torch.zeros((n,), dtype=torch.float32, device=device))


def _c(w: torch.Tensor) -> torch.Tensor:
    """``w`` in the compute dtype (a no-op for bf16 weights)."""
    return w.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# normalization + rope
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable).  Rotate
    half (the two halves of hd, not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # [hd/2]
    ang = positions[..., :, None].float() * freqs         # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                 # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.split(x.float(), hd // 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention in torch ops (decode, and the reference routes of prefill)
# ---------------------------------------------------------------------------

def _kv_valid(skv: int, kv_len) -> int:
    """Keys a query can see at all.  ``kv_len`` is a host int here (the
    port keeps the cache index on the host), so key blocks past it,
    which the JAX scan visits fully masked and which leave (max, sum,
    acc) exactly as they were, are not visited."""
    return skv if kv_len is None else max(0, min(skv, int(kv_len)))


def plain_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_len: Optional[int] = None, chunk: int = 0):
    """Reference attention with materialized scores."""
    b, sq, h, hd = q.shape
    _, skv, hkv, _ = k.shape
    vd = v.shape[-1]
    g = h // hkv
    qh = (q.float() / math.sqrt(hd)).reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqkgd,bckd->bqkgc", qh, k.float())
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, vd).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      kv_len: Optional[int] = None, chunk: int = 1024):
    """q: [B, Sq, H, hd]; k/v: [B, Skv, Hkv, hd] (GQA: H % Hkv == 0).

    The flash recurrence over KV blocks of ``chunk`` rows with running
    (max, sum, acc) in float32, so live memory is O(Sq * chunk).
    ``q_offset`` is the position of q[0] within the kv sequence; keys at
    or past ``kv_len`` are masked.  A fully masked row keeps max -inf,
    sum 0 and acc 0, and comes out 0.
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    vd = v.shape[-1]                 # MLA: v head dim may differ from qk
    g = h // hkv
    skv = _kv_valid(k.shape[1], kv_len)
    qh = (q.float() / math.sqrt(hd)).reshape(b, sq, hkv, g, hd)
    qpos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, sq, hkv, g), float("-inf"), device=q.device)
    l = torch.zeros((b, sq, hkv, g), device=q.device)
    acc = torch.zeros((b, sq, hkv, g, vd), device=q.device)
    for c0 in range(0, skv, chunk):
        c1 = min(c0 + chunk, skv)
        kpos = torch.arange(c0, c1, device=q.device)
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, k[:, c0:c1].float())
        mask = torch.ones((sq, c1 - c0), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        mask = mask[None, :, None, None, :]
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
        scale = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * scale + p.sum(dim=-1)
        acc = (acc * scale[..., None]
               + torch.einsum("bqkgc,bckd->bqkgd", p, v[:, c0:c1].float()))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, vd).to(q.dtype)


def attention(q, k, v, *, impl: str = "chunked", **kw):
    """The torch-ops attention routes: ``plain`` or ``chunked``."""
    if impl == "plain":
        return plain_attention(q, k, v, **kw)
    if impl == "chunked":
        return chunked_attention(q, k, v, **kw)
    raise ValueError(f"unknown torch attention route {impl!r}")


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Grouped-query attention (``layers.gqa_init`` / ``gqa_apply``):
    ``wq [d, H*hd]``, ``wk``/``wv [d, Hkv*hd]``, ``wo [H*hd, d]`` of
    ``dtype``, and zero biases when ``cfg.qkv_bias``."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd),
                  "wv": (d, hkv * hd), "wo": (h * hd, d)}
        for name, shape in shapes.items():
            setattr(self, name, _matrix(shape, generator, device,
                                        dtype=dtype))
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
                setattr(self, name, _param(torch.zeros(
                    (n,), dtype=dtype, device=device)))

    def forward(self, x, *, positions, cache=None, cache_index=None,
                attn_chunk: int = 1024, attn_impl: str = "flash"):
        return gqa_apply(self, x, self.cfg, positions=positions, cache=cache,
                         cache_index=cache_index, attn_chunk=attn_chunk,
                         attn_impl=attn_impl)


def gqa_apply(p, x, cfg, *, positions, cache=None, cache_index=None,
              attn_chunk: int = 1024, attn_impl: str = "flash"):
    """cache: optional ``{k: [B, Smax, Hkv, hd], v: ...}``, updated in
    place at ``cache_index`` (a host int).  Returns (out, cache)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    b, s, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    xc = x.to(COMPUTE_DTYPE)
    q = xc @ _c(p.wq)
    k = xc @ _c(p.wk)
    v = xc @ _c(p.wv)
    if cfg.qkv_bias:
        q, k, v = q + _c(p.bq), k + _c(p.bk), v + _c(p.bv)
    q = apply_rope(split_last(q, h, hd), positions, cfg.rope_theta)
    k = apply_rope(split_last(k, hkv, hd), positions, cfg.rope_theta)
    v = split_last(v, hkv, hd)

    torch_impl = "plain" if attn_impl == "plain" else "chunked"
    flash = lambda q, k, v: flash_attention(q, k, v, causal=True)
    if cache is None:
        if attn_impl == "flash":
            out = attend(flash, q, k, v)
        else:
            out = attend(lambda q, k, v: attention(
                q, k, v, impl=torch_impl, causal=True, chunk=attn_chunk),
                q, k, v)
    else:
        ci = int(cache_index)
        k = k.to(cache["k"].dtype)
        v = v.to(cache["v"].dtype)
        write_seq(cache["k"], k, ci)
        write_seq(cache["v"], v, ci)
        if ci == 0 and attn_impl == "flash":
            # prefill from an empty cache: causal attention of the prompt
            # over cache[:, :s], which holds exactly these k and v
            out = attend(flash, q, k, v)
        else:
            out = attend(lambda q, k, v: attention(
                q, k, v, impl=torch_impl, causal=True, q_offset=ci,
                kv_len=ci + s, chunk=attn_chunk), q, cache["k"], cache["v"])
    out = out @ _c(p.wo)                      # out: [B, S, H * hd]
    return out.to(x.dtype), cache


def gqa_cache_shape(cfg, batch, max_len, dtype=COMPUTE_DTYPE):
    """``{name: (shape, dtype)}`` of one layer's KV cache."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": ((batch, max_len, hkv, hd), dtype),
            "v": ((batch, max_len, hkv, hd), dtype)}


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-V2): low-rank compressed Q and KV;
# the decode cache keeps only the compressed latent and the rope key
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Multi-head latent attention (``layers.mla_init`` / ``mla_apply``):
    ``wq_a [d, q_lora]``, ``wq_b [q_lora, H*(nope+rope)]``,
    ``wkv_a [d, kv_lora+rope]``, ``wkv_b [kv_lora, H*(nope+vd)]`` and
    ``wo [H*vd, d]`` of ``dtype``; ``q_norm`` and ``kv_norm`` float32
    gains."""

    def __init__(self, cfg, *, generator=None, device=None,
                 dtype=COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        shapes = {"wq_a": (d, m.q_lora_rank),
                  "wq_b": (m.q_lora_rank, h * qk),
                  "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
                  "wkv_b": (m.kv_lora_rank,
                            h * (m.qk_nope_head_dim + m.v_head_dim)),
                  "wo": (h * m.v_head_dim, d)}
        for name, shape in shapes.items():
            setattr(self, name, _matrix(shape, generator, device,
                                        dtype=dtype))
        self.q_norm = _zeros_gain(m.q_lora_rank, device)
        self.kv_norm = _zeros_gain(m.kv_lora_rank, device)

    def forward(self, x, *, positions, cache=None, cache_index=None,
                attn_chunk: int = 1024, attn_impl: str = "flash"):
        return mla_apply(self, x, self.cfg, positions=positions,
                         cache=cache, cache_index=cache_index,
                         attn_chunk=attn_chunk, attn_impl=attn_impl)


def mla_apply(p, x, cfg, *, positions, cache=None, cache_index=None,
              attn_chunk: int = 1024, attn_impl: str = "flash"):
    """cache: optional ``{ckv: [B, Smax, kv_lora], k_rope: [B, Smax, 1,
    rope]}``, updated in place at ``cache_index`` (a host int).  Returns
    (out, cache).

    Attention is the torch ``chunked`` version for ``attn_impl``
    ``"flash"`` and ``"chunked"`` (``"plain"``: plain), as JAX's
    ``mla_apply`` calls ``layers.attention``: the qk head width
    (nope + rope) differs from v's, which ``flash_attention`` does not
    take.  With a cache, only the ``cache_index + S`` positions written
    so far are decompressed (JAX decompresses all ``Smax`` and masks the
    rest: the same values)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    b, s, _ = x.shape
    h, m = cfg.num_heads, cfg.mla
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    xc = x.to(COMPUTE_DTYPE)

    cq = rms_norm(xc @ _c(p.wq_a), p.q_norm, cfg.norm_eps)
    q = split_last(cq @ _c(p.wq_b), h, nope + rope_d)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)

    ckv_full = xc @ _c(p.wkv_a)
    ckv = rms_norm(ckv_full[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(ckv_full[:, :, None, r:], positions,
                        cfg.rope_theta)                    # [B,S,1,rope]
    if cache is None:
        q_offset, kv_len = 0, None
    else:
        ci = int(cache_index)
        write_seq(cache["ckv"], ckv.to(cache["ckv"].dtype), ci)
        write_seq(cache["k_rope"], k_rope.to(cache["k_rope"].dtype), ci)
        q_offset, kv_len = ci, ci + s
        ckv = unshard(cache["ckv"], 1)[:, :kv_len]
        k_rope = unshard(cache["k_rope"], 1)[:, :kv_len]

    # decompress k and v from the latent (MLA's FLOPs-for-memory trade)
    skv = ckv.shape[1]
    kv = split_last(ckv @ _c(p.wkv_b), h, nope + vd)
    k = torch.cat([kv[..., :nope],
                   k_rope.expand(b, skv, h, rope_d)], dim=-1)
    out = attend(lambda q, k, v: attention(
        q, k, v, impl="plain" if attn_impl == "plain" else "chunked",
        causal=True, q_offset=q_offset, kv_len=kv_len, chunk=attn_chunk),
        q_full, k, kv[..., nope:])
    out = out @ _c(p.wo)                      # out: [B, S, H * vd]
    return out.to(x.dtype), cache


def mla_cache_shape(cfg, batch, max_len, dtype=COMPUTE_DTYPE):
    """``{name: (shape, dtype)}`` of one layer's latent cache."""
    m = cfg.mla
    return {"ckv": ((batch, max_len, m.kv_lora_rank), dtype),
            "k_rope": ((batch, max_len, 1, m.qk_rope_head_dim), dtype)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``act="silu"``: ``w_gate``, ``w_up``, ``w_down``) or GELU
    MLP (``layers.mlp_init`` / ``mlp_apply``), weights of ``dtype``."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, generator=None,
                 device=None, dtype=COMPUTE_DTYPE):
        super().__init__()
        self.act = act
        shapes = {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
        if act == "silu":
            shapes["w_gate"] = (d_model, d_ff)
        for name, shape in shapes.items():
            setattr(self, name, _matrix(shape, generator, device,
                                        dtype=dtype))

    def forward(self, x):
        return mlp_apply(self, x, self.act)


def mlp_apply(p, x, act: str):
    xc = x.to(COMPUTE_DTYPE)
    up = xc @ _c(p.w_up)
    if act == "silu":
        hidden = F.silu(xc @ _c(p.w_gate)) * up
    else:
        hidden = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    return (hidden @ _c(p.w_down)).to(x.dtype)
