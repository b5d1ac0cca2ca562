"""``flash_attention``: attention forward with an online softmax — the
prefill path of the port's GQA attention.

Port of ``repro/kernels/flash_attention.py`` (Pallas, TPU) to the CUDA
C++ kernel ``csrc/flash_attention.cu``: one block per (batch*head,
64-query block), K/V tiles streamed through shared memory, query head
``i`` reading KV head ``i // (H // Hkv)`` without a materialized repeat,
float32 (max, sum, acc) per row, causal key tiles above the diagonal
skipped.  Unlike the TPU kernel it takes any S (no ``S % block == 0``)
and any head width up to 128.

For CPU tensors the wrapper computes the plain version
(``ref.flash_attention_ref``); for CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import flash_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest head the kernel takes
MAX_HEAD_DIM = 128


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, hd]")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if k.shape != (b, s, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be [B, S, Hkv, hd] "
                         f"= [{b}, {s}, Hkv, {hd}] (Sq == Skv); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"float32 / bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must share one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: ``[B, S, H, hd]``; k/v: ``[B, S, Hkv, hd]`` (H % Hkv == 0).
    Returns ``[B, S, H, hd]`` in ``q.dtype``; causal attention starts at
    position 0 (query s sees keys 0..s)."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, h, k.shape[2], hd, int(causal), _DTYPES[q.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
