"""``flash_attention``: attention forward with an online softmax — the
prefill path of the port's GQA attention.

Port of ``repro/kernels/flash_attention.py`` (Pallas, TPU) to two CUDA
C++ kernels, chosen by :func:`route` from (dtype, head width):

* ``"wgmma"`` — ``csrc/flash_attention_wgmma.cu``, bf16 with head width
  64, 80, 128 or 256 (the LM serving path; zamba2's shared block is
  80, paligemma 256): a persistent grid over 128-query blocks, TMA
  loads into an mbarrier ring, both products ``wgmma`` on the tensor
  cores, two consumer warpgroups taking turns;
* ``"simt"`` — ``csrc/flash_attention.cu``, float32 and every other
  head width up to 256: the products on the CUDA cores in float32 (a
  TF32 product would not hold float32's tolerance).

Both: query head ``i`` reads KV head ``i // (H // Hkv)`` without a
materialized repeat, float32 (max, sum, acc) per row, causal key tiles
above the diagonal skipped.  Unlike the TPU kernel they take any S (no
``S % block == 0``).

For CPU tensors the wrapper computes the plain version
(``ref.flash_attention_ref``); for CUDA tensors it launches the kernel
of its route or raises.  ``flash_attention.launches`` counts launches of
both routes, ``flash_attention.launches_by_route`` each one.
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
#: widest head the kernels take (the simt route's widest instantiation)
MAX_HEAD_DIM = 256
#: head widths of the wgmma route, each at its exact width (TMA boxes of
#: 64 lanes, or of 16 at hd 80)
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
#: TMA reads and writes from 16-byte aligned addresses only
TMA_ALIGN = 16


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that computes ``flash_attention`` for this dtype and
    head width: ``"wgmma"`` (bf16, hd 64, 80, 128 or 256) or
    ``"simt"``."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


@functools.cache
def _simt():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _wgmma():
    fn = build.load("flash_attention_wgmma").flash_attention_wgmma_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
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


def check_tma(**tensors) -> None:
    """Raise unless every tensor's first element is 16-byte aligned, as
    the wgmma route's TMA loads need (a contiguous view at an odd
    storage offset is not)."""
    for name, t in tensors.items():
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name} starts at "
                             f"{t.data_ptr():#x}, not {TMA_ALIGN}-byte "
                             f"aligned; the wgmma route reads it by TMA")


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
    which = route(q.dtype, hd)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, k.shape[2], hd, int(causal))
    if which == "wgmma":
        check_tma(q=q, k=k, v=v)
        err = _wgmma()(*args, stream)
    else:
        err = _simt()(*args, _DTYPES[q.dtype], stream)
    if err < 0:
        raise RuntimeError(f"flash_attention ({which}): TMA tensor map "
                           f"encoding failed with CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_attention ({which}): kernel launch "
                           f"failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[which] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
