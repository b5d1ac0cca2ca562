"""Tensors to and from host numpy arrays, for the checkpoint
(``checkpoint.ckpt``) and the JAX tree converters (``models.convert``).

Numpy has no bf16: a bf16 tensor goes to the host as its 16-bit pattern
in a ``V2`` array, which is also what numpy reads back from a bf16 leaf
the JAX package wrote (without ``ml_dtypes``), and comes back by viewing
the bits, never by converting them.
"""
from __future__ import annotations

import numpy as np
import torch


def is_bf16_bits(a: np.ndarray) -> bool:
    """A bf16 leaf as numpy holds it: 16-bit void (``V2``) or
    ``ml_dtypes.bfloat16``."""
    return a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                      or a.dtype.name == "bfloat16")


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that holds a tensor of ``dtype`` (bf16: ``V2``)."""
    if dtype == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty((), dtype=dtype).numpy().dtype  # repro: allow[host-sync] -- a CPU tensor made here: nothing crosses from a device


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory (a bf16 leaf's bits viewed as
    bfloat16), or over a copy where ``a`` is not C-contiguous and
    writable, which ``torch.from_numpy`` needs."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if is_bf16_bits(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array that owns its memory: one copy, so a later
    in-place update of ``t`` does not reach it."""
    out = np.empty(tuple(t.shape), dtype=host_dtype(t.dtype))
    host_tensor(out).copy_(t.detach())
    return out


def from_host(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy leaf as a new tensor of ``dtype`` on ``device``: one copy,
    so the tensor never shares the caller's memory."""
    return host_tensor(a).to(device=device, dtype=dtype, copy=True)
