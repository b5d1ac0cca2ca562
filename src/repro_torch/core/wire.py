"""Pluggable wire codecs for the distributed sync payload path.

Port of ``repro/core/wire.py``.  A codec (:class:`WireCodec`) separates
*what* a sync round ships (the dirty boundary payload ``core.gluon``
assembles) from *how* it is packed: ``encode`` / ``decode`` transform
one ring step's ``[B, L]`` payload slab at a fixed shape, and the byte
accountants (``step_wire_bytes`` / ``allreduce_wire_bytes``) report what
the encoded form would occupy on a wire, as int32 0-dim tensors on the
payload's device that ride the round's stats.  ``bytes_synced`` is the
codec-independent logical volume (one int32 index word plus the ``[B]``
label vector per exchanged vertex, :func:`step_logical_bytes`);
``bytes_wire`` the post-encode volume.

Four codecs are registered, with the JAX package's semantics and byte
counts:

* ``identity`` — the payload as it is; ``bytes_wire == bytes_synced``.
* ``delta`` — integer payloads ship their difference to the round-entry
  reference both ends of a ring step hold (int32 wraparound makes
  ``(a - b) + b`` exact); accounting: a 2-bit code per entry and 1, 2
  or 4 offset bytes per changed entry against a per-query base.  Float
  payloads ship raw behind a 1-bit change mask.
* ``quantize`` — narrow integer words where the operator declares the
  narrowing safe (``Operator.wire_narrow``); anything else raises at
  config time.  min-combine payloads saturate at the narrow maximum,
  which decodes to ``INF``; add-combine payloads wrap and sign-extend
  back (reduce ring) or zero-extend (``signed=False``, the broadcast of
  non-negative labels).
* ``bitmap`` — the index side of a dense step as an ``ceil(L / 8)``-byte
  bitmap over its mirror-list slots; payload bytes unchanged.

A ``uint16`` word travels as the bit pattern of an ``int16`` tensor:
torch's ``uint16`` dtype has few kernels on CUDA, so the codec never
computes in it; :func:`word_numpy` views a wire tensor as the word
dtype the JAX package ships.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .graph import INF
from .operators import Operator

#: bytes of the per-vertex index word the uncompressed exchange ships
#: alongside each dirty vertex's payload (int32 vertex ids)
INDEX_BYTES = 4

#: block length of the block-absmax quantization idiom
BLOCK = 256


# ---------------------------------------------------------------------------
# the block-absmax helpers (shared with a gradient compressor in the JAX
# package; kept here with the same contract)
# ---------------------------------------------------------------------------

def pad_to_block(x: torch.Tensor, block: int = BLOCK):
    """Flatten ``x`` and pad with zeros to whole ``block``-wide rows.

    Returns ``(blocks[N, block], npad)``."""
    n = x.numel()
    npad = -(-n // block) * block - n
    flat = x.reshape(-1)
    if npad:
        flat = torch.cat([flat, flat.new_zeros(npad)])
    return flat.reshape(-1, block), npad


def block_absmax_scale(blocks: torch.Tensor, qmax: float = 127.0,
                       eps: float = 1e-12) -> torch.Tensor:
    """Per-block symmetric absmax scale (``[N, 1]``, floored at
    ``eps``): the step that maps each block onto ``[-qmax, qmax]``."""
    scale = blocks.abs().amax(dim=1, keepdim=True) / qmax
    return torch.clamp(scale, min=eps)


# ---------------------------------------------------------------------------
# codec protocol + registry
# ---------------------------------------------------------------------------

def _is_float(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(np.dtype(dtype), np.floating)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _narrow_info(name: str):
    """(torch dtype the word travels in, itemsize, min-combine sentinel)
    of a declared narrowing."""
    if name == "uint16":
        return torch.int16, 2, (1 << 16) - 1
    if name == "int8":
        return torch.int8, 1, (1 << 7) - 1
    if name == "uint8":
        return torch.uint8, 1, (1 << 8) - 1
    if name == "int16":
        return torch.int16, 2, (1 << 15) - 1
    raise ValueError(f"unsupported wire narrowing dtype {name!r}")


#: dtype names a quantize codec may ship
NARROW_DTYPES = frozenset({"int8", "uint8", "int16", "uint16"})


def _widen(word: torch.Tensor, name: str, signed: bool) -> torch.Tensor:
    """The int32 value of a narrow word of dtype ``name``: sign-extended
    when ``signed``, else zero-extended (callers never zero-extend a
    signed dtype's word)."""
    wide = (word.view(torch.int8) if signed and name == "uint8"
            else word).to(torch.int32)
    if name == "uint16" and not signed:
        wide = wide & 0xFFFF               # its int16 carrier, unsigned
    return wide


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire packing of the sync payload path (see the module
    docstring).  Frozen and stateless: the ``delta`` codec's reference
    is the round-entry label array the caller's loop carries, passed in
    per call.  Every method keeps fixed output shapes and reads nothing
    on the host, so a captured round can run it."""

    #: registry name ("identity" | "delta" | "quantize" | "bitmap")
    name: str

    #: narrow dtype name shipped by the quantize codec (None elsewhere)
    narrow: Optional[str] = None

    # -- config-time validation ------------------------------------------

    def validate(self, op: Operator, dtype) -> None:
        """Raise, at config time and before any round runs, when this
        codec cannot carry ``op``'s payloads exactly.  Only ``quantize``
        constrains the pairing: the operator must declare the requested
        narrowing, and the payload must be an integer."""
        if self.name != "quantize":
            return
        if not op.wire_narrow:
            raise ValueError(
                f"wire codec 'quantize' needs an operator that "
                f"declares a safe narrowing; {op.name} declares none "
                f"(its combine does not tolerate narrow payloads — "
                f"DESIGN.md section 14)")
        if self.narrow not in op.wire_narrow:
            raise ValueError(
                f"operator {op.name} declares safe narrowings "
                f"{op.wire_narrow}; requested {self.narrow!r} is not "
                f"among them")
        if _is_float(dtype):
            raise ValueError(
                f"wire codec 'quantize' is exact only for integer "
                f"payloads; {op.name} ships {_dtype_name(dtype)}")

    # -- payload transform (per ring step) -------------------------------

    def encode(self, payload: torch.Tensor, prev: torch.Tensor,
               op: Operator) -> torch.Tensor:
        """Encode one ring step's ``[B, L]`` payload slab against the
        ``[B, L]`` reference ``prev`` gathered at the same slots (both
        ends of the step hold an identical copy for every real slot).
        The output has the slab's shape, possibly a narrower dtype."""
        if self.name == "delta" and not payload.is_floating_point():
            return payload - prev
        if self.name == "quantize":
            ndt, _, sent = _narrow_info(self.narrow)
            if op.combine == "min":
                return torch.clamp(payload, max=sent).to(ndt)
            return payload.to(ndt)              # add: two's-complement wrap
        return payload

    def decode(self, wire: torch.Tensor, prev: torch.Tensor,
               op: Operator, dtype, signed: bool = True) -> torch.Tensor:
        """Exact inverse of :meth:`encode` given the receiver's copy of
        the same ``prev``; returns the logical payload in ``dtype``.

        ``signed`` tells an add-combine quantize widening what the word
        holds: the reduce ring ships wrapped deltas (sign-extend, exact
        while ``|value| < 2^(bits-1)``), the broadcast ring full labels,
        which are non-negative (``signed=False`` zero-extends unsigned
        words, exact while ``value < 2^bits``: kcore's remaining degrees
        in ``[2^15, 2^16)``).  Signed narrow dtypes and the other codecs
        ignore it."""
        if self.name == "delta" and not _is_float(dtype):
            return prev + wire
        if self.name == "quantize":
            _, _, sent = _narrow_info(self.narrow)
            unsigned = self.narrow.startswith("u")
            if op.combine == "min":
                wide = _widen(wire, self.narrow, signed=not unsigned)
                return torch.where(wide == sent, int(INF), wide).to(dtype)
            return _widen(wire, self.narrow,
                          signed=signed or not unsigned).to(dtype)
        return wire

    # -- wire accounting (int32 device scalars) --------------------------

    def step_wire_bytes(self, payload: torch.Tensor, prev: torch.Tensor,
                        live: torch.Tensor, op: Operator) -> torch.Tensor:
        """Post-encode bytes of one mirror ring step.  ``payload`` /
        ``prev``: ``[B, L]`` slabs; ``live``: ``bool[L]``, the slots that
        carry traffic (padding and clean slots ship nothing under every
        codec)."""
        b = payload.shape[0]
        isz = payload.element_size()
        n_live = live.sum(dtype=torch.int32)
        if self.name == "identity":
            return n_live * (INDEX_BYTES + b * isz)
        if self.name == "quantize":
            _, nisz, _ = _narrow_info(self.narrow)
            return n_live * (INDEX_BYTES + b * nisz)
        if self.name == "bitmap":
            # the index side: a bitmap over the step's L static slots
            # when denser than the index list
            lcap = live.shape[0]
            idx = torch.clamp(n_live * INDEX_BYTES, max=-(-lcap // 8))
            idx = torch.where(n_live > 0, idx, 0)
            return idx + n_live * (b * isz)
        # delta: indices + 2-bit entry codes + per-entry offset bytes
        changed = live[None, :] & (payload != prev)
        n_changed_q = changed.sum(dim=1, dtype=torch.int32)       # [B]
        if payload.is_floating_point():
            mask_bytes = n_live * (-(-b // 8))
            return (n_live * INDEX_BYTES + mask_bytes
                    + n_changed_q.sum(dtype=torch.int32) * isz)
        # frame of reference: per-query base = the least changed value;
        # each changed entry ships its offset in 1, 2 or isz bytes
        wide = payload.to(torch.int32)
        big = torch.iinfo(torch.int32).max
        base = torch.where(changed, wide, big).amin(dim=1, keepdim=True)
        off = torch.where(changed, wide - base, 0)
        entry = torch.where(off < (1 << 8), 1,
                            torch.where(off < (1 << 16), 2, isz))
        entry_bytes = torch.where(changed, entry, 0).sum(dtype=torch.int32)
        base_bytes = (n_changed_q > 0).sum(dtype=torch.int32) * isz
        code_bytes = n_live * (-(-(2 * b) // 8))
        return (n_live * INDEX_BYTES + code_bytes + base_bytes
                + entry_bytes)

    def allreduce_wire_bytes(self, new: torch.Tensor, prev: torch.Tensor
                             ) -> torch.Tensor:
        """Post-encode per-device bytes of one replicated all-reduce
        round over the labels ``new`` (``prev``: the round-entry labels,
        or zeros when the payload already is a delta).  Dense, with no
        index side: ``bitmap`` is ``identity`` here, ``delta`` a sparse
        all-reduce behind a 1-bit mask, ``quantize`` narrow words."""
        isz = new.element_size()
        if self.name == "quantize":
            _, nisz, _ = _narrow_info(self.narrow)
            return _int32(new.numel() * nisz, new.device)
        if self.name == "delta":
            changed = (new != prev).sum(dtype=torch.int32)
            return -(-new.numel() // 8) + changed * isz
        return _int32(new.numel() * isz, new.device)


def _int32(n: int, device) -> torch.Tensor:
    if not -(1 << 31) <= n < (1 << 31):
        raise OverflowError(f"{n} bytes overflow the int32 byte counts")
    return torch.full((), n, dtype=torch.int32, device=device)


def step_logical_bytes(live: torch.Tensor, batch: int, itemsize: int
                       ) -> torch.Tensor:
    """Codec-independent **logical** bytes of one ring step: every live
    vertex ships its int32 index word plus its ``[B]`` label vector.
    What ``bytes_synced`` accumulates, and the denominator of the
    compression ratio."""
    return live.sum(dtype=torch.int32) * (INDEX_BYTES + batch * itemsize)


def word_numpy(wire: torch.Tensor, codec: WireCodec) -> np.ndarray:
    """A wire tensor on the host, viewed as the word dtype the JAX
    package ships (``uint16`` words travel as ``int16`` bits here)."""
    arr = wire.cpu().numpy()  # repro: allow[host-sync] -- inspection of a wire payload on request, on no round path
    if codec.name == "quantize":
        arr = arr.view(np.dtype(codec.narrow))
    return arr


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

IDENTITY = WireCodec("identity")
DELTA = WireCodec("delta")
BITMAP = WireCodec("bitmap")

_CODECS = {"identity": IDENTITY, "delta": DELTA, "bitmap": BITMAP}
_QUANTIZE_CACHE: dict = {}

WIRE_NAMES = ("identity", "delta", "quantize", "bitmap")


def get_codec(wire: str, op: Optional[Operator] = None,
              dtype=None) -> WireCodec:
    """Resolve a ``BalancerConfig.wire`` spec to a codec.

    ``"quantize"`` picks the operator's first declared narrowing;
    ``"quantize:<dtype>"`` requests one (it must still be declared).
    Given ``op`` (and optionally the payload ``dtype``, int32 by
    default) the pairing is validated at once: the config-time refusal.
    Without an operator only the syntax is checked."""
    if wire in _CODECS:
        codec = _CODECS[wire]
    else:
        base, _, req = wire.partition(":")
        if base != "quantize":
            raise ValueError(
                f"unknown wire codec {wire!r} (expected one of "
                f"{WIRE_NAMES} or 'quantize:<dtype>')")
        if req and req not in NARROW_DTYPES:
            raise ValueError(
                f"wire codec {wire!r}: {req!r} is not a supported "
                f"narrow dtype ({sorted(NARROW_DTYPES)})")
        narrow = req or None
        if narrow is None:
            if op is None:
                # the syntax is valid; the narrowing is resolved (and
                # validated) once the operator is known
                return WireCodec("quantize", narrow=None)
            if not op.wire_narrow:
                raise ValueError(
                    f"wire codec 'quantize' needs an operator that "
                    f"declares a safe narrowing; {op.name} declares "
                    f"none (DESIGN.md section 14)")
            narrow = op.wire_narrow[0]
        if narrow not in _QUANTIZE_CACHE:
            _narrow_info(narrow)      # reject unsupported names early
            _QUANTIZE_CACHE[narrow] = WireCodec("quantize", narrow=narrow)
        codec = _QUANTIZE_CACHE[narrow]
    if op is not None:
        codec.validate(op, dtype if dtype is not None else torch.int32)
    return codec


def validate_wire(wire: str) -> None:
    """Config-syntax check of ``BalancerConfig.wire``: the spec must
    name a registered codec (the operator pairing is checked when the
    driver knows its operator)."""
    get_codec(wire)
