"""The mesh of partition slots and the collectives the Gluon runtime uses.

The JAX package runs its distributed rounds under ``shard_map`` over a
1-D ``("dev",)`` mesh of local devices, one controller for all of them,
and syncs with ``pmin`` / ``psum`` and ``ppermute`` rings.  Here one
process drives a :class:`Mesh` of D partition *slots*, each bound to a
``torch.device``: each partition's round runs on its slot's device, and
the collectives below are torch ops on the partitions' tensors, copied
between devices where slots differ.  A device may fill several slots
(``["cuda:0"] * 4`` on one card, ``["cpu"] * 4`` in the tests), and
then a copy between two of its slots is no copy at all.

The interface is narrow, so that a process-group backend (one rank a
card) can implement it later:

* :func:`all_reduce` — ``pmin`` / ``psum`` / ``pmax``: every slot gets
  the combination of all slots' tensors;
* :func:`ring_shift` — ``ppermute`` by a shift ``s``: slot ``d``'s
  tensor goes to slot ``(d + s) % D``;
* :func:`owner_gather` — each vertex's entry from its owner slot's
  tensor (the master/mirror substrate's final assembly);
* :func:`to_slots` — one tensor given to every slot (a replicated
  input).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .graph import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D partition slots, each on a ``torch.device`` (repeats allowed)."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def single_device(self) -> Optional[torch.device]:
        """The device of every slot when they share one, else None."""
        first = self.devices[0]
        return first if all(d == first for d in self.devices) else None


def _canonical(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def device_mesh(num_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``num_devices`` slots: by default one per card,
    ``cuda:0 .. cuda:{D-1}`` (all the cards when ``num_devices`` is
    None), raising when fewer cards exist.  ``devices=`` names each
    slot's device instead and may repeat one: ``["cuda:0"] * 4`` runs
    four partitions on one card, ``["cpu"] * 4`` on the CPU."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if num_devices is None else int(num_devices)
        if want < 1 or want > have:
            raise RuntimeError(
                f"device_mesh({num_devices}) needs {want or 1} CUDA "
                f"devices and {have} exist; pass devices= to put several "
                f"partitions on one device (e.g. ['cuda:0'] * 4 or "
                f"['cpu'] * 4)")
        devices = [f"cuda:{i}" for i in range(want)]
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one slot")
    if num_devices is not None and len(devices) != num_devices:
        raise ValueError(f"device_mesh: {len(devices)} devices given for "
                         f"{num_devices} slots")
    return Mesh(devices)


_COMBINE = {"min": torch.minimum, "add": torch.add, "max": torch.maximum}


def to_slots(x: torch.Tensor, mesh: Mesh) -> list:
    """``x`` on every slot's device: one copy per device, shared by the
    slots of that device (``x`` itself on its own device)."""
    copies = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return out


def all_reduce(parts: Sequence[torch.Tensor], combine: str,
               mesh: Mesh) -> list:
    """``pmin`` (``combine="min"``), ``psum`` (``"add"``) or ``pmax``
    (``"max"``) over the slots: the slots' tensors combined in slot
    order on slot 0's device, then given to every slot
    (:func:`to_slots`)."""
    fn = _COMBINE.get(combine)
    if fn is None:
        raise ValueError(f"unknown combine {combine!r} (min|add|max)")
    acc = parts[0]
    for p in parts[1:]:
        acc = fn(acc, p.to(acc.device))
    return to_slots(acc, mesh)


def ring_shift(parts: Sequence[torch.Tensor], shift: int,
               mesh: Mesh) -> list:
    """``ppermute`` by ``shift``: slot ``d``'s tensor goes to slot
    ``(d + shift) % D``, on that slot's device.  Returns the received
    tensor of each slot."""
    n = mesh.size
    out = [None] * n
    for d, p in enumerate(parts):
        r = (d + shift) % n
        out[r] = p.to(mesh.devices[r])
    return out


def owner_gather(parts: Sequence[torch.Tensor],
                 owner: torch.Tensor) -> torch.Tensor:
    """Each vertex's entry from its owner slot: ``out[..., v] =
    parts[owner[v]][..., v]``, on the device of ``owner`` (``parts``:
    ``[V]`` or ``[B, V]`` per slot; ``owner``: ``[V]``)."""
    dev = owner.device
    out = parts[0].to(dev)
    for d in range(1, len(parts)):
        out = torch.where(owner == d, parts[d].to(dev), out)
    return out
