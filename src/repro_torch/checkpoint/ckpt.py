"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

Port of ``repro/checkpoint/ckpt.py``:

* step-granular directories ``step_%08d/`` holding ``shard_0.npz``;
* a ``MANIFEST.json`` written LAST: the directory is written as
  ``step_%08d.tmp`` and published by an atomic rename, so a directory
  without a manifest is incomplete and ignored by restore;
* an async writer thread, so the train loop never blocks on disk;
* elastic restore: arrays are saved with their global shape and restored
  onto whatever device the template's tensors are on.

A tree is a nested dict (or list) of tensors or numpy arrays; its keys
in the npz are the ``/``-joined paths, as JAX's
``tree_flatten_with_path`` names them (``params/layers/attn/wq``,
``opt/mu/...``, ``opt/step``), so a checkpoint the JAX trainer writes
restores here and the reverse (``models.convert`` maps the port's
modules to JAX's tree).  bf16 has no numpy dtype: a bf16 tensor is
written as its 16-bit pattern in a ``V2`` array, which is also what
numpy reads back from a bf16 leaf the JAX package wrote, and restored by
viewing the bits (``core.host``).

A tensor leaf is copied to the host once, when it is saved or
submitted; a numpy leaf is taken as it is, so the caller hands it over
(``models.convert.train_state_to_jax_tree`` builds a fresh tree).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch

from ..core.host import from_host, is_bf16_bits, to_host


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def _flatten_with_paths(tree, prefix=()):
    """``[(key, leaf)]`` in JAX's order (dict keys sorted)."""
    items = _items(tree)
    if items is None:
        return [("/".join(str(p) for p in prefix), tree)]
    if isinstance(tree, dict):
        items = sorted(items)
    out = []
    for k, v in items:
        out += _flatten_with_paths(v, prefix + (k,))
    return out


def _host_leaf(v) -> np.ndarray:
    """A tensor copied to the host; a numpy leaf as it is."""
    return to_host(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _map_tree(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(str(p) for p in prefix), tree)


def save_checkpoint(directory: str, step: int, tree, extra: dict | None
                    = None) -> str:
    """Synchronous save; returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _host_leaf(v) for k, v in _flatten_with_paths(tree)}
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)                 # atomic publish
    return path


def latest_step(directory: str) -> int | None:
    """Newest COMPLETE checkpoint (manifest present)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(directory, name,
                                           "MANIFEST.json")):
            continue
        step = int(name.split("_")[1])
        best = step if best is None else max(best, step)
    return best


def restore_checkpoint(directory: str, step: int, tree_template):
    """Restore into the structure of ``tree_template``: a tensor leaf
    comes back as a tensor of its dtype on its device (the elastic
    re-placement), a numpy leaf as numpy of its dtype, and a ``meta``
    tensor leaf, which gives a shape and holds no memory, as the numpy
    array the checkpoint holds.  Raises ``AssertionError`` on a shape
    that differs from the template's."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        def one(key, leaf):
            arr = data[key]
            if not isinstance(leaf, torch.Tensor):
                leaf = np.asarray(leaf)
            assert tuple(arr.shape) == tuple(leaf.shape), \
                f"{key}: ckpt {arr.shape} vs template {tuple(leaf.shape)}"
            if isinstance(leaf, torch.Tensor):
                if leaf.is_meta:
                    return arr
                return from_host(arr, leaf.dtype, leaf.device)
            if is_bf16_bits(arr) and is_bf16_bits(leaf):
                return arr.view(leaf.dtype)
            return arr.astype(leaf.dtype, copy=False)
        return _map_tree(one, tree_template), manifest


class AsyncCheckpointer:
    """Background writer: ``submit`` copies the tree's tensors to host
    memory and returns; the previous write is awaited first, so at most
    one write is in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                save_checkpoint(self.directory, step, tree, extra)
                self._gc()
            except Exception as e:     # surfaced on next submit/close
                self._err = e

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def submit(self, step: int, tree, extra: dict | None = None):
        if self._err:
            raise self._err
        # tensors copied to the host before the caller updates them in
        # place; numpy leaves are handed over as they are
        host_tree = _map_tree(lambda _k, v: _host_leaf(v), tree)
        self._q.put((step, host_tree, extra))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
