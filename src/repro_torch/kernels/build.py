"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, and loaded with ``ctypes``.
The libraries go to ``<repo>/build/repro_torch/`` (listed in
``.gitignore``), named by a hash of the source, every ``csrc/*.cuh``
header and the flags, so a changed source or header is rebuilt and an
unchanged one is reused; each build's ``nvcc`` output is kept beside its
library (:func:`build_log`).  Every source builds with ``NVCC_FLAGS`` alone:
none needs an include path or a library of its own (the wgmma kernel
reaches the CUDA driver's tensor-map encoder through the runtime).
Nothing is built when this module is imported: :func:`load_all` builds
on first use, one ``nvcc`` process per source, all started together, and
:func:`load` is its one-source case.  :func:`check_vec` holds the input
checks every wrapper makes before it hands raw pointers to a kernel, and
:func:`scalar_arg` those of a scalar that is a host int or a device int32.
:func:`count_launch` keeps a wrapper's counts, and :func:`device_launches`
reads the launches a source's kernels counted on the card
(``csrc/device_count.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}
_LOCK = threading.Lock()
#: ``nvcc`` output of each build in this process (ptxas register and
#: shared-memory report), by source name
BUILD_LOG: dict = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # any source may include one
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library and that build's
    log exist; returns ``(name, out, tmp, process)`` or None."""
    out = _lib_path(name)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, proc


def _finish(job) -> None:
    name, out, tmp, proc = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    tmp.with_suffix(".log").write_text(log)
    os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
    os.replace(tmp, out)                # atomic: readers never see half


def build_log(name: str):
    """The ``nvcc`` output (ptxas report) of ``csrc/<name>.cu``'s library:
    this process's build, else the log kept beside the library when it
    was built; None if neither exists."""
    if name in BUILD_LOG:
        return BUILD_LOG[name]
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def check_vec(kernel: str, name: str, t, n: int, device,
              dtypes=("int32",)) -> None:
    """Raise unless ``t`` is a contiguous ``[n]`` tensor on ``device``
    whose dtype is one of ``dtypes`` (torch dtype names): what a kernel
    reading raw pointers needs to hold."""
    if str(t.dtype).removeprefix("torch.") not in dtypes:
        raise TypeError(f"{kernel}: {name} must be one of {dtypes}, "
                        f"got {t.dtype}")
    if t.shape != (n,) or t.device != device or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous [{n}] "
                         f"tensor on {device}; got {tuple(t.shape)} on "
                         f"{t.device}")


def scalar_arg(kernel: str, name: str, x, device) -> tuple:
    """A kernel's int32 scalar argument as ``(pointer, host value)``: a
    host int gives ``(None, x)``; a one-element int32 tensor on
    ``device`` gives ``(its address, 0)``, which the kernel reads on the
    card (no host read, so a captured round can take it)."""
    if not isinstance(x, torch.Tensor):
        return None, int(x)
    if x.dtype != torch.int32 or x.numel() != 1 or x.device != device:
        raise ValueError(f"{kernel}: a tensor {name} must be one int32 on "
                         f"{device}; got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.data_ptr(), 0


def load_all(names=None) -> dict:
    """The loaded library of ``csrc/<name>.cu`` for each of ``names``
    (default: every source).  Sources without an up-to-date library are
    compiled first, one ``nvcc`` process each, all started together."""
    names = sources() if names is None else list(names)
    with _LOCK:
        jobs = [j for j in (_start(n) for n in names if n not in _LOADED)
                if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:    # finish the others, then raise
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _LOADED:
                _LOADED[n] = ctypes.CDLL(str(_lib_path(n)))
        return {n: _LOADED[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return load_all([name])[name]


def count_launch(fn) -> None:
    """Count one launch of wrapper ``fn`` where it launches its kernel:
    ``fn.launches``, or ``fn.captured`` while the current stream is being
    captured into a CUDA graph, where the call only records the kernel
    (the graph launches it each time it runs, and the kernel counts
    those launches on the card: :func:`device_launches`)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def device_launches(name: str, reset: bool = False) -> int:
    """Launches of ``csrc/<name>.cu``'s kernels counted on the card since
    the last reset, those of graph replays included (a source that
    includes ``device_count.cuh``; reads device memory, so it syncs)."""
    fn = load(name).device_launches
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    n = ctypes.c_ulonglong(0)
    err = fn(ctypes.byref(n), int(reset))
    if err != 0:
        raise RuntimeError(f"{name}: reading the device launch count "
                           f"failed with CUDA error {err}")
    return n.value
