"""``twc_bin_relax`` and ``edge_lb_relax``: one whole ALB pass, fused;
``merge_path_relax``: one whole merge-path pass, fused;
``twc_bin_list``: the static round's bins, listed once a round;
``round_turn``: the fused min-combine round's turn and census.

Hand-written CUDA C++ kernels for the hot paths of the ``pallas`` and
``merge_path`` executor pairs (``kernels/ops.py``):
``csrc/twc_relax.cu`` serves one degree bin's pass ``chunk``,
``csrc/edge_lb_relax.cu`` the huge bin's edge-balanced pass,
``csrc/merge_path_relax.cu`` the merge-path pass over every frontier
edge in equal-work tiles (``edge_lb_relax``'s cyclic deal and
``merge_path_relax`` share one tile walk, ``csrc/tile_relax.cuh``).
Each maps slot -> CSR edge in registers, loads ``col_idx`` (and
``edge_w`` for ``v + w``), applies the operator's ``msg`` per query and
combines into ``labels`` with atomics, so no index tile reaches device
memory.  They replace, on the main path, the Pallas TPU kernels
``twc_bin_map`` / ``edge_lb_map`` / ``merge_path_map`` together with
the gather/scatter epilogue the JAX package leaves to XLA.
``csrc/twc_list.cu`` (no TPU kernel) is the static round's frontier
inspector: from the dense frontier and ``row_ptr`` it lists each degree
bin's members in vertex order, and the edge-balanced (LB) bin's with
their edge prefix and total, so that each bin's ``twc_bin_relax``
launch and the ``edge_lb_relax`` or ``merge_path_relax`` launch run
over their members alone.
``csrc/round_turn.cu`` (no TPU kernel) is the fused min-combine loop's
turn: the next frontier, the carry's labels brought level with the
round's relaxed copy, and the next round's ``n_f`` / ``m_f``, in one
pass over the labels.

``values`` / ``labels`` / ``fmask`` are ``[B, V]`` and the enumeration is
batch-shared.  ``labels`` is written in place and returned; it must not
share memory with ``values`` (the round hands the pair a private copy of
its labels and reads the round-entry values).  The operator's ``msg``
goes to the kernel as ``operators.msg_kind``; the labels may be int32
(min or add) or float32 (add).  :func:`takes` says whether the kernels
take an operator and a label dtype; the wrappers raise on anything
else.  The kernel pairs' entries (``kernels/ops.py``) ask :func:`takes`
first and send any other operator through the unfused route, as the
JAX pairs run every operator.

For CPU tensors the wrappers compute the plain version
(``ref.twc_bin_relax_ref`` / ``ref.edge_lb_relax_ref`` /
``ref.merge_path_relax_ref``: the reference index map plus the torch
epilogue, written into ``labels``; ``ref.twc_bin_list_ref``;
``ref.round_turn_ref``); for CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.operators import has_msg_kind, msg_kind

from . import build
from .ref import (BinLists, edge_lb_relax_ref, merge_path_relax_ref,
                  round_turn_ref, twc_bin_list_ref, twc_bin_relax_ref)

_P = ctypes.c_void_p
_I = ctypes.c_int

# (labels dtype, combine) pairs the kernels take
_TAKES = {(torch.int32, "min"), (torch.int32, "add"),
          (torch.float32, "add")}


@functools.cache
def _launcher(source: str, kernel: str, n_ptr: int, n_int: int):
    """``<kernel>_launch`` of ``csrc/<source>.cu``: ``n_ptr`` pointers,
    ``n_int`` ints, then the stream."""
    fn = getattr(build.load(source), f"{kernel}_launch")
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
    fn.restype = _I
    return fn


def takes(op, labels_dtype: torch.dtype) -> bool:
    """Whether the fused kernels run ``op`` on labels of ``labels_dtype``:
    its combine on that dtype is one of ``_TAKES`` and its ``msg`` has a
    kind (``operators.msg_kind``).  Never raises."""
    return (labels_dtype, op.combine) in _TAKES and has_msg_kind(op)


def _state(kernel: str, values, labels, fmask, col_idx, edge_w,
           op) -> list:
    """Check the batched state and the operator; returns the kernels'
    trailing ints ``[B, V, dtype, add, pull, msg kind]``."""
    if labels.ndim != 2:
        raise ValueError(f"{kernel}: labels must be [B, V]; got "
                         f"{tuple(labels.shape)}")
    if not takes(op, labels.dtype):
        if (labels.dtype, op.combine) not in _TAKES:
            raise TypeError(f"{kernel}: {labels.dtype} labels with "
                            f"combine {op.combine!r} are not taken (int32 "
                            f"min, int32 add, float32 add)")
        msg_kind(op)                     # raises: the msg has no kind
    kind = msg_kind(op)
    dev = labels.device
    for name, t, dtype in (("values", values, labels.dtype),
                           ("labels", labels, labels.dtype),
                           ("fmask", fmask, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if t.shape != labels.shape or t.device != dev or \
                not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous "
                             f"{tuple(labels.shape)} tensor on {dev}; got "
                             f"{tuple(t.shape)} on {t.device}")
    if values.untyped_storage().data_ptr() == \
            labels.untyped_storage().data_ptr():
        raise ValueError(f"{kernel}: labels must not share memory with "
                         f"values (it is combined into in place)")
    build.check_vec(kernel, "col_idx", col_idx, col_idx.shape[0], dev)
    build.check_vec(kernel, "edge_w", edge_w, col_idx.shape[0], dev)
    return [*labels.shape, int(labels.dtype == torch.float32),
            int(op.combine == "add"), int(op.direction == "pull"), kind]


def _launched(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA "
                           f"error {err}")


def twc_bin_relax(values: torch.Tensor, labels: torch.Tensor,
                  fmask: torch.Tensor, col_idx: torch.Tensor,
                  edge_w: torch.Tensor, vidx: torch.Tensor,
                  deg: torch.Tensor, row_start: torch.Tensor, op, *,
                  width: int, chunk=0, passes=1, rows=None) -> torch.Tensor:
    """Combine passes ``chunk .. chunk + passes - 1`` of one degree bin
    into ``labels``, in order (one pass by default).

    Bin row ``r`` (``vidx``/``deg``/``row_start``: int32 ``[N]``;
    ``vidx >= V`` marks an empty slot) contributes its CSR edges
    ``[c*width, c*width + width)`` in pass ``c``.  ``chunk`` and
    ``passes`` are each a host int or a one-element int32 tensor on the
    device, which the kernel reads there.  ``rows``, a one-element int32
    tensor on the device, limits the bin to rows ``[0, rows)``: the
    static round's bin list (:func:`twc_bin_list`) with its member
    count; the kernel then hands the rows out one group each on a grid
    of a few blocks per SM, fixed by ``N``.  Returns ``labels``.
    """
    ints = _state("twc_bin_relax", values, labels, fmask, col_idx, edge_w,
                  op)
    n, dev = vidx.shape[0], labels.device
    for name, t in (("vidx", vidx), ("deg", deg), ("row_start", row_start)):
        build.check_vec("twc_bin_relax", name, t, n, dev)
    if dev.type == "cpu":
        return twc_bin_relax_ref(values, labels, fmask, col_idx, edge_w,
                                 vidx, deg, row_start, op, width=width,
                                 chunk=chunk, passes=passes, rows=rows)
    if dev.type != "cuda":
        raise ValueError(f"twc_bin_relax runs on cuda or cpu, not {dev}")
    chunk_ptr, chunk_host = build.scalar_arg("twc_bin_relax", "chunk",
                                             chunk, dev)
    passes_ptr, passes_host = build.scalar_arg("twc_bin_relax", "passes",
                                               passes, dev)
    rows_ptr = None
    if rows is not None:
        if not isinstance(rows, torch.Tensor):
            raise ValueError("twc_bin_relax: rows is a device int32")
        rows_ptr, _ = build.scalar_arg("twc_bin_relax", "rows", rows, dev)
    if n == 0 or labels.numel() == 0:
        return labels
    fn = _launcher("twc_relax", "twc_bin_relax", 11, 10)
    _launched("twc_bin_relax", fn(
        values.data_ptr(), labels.data_ptr(), fmask.data_ptr(),
        col_idx.data_ptr(), edge_w.data_ptr(), vidx.data_ptr(),
        deg.data_ptr(), row_start.data_ptr(), chunk_ptr, passes_ptr,
        rows_ptr, chunk_host, passes_host, n, width, *ints,
        torch.cuda.current_stream(dev).cuda_stream))
    build.count_launch(twc_bin_relax)
    return labels


# vertices a list may hold: the listing kernel packs a tile's prefix count
# in 31 bits of its status word
_LIST_ROWS = 1 << 30
_NO_CAP = (1 << 31) - 1


@functools.cache
def _list_scratch():
    """``twc_bin_list_scratch`` of ``csrc/twc_list.cu``: the int32
    scratch a launch over ``(V vertices, nb bins)`` needs zeroed."""
    fn = build.load("twc_list").twc_bin_list_scratch
    fn.argtypes, fn.restype = [_I, _I], _I
    return fn


def twc_bin_list(mask: torch.Tensor, row_ptr: torch.Tensor, bounds, *,
                 lb: bool = False) -> BinLists:
    """List each degree bin's members of a static round, once, straight
    from the dense frontier.

    ``mask`` is a contiguous bool ``[R, V]`` (R >= 1): a push round's
    ``[B, V]`` frontier, whose rows are OR-ed, or a pull round's
    ``emask[None]``.  Each vertex it lists goes to the bin ``(lo, hi)``
    of ``bounds`` (1 to 4 disjoint ranges ``lo < deg <= hi``, ``hi``
    None for no cap) that holds its degree ``row_ptr[v + 1] -
    row_ptr[v]`` (``row_ptr``: int32 ``[V + 1]``).  With ``lb`` the last
    bin is the plan's edge-balanced (LB) bin: its list also carries the
    exclusive prefix of its members' degrees and their total.  Nothing
    is read on the host.  Returns a :class:`ref.BinLists`: each bin's
    members in vertex order (the compacted frontier's order), their
    count and their largest degree (and the LB bin's ``start_e`` and
    ``total``), on the device, allocated here; rows past a bin's count
    are left unwritten by the kernel.  Each degree bin's list with its
    count feeds one :func:`twc_bin_relax` launch
    (``rows=count[b:b + 1]``), the LB bin's one :func:`edge_lb_relax`
    or :func:`merge_path_relax` launch (``rows=count[-1:]``).  Raises on
    a mask that is not a contiguous bool ``[R, V]`` or whose V is not
    ``row_ptr``'s; it is never copied or converted here."""
    nb = len(bounds)
    if not 1 <= nb <= 4:
        raise ValueError(f"twc_bin_list: 1 to 4 bins, got {nb}")
    if mask.dtype != torch.bool:
        raise TypeError(f"twc_bin_list: mask must be torch.bool, got "
                        f"{mask.dtype}")
    if mask.ndim != 2 or mask.shape[0] < 1 or not mask.is_contiguous():
        raise ValueError(f"twc_bin_list: mask must be a contiguous bool "
                         f"[R, V] with R >= 1; got {tuple(mask.shape)}, "
                         f"strides {mask.stride()}")
    r, n = mask.shape
    dev = mask.device
    build.check_vec("twc_bin_list", "row_ptr", row_ptr, n + 1, dev)
    if dev.type == "cpu":
        return twc_bin_list_ref(mask, row_ptr, bounds, lb=lb)
    if dev.type != "cuda":
        raise ValueError(f"twc_bin_list runs on cuda or cpu, not {dev}")
    if n >= _LIST_ROWS:
        raise ValueError(f"twc_bin_list: {n} vertices exceed "
                         f"{_LIST_ROWS - 1}")
    scratch = torch.zeros(_list_scratch()(n, nb), dtype=torch.int32,
                          device=dev)
    buf = torch.empty((3 * nb + lb) * n, dtype=torch.int32, device=dev)
    out = buf[:3 * nb * n].view(3, nb, n)
    start_e = buf[3 * nb * n:] if lb else None
    lists = BinLists(*out[:3], scratch[1:1 + nb],
                     scratch[1 + nb:1 + 2 * nb], start_e,
                     scratch[1 + 2 * nb] if lb else None)
    if n == 0:
        return lists
    cut = (_I * (2 * nb))(*[lo for lo, _ in bounds],
                          *[_NO_CAP if hi is None else hi
                            for _, hi in bounds])
    fn = _launcher("twc_list", "twc_bin_list", 8, 4)
    _launched("twc_bin_list", fn(
        mask.data_ptr(), row_ptr.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(),
        None if start_e is None else start_e.data_ptr(), scratch.data_ptr(),
        ctypes.addressof(cut), r, n, nb, nb - 1 if lb else -1,
        torch.cuda.current_stream(dev).cuda_stream))
    build.count_launch(twc_bin_list)
    return lists


def edge_lb_relax(values: torch.Tensor, labels: torch.Tensor,
                  fmask: torch.Tensor, col_idx: torch.Tensor,
                  edge_w: torch.Tensor, hvidx: torch.Tensor,
                  start_e: torch.Tensor, row_start: torch.Tensor,
                  total_edges, n_enum: int, op, *, tile_edges: int = 2048,
                  distribution: str = "cyclic", num_tiles: int = 64,
                  rows=None) -> torch.Tensor:
    """Combine the huge bin's edge-balanced pass into ``labels``.

    ``hvidx``/``start_e``/``row_start`` are int32 ``[H]`` (H >= 1):
    the huge vertices, the exclusive prefix sum of their degrees and
    their CSR row starts; ``total_edges`` is a host int or a one-element
    int32 tensor on the device (ids at or past it do nothing, so a
    total of 0 does nothing).  ``rows``, a one-element int32 tensor on
    the device, bounds the slots to ``[0, rows)``: the static round's
    LB list (:func:`twc_bin_list` with ``lb``) with its member count,
    where the slots past it are unwritten; no slot, no id.  The ids are
    enumerated and dealt exactly as ``edge_lb.edge_lb_map`` deals them
    (span ``ceil(n_enum / num_tiles) * num_tiles``); ``tile_edges`` only
    pads the plain version's enumeration.  Returns ``labels``.
    """
    h, dev = start_e.shape[0], labels.device
    if h < 1:
        raise ValueError("edge_lb_relax: the huge bin needs H >= 1 slots")
    if distribution not in ("cyclic", "blocked"):
        raise ValueError(f"unknown distribution {distribution!r}")
    ints = _state("edge_lb_relax", values, labels, fmask, col_idx, edge_w,
                  op)
    for name, t in (("hvidx", hvidx), ("start_e", start_e),
                    ("row_start", row_start)):
        build.check_vec("edge_lb_relax", name, t, h, dev)
    if dev.type == "cpu":
        return edge_lb_relax_ref(values, labels, fmask, col_idx, edge_w,
                                 hvidx, start_e, row_start, total_edges,
                                 n_enum, op, tile_edges=tile_edges,
                                 distribution=distribution,
                                 num_tiles=num_tiles, rows=rows)
    if dev.type != "cuda":
        raise ValueError(f"edge_lb_relax runs on cuda or cpu, not {dev}")
    total_ptr, total_host = build.scalar_arg("edge_lb_relax", "total_edges",
                                             total_edges, dev)
    rows_ptr = None
    if rows is not None:
        if not isinstance(rows, torch.Tensor):
            raise ValueError("edge_lb_relax: rows is a device int32")
        rows_ptr, _ = build.scalar_arg("edge_lb_relax", "rows", rows, dev)
    w_per = -(-n_enum // num_tiles)
    span = w_per * num_tiles
    if span >= 1 << 31:
        raise ValueError(f"edge_lb_relax: {span} ids exceed int32")
    if span == 0 or labels.numel() == 0 or (total_ptr is None
                                            and total_host == 0):
        return labels
    fn = _launcher("edge_lb_relax", "edge_lb_relax", 10, 12)
    _launched("edge_lb_relax", fn(
        values.data_ptr(), labels.data_ptr(), fmask.data_ptr(),
        col_idx.data_ptr(), edge_w.data_ptr(), hvidx.data_ptr(),
        start_e.data_ptr(), row_start.data_ptr(), total_ptr, rows_ptr, h,
        total_host,
        w_per, num_tiles, span, int(distribution == "blocked"), *ints,
        torch.cuda.current_stream(dev).cuda_stream))
    build.count_launch(edge_lb_relax)
    return labels


def merge_path_relax(values: torch.Tensor, labels: torch.Tensor,
                     fmask: torch.Tensor, col_idx: torch.Tensor,
                     edge_w: torch.Tensor, hvidx: torch.Tensor,
                     start_e: torch.Tensor, row_start: torch.Tensor,
                     total_edges, ecap: int, op, *, tile_edges: int = 2048,
                     rows=None) -> torch.Tensor:
    """Combine the merge-path pass over every frontier edge into
    ``labels``.

    ``hvidx``/``start_e``/``row_start`` are int32 ``[H]`` (H >= 1): the
    enumerated vertices, the exclusive prefix sum of their degrees and
    their CSR row starts.  The ids ``[0, n)``, ``n = max(1, ceil(ecap /
    tile_edges)) * tile_edges``, are cut into tiles of ``tile_edges``
    (a positive multiple of 128) and mapped as ``merge_path.
    merge_path_map`` maps them; ids at or past ``total_edges`` (a host
    int or a one-element int32 tensor on the device, read there) do
    nothing.  ``rows``, a one-element int32 tensor on the device, bounds
    the slots to ``[0, rows)``: the static round's LB-all list
    (:func:`twc_bin_list` with ``lb``) with its member count, whose
    slots past it are unwritten.  Returns ``labels``.
    """
    h, dev = start_e.shape[0], labels.device
    if h < 1:
        raise ValueError("merge_path_relax: needs H >= 1 slots")
    if tile_edges <= 0 or tile_edges % 128:
        raise ValueError(f"merge_path_relax: tile_edges={tile_edges} is "
                         f"not a positive multiple of 128")
    ints = _state("merge_path_relax", values, labels, fmask, col_idx,
                  edge_w, op)
    for name, t in (("hvidx", hvidx), ("start_e", start_e),
                    ("row_start", row_start)):
        build.check_vec("merge_path_relax", name, t, h, dev)
    if dev.type == "cpu":
        return merge_path_relax_ref(values, labels, fmask, col_idx, edge_w,
                                    hvidx, start_e, row_start, total_edges,
                                    ecap, op, tile_edges=tile_edges,
                                    rows=rows)
    if dev.type != "cuda":
        raise ValueError(f"merge_path_relax runs on cuda or cpu, not {dev}")
    total_ptr, total_host = build.scalar_arg("merge_path_relax",
                                             "total_edges", total_edges, dev)
    rows_ptr = None
    if rows is not None:
        if not isinstance(rows, torch.Tensor):
            raise ValueError("merge_path_relax: rows is a device int32")
        rows_ptr, _ = build.scalar_arg("merge_path_relax", "rows", rows,
                                       dev)
    span = max(1, -(-ecap // tile_edges)) * tile_edges
    if span >= 1 << 31:
        raise ValueError(f"merge_path_relax: {span} ids exceed int32")
    if labels.numel() == 0 or (total_ptr is None and total_host == 0):
        return labels
    fn = _launcher("merge_path_relax", "merge_path_relax", 10, 10)
    _launched("merge_path_relax", fn(
        values.data_ptr(), labels.data_ptr(), fmask.data_ptr(),
        col_idx.data_ptr(), edge_w.data_ptr(), hvidx.data_ptr(),
        start_e.data_ptr(), row_start.data_ptr(), total_ptr, rows_ptr, h,
        total_host, span, tile_edges, *ints,
        torch.cuda.current_stream(dev).cuda_stream))
    build.count_launch(merge_path_relax)
    return labels


#: int32s of a census buffer (:func:`census_buffer`): ``n_f``, ``m_f``,
#: then the kernel's two block sums and its count of blocks done, which
#: every launch leaves at 0
CENSUS_INTS = 5
# the kernel's code for each label dtype it takes (32- and 64-bit words)
_TURN_DTYPES = {torch.int32: 0, torch.float32: 1, torch.int64: 2,
                torch.float64: 3}


def census_buffer(device) -> torch.Tensor:
    """A zeroed census for :func:`round_turn` on ``device``."""
    return torch.zeros(CENSUS_INTS, dtype=torch.int32, device=device)


def round_turn(labels, new, row_ptr: torch.Tensor, frontier: torch.Tensor,
               census: torch.Tensor) -> torch.Tensor:
    """The turn of a fused min-combine round, in place, and the census of
    the frontier it leaves.

    ``frontier`` is a contiguous bool ``[R, V]`` (or ``[V]``);
    ``labels`` and ``new`` are contiguous tensors of its shape and of one
    dtype that share no memory: on the card int32, float32, int64 or
    float64, on the CPU (its plain version) any.  It writes ``frontier =
    new < labels`` and ``labels = new`` (where their bits differ: the
    same words), then
    ``census[0]`` = the vertices set in any row of ``frontier`` and
    ``census[1]`` = their out-degrees from ``row_ptr`` (int32 ``[V +
    1]``), summed in int32.  With ``labels`` and ``new`` None it only
    takes the census of ``frontier``.  ``census`` is a
    :func:`census_buffer` (int32 ``[CENSUS_INTS]``, its scratch ints at
    0, as each launch leaves them).  Nothing is read on the host, so a
    captured loop can run it.  Returns ``census``."""
    if (labels is None) != (new is None):
        raise ValueError("round_turn: labels and new are given together")
    if frontier.dtype != torch.bool:
        raise TypeError(f"round_turn: frontier must be torch.bool, got "
                        f"{frontier.dtype}")
    if frontier.ndim not in (1, 2) or frontier.ndim == 2 and \
            frontier.shape[0] < 1 or not frontier.is_contiguous():
        raise ValueError(f"round_turn: frontier must be a contiguous [V] "
                         f"or [R, V] mask with R >= 1; got "
                         f"{tuple(frontier.shape)}, strides "
                         f"{frontier.stride()}")
    v, dev = frontier.shape[-1], frontier.device
    build.check_vec("round_turn", "row_ptr", row_ptr, v + 1, dev)
    build.check_vec("round_turn", "census", census, CENSUS_INTS, dev)
    if labels is not None:
        if new.dtype != labels.dtype or dev.type == "cuda" and \
                labels.dtype not in _TURN_DTYPES:
            raise TypeError(f"round_turn: labels and new must be of one "
                            f"dtype, on the card one of "
                            f"{tuple(_TURN_DTYPES)}; got {labels.dtype}, "
                            f"{new.dtype}")
        for name, t in (("labels", labels), ("new", new)):
            if t.shape != frontier.shape or t.device != dev or \
                    not t.is_contiguous():
                raise ValueError(f"round_turn: {name} must be a contiguous "
                                 f"{tuple(frontier.shape)} tensor on {dev};"
                                 f" got {tuple(t.shape)} on {t.device}")
        if labels.untyped_storage().data_ptr() == \
                new.untyped_storage().data_ptr():
            raise ValueError("round_turn: labels must not share memory "
                             "with new (it is written in place)")
    if dev.type == "cpu":
        return round_turn_ref(labels, new, row_ptr, frontier, census)
    if dev.type != "cuda":
        raise ValueError(f"round_turn runs on cuda or cpu, not {dev}")
    rows = frontier.shape[0] if frontier.ndim == 2 else 1
    fn = _launcher("round_turn", "round_turn", 5, 3)
    _launched("round_turn", fn(
        None if labels is None else labels.data_ptr(),
        None if new is None else new.data_ptr(), row_ptr.data_ptr(),
        frontier.data_ptr(), census.data_ptr(), rows, v,
        0 if labels is None else _TURN_DTYPES[labels.dtype],
        torch.cuda.current_stream(dev).cuda_stream))
    build.count_launch(round_turn)
    return census


twc_bin_relax.launches = twc_bin_relax.captured = 0
twc_bin_list.launches = twc_bin_list.captured = 0
edge_lb_relax.launches = edge_lb_relax.captured = 0
merge_path_relax.launches = merge_path_relax.captured = 0
round_turn.launches = round_turn.captured = 0
