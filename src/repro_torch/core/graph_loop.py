"""Device-side control flow: the port's ``lax.cond`` and ``lax.while_loop``.

The static-shape and fused round modes (``core.balancer``: the
direction choice, an unbounded bin's chunk loop, the fused traversal
loop) branch and loop on values that live on the device.  JAX traces
them into one program with ``lax.cond`` / ``lax.while_loop``; here the
same round code calls :func:`cond` and :func:`while_`, which differ by
device in this one module:

* **CPU tensors** evaluate eagerly with Python control flow.  Reading a
  CPU tensor is no device->host transfer, and none is counted.
* **CUDA tensors** are recorded, never run eagerly: :func:`run` captures
  the whole function once as a :class:`Program` and replays it.  The
  torch ops between two control-flow points are captured with
  ``torch.cuda.CUDAGraph(keep_graph=True)``; ``kernels/csrc/graph_loop.cu``
  puts each captured piece into one graph of its own as a child graph
  node, each :func:`cond` as two IF nodes (``pred`` and ``not pred``),
  each :func:`while_` as a WHILE node whose body ends by setting the
  loop's condition again.  A small kernel sets each condition on the
  device from one bool, so a replay takes its branches and turns its
  loops with no value crossing to the host.  That needs CUDA 12.4 or
  later; where a node cannot be built the call raises.  There is no
  route that syncs instead.

Every captured piece shares one memory pool, so a tensor made in one
piece and read in a later one keeps its address; the pieces run in the
order they were recorded (a loop body's pieces before what follows the
loop, an untaken branch not at all), which is what lets the pool reuse
a dead temporary's memory.  Inputs are copied into the program's own
buffers before each replay, and outputs are cloned after it, so callers
never share memory with a program.

:func:`run` keeps at most ``MAX_PROGRAMS`` programs per graph, the
most recently used: each holds a pool of its own, as large as the
temporaries of the function it captured (about 1 GB for a traversal of
a 4 M-vertex graph), so a caller who varies the configuration, the
operator or the batch cannot fill the card with them.  A program holds
no reference to the graph it is cached on, so a graph that is let go
(a superseded streaming version) frees its programs at once.  An evicted
program frees its graph at once and hands its pool back to torch's
allocator, which frees that memory the next time it trims its cache
(``torch.cuda.empty_cache``, or an allocation that would fail).

``captures`` counts the programs captured (a repeated call with a cached
key captures none) and ``capture_seconds`` the time spent capturing
them; :func:`set_runs` reads, on the card, how many branch and loop
decisions the condition kernel took.  A traced driver call
(``core.spans``) sees a capture as its ``repro.graph.capture`` span and a
replay as ``repro.graph.copy_in``, ``repro.graph.launch`` (with the eager
stamp just before the launch) and ``repro.graph.copy_out``;
:func:`stamp` launches the span stamp kernel.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time
import warnings

import torch
from torch.utils import _pytree as pytree

from . import spans

#: programs captured, and the seconds their captures took
captures = 0
capture_seconds = 0.0
#: programs :func:`run` keeps cached per graph (least recently used out)
MAX_PROGRAMS = 16

_P = ctypes.c_void_p
_IF, _WHILE = 0, 1
_REC = None                 # the recorder capturing now, if any


@functools.cache
def _lib():
    from repro_torch.kernels import build
    lib = build.load("graph_loop")
    pp = ctypes.POINTER(ctypes.c_void_p)
    for name, args in (
            ("gl_graph_create", [pp]),
            ("gl_graph_destroy", [_P]),
            ("gl_graph_nodes", [_P, ctypes.POINTER(ctypes.c_longlong)]),
            ("gl_add_child", [_P, _P, _P, pp]),
            ("gl_add_conditional", [_P, _P, ctypes.c_int, _P, ctypes.c_int,
                                    pp, pp,
                                    ctypes.POINTER(ctypes.c_ulonglong)]),
            ("gl_add_set", [_P, _P, ctypes.c_ulonglong, _P, pp]),
            ("gl_instantiate", [_P, pp]),
            ("gl_launch", [_P, _P]),
            ("gl_exec_destroy", [_P]),
            ("gl_set_runs", [ctypes.POINTER(ctypes.c_ulonglong),
                             ctypes.c_int]),
            ("gl_stamp", [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                          ctypes.c_int, _P, pp, ctypes.c_int, _P])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _ok(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"graph_loop: {what} failed with CUDA error "
                           f"{err} (conditional graph nodes need CUDA "
                           f"12.4 or later)")


def _call(name: str, *args) -> None:
    """Call ``gl_<name>`` of ``csrc/graph_loop.cu``, raising on a CUDA
    error; out-parameters come back through the ctypes objects given."""
    _ok(name, getattr(_lib(), f"gl_{name}")(*args))


def set_runs(reset: bool = False) -> int:
    """Runs of the condition kernel on the card since the last reset:
    one per branch or loop decision a replay took (reads the card)."""
    n = ctypes.c_ulonglong(0)
    _call("set_runs", ctypes.byref(n), int(reset))
    return n.value


def stamp(ring: int, cap: int, points: int, row: int, r, col: int, flag,
          counts, ncounts: int, stream: int) -> None:
    """Launch ``span_stamp`` on ``stream`` (recorded, while a program is
    captured): ``%globaltimer`` and the int32 ``counts`` (an array of
    ``ncounts`` device addresses) into column ``col`` of row ``row + *r
    % cap`` (``r`` a device int32's address) or of ``row`` (``r`` None)
    of the int64 ring at address ``ring``; it returns at once while the
    int32 at ``flag`` is 0 (``flag`` None: always writes).
    ``core.spans`` owns the ring and its layout."""
    _call("stamp", ring, cap, points, row, r, col, flag, counts, ncounts,
          stream)


# ---------------------------------------------------------------------------
# the two primitives
# ---------------------------------------------------------------------------

def _recorder(what: str) -> "_Recorder":
    if _REC is None:
        raise RuntimeError(
            f"graph_loop.{what} on CUDA tensors runs only inside a "
            f"captured program (graph_loop.run): it never reads a device "
            f"value on the host")
    return _REC


def cond(pred: torch.Tensor, true_fn, false_fn):
    """``lax.cond``: the outputs of ``true_fn()`` when the one-element
    bool ``pred`` holds, else of ``false_fn()``.  Both branches return
    the same structure of tensors (shapes and dtypes); neither takes
    arguments (they close over what they read)."""
    if pred.device.type == "cpu":
        return true_fn() if bool(pred) else false_fn()
    return _recorder("cond").cond(pred, true_fn, false_fn)


def while_(cond_fn, body_fn, carry):
    """``lax.while_loop``: ``carry = body_fn(*carry)`` while
    ``cond_fn(*carry)`` (a one-element bool) holds; returns the final
    carry, a tuple of tensors of fixed shapes and dtypes.  The loop runs
    on its own copy of the carry given, which is not written: the body
    may write its carry in place and return it, and a leaf it returns in
    the same memory is not copied on the card."""
    carry = tuple(carry)
    if carry[0].device.type == "cpu":
        carry = _own(carry)
        while bool(cond_fn(*carry)):
            carry = tuple(body_fn(*carry))
        return carry
    return _recorder("while_").while_(cond_fn, body_fn, carry)


def _own(carry) -> tuple:
    """The loop's own copy of a carry, contiguous (a body may hand its
    leaves to a kernel that takes contiguous tensors)."""
    return tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in carry)


def repeat(fn, x: torch.Tensor, start: int, count):
    """``x = fn(x, i)`` for ``i`` in ``start .. start + count - 1``: a
    Python loop for a host int ``count``; a :func:`while_` for a
    one-element int32 tensor ``count``, with ``i`` a 0-dim int32 tensor.
    Returns ``x``."""
    if not isinstance(count, torch.Tensor):
        for i in range(start, start + count):
            x = fn(x, i)
        return x
    i0 = torch.full((), start, dtype=torch.int32, device=count.device)
    end = i0 + count.reshape(())
    return while_(lambda i, y: i < end, lambda i, y: (i + 1, fn(y, i)),
                  (i0, x))[1]


# ---------------------------------------------------------------------------
# recording (CUDA)
# ---------------------------------------------------------------------------

class _Frame:
    """One graph being built (the program's, or a conditional node's
    body) and the last node appended to it: each node depends on the
    one before."""
    __slots__ = ("graph", "tail")

    def __init__(self, graph):
        self.graph = graph
        self.tail = None


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class _Recorder:
    """Records a function of CUDA tensors into one graph: torch's
    captures for the pieces, ``graph_loop.cu`` for the nodes."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.keep = []          # captured pieces and the flags nodes read
        graph = ctypes.c_void_p()
        _call("graph_create", ctypes.byref(graph))
        self.root = _Frame(graph)
        self.frames = [self.root]
        self.piece = None

    def begin(self) -> None:
        self.piece = torch.cuda.CUDAGraph(keep_graph=True)
        self.piece.capture_begin(pool=self.pool,
                                 capture_error_mode="relaxed")

    def end(self, frame: _Frame = None) -> None:
        """End the piece being captured and append it to ``frame`` (the
        innermost open one by default)."""
        piece, self.piece = self.piece, None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # an empty piece warns
            piece.capture_end()
        self.keep.append(piece)
        raw = ctypes.c_void_p(piece.raw_cuda_graph())
        n = ctypes.c_longlong(0)
        _call("graph_nodes", raw, ctypes.byref(n))
        if n.value == 0:
            return
        frame = frame or self.frames[-1]
        node = ctypes.c_void_p()
        _call("add_child", frame.graph, frame.tail, raw, ctypes.byref(node))
        frame.tail = node

    def _conditional(self, kind: int, flag: torch.Tensor, negate: int):
        """Append a conditional node over ``flag`` to the innermost frame;
        returns its body's frame and its handle."""
        parent = self.frames[-1]
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        handle = ctypes.c_ulonglong(0)
        _call("add_conditional", parent.graph, parent.tail, kind,
              flag.data_ptr(), negate, ctypes.byref(node),
              ctypes.byref(body), ctypes.byref(handle))
        parent.tail = node
        return _Frame(body), handle

    def _flag(self, t: torch.Tensor) -> torch.Tensor:
        """A private bool the conditional nodes read (captured)."""
        if t.numel() != 1:
            raise ValueError(f"graph_loop: a condition is one element, "
                             f"got shape {tuple(t.shape)}")
        flag = t.reshape(()).to(torch.bool).clone()
        self.keep.append(flag)
        return flag

    def _inside(self, frame: _Frame, fn):
        self.frames.append(frame)
        self.begin()
        out = fn()
        self.end()
        self.frames.pop()
        return out

    def cond(self, pred, true_fn, false_fn):
        flag = self._flag(pred)
        self.end()
        frames, outs = [], []
        for fn, negate in ((true_fn, 0), (false_fn, 1)):
            frame, _ = self._conditional(_IF, flag, negate)
            outs.append(self._inside(frame, fn))
            frames.append(frame)
        t_leaves, spec = pytree.tree_flatten(outs[0])
        f_leaves, f_spec = pytree.tree_flatten(outs[1])
        if spec != f_spec or any(a.shape != b.shape or a.dtype != b.dtype
                                 for a, b in zip(t_leaves, f_leaves)):
            raise ValueError("graph_loop.cond: the branches return "
                             "different structures, shapes or dtypes")
        # a leaf both branches return in the same memory passes through;
        # any other gets one buffer that each branch copies into
        merge = [i for i, (a, b) in enumerate(zip(t_leaves, f_leaves))
                 if not _same(a, b)]
        if merge:
            res = {}
            for frame, leaves in zip(frames, (t_leaves, f_leaves)):
                self.begin()
                for i in merge:
                    if i not in res:
                        res[i] = torch.empty_like(leaves[i])
                    res[i].copy_(leaves[i])
                self.end(frame)
            t_leaves = [res.get(i, a) for i, a in enumerate(t_leaves)]
        self.begin()
        return pytree.tree_unflatten(t_leaves, spec)

    def while_(self, cond_fn, body_fn, carry):
        bufs = _own(carry)
        flag = self._flag(cond_fn(*bufs))
        self.end()
        frame, handle = self._conditional(_WHILE, flag, 0)

        def body():
            outs = tuple(body_fn(*bufs))
            if len(outs) != len(bufs) or any(
                    o.shape != b.shape or o.dtype != b.dtype
                    for o, b in zip(outs, bufs)):
                raise ValueError("graph_loop.while_: the body changes the "
                                 "carry's structure, shapes or dtypes")
            for b, o in zip(bufs, outs):
                if not _same(b, o):
                    b.copy_(o)
            flag.copy_(cond_fn(*bufs).reshape(()))

        self._inside(frame, body)
        node = ctypes.c_void_p()
        _call("add_set", frame.graph, frame.tail, handle,
              flag.data_ptr(), ctypes.byref(node))
        frame.tail = node
        self.begin()
        return bufs


class Program:
    """A function of CUDA tensors, captured once as one CUDA graph with
    conditional nodes and replayed on the current stream.  ``fn`` takes
    the input tensors and returns a structure of tensors (a tensor, a
    tuple, a NamedTuple); it may call :func:`cond` and :func:`while_`.
    ``keep`` holds what the graph reads besides its inputs and its own
    pool (the tensors ``fn`` closes over, but for its owner's)."""

    def __init__(self, fn, inputs, keep: tuple):
        with spans.span("repro.graph.capture"):
            self._capture(fn, inputs, keep)

    def _capture(self, fn, inputs, keep: tuple) -> None:
        global _REC, captures, capture_seconds
        from repro_torch.kernels import build
        if _REC is not None:
            raise RuntimeError("graph_loop: a program cannot be captured "
                               "inside another")
        build.load_all()          # no nvcc or library load while capturing
        self._gl = _lib()         # close() needs no module global
        t0 = time.perf_counter()
        dev = inputs[0].device
        self.inputs = tuple(x.clone(memory_format=torch.contiguous_format)
                            for x in inputs)
        rec = _Recorder()
        _REC = rec
        try:
            with torch.cuda.device(dev), torch.cuda.stream(
                    torch.cuda.Stream(dev)):
                try:
                    rec.begin()
                    out = fn(*self.inputs)
                    rec.end()
                except BaseException:
                    # close the failed capture on its own stream, and let
                    # the error that failed it propagate, not this one's
                    if rec.piece is not None:
                        with warnings.catch_warnings(), \
                                contextlib.suppress(RuntimeError):
                            warnings.simplefilter("ignore")
                            rec.piece.capture_end()
                    raise
        finally:
            _REC = None
        self.leaves, self.spec = pytree.tree_flatten(out)
        # what the graph reads: the captured pieces' pool, their flags,
        # and ``keep``
        self._keep = (rec.keep, keep)
        self._graph = rec.root.graph
        self._exec = ctypes.c_void_p()
        _call("instantiate", self._graph, ctypes.byref(self._exec))
        captures += 1
        capture_seconds += time.perf_counter() - t0

    def __call__(self, *inputs):
        with spans.span("repro.graph.copy_in"):
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
        dev = self.inputs[0].device
        stream = torch.cuda.current_stream(dev)
        with spans.span("repro.graph.launch"):
            spans.before_launch(dev)
            _call("launch", self._exec, ctypes.c_void_p(stream.cuda_stream))
        with spans.span("repro.graph.copy_out"):
            return pytree.tree_unflatten([t.clone() for t in self.leaves],
                                         self.spec)

    def close(self) -> None:
        """Free the program: its executable graph (freed by the driver
        once a launch still in flight ends), its graph, and the captured
        pieces, buffers and outputs that hold its memory pool.  The
        program cannot run again.  It reads no module global, so a
        program that outlives this module at interpreter exit closes
        too."""
        exe, graph = getattr(self, "_exec", None), getattr(self, "_graph",
                                                           None)
        lib = getattr(self, "_gl", None)
        self._exec = self._graph = None
        if lib is not None:
            if exe:
                lib.gl_exec_destroy(exe)
            if graph:
                lib.gl_graph_destroy(graph)
        self._keep = self.leaves = self.inputs = None

    def __del__(self):
        self.close()


def _free_vars(fn, owner) -> tuple:
    """What ``fn`` closes over, less ``owner``: what a program cached on
    ``owner`` keeps alive besides its pool.  The owner holds the program,
    so the program must not hold the owner: that cycle would keep a
    superseded graph, and its programs' pools, on the card until Python's
    cyclic collector happens to run.  ``fn`` must not reach the owner
    through anything else it closes over."""
    out = []
    for cell in fn.__closure__ or ():
        try:
            val = cell.cell_contents
        except ValueError:          # an empty cell
            continue
        if val is not owner:
            out.append(val)
    return tuple(out)


def release(owner) -> int:
    """Close every program cached on ``owner`` (their pools go back to
    torch's allocator) and return how many there were; the next
    :func:`run` on ``owner`` captures anew."""
    cache = owner.__dict__.pop("_programs", None) or {}
    for prog in cache.values():
        prog.close()
    return len(cache)


def run(owner, key, fn, *inputs):
    """``fn(*inputs)``: eagerly for CPU tensors; for CUDA tensors through
    the :class:`Program` cached on ``owner`` (a ``Graph``, whose topology
    the program reads) under ``key`` plus the inputs' shapes and dtypes,
    captured on first use.  Before a capture, the programs of an older
    ``owner.version`` are closed, and so is the least recently used one
    while ``MAX_PROGRAMS`` are cached.  A program keeps what ``fn``
    closes over except ``owner`` (:func:`_free_vars`), so a graph that
    is let go frees its programs at once, by reference counting."""
    if inputs[0].device.type == "cpu":
        return fn(*inputs)
    cache = owner.__dict__.get("_programs")
    if cache is None:
        cache = collections.OrderedDict()
        object.__setattr__(owner, "_programs", cache)
    full = (owner.version, key,
            tuple((tuple(x.shape), x.dtype) for x in inputs))
    prog = cache.get(full)
    if prog is None:
        for stale in [k for k in cache if k[0] != owner.version]:
            cache.pop(stale).close()
        while len(cache) >= MAX_PROGRAMS:
            cache.popitem(last=False)[1].close()
        prog = cache[full] = Program(fn, inputs,
                                     keep=_free_vars(fn, owner))
    else:
        cache.move_to_end(full)
    return prog(*inputs)
