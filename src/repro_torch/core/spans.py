"""Spans of the port's traversals: host ranges and device stamps, kept in
memory on one clock.

A driver call is *traced* exactly while a ``torch.profiler`` is
recording: :func:`traced` asks ``torch.autograd._profiler_enabled()``
once, on entry.  A traced call opens a :class:`Traversal` record; an
untraced one records nothing and costs one such check.

* **Host spans** are ``torch.profiler.record_function`` ranges
  (:func:`span`), so they land in the profiler's own trace; each is also
  kept in the record as ``(name, start_ns, end_ns, parent)``.  Their
  clock is ``time.time_ns()``, the profiler's host clock.
* **Device stamps** are written by one tiny kernel
  (``kernels/csrc/graph_loop.cu`` ``span_stamp``, one thread) into a
  ring of ``RING_ROUNDS`` round rows per device, row ``1 + r %
  RING_ROUNDS`` for round ``r``, which the kernel reads from the fused
  loop's carry on the device, so a captured graph's fixed arguments land
  in the right row.  Each point of a round (:data:`START`, :data:`LIST`,
  :data:`LISTED`, each bin's end ``BIN + i``, :data:`LB`) is a column:
  ``%globaltimer`` and up to :data:`COUNTS` int32 device counts the round
  already has.  Row 0 holds the traversal's points: the eager
  stamp before the graph launch (:data:`LAUNCH`), the loop's start and
  end.  The stamps are captured always, in the one cached program, and
  gated by a device flag that :func:`arm` writes only when it changes:
  off, the kernel returns at once.  On CPU tensors (eager rounds) a stamp
  reads the host clock.
* **One clock**: a traced loop's device times are mapped onto the host
  clock by an offset calibrated right after it, once the driver has
  synchronised (host time, stamp, sync, host time; the tighter of
  :data:`TRIES`): the card's timer drifts against the host clock (about
  2 µs a second on an H100), so an offset taken once would not hold.

:func:`fetch` reads the rows a traced fused traversal wrote once it has
ended (one transfer, after the driver's sync) and decodes them into the
record: per round, each phase's ``(start_ns, end_ns)`` and its counts.
Phases of a round, in order: ``inspect`` (round start to the listing:
the direction rule, and where no census is carried the union frontier,
``n_f``, ``m_f`` and the round's labels copy), ``list`` (the bin
listing), ``bin.<name>`` (each bin's pass), ``lb`` (the LB pass) and
``turn`` (to the next round's start, or the loop's end: the frontier
update, in the fused min loop with the next round's census, the loop
condition and the WHILE turn).  A round that outruns the ring overwrites the oldest row; the
record counts the rounds lost (``overflow``).

:func:`records` returns the last :data:`KEEP` traversal records of this
process: the port's only span store.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import itertools
import time
from typing import Optional

import numpy as np
import torch

#: round rows of the device ring (older rounds are overwritten, counted)
RING_ROUNDS = 1024
#: traversal records kept, the most recent last
KEEP = 64
#: int32 device counts a stamp carries
COUNTS = 5

# a round's points (ring columns), in the order a round reaches them;
# bin i of the plan (at most 3) ends at BIN + i
START, LIST, LISTED, BIN, LB = 0, 1, 2, 3, 6
POINTS = 7
# the traversal row's points; the clock's marks take CALIBRATE ..
# CALIBRATE + TRIES - 1
LAUNCH, LOOP_START, LOOP_END, CALIBRATE = 0, 1, 2, 3
TRIES = 2

_RECORDS: collections.deque = collections.deque(maxlen=KEEP)
_IDS = itertools.count(1)
_CURRENT: Optional["Traversal"] = None     # the traced call open now
_ROUND = None                              # (ring, r) of the round stamped
_RINGS: dict = {}                          # device -> _Ring; never freed


@dataclasses.dataclass
class Round:
    """One round's phases ``{name: (start_ns, end_ns)}`` in order, and
    its counts (``n_f``, ``m_f``, ``members.<bin>``, ``lb_edges``)."""
    index: int
    phases: dict
    counts: dict


@dataclasses.dataclass
class Traversal:
    """One traced driver call.  Times are ``time.time_ns()`` values (the
    profiler's host clock); device stamps are mapped onto it."""
    id: int
    app: str
    host: list = dataclasses.field(default_factory=list)
    loop: Optional[tuple] = None       # (start_ns, end_ns) on the device
    launch_ns: Optional[int] = None    # eager stamp before the launch
    rounds: list = dataclasses.field(default_factory=list)
    total_rounds: int = 0              # the traversal's rounds
    overflow: int = 0                  # of them, lost to the ring
    bins: tuple = ()                   # the plan's bin names, "lb" last
    _stack: list = dataclasses.field(default_factory=list, repr=False)
    _ring: object = dataclasses.field(default=None, repr=False)

    def host_span(self, name: str) -> Optional[tuple]:
        """The first host span called ``name``, or None."""
        return next((h for h in self.host if h[0] == name), None)


def records() -> list:
    """The traversal records kept, oldest first."""
    return list(_RECORDS)


def traced(app: str):
    """Decorate a driver returning an ``AppResult``.  A call made while a
    profiler records is traced: it opens a :class:`Traversal`, inside its
    ``repro.<app>`` host span, keeps it in :func:`records` and returns it
    as the result's ``spans``.  A call inside a traced one adds its spans
    to the outer record."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            global _CURRENT
            if _CURRENT is not None or \
                    not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            rec = _CURRENT = Traversal(next(_IDS), app)
            try:
                with span(f"repro.{app}"):
                    res = fn(*args, **kwargs)
            finally:
                _CURRENT = None
                rec._stack, rec._ring = [], None
                _RECORDS.append(rec)
            res.spans = rec
            return res
        return call
    return wrap


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _CURRENT
        rec._stack.append(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(*exc)
        rec = _CURRENT
        rec._stack.pop()
        rec.host.append((self.name, self.t0, t1,
                         rec._stack[-1] if rec._stack else None))
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """A host span of the traced call open now (a ``record_function``
    range, kept in its record); nothing when none is open."""
    return _NULL if _CURRENT is None else _Span(name)


# ---------------------------------------------------------------------------
# device stamps
# ---------------------------------------------------------------------------

class _Ring:
    """A device's stamp rows: int64 ``[1 + RING_ROUNDS, POINTS, 1 +
    COUNTS]`` (a time, then counts; row 0 the traversal's, then the
    rounds') and its int32 flag."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cap = RING_ROUNDS
        self.buf = torch.zeros((1 + self.cap, POINTS, 1 + COUNTS),
                               dtype=torch.int64, device=device)
        self.flag = torch.zeros((), dtype=torch.int32, device=device)
        self.on = False


def _mark_clock(ring: _Ring) -> list:
    """Stamp the card's clock :data:`TRIES` times into the traversal
    row, each between two host times and followed by a sync (the card
    idle: the driver has synchronised); returns the host intervals."""
    marks = []
    for i in range(TRIES):
        h0 = time.time_ns()
        _write(ring, 0, None, CALIBRATE + i, (), gate=False)
        torch.cuda.synchronize(ring.device)  # repro: allow[host-sync] -- traced calls only: the clock's marks after the loop, moving no value
        marks.append((h0, time.time_ns()))
    return marks


def _count_ptrs(counts) -> list:
    """The int32 device counts' addresses (a tensor of several elements
    gives each; None gives none)."""
    out = []
    for c in counts:
        if c is None:
            continue
        if c.dtype != torch.int32 or not c.is_contiguous():
            raise TypeError(f"spans: a stamped count is a contiguous int32, "
                            f"got {c.dtype} {tuple(c.shape)}")
        out += [c.data_ptr() + 4 * i for i in range(c.numel())]
    if len(out) > COUNTS:
        raise ValueError(f"spans: at most {COUNTS} counts a stamp")
    return out


def _write(ring: _Ring, row: int, r, col: int, counts, gate=True) -> None:
    """Stamp column ``col`` of row ``row + r % cap`` (``r`` a device
    int32: a round's, ``row`` 1) or of ``row`` (``r`` None: the
    traversal's, ``row`` 0): on the card one ``span_stamp`` launch on the
    current stream, which returns at once while the flag is off
    (``gate``); on CPU tensors the host clock."""
    if ring.device.type == "cpu":
        if gate and not bool(ring.flag):
            return
        at = row + (int(r) % ring.cap if r is not None else 0)
        ring.buf[at, col, 0] = time.time_ns()
        vals = [int(x) for c in counts if c is not None
                for x in c.reshape(-1).tolist()]
        ring.buf[at, col, 1:1 + len(vals)] = torch.tensor(vals,
                                                           dtype=torch.int64)
        return
    from . import graph_loop
    ptrs = _count_ptrs(counts)
    arr = (ctypes.c_void_p * COUNTS)(*ptrs)
    graph_loop.stamp(ring.buf.data_ptr(), ring.cap, POINTS, row,
                     None if r is None else r.data_ptr(), col,
                     ring.flag.data_ptr() if gate else None, arr, len(ptrs),
                     torch.cuda.current_stream(ring.device).cuda_stream)


def arm(device: torch.device, bins: tuple) -> None:
    """Before a stamped loop's dispatch (never while a program is being
    captured): make the device's ring on first use, and set its flag to
    whether a traced call is open (written only when it changes).  A
    traced call's ring is cleared, so its rows are this loop's alone.
    ``bins``: the plan's bin names, ``"lb"`` last where it has one."""
    ring = _RINGS.get(device)
    if ring is None:
        ring = _RINGS[device] = _Ring(device)
    on = _CURRENT is not None
    if on != ring.on:
        ring.flag.fill_(int(on))
        ring.on = on
    if on:
        ring.buf.zero_()
        _CURRENT._ring, _CURRENT.bins = ring, tuple(bins)


@contextlib.contextmanager
def round_(r: torch.Tensor):
    """The body of a stamped loop's round ``r`` (the carry's device
    int32): stamps its :data:`START`, and lets :func:`stamp` place the
    round's other points in row ``r``."""
    global _ROUND
    ring = _RINGS.get(r.device)
    if ring is None:
        yield
        return
    prev, _ROUND = _ROUND, (ring, r)
    _write(ring, 1, r, START, ())
    try:
        yield
    finally:
        _ROUND = prev


def stamp(col: int, *counts) -> None:
    """Stamp point ``col`` of the round being stamped, with ``counts``
    (int32 device tensors, or None); nothing outside a stamped round."""
    if _ROUND is not None:
        ring, r = _ROUND
        _write(ring, 1, r, col, counts)


def stamp_loop(col: int, t: torch.Tensor, count=None) -> None:
    """Stamp the traversal row's point ``col`` (:data:`LOOP_START`,
    :data:`LOOP_END`) on ``t``'s device, with an optional count."""
    ring = _RINGS.get(t.device)
    if ring is not None:
        _write(ring, 0, None, col, (count,))


def before_launch(device: torch.device) -> None:
    """The eager stamp just before a traced call's graph launch
    (:data:`LAUNCH`): an ordinary kernel in the profiler's trace, whose
    time there checks the clock mapping."""
    ring = _RINGS.get(device)
    if _CURRENT is not None and ring is not None and ring.on:
        _write(ring, 0, None, LAUNCH, ())


def fetch(device: torch.device, rounds: int) -> None:
    """After a traced stamped loop of ``rounds`` rounds has ended (the
    caller has synchronised): read the rows it wrote in one transfer
    and decode them into the open record.  Nothing for an untraced
    call."""
    rec = _CURRENT
    if rec is None or rec._ring is None or rec._ring.device != device:
        return
    ring = rec._ring
    kept = min(rounds, ring.cap)
    first = rounds - kept
    # row 0, then the rounds' rows: a traversal that did not wrap wrote
    # only the first 1 + rounds
    n = 1 + (rounds if rounds <= ring.cap else ring.cap)
    marks = _mark_clock(ring) if ring.device.type == "cuda" else []
    rows = ring.buf[:n].cpu().numpy()  # repro: allow[host-sync] -- traced calls only: the stamp rows, once a traversal, after the driver's sync
    rows = rows[[0] + [1 + k % ring.cap for k in range(first, rounds)]]
    offset = 0              # device ns less host ns (CPU stamps: host)
    if marks:
        i = min(range(TRIES), key=lambda j: marks[j][1] - marks[j][0])
        offset = int(rows[0, CALIBRATE + i, 0]) - sum(marks[i]) // 2
    times = np.where(rows[..., 0] != 0, rows[..., 0] - offset, 0)
    times, counts = times.tolist(), rows[..., 1:].tolist()
    head, times, counts = times[0], times[1:], counts[1:]
    rec.launch_ns = head[LAUNCH] or None
    if head[LOOP_START] and head[LOOP_END]:
        rec.loop = (head[LOOP_START], head[LOOP_END])
    rec.total_rounds, rec.overflow = rounds, first
    names = {LIST: "inspect", LISTED: "list", LB: "lb"}
    degree_bins = [b for b in rec.bins if b != "lb"]
    names.update({BIN + i: f"bin.{b}" for i, b in enumerate(degree_bins)})
    for j in range(kept):
        t, c = times[j], counts[j]
        phases, prev = {}, None
        for col in range(POINTS):
            if not t[col]:
                continue
            if prev is not None:
                phases[names[col]] = (t[prev], t[col])
            prev = col
        # the next round's start; the newest round's turn ends the loop
        nxt = times[j + 1][START] if j + 1 < kept else head[LOOP_END]
        if prev is not None and nxt:
            phases["turn"] = (t[prev], nxt)
        got = {}
        if t[LIST]:
            got["n_f"], got["m_f"] = c[LIST][0], c[LIST][1]
        if t[LISTED]:
            got.update({f"members.{b}": c[LISTED][i]
                        for i, b in enumerate(rec.bins)})
        if t[LB]:
            got["lb_edges"] = c[LB][0]
        rec.rounds.append(Round(first + j, phases, got))
