"""Spans and counters at the port's layer boundaries, kept in memory.

Off by default: while off, a span or a count tests one module-level flag
and returns; nothing is recorded and no ``record_function`` is opened.
``enable()`` / ``disable()`` switch recording for the whole process.

    with telemetry.span("kf_path", frame=fid): ...   # a span, its frame named
    @telemetry.span("ba")                              # a span around each call
    telemetry.count("ba.trials")                       # a counter of the frame

A span records its name, its start and end (``time.perf_counter_ns()``),
its number and its parent's (the span open below it on the same thread,
-1 at a root) and the thread. It belongs to the frame its ``frame``
argument names, else to its parent's frame: ``FullSystem.add_frame`` names
the frame it adds, the keyframe path names the keyframe's frame, so a
mapping thread's spans join the frame they build. Counters add up per
frame the same way. Records are kept per frame, oldest first, in a ring of
``RING_FRAMES``; a frame pushed out of the ring is counted in ``dropped``.

One clock with the device trace: ``to_unix_ns`` converts a stamp to the
Unix clock, which ``torch.profiler`` (kineto) uses for its host and device
events; and while a profiler runs, every span also opens a
``record_function`` of its own name, so a trace shows the program's spans
on the kernels' timeline.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

RING_FRAMES = 1 << 16

_on = False


class Span(NamedTuple):
    name: str
    start_ns: int         # time.perf_counter_ns()
    end_ns: int
    seq: int              # this span's number, unique in the process
    parent: int           # the enclosing span's number on its thread, -1 at a root
    thread: int           # threading.get_ident()


class Frame:
    """What was recorded under one frame id: spans in the order they
    ended, counters by name."""

    __slots__ = ("id", "spans", "counts")

    def __init__(self, fid):
        self.id = fid
        self.spans: list = []
        self.counts: dict = {}


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.ring: dict = {}          # frame id -> Frame, oldest first
        self.dropped = 0
        self.offset_ns = 0            # Unix clock minus perf_counter at enable()
        self.seq = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def frame(self, fid) -> Frame:
        """The record of frame ``fid`` (under ``lock``), pushing the oldest
        out of a full ring."""
        f = self.ring.get(fid)
        if f is None:
            if len(self.ring) >= RING_FRAMES:
                del self.ring[next(iter(self.ring))]
                self.dropped += 1
            f = self.ring[fid] = Frame(fid)
        return f


_rec = _Recorder()


class span:
    """A span of ``name`` (see the module docstring), as a context manager
    or as a decorator of a function (one span a call)."""

    __slots__ = ("name", "fid", "_open")

    def __init__(self, name: str, frame: Optional[int] = None):
        self.name, self.fid, self._open = name, frame, None

    def __enter__(self):
        if _on:
            st = _rec.stack()
            parent = st[-1] if st else None
            fid = self.fid if self.fid is not None else (parent[2] if parent else None)
            rf = None
            if torch._C._autograd._profiler_enabled():
                rf = torch.profiler.record_function(self.name)
                rf.__enter__()
            entry = (next(_rec.seq), parent[0] if parent else -1, fid, rf, self.name,
                     time.perf_counter_ns())
            st.append(entry)
            self._open = entry
        return self

    def __exit__(self, *exc):
        entry, self._open = self._open, None
        if entry is None:
            return False
        t1 = time.perf_counter_ns()
        seq, parent, fid, rf, _, t0 = entry
        st = _rec.stack()
        if st and st[-1] is entry:
            st.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        rec = Span(self.name, t0, t1, seq, parent, threading.get_ident())
        with _rec.lock:
            _rec.frame(fid).spans.append(rec)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kw):
            if not _on:
                return fn(*args, **kw)
            with span(name):
                return fn(*args, **kw)
        return spanned


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the current frame (the frame of
    the innermost span open on this thread)."""
    if not _on:
        return
    st = _rec.stack()
    fid = st[-1][2] if st else None
    with _rec.lock:
        c = _rec.frame(fid).counts
        c[name] = c.get(name, 0) + n


def enable():
    """Record from now on, in every thread; fixes the offset of the span
    clock to the Unix clock (the least of a few paired reads)."""
    global _on
    pairs = []
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        pairs.append((b - a, u - (a + b) // 2))
    _rec.offset_ns = min(pairs)[1]
    _on = True


def disable():
    """Stop recording; what was recorded stays readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Forget every recorded frame and the dropped count."""
    with _rec.lock:
        _rec.ring.clear()
        _rec.dropped = 0


def frames() -> tuple:
    """(frames, dropped): the recorded frames oldest first (a new list of
    the ring's live records; spans outside any frame are under frame id
    None) and the number of frames pushed out of the ring."""
    with _rec.lock:
        return list(_rec.ring.values()), _rec.dropped


def open_spans() -> tuple:
    """The names of the spans open on this thread, outermost first."""
    return tuple(e[4] for e in _rec.stack())


def totals(frames_) -> dict:
    """{name: [spans, total ns, self ns]} over ``frames_``: a span's self
    time is its duration less its children's (the spans recorded with it
    as their parent, in these frames)."""
    out: dict = {}
    child_ns: dict = {}
    for f in frames_:
        for s in f.spans:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
    for f in frames_:
        for s in f.spans:
            t = out.setdefault(s.name, [0, 0, 0])
            d = s.end_ns - s.start_ns
            t[0] += 1
            t[1] += d
            t[2] += d - child_ns.get(s.seq, 0)
    return out


def to_unix_ns(t_ns: int) -> int:
    """A span stamp on the Unix clock (the profiler's)."""
    return t_ns + _rec.offset_ns
