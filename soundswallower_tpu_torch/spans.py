"""Spans and counters of the port's host stages, recorded only while a
``Recorder`` is installed.

Off (the default), ``span(name)`` hands back one shared no-op context
and ``count`` returns at once: they allocate nothing, never wait for the
device and change nothing the program launches.  ``install(Recorder())``
turns them on for the whole process until ``uninstall()``:

* each span appends one ``Span`` to the recorder: its name, ``t0`` and
  ``t1`` from ``time.perf_counter`` (the host clock; a launch's span
  times its enqueue, the device side of the same work is a device
  trace's), its parent (the innermost span its thread had open), its
  thread and its request;
* each ``count(name, n)`` adds ``n`` to the counter ``name``;
  ``high(name, n)`` raises it to ``n`` where ``n`` is larger (a
  high-water mark).

A request is one call of an entry point (``request()``: a new id for
the calling thread while it is open; ``resume(i)`` takes request ``i``
up again, as ``align_batch_end`` takes up its ``align_batch_begin``'s).
``task(name, fn)`` carries the submitting thread's request to a worker:
``fn`` runs under a span ``name`` of that request.

The records stay in memory; ``Recorder``'s readers take them out when
the recording ends.  The port's spans (``aligner.py``,
``parallel/seqpipe.py``):

* ``batch.begin`` (``align_batch_begin``): ``graphs``, ``union``,
  ``stack`` or ``consts``, ``pack``, ``fe.wait`` and ``fe.device`` (per
  upload chunk), ``score``, ``gather``, ``viterbi``, ``download``;
* ``batch.end`` (``align_batch_end``): ``wait``, ``extract``, ``segs``;
* ``longform`` (``align_longform_batch``): ``pack`` (the host front
  end submitted there), ``graphs``, ``consts``, ``fe.wait``,
  ``fe.device``, ``score``, ``viterbi``, ``backtrace``, ``wait``,
  ``extract``;
* ``fe.host`` on the host front end's worker thread, a call each.

Counters: ``frames.scored`` (rows times the frame axis of every chunk
the scorer is launched on, pad rows and frames included) and
``frames.real`` (the real rows' frames of every shaped batch); of the
fully continuous scorer (``ops/senscore_torch.py``), ``ms.blocks`` (its
frame blocks, a K11 and a K12 call each, summed over the ``score``
spans), ``ms.block_frames`` (the largest block, a high-water mark) and
``ms_dist_topn.forms[<form>]`` (K11's launches by form: "frame top-N",
"registers 13", "runtime L"); of the long form on the host front end,
``longform.fe_early`` (calls whose front end was submitted before
``graphs``) and ``longform.fe_ready`` (calls whose front end had
finished when ``consts`` ended).
"""

from __future__ import annotations

import bisect
import itertools
import statistics
import threading
import time

_rec: "Recorder | None" = None
_local = threading.local()      # .stack: open Spans; .req: request id


class _Off:
    """The no-op context every ``span`` and ``request`` hands back while
    nothing is installed."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One span: ``name``, ``t0``, ``t1`` (None while open), ``parent``
    (a Span or None), ``thread`` (its ident), ``req`` (its request id or
    None)."""

    __slots__ = ("rec", "name", "t0", "t1", "parent", "thread", "req")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name
        self.t0 = self.t1 = self.parent = None

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.thread = threading.get_ident()
        self.req = getattr(_local, "req", None)
        self.rec.spans.append(self)
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        _stack().pop()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Request:
    __slots__ = ("req", "prev")

    def __init__(self, req: int):
        self.req = req

    def __enter__(self) -> int:
        self.prev = getattr(_local, "req", None)
        _local.req = self.req
        return self.req

    def __exit__(self, *exc):
        _local.req = self.prev
        return False


class Recorder:
    """The spans (``spans``, in the order they opened) and counters
    (``counts``) recorded while installed, with their readers."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + int(n)

    def top(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = max(self.counts.get(name, int(n)), int(n))

    def new_request(self) -> int:
        with self._lock:
            return next(self._ids)

    # -- readers ------------------------------------------------------------

    def closed(self, name: str | None = None) -> list[Span]:
        """The closed spans (of ``name``)."""
        return [s for s in self.spans if s.t1 is not None
                and (name is None or s.name == name)]

    def per_request(self, *names: str) -> list[float]:
        """Per request, the seconds of its closed spans of ``names``
        summed, in the order of the requests' first such span (spans
        of no request left out)."""
        out: dict[int, float] = {}
        for s in self.spans:
            if s.t1 is not None and s.req is not None and s.name in names:
                out[s.req] = out.get(s.req, 0.0) + s.seconds
        return list(out.values())

    def median_ms(self, *names: str):
        """The median over requests of ``per_request(*names)`` in ms;
        None where no request has one."""
        d = self.per_request(*names)
        return statistics.median(d) * 1e3 if d else None

    def share_padded(self):
        """100 x (1 - frames.real / frames.scored); None where nothing
        was scored."""
        scored = self.counts.get("frames.scored", 0)
        if scored <= 0:
            return None
        return 100.0 * (1.0 - self.counts.get("frames.real", 0) / scored)

    def labeller(self, thread: int | None = None):
        """A function of a host time t: the name of the innermost closed
        span of ``thread`` (the main thread's by default) open at t, or
        None.  Spans of one thread nest; other threads' spans may
        overlap them and are not read."""
        if thread is None:
            thread = threading.main_thread().ident
        own = sorted((s for s in self.closed() if s.thread == thread),
                     key=lambda s: s.t0)
        starts = [s.t0 for s in own]
        reach = list(itertools.accumulate((s.t1 for s in own), max))

        def label(t: float):
            # back from the last span opened by t, while some span at or
            # before it still reaches past t; the first holding t is the
            # innermost (the latest opened of those holding t)
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if reach[i] <= t:
                    return None
                if t < own[i].t1:
                    return own[i].name
            return None

        return label


def install(rec: Recorder) -> None:
    """Record the process's spans and counters into ``rec``."""
    global _rec
    _rec = rec


def uninstall() -> None:
    """Stop recording."""
    global _rec
    _rec = None


def recording() -> bool:
    return _rec is not None


def span(name: str):
    """A context that records span ``name`` (the shared no-op ``OFF``
    while nothing is installed)."""
    rec = _rec
    if rec is None:
        return OFF
    return Span(rec, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` (nothing while nothing is
    installed)."""
    rec = _rec
    if rec is not None:
        rec.add(name, n)


def high(name: str, n: int) -> None:
    """Raise counter ``name`` to ``n`` where ``n`` is larger (nothing
    while nothing is installed)."""
    rec = _rec
    if rec is not None:
        rec.top(name, n)


def request():
    """A context in which the calling thread's spans belong to a new
    request; ``with`` gives its id (None, and nothing recorded, while
    nothing is installed)."""
    rec = _rec
    if rec is None:
        return OFF
    return _Request(rec.new_request())


def resume(req: int | None):
    """A context in which the calling thread's spans belong to request
    ``req`` again (OFF where nothing is installed or ``req`` is None:
    its request began while nothing was)."""
    if _rec is None or req is None:
        return OFF
    return _Request(req)


def task(name: str, fn):
    """``fn`` as it should run on a worker thread: under span ``name``
    of the submitting thread's request; ``fn`` itself while nothing is
    installed."""
    rec = _rec
    if rec is None:
        return fn
    req = getattr(_local, "req", None)

    def run(*args, **kwargs):
        with _Request(req), Span(rec, name):
            return fn(*args, **kwargs)

    return run
