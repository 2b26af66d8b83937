"""The port's spans and its kernel launch counter: one registry for the
process.

**Spans.**  ``with span(name):`` marks one pass through a layer boundary:
its name, its host start and end (``time.perf_counter_ns``) and the name
of the span that encloses it on the same thread, its parent.
``card=True`` also records a CUDA event on the current stream at the
span's entry and at its exit; the time between them is the span's card
time.  It is stream time: the card's idle stretches inside the span
count.  Nothing inside a span synchronizes: :func:`summary` waits for the
events when it reads them, and drops them.

Spans record only while recording is on: while a ``torch.profiler``
records (PyTorch's process-wide flag), or inside :func:`recording`.  The
flag is the process's, not the calling thread's, so a span on a writer's
pool thread records under a profiler that the main thread started.  With
recording off a span costs one flag check: no clock read, no profiler
range, no event.  With it on, each span also opens
``torch.profiler.record_function(name)``, which puts it on the profiler's
clock, where a trace can label what the card waited for.  At most
:data:`MAX_SPANS` spans are kept; the oldest go first.

**Launch counter.**  The kernel wrappers count each launch of their CUDA
kernels with the input shape (:func:`count_launch`, always on; the
kernels are named once by :func:`name_kernels`).

Every function here is thread-safe.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

#: spans kept, the newest; the oldest go first
MAX_SPANS = 65_536

_ns = time.perf_counter_ns
_lock = threading.Lock()
_resolving = threading.Lock()
_local = threading.local()
_index = itertools.count()
_spans: deque = deque(maxlen=MAX_SPANS)
_recording = 0          # open ``recording()`` blocks, over every thread
_OFF = nullcontext()


class Span:
    """One recorded span; ``card_ms`` is None until :func:`summary`
    reads its events (and stays None for a span without them)."""

    __slots__ = ("name", "index", "parent", "start_ns", "end_ns", "card_ms",
                 "_card", "_events", "_range")

    def __init__(self, name: str, card: bool):
        self.name = name
        self.card_ms: Optional[float] = None
        self._card = card
        self._events = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        self.index = next(_index)
        stack.append(self)
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        if self._card:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = _ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._card:
            self._events[1].record()
        self.end_ns = _ns()
        self._range.__exit__(*exc)
        self._range = None
        _local.stack.pop()
        with _lock:
            _spans.append(self)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def span(name: str, card: bool = False):
    """A context manager that records one span of ``name`` while
    recording is on (and does nothing otherwise).  ``card``: also time the
    span on the card by two CUDA events on the current stream (the caller
    passes it only for work on a CUDA device)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, card)


@contextmanager
def recording():
    """Record spans inside the block, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def mark() -> int:
    """An index below that of every span opened after the call (for
    :func:`summary`'s ``since``)."""
    return next(_index)


def summary(since: int = 0) -> Dict[str, Dict]:
    """``{name: {count, host_ms, card_ms, parent}}`` over the kept spans
    opened after :func:`mark` gave ``since``: their number, their host and
    card milliseconds summed (``card_ms`` None where no span of the name
    was timed on the card) and the name of the span that encloses them
    (None at the top)."""
    with _resolving:
        with _lock:
            kept = list(_spans)
        for s in kept:
            if s._events is not None:
                first, last = s._events
                last.synchronize()
                s.card_ms = first.elapsed_time(last)
                s._events = None
    out: Dict[str, Dict] = {}
    for s in kept:
        if s.index < since:
            continue
        e = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                    "card_ms": None, "parent": s.parent})
        e["count"] += 1
        e["host_ms"] += s.host_ms
        if s.card_ms is not None:
            e["card_ms"] = (e["card_ms"] or 0.0) + s.card_ms
    return out


def reset() -> None:
    """Forget every kept span (the launch counts stay)."""
    with _lock:
        _spans.clear()


_count_lock = threading.Lock()
_launches: Dict[str, int] = {}
_shapes: Dict[str, Counter] = {}


def name_kernels(names: Iterable[str]) -> None:
    """Give each kernel of ``names`` a launch count (zero where new)."""
    with _count_lock:
        for k in names:
            _launches.setdefault(k, 0)
            _shapes.setdefault(k, Counter())


def count_launch(name: str, shape: Tuple[int, ...]) -> None:
    """One launch of kernel ``name`` on an input of ``shape`` (fills run on
    many producer threads, seals on the writer's pool; ``KeyError`` for a
    kernel :func:`name_kernels` did not name)."""
    with _count_lock:
        _launches[name] += 1
        _shapes[name][tuple(shape)] += 1


def launch_counts() -> Dict[str, int]:
    """``{kernel: launches}`` since the last reset, every kernel named."""
    with _count_lock:
        return dict(_launches)


def launch_shapes() -> Dict[str, Counter]:
    """``{kernel: Counter({input shape: launches})}`` since the last reset."""
    with _count_lock:
        return {k: Counter(c) for k, c in _shapes.items()}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0
            _shapes[k].clear()
