"""Tracing: the port's named spans over its layers, an in-memory recorder
of them, the host reads they count, and a device trace scope.

A span is opened by ``traced(name)`` (a decorator) or ``span(name)`` (a
context manager); the port opens no other kind. A span is, at once:

- a ``torch.profiler`` range (``record_function``'s) while a profiler
  runs, so a profiler trace attributes host and device time to the layers;
- a :class:`Span` kept by the :class:`SpanRecorder` that is recording, if
  one is: its name, start and end in ns on the profiler's clock, its
  parent and the frame it belongs to. ``limo.scan_step`` sets the frame;
  every span inside it inherits the frame.

With neither a profiler nor a recorder on, opening a span costs one check.
The recorder is this process's (one thread opens the port's spans).

:func:`host_read` is the scan path's one way to read a device value back
to the host: each read is a ``limo.sync`` span, so their count is the
host-sync count and their self time (:func:`self_ns`) the host's wait for
the card. :meth:`SpanRecorder.report` gives per-name count, total, self and
mean, the reference's per-stage duration lines (mono_lidar.cpp:90-371).

:func:`device_trace` is the reference package's profiler scope
(``limo_tpu/utils/profiling.py``), writing a trace of the host and the
card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch

# the one check a span makes when nothing records it
_profiling = torch._C._autograd._profiler_enabled
# a profiler range, record_function's without the dispatcher: it returns
# within ~1 us of its own time stamp (record_function: ~10 us after it)
_range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
# the SpanRecorder that is recording, if any
_recorder: Optional["SpanRecorder"] = None


class Span(NamedTuple):
    name: str
    start_ns: int        # on the profiler's clock (time.time_ns)
    end_ns: int          # -1 while the span is open
    parent: int          # index of the enclosing recorded span, -1 if none
    frame: int           # the frame's id (limo.scan_step's), -1 outside one


class SpanRecorder:
    """Keeps the spans opened between :meth:`start` and :meth:`stop`, at
    most ``capacity`` of them; :attr:`dropped` counts the spans past it.
    Times are ``perf_counter_ns`` moved onto the profiler's clock by an
    offset taken at :meth:`start`."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self.dropped = 0
        self._rows: list = []       # [name, start, end, parent, frame]
        self._stack: list = []      # (nearest recorded index, frame)
        self._offset = 0

    def start(self):
        global _recorder
        if _recorder is not None:
            raise RuntimeError("a SpanRecorder is already recording")
        self._offset = time.time_ns() - time.perf_counter_ns()
        _recorder = self

    def stop(self):
        global _recorder
        if _recorder is not self:
            raise RuntimeError("this SpanRecorder is not recording")
        _recorder = None

    def snapshot(self) -> List[Span]:
        """The spans kept so far, in the order they opened (a parent before
        its children)."""
        return [Span(*r) for r in self._rows]

    def report(self) -> str:
        """One line per span name, the largest total first: count, total,
        self and mean ms."""
        spans = self.snapshot()
        agg = defaultdict(lambda: [0, 0, 0])
        for s, own in zip(spans, self_ns(spans)):
            a = agg[s.name]
            a[0] += 1
            a[1] += s.end_ns - s.start_ns
            a[2] += own
        lines = [f"{name}: n={n}, total {tot / 1e6:.3f} ms, self "
                 f"{own / 1e6:.3f} ms, mean {tot / n / 1e6:.4f} ms"
                 for name, (n, tot, own) in sorted(
                     agg.items(), key=lambda kv: -kv[1][1])]
        if self.dropped:
            lines.append(f"dropped {self.dropped} spans past {self.capacity}")
        return "\n".join(lines)

    def _open(self, name: str, frame: Optional[int]) -> int:
        t = time.perf_counter_ns() + self._offset
        up, fr = self._stack[-1] if self._stack else (-1, -1)
        if frame is not None:
            fr = frame
        if len(self._rows) >= self.capacity:
            self.dropped += 1
            self._stack.append((up, fr))
            return -1
        self._stack.append((len(self._rows), fr))
        self._rows.append([name, t, -1, up, fr])
        return len(self._rows) - 1

    def _close(self, i: int):
        t = time.perf_counter_ns() + self._offset
        self._stack.pop()
        if i >= 0:
            self._rows[i][2] = t


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's duration less the part its recorded children cover, for
    a whole :meth:`SpanRecorder.snapshot` of closed spans (``parent``
    indexes into it). A frame's self times sum to its top span's
    duration."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


class _Open:
    """One open span: a profiler range while a profiler runs, a row of the
    recorder that was recording when it opened."""

    __slots__ = ("name", "frame", "rf", "rec", "i")

    def __init__(self, name: str, frame: Optional[int] = None):
        self.name, self.frame = name, frame

    def __enter__(self):
        # the recorder's span nests inside the profiler's range, so the
        # profiler's own work on entering and leaving falls outside it
        self.rf = None
        if _profiling():
            self.rf = _range(self.name)
            self.rf.__enter__()
        self.rec = _recorder
        if self.rec is not None:
            self.i = self.rec._open(self.name, self.frame)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._close(self.i)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, frame: Optional[int] = None):
    """A span over a ``with`` block; ``frame`` starts a frame of that id."""
    if _recorder is None and not _profiling():
        return _NULL
    return _Open(name, frame)


def traced(name: str):
    """A span over every call of the decorated function."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _recorder is None and not _profiling():
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def host_read(flag: torch.Tensor) -> bool:
    """``bool(flag)``, a device→host read, as one ``limo.sync`` span."""
    with span("limo.sync"):
        return bool(flag)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` scope over the host and, where there is one, the
    card; on exit the trace is written to ``logdir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``: chrome://tracing, Perfetto). Yields the
    profiler, or None (and traces nothing) when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
