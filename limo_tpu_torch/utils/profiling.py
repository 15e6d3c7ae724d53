"""Tracing and profiling: named profiler ranges over the solver's layers,
a wall-clock stage timer and a device trace scope.

``traced("limo.assemble")`` wraps a function in a
``torch.profiler.record_function`` range, so that a ``torch.profiler``
trace of a solve attributes host and device time to the solver's layers
(chip_smoke.py phase 5). With no profiler running a range costs a few
microseconds per call; the solver opens about ten per LM iteration.

:class:`StageTimer` and :func:`device_trace` are the reference package's
(``limo_tpu/utils/profiling.py``): the reference's manual chrono spans
(mono_lidar.cpp:90-371 prints per-stage durations) as a stage timer, and a
profiler scope that writes a trace of the host and the card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def traced(name: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


class StageTimer:
    """Accumulates wall-time per named stage; ``report()`` mirrors the
    reference's "duration solver:..." stdout lines. A stage's time is the
    host's: on the card, end a stage with ``torch.cuda.synchronize()`` to
    include its device work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name}: total {tot*1e3:.1f} ms, "
                         f"n={n}, mean {tot/n*1e3:.2f} ms")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


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
