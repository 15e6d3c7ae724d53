"""Named profiler ranges over the solver's layers.

``traced("limo.assemble")`` wraps a function in a
``torch.profiler.record_function`` range, so that a ``torch.profiler``
trace of a solve attributes host and device time to the solver's layers
(chip_smoke.py phase 5). With no profiler running a range costs a few
microseconds per call; the solver opens about ten per LM iteration.
"""

from __future__ import annotations

import functools

import torch


def traced(name: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
