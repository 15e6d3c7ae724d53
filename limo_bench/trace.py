"""Reading a torch.profiler trace of the measured window.

A frozen copy of the port's ``chip_smoke.trace_summary`` (the raw kineto
events, walked once; a range's device time is that of the device operations
whose launching call started inside it), extended with what the benchmark's
readers need: the union of device activity (busy time), the idle gaps
between device operations attributed to the innermost ``limo.*`` range the
host was in at the gap, and the host spans themselves.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

OTHER = "(no limo range)"


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of [start, end] rows, sorted, as disjoint rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    # a new block starts where the start passes every earlier end
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    block_ends = np.maximum.reduceat(iv[:, 1], idx)
    return np.stack([starts, block_ends], 1)


def _innermost(spans, points):
    """For each time in ``points`` (sorted), the name of the innermost span
    (host ranges nest) that holds it, else :data:`OTHER`."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    names = []
    stack = []
    j = 0
    for t in points:
        while j < len(order) and spans[order[j]][1] <= t:
            s = spans[order[j]]
            while stack and stack[-1][2] < s[1]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        names.append(stack[-1][0] if stack else OTHER)
    return names


def summarize(prof, window_s: float, top: int = 10) -> dict | None:
    """Busy time, device operations, ranges and the breakdown of one traced
    window (``window_s`` of host wall time); None where the trace holds no
    device time."""
    from torch.autograd import DeviceType
    ops = {}
    dev = []          # (start_ns, end_ns) per device operation
    launched = []     # (correlation id of the launching call, ms)
    names = []        # each launched operation's name
    spans = []        # (name, start_ns, end_ns) of the host's limo.* ranges
    host_start = {}
    for e in prof.profiler.kineto_results.events():
        key = e.name()
        if e.device_type() == DeviceType.CUDA:
            if key.startswith("limo."):   # ranges' device annotations
                continue
            ns = e.duration_ns()
            c, total = ops.get(key, (0, 0.0))
            ops[key] = (c + 1, total + ns / 1e9)
            dev.append((e.start_ns(), e.start_ns() + ns))
            launched.append((e.linked_correlation_id(), ns / 1e6))
            names.append(key)
            continue
        if key.startswith("limo."):
            spans.append((key, e.start_ns(), e.end_ns()))
        if e.correlation_id() > 0:
            host_start[e.correlation_id()] = e.start_ns()
    if not dev:
        return None
    # operations whose launching call the trace does not hold (a kernel
    # launched from a library with its own static CUDA runtime, as the
    # port's ctypes-bound kernels are): device ms by name
    unlinked = defaultdict(float)
    for (c, ms), key in zip(launched, names):
        if c not in host_start:
            unlinked[key] += ms
    # each range's host ms (incl. nested) and the device ms of the
    # operations launched inside it: prefix sums over launch times
    at = np.array([host_start.get(c, -1) for c, _ in launched], np.int64)
    order = np.argsort(at, kind="stable")
    at = at[order]
    cum = np.concatenate([[0.0], np.cumsum(
        np.array([ms for _, ms in launched])[order])])
    ranges = defaultdict(lambda: [0, 0.0, 0.0])
    for key, start, end in spans:
        r = ranges[key]
        r[0] += 1
        r[1] += (end - start) / 1e6
        r[2] += (cum[np.searchsorted(at, end, "right")]
                 - cum[np.searchsorted(at, start, "left")])
    busy = _merge(np.array(dev, np.int64))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    gaps = np.stack([busy[:-1, 1], busy[1:, 0]], 1)
    gap_names = _innermost(spans, ((gaps[:, 0] + gaps[:, 1]) // 2).tolist())
    by_gap = defaultdict(float)
    for name, (a, b) in zip(gap_names, gaps.tolist()):
        by_gap[name] += (b - a) / 1e9
    device_ops = sorted(([k, s] for k, (c, s) in ops.items()),
                        key=lambda r: -r[1])[:top]
    idle = sorted(([k, s] for k, s in by_gap.items()),
                  key=lambda r: -r[1])[:top]
    return {
        "window_s": window_s, "busy_s": busy_s,
        "device_ops": sum(c for c, _ in ops.values()),
        "ranges": {k: {"count": c, "host_ms": h, "device_ms": d}
                   for k, (c, h, d) in ranges.items()},
        "spans": spans, "unlinked_ms": dict(unlinked),
        "breakdown": {"device_ops": [[k[:64], s] for k, s in device_ops],
                      "idle_gaps": idle},
    }


def outermost_ms(spans, names) -> float:
    """Host ms covered by spans of any of ``names``, each instant once (a
    range nested in another of the set adds nothing)."""
    iv = np.array([(s, e) for n, s, e in spans if n in names], np.int64)
    if len(iv) == 0:
        return 0.0
    m = _merge(iv)
    return float((m[:, 1] - m[:, 0]).sum()) / 1e6
