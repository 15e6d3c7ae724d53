"""The ``scan.drive`` cell's per-layer split from the port's own spans, and
the span recorder's cost, on the card. One JSON line per mode.

    python3 scripts/scan_spans.py split --seed 3200000101
    python3 scripts/scan_spans.py cost --seed 3200000201 [--windows 3]
    python3 scripts/scan_spans.py micro

The cell's inputs, program, warm-up and window are the benchmark's own
(``limo_bench/drivers/scan.py``); this script adds what its ``--trace 1``
run does not record yet (PERF.md, Open questions):

- ``split``: the span recorder (``limo_tpu_torch.utils.profiling``) is on
  from before the program is set up to the end of the warm-up (the set-up's
  spans: ``first_solve_s``), then over one pass's frames outside the cell's
  ``trace_frames``, and off while the profiler traces those. It prints the
  per-layer self times of the recorded frames, the device operations
  launched inside each profiler range, each recorded frame's coverage by
  its ``limo.scan_step`` span, and, against a second pass with nothing on,
  the profiler's cost per frame.
- ``cost``: whole ``--trace 0`` windows, alternately with the recorder off
  and on (off, on, on, off, ...): ``frames_per_s`` and ``keyframe_ms``.
- ``micro``: host microseconds per span with nothing on, with the recorder
  on and under the profiler, beside a plain call.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit
from collections import defaultdict

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from limo_tpu_torch.utils import profiling  # noqa: E402

# the per-layer metrics, each a set of span names whose self times it sums
LAYERS = {
    "sync_wait": ("limo.sync",),
    "scan_step": ("limo.scan_step", "limo.push", "limo.selection"),
    "pose_only": ("limo.pose_only",),
    "solve_loop": ("limo.solve_trimmed", "limo.trim", "limo.schur_solve",
                   "limo.apply_step"),
    "assembly": ("limo.kernel_inputs", "limo.obs_residuals",
                 "limo.obs_jacobians", "limo.torch_obs_blocks",
                 "limo.gp_system", "limo.assemble", "limo.compute_cost",
                 "limo.residual_stats", "limo.regularizers",
                 "limo.assemble_obs", "limo.cost_obs"),
}
LAYER_OF = {n: layer for layer, names in LAYERS.items() for n in names}


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def cell(seed, device, rec=None):
    """The benchmark's set-up of ``scan.drive``, the recorder ``rec`` on
    from before the program's set-up to the warm-up's end."""
    from limo_bench import harness
    from limo_bench.drivers import scan as drv
    _, _, traffic, config = harness.cell_files("scan.drive",
                                               harness.load_manifest())
    stamps, uvd, valid, world = drv.inputs(traffic, config, seed)
    if rec is not None:
        rec.start()
    system = drv.port_system(config, world, device)
    frames = drv.frames_of(system, stamps, uvd, valid, device)
    st0 = system.so.init_state(system.cfg.capacity, system.dtype,
                               system.cfg.prior.default_speed, device)
    drv.warm_up(system, frames, st0)
    if rec is not None:
        rec.stop()
    return drv, system, frames, st0, tuple(traffic["traffic"]["trace_frames"])


def one_pass(system, frames, st0, rec=None, recorded=None, profiled=None):
    """One pass from the initial state: per frame (wall ms, kind), as the
    benchmark times a frame. ``rec`` records the frames in ``recorded``; a
    profiler traces the frames in ``profiled`` (a range) and is returned."""
    from torch.profiler import ProfilerActivity, profile
    step = system.so.make_scan_step(system.rig, system.cfg)
    prof = None
    out, st = [], st0
    for i, fr in enumerate(frames):
        if profiled is not None and i == profiled.start:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        on = rec is not None and i in recorded
        if on:
            rec.start()
        n0 = len(step.stats.solves)
        t = time.perf_counter()
        st, _ = step(st, fr)
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t) * 1e3,
                    "solve" if len(step.stats.solves) > n0 else "track"))
        if on:
            rec.stop()
        if prof is not None and i == profiled.stop - 1:
            prof.stop()
    return out, prof


def layer_split(spans):
    """Self ms per layer (and per span name outside every layer), and per
    span name, of each recorded frame, keyed by frame id."""
    per = defaultdict(lambda: defaultdict(float))
    names = defaultdict(lambda: defaultdict(float))
    for s, own in zip(spans, profiling.self_ns(spans)):
        per[s.frame][LAYER_OF.get(s.name, s.name)] += own / 1e6
        names[s.frame][s.name] += own / 1e6
    return per, names


def device_ops(prof):
    """Per ``limo.*`` range name: [count, device operations launched inside
    (inclusive), launched inside and in no child range (self)]. An
    operation whose launching call the trace lacks (the ctypes-bound
    kernels) counts in no range, as ``limo_bench/trace.py`` counts device
    time."""
    import numpy as np
    from torch.autograd import DeviceType
    spans, host_start, launched = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith("limo."):
                launched.append(e.linked_correlation_id())
            continue
        if e.name().startswith("limo."):
            spans.append((e.start_ns(), e.end_ns(), e.name()))
        if e.correlation_id() > 0:
            host_start[e.correlation_id()] = e.start_ns()
    at = np.sort(np.array([host_start[c] for c in launched
                           if c in host_start], np.int64))
    count = lambda a, b: int(np.searchsorted(at, b, "right")
                             - np.searchsorted(at, a, "left"))
    spans.sort(key=lambda s: (s[0], -s[1]))
    out = defaultdict(lambda: [0, 0, 0])
    stack = []
    for a, b, name in spans:
        while stack and stack[-1][1] < a:
            stack.pop()
        n = count(a, b)
        out[name][0] += 1
        out[name][1] += n
        out[name][2] += n
        if stack:
            out[stack[-1][2]][2] -= n
        stack.append((a, b, name))
    return dict(out), len(launched)


def split(seed, device):
    setup = profiling.SpanRecorder()
    _, system, frames, st0, (a, b) = cell(seed, device, setup)
    set_spans = setup.snapshot()
    first = next(s for s in set_spans if s.name == "limo.solve_trimmed")
    rec = profiling.SpanRecorder()
    recorded = set(range(len(frames))) - set(range(a, b))
    traced, prof = one_pass(system, frames, st0, rec, recorded, range(a, b))
    plain, _ = one_pass(system, frames, st0)
    spans = rec.snapshot()
    per, names = layer_split(spans)
    tops = {s.frame: s for s in spans if s.name == "limo.scan_step"}
    cover, sums_exact = [], True
    for f, top in tops.items():
        dur = (top.end_ns - top.start_ns) / 1e6
        cover.append(dur / traced[f][0])
        sums_exact &= abs(sum(per[f].values()) - dur) < 1e-6
    kinds = {f: traced[f][1] for f in recorded}
    n_solves = sum(k == "solve" for k in kinds.values())
    total = lambda layer: sum(per[f].get(layer, 0.0) for f in recorded)
    metrics = {
        "sync_wait_ms_per_frame": total("sync_wait") / len(recorded),
        "scan_step_self_ms": total("scan_step") / len(recorded),
        "pose_only_self_ms": total("pose_only") / len(recorded),
        "solve_loop_self_ms_per_solve": total("solve_loop") / n_solves,
        "assembly_self_ms_per_solve": total("assembly") / n_solves,
        "first_solve_s": (first.end_ns - first.start_ns) / 1e9,
    }
    ops, n_ops = device_ops(prof)
    traced_solves = sum(traced[i][1] == "solve" for i in range(a, b))
    if traced_solves:
        metrics["solve_ops_per_solve"] = \
            ops.get("limo.solve_trimmed", [0, 0, 0])[1] / traced_solves
    # the mean split of a recorded frame of each kind: self ms per layer
    # (and per name outside every layer), and the frame's wall ms outside
    # its limo.scan_step span
    by_kind = {}
    for kind in ("track", "solve"):
        fs = [f for f in recorded if kinds[f] == kind]
        keys = sorted({k for f in fs for k in per[f]})
        mean = {k: sum(per[f].get(k, 0.0) for f in fs) / len(fs)
                for k in keys}
        mean["outside_scan_step"] = sum(
            traced[f][0] - (tops[f].end_ns - tops[f].start_ns) / 1e6
            for f in fs) / len(fs)
        mean["wall_ms"] = sum(traced[f][0] for f in fs) / len(fs)
        by_kind[kind] = {"frames": len(fs), "ms": mean, "self_ms_by_name": {
            k: sum(names[f].get(k, 0.0) for f in fs) / len(fs)
            for k in sorted({k for f in fs for k in names[f]})}}
    line = {
        "mode": "split", "seed": seed, "card": card(),
        "torch": torch.__version__, "metrics": metrics,
        "recorded_frames": len(recorded), "recorded_solves": n_solves,
        "traced_frames": b - a, "traced_solves": traced_solves,
        "coverage_min": min(cover), "coverage_median": statistics.median(
            cover), "self_sums_exact": sums_exact,
        "spans": len(spans), "dropped": rec.dropped + setup.dropped,
        "split": by_kind,
        "setup": {"spans": len(set_spans),
                  "report": setup.report().splitlines()[:12]},
        "device_ops_traced": n_ops,
        "ops_by_range": dict(sorted(ops.items(), key=lambda kv: -kv[1][1])),
        # the profiled frames' wall ms against the plain pass's
        "profiler_cost": sum(traced[i][0] for i in range(a, b))
        / sum(plain[i][0] for i in range(a, b)),
        "syncs": sum(s.name == "limo.sync" for s in spans),
    }
    return line


def cost(seed, windows, seconds, device):
    drv, system, frames, st0, _ = cell(seed, device)
    runs = []
    order = ([False, True, True, False] * windows)[:2 * windows]
    for on in order:
        rec = profiling.SpanRecorder()
        if on:
            rec.start()
        frame_ms, kinds, window_s, *_ = drv.measure(system, frames, st0,
                                                    seconds, None)
        if on:
            rec.stop()
        solve = [m for m, k in zip(frame_ms, kinds) if k == "solve"]
        runs.append({"recorder": on, "frames_per_s": len(frame_ms) / window_s,
                     "keyframe_ms": sum(solve) / len(solve),
                     "frames": len(frame_ms), "spans": len(rec.snapshot())})
    med = lambda on, k: statistics.median(r[k] for r in runs
                                          if r["recorder"] == on)
    return {"mode": "cost", "seed": seed, "card": card(), "runs": runs,
            "median_off": {k: med(False, k) for k in ("frames_per_s",
                                                      "keyframe_ms")},
            "median_on": {k: med(True, k) for k in ("frames_per_s",
                                                    "keyframe_ms")}}


def micro(device, n=200_000):
    from torch.profiler import ProfilerActivity, profile

    def plain():
        pass

    traced = profiling.traced("limo.micro")(plain)
    flag = torch.ones((), dtype=torch.bool, device=device)
    us = lambda fn, k=n: timeit.timeit(fn, number=k) / k * 1e6
    out = {"plain_call_us": us(plain), "span_off_us": us(traced),
           "host_read_off_us": us(lambda: profiling.host_read(flag), 20_000),
           "bool_us": us(lambda: bool(flag), 20_000)}
    rec = profiling.SpanRecorder(capacity=4 * n)
    rec.start()
    out["span_recorder_us"] = us(traced)
    rec.stop()
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_profiler_us"] = us(traced, 20_000)
    return {"mode": "micro", "card": card(), "torch": torch.__version__,
            **out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("split", "cost", "micro"))
    p.add_argument("--seed", type=int, default=3200000101)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scan_spans.py: needs a CUDA card (or --device)")
    if args.mode == "split":
        line = split(args.seed, device)
    elif args.mode == "cost":
        line = cost(args.seed, args.windows, args.seconds, device)
    else:
        line = micro(device)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
