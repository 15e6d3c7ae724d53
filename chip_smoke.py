"""Chip smoke run of the PyTorch/CUDA port (``limo_tpu_torch``) on one card.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit, and no result):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels from limo_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the bench width (K=20, C=1, L=1536) and at a 2-camera ragged shape
   (K=6, C=2, L=1000), depth on and off, and on 40 keyframe slots with the
   keyframes in use in slots 28-39 (L=999); 20 launches of each kernel on
   the same inputs bit-identical; the kernel's device time per launch (from
   the torch.profiler trace, else CUDA graph replay: ``device_ms``)
   beside an empty kernel's on the same grid (the launch floor), the whole
   wrapper, the plain version and the least time the card could take
   (bound);
4. main path: the trimmed windowed-BA solve at the bench width
   (``make_problem(20, 1536, 12, 800, float32, seed=1)``) run 10 times
   after one warm-up, with the launch counts of both kernels, the solve
   shape (1 round, 77 trimmed, final cost within 1e-4 of the reference
   package's f64 solve, 1612.640648) and bit-identical repeats checked,
   then one solve without lidar depth;
5. where the time goes: one solve under torch.profiler (device time by
   kernel, the two kernels' own, device idle share) and the host syncs of
   one solve;
6. the scan drive at full width (``entry.scan_drive()``: LimoConfig()'s
   20 x 1536 x 1, 60 frames of a 10 m/s drive with lidar depth, f32):
   the scan step through both kernels, frame by frame, with the launch
   identity summed over its attempted solves; the kernels against their
   plain versions on the windows of its first three solves; its first five
   solves against the port's f64 solve of the same input on the CPU; the
   counts against the reference package's (13 keyframes, 11 attempted
   solves); 10 frames under torch.profiler, bit-identical to the drive's;
   and the same world without depth but with external priors for 30
   frames, which must accept a solve that moves the window;
7. the fused drive at full width (``entry.fused_drive()``: the reference
   package's flagship fused configuration, 20 x 1536 x 1 with 384
   features, lidar depth, groundplane and labels, f32, on a 200-frame
   rendered world with a standstill and two turns): the stages of the
   first three frames (detect, labels, lidar depth and plane, guided match,
   slot assignment, per-slot channels) against the port's f64 run of each
   stage on the same inputs on the CPU; ``run_fused`` with chunks of 64,
   timed frame by frame, with the launch identity over its solves, the
   kernels against their plain versions on the windows of its first three
   solves and its first five solves against the port's f64 solves on the
   CPU; its counts, track statistics and ATE against the reference
   package's run of the same drive; a second pass bit-identical, with its
   host syncs counted; the first 44 frames in chunks of 16 against one
   chunk; 20 frames under torch.profiler. To keep the script near half
   its 1200 s limit, phase 6 runs its drive once (its second pass through
   ``run_sequence`` was cut; phase 7's second pass holds the same step to
   bit-identical repeats), solves only its first five windows in f64 and
   profiles 10 frames, not 20.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The profile table and a JSON record of
the run are written under chiprun_out/.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from limo_tpu_torch.entry import fused_drive, kernel_check_windows, \
    make_problem, scan_drive
from limo_tpu_torch.frontend import tracker as trk
from limo_tpu_torch.frontend.semantics import dilate_labels, sample_labels
from limo_tpu_torch.geometry.camera import CameraRig
from limo_tpu_torch.pipeline import fused
from limo_tpu_torch.pipeline import scan_odometry as so
from limo_tpu_torch.pipeline.full import frontend_depth_plane
from limo_tpu_torch.pipeline.metrics import ate_rmse, kitti_drift
from limo_tpu_torch.solver import ba_core, cuda_assemble as ca
from limo_tpu_torch.solver import solve_trimmed
from limo_tpu_torch.window_manager import DEFAULT_OUTLIER_LABELS

# the reference package's solve of this fixture, JAX on the CPU in f64
REF_FINAL_COST = 1612.640648
REF_TRIMMED = 77
N_SOLVES = 10

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations per (landmark, keyframe, camera) slot, counted from
# csrc/assemble.cu: residuals and cost 44; weights, the 18+9 Jacobian
# entries and the V/b_l/U/b_pose/W accumulations 575 more. Both kernels do
# this work for every slot (masks multiply, they do not skip).
OPS_PER_SLOT = {"assemble_obs": 619, "cost_obs": 44}
SOURCE = "limo_tpu_torch/csrc/assemble.cu"
REPLACES = {
    "assemble_obs": "limo_tpu/solver/pallas_assemble.py:325",
    "cost_obs": "limo_tpu/solver/pallas_assemble.py:122",
}
N_REPEAT = 20

# the reference package's run_sequence on entry.scan_drive() (JAX on the
# CPU): the same counts in f32 and in f64; ATE 5.121 m in both
REF_SCAN = {"keyframes": 13, "attempted": 11, "accepted": 0, "po_ok": 1,
            "ate_m": 5.121}
# the same world without depth, external priors (rng seed 9, sigma 0.05 m),
# the first 30 frames: the same counts in f32 and in f64; ATE 0.2460 m in
# f32, 0.2455 m in f64
MONO_FRAMES = 30
REF_MONO = {"keyframes": 15, "attempted": 7, "accepted": 7, "ate_m": 0.246}
# each attempted solve against the port's f64 solve of the same input on
# the CPU (PERF.md, PR 4): the initial cost within 1e-4 (phase 4's
# tolerance); the final cost finite, below the initial cost and within a
# factor SCAN_FINAL_FACTOR of the f64 one. These windows are ill-posed (the
# post-solve guard rejects every one of them): f32 and f64 LM part from the
# first step (up to 5e-3 apart after it), and their final costs end up to
# 3.07x apart on the CPU, in the reference package as in the port
SCAN_INITIAL_RTOL = 1e-4
SCAN_FINAL_FACTOR = 4.0
N_SCAN_CHECK = 3
# phase 6 solves its first N_SCAN_F64 windows again in f64 on the CPU (all
# 11 until the fused phase came; cut to hold the script near half its limit)
N_SCAN_F64 = 5
# phase 6 profiles its first 10 frames (20 until the fused phase came)
SCAN_PROFILE_FRAMES = 10
# phase 7: the reference package's run_fused on entry.fused_drive() (JAX
# f32 on the CPU; python scripts/fused_drive_cpu.py --package reference)
REF_FUSED = {"keyframes": 55, "attempted": 41, "accepted": 23, "po_ok": 173,
             "min_n_tracks": 296, "min_n_matches": 149, "min_n_depth": 215,
             "ate_m": 2.2036, "drift_t_percent": 5.092,
             "drift_r_deg_per_m": 0.03856, "drift_segments": 14}
FUSED_CHUNK = 64
FUSED_PARITY_FRAMES = 3
FUSED_CHUNK_FRAMES = 44
FUSED_F64_SOLVES = 5
FUSED_PROFILE_FRAMES = 20
# stage parity of the first frames, card f32 against the port's f64 run of
# the same stage on the same inputs on the CPU (PERF.md): discrete
# outputs may differ only where f32 rounding decides a near-tie, at most
# FUSED_STAGE_FLIPS per frame and stage, each printed; continuous outputs
# within these bounds
FUSED_STAGE_FLIPS = 3
FUSED_STAGE_UV_PX = 1e-3
FUSED_STAGE_DESC = 1e-5
FUSED_STAGE_RESPONSE_REL = 1e-3
FUSED_STAGE_DEPTH_REL = 1e-3
FUSED_STAGE_NORMAL = 1e-5
# the fused drive's solves run out their LM budget on ill-posed windows,
# where f32 rounding steers LM: the final costs of the port's and the
# reference package's f32 solves of one window lie up to 1.5x apart, and
# the port's f32 against its f64 up to 3.5x (CPU, PERF.md)
FUSED_FINAL_FACTOR = 10.0
# the card's drive against REF_FUSED: each count within [lo, hi] times the
# reference's. Three CPU runs of the drive (the reference in f32, the port
# in f32 and in f64) agree on every decision until the first ill-posed
# solve whose f32 result parts (frame 73 or 78), then spread: keyframes
# 51-67, attempted 40-51, accepted 23-26, po_ok 157-182, ATE 1.70-17.05 m
# (PERF.md). The band holds that spread with a margin.
FUSED_BAND = {"keyframes": (0.75, 1.35), "attempted": (0.75, 1.35),
              "accepted": (0.6, 1.5), "po_ok": (0.8, 1.1),
              "ate_m": (0.0, 10.0)}
# test_fused.py's structure gates, over frames 5 on: tracks, matches and
# depths per frame, keyframes, accepted solves. The tracks' gate is 40, not
# 50: the port's f32 CPU run, a correct run that parts from the others at
# frame 78, holds 47 tracks at frame 95, where the standstill's extra
# keyframes fill the landmark slots
FUSED_STRUCTURE = {"min_n_tracks": 40, "min_n_matches": 30,
                   "min_n_depth": 20, "keyframes": 7, "accepted": 0}
OUT = Path("chiprun_out")
# each kernel's symbol in the profiler's trace
SYMBOL = {"assemble_obs": "assemble_obs_kernel", "cost_obs": "cost_obs_kernel",
          "noop": "noop_kernel"}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


T0 = time.perf_counter()


def phase(name):
    print(f"\n== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def events_ms(fn, n_batches, per_batch, warmup=3):
    """Median over batches of the per-call time of ``fn`` (CUDA events
    around ``per_batch`` back-to-back calls): paced by the host where a
    call's host work outlasts its device work."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n_batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def profiled_ms(fn, symbol, n=50):
    """Device time (ms) per launch of kernel ``symbol`` over ``n`` calls of
    ``fn`` (after one warm-up call), from the torch.profiler trace; None
    if the trace does not hold the kernel's ``n`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and symbol in e.key]
    if len(hits) != 1 or hits[0].count != n:
        return None
    return hits[0].device_time_total / 1e3 / n


def graph_ms(fn, n=50, reps=11):
    """Device time (ms) per call of ``fn`` from replaying a CUDA graph that
    captured ``n`` calls (one warm-up call outside the capture): the median
    over ``reps`` replays, CUDA events around each. It includes whatever
    else ``fn`` launches and the gaps between launches inside the graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return events_ms(graph.replay, reps, 1, warmup=1) / n


def device_ms(fn, symbol):
    """(ms per launch of kernel ``symbol`` in calls of ``fn``, method): the
    profiler's trace, taken twice if the first lacks the kernel's launches,
    then CUDA graph replay."""
    for _ in range(2):
        ms = profiled_ms(fn, symbol)
        if ms is not None:
            return ms, "torch.profiler trace"
    return graph_ms(fn), "CUDA graph replay"


def check_repeats(name, ops, sizes):
    """N_REPEAT wrapper calls on the same inputs; every output must equal
    the first call's bit for bit (a counter that does not reset, or a
    reduction that races, shows here)."""
    fn = {"assemble_obs": ca.assemble_obs, "cost_obs": ca.cost_obs}[name]
    runs = [fn(*ops, **sizes) for _ in range(N_REPEAT)]
    torch.cuda.synchronize()
    first = runs[0] if name == "assemble_obs" else (runs[0],)
    for run in runs[1:]:
        run = run if name == "assemble_obs" else (run,)
        check(all(torch.equal(a, b) for a, b in zip(first, run)),
              f"{name}: {N_REPEAT} launches on the same inputs differ")


def bound(name, ops, outs, K, C):
    """Least time (ms) for the work: each input read once, each public
    output written once (not the partials' scratch), over the HBM rate; the
    f32 operations over the f32 rate."""
    L = ops[0].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*ops, *outs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_SLOT[name] * L * K * C / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def against_plain(ops, sizes):
    """Both kernels against their plain versions on one window's operands.
    Where f32 rounding alone stays inside the kernels' tolerance (the plain
    f32 assembly within half of it of the plain f64 one, on the same
    operands), kernel and plain f32 must agree within it
    (``ca.compare_with_plain``). Where it does not (many keyframes, near
    landmarks: some blocks are sums of far larger terms), each kernel
    output must lie within the tolerance plus twice the plain f32
    version's largest error in that field of the plain f64 value, and the
    two kernels' costs must be equal. Returns ({kernel: (max abs, max rel)
    error against the plain f32 version}, the plain f32 version's largest
    error over the tolerance)."""
    ops64 = [t.double() for t in ops]
    plain = {"assemble_obs": (ca.assemble_obs_plain(*ops, **sizes),
                              ca.assemble_obs_plain(*ops64, **sizes)),
             "cost_obs": (ca.cost_obs_plain(*ops, **sizes),
                          ca.cost_obs_plain(*ops64, **sizes))}
    fields = lambda name, out: (
        [(f, getattr(out, f)) for f in out._fields] if name == "assemble_obs"
        else [("cost_obs", out)])

    def over(a, x, field):
        rtol, atol = ca.TOLERANCES[field]
        return float(((a.double() - x).abs() / (atol + rtol * x.abs())).max())
    ratio = max(over(a, x, f) for name, (p32, p64) in plain.items()
                for (f, a), (_, x) in zip(fields(name, p32),
                                          fields(name, p64)))
    if ratio < 0.5:
        return ca.compare_with_plain(ops, sizes), ratio
    kern = {"assemble_obs": ca.assemble_obs(*ops, **sizes),
            "cost_obs": ca.cost_obs(*ops, **sizes)}
    check(torch.equal(kern["cost_obs"], kern["assemble_obs"].cost),
          "cost kernel != assembly kernel cost")
    errs = {}
    for name, out in kern.items():
        p32, p64 = plain[name]
        abs_err = rel_err = 0.0
        for (f, k), (_, a), (_, x) in zip(fields(name, out),
                                          fields(name, p32),
                                          fields(name, p64)):
            rtol, atol = ca.TOLERANCES[f]
            bound = atol + rtol * x.abs() + 2 * (a.double() - x).abs().max()
            gap = (k.double() - x).abs()
            check(bool((gap <= bound).all()),
                  f"{name} {f}: {float(gap.max())} from the f64 plain value "
                  f"(bound {float(bound.max())})")
            err = float((k - a).abs().max())
            abs_err = max(abs_err, err)
            rel_err = max(rel_err, err / max(float(a.abs().max()), 1e-30))
        errs[name] = (abs_err, rel_err)
    return errs, ratio


def check_windows(windows, errs):
    """Each kernel against its plain version on each (name, (window, sel,
    rig, cfg)) (``against_plain``), and N_REPEAT bit-identical launches;
    returns ``errs`` (kernel -> (max abs, max rel) error against the plain
    f32 version) updated."""
    for name, (w, sel, rig, cfg) in windows:
        ops, sizes = ba_core._obs_kernel_args(w, sel, rig, cfg)
        case, ratio = against_plain(ops, sizes)
        torch.cuda.synchronize()
        errs = {k: tuple(map(max, errs[k], case[k])) for k in errs}
        for kernel in errs:
            check_repeats(kernel, ops, sizes)
        how = ("agree with their plain versions" if ratio < 0.5 else
               "lie as close to the plain f64 values as the plain f32 "
               "versions, within the tolerance")
        print(f"{name}: both kernels {how} (plain f32 rounding / "
              f"tolerance {ratio:.3g}); cost kernel == assembly kernel cost; "
              f"{N_REPEAT} launches of each bit-identical")
    return errs


def check_kernels(device):
    """Phase 3: every kernel against its plain version; returns the
    per-kernel error and timing record at the bench width."""
    errs = check_windows(kernel_check_windows(device),
                         {"assemble_obs": (0.0, 0.0), "cost_obs": (0.0, 0.0)})

    # timing at the bench width, depth on, in one call: the kernel alone
    # (the wrapper's launch into outputs allocated once), an empty kernel on
    # the same grid, the whole wrapper, and the plain version
    w, sel, rig, cfg = make_problem(20, 1536, 12, 800, torch.float32, seed=1,
                                    device=device)
    ops, sizes = ba_core._obs_kernel_args(w, sel, rig, cfg)
    K, C, L = sizes["K"], sizes["C"], ops[0].shape[1]
    lib = ca.build().lib

    def noop():
        check(lib.limo_noop(L, torch.cuda.current_stream().cuda_stream) == 0,
              "empty kernel: launch failed")
    floor_ms, floor_how = device_ms(noop, SYMBOL["noop"])
    print(f"launch floor (empty kernel, {ca.n_blocks(L)} blocks of "
          f"{ca.block_size()} threads): {floor_ms * 1e3:.3f} us ({floor_how})")
    wrapper = {"assemble_obs": lambda: ca.assemble_obs(*ops, **sizes),
               "cost_obs": lambda: ca.cost_obs(*ops, **sizes)}
    plain = {"assemble_obs": lambda: ca.assemble_obs_plain(*ops, **sizes),
             "cost_obs": lambda: ca.cost_obs_plain(*ops, **sizes)}
    records = {}
    for name in ("assemble_obs", "cost_obs"):
        outs, scratch = ca.kernel_outputs(name, K, L, ops[0].device)
        launch = ca.launcher(name, ops, outs, scratch, **sizes)
        b_ms, b_by, nbytes = bound(name, ops, outs, K, C)
        ms, how = device_ms(launch, SYMBOL[name])
        records[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": None,               # filled from the main path
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": ms, "ms_method": how, "floor_ms": floor_ms,
            "floor_method": floor_how,
            "wrapper_ms": events_ms(wrapper[name], 11, 50),
            "plain_ms": events_ms(plain[name], 5, 10),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "library_ms": None,     # no single PyTorch call computes this
        }
        r = records[name]
        print(f"{name}: {ms * 1e3:.3f} us/launch on the device ({how}; "
              f"floor {floor_ms * 1e3:.3f} us, bound {b_ms * 1e3:.3f} us by "
              f"{b_by}); wrapper {r['wrapper_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms (CUDA events); max |kernel - plain| "
              f"{errs[name][0]:.3g} (relative {errs[name][1]:.3g})")
    return records


def main_path(device):
    """Phase 4: the trimmed solve at the bench width, through both kernels."""
    w, sel, rig, cfg = make_problem(20, 1536, 12, 800, torch.float32,
                                    seed=1, device=device)
    plan = ba_core.assembly_plan(w.poses.dtype, w.poses.device, cfg)
    print(f"assembly plan: {plan}")
    check(plan.startswith("cuda["), f"plan {plan} is not the kernel path")
    solve_trimmed(w, sel, rig, cfg)                    # warm-up
    torch.cuda.synchronize()

    for k in ca.launches:
        ca.launches[k] = 0
    results, dev_ms, host_ms = [], [], []
    for _ in range(N_SOLVES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = solve_trimmed(w, sel, rig, cfg)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        results.append(out)
    launches = dict(ca.launches)

    infos = [r[2] for r in results]
    n_it = sum(i.n_iterations for i in infos)
    n_rounds = sum(i.n_rounds for i in infos)
    print(f"launches in {N_SOLVES} solves: {launches} "
          f"(LM iterations {n_it}, trim rounds {n_rounds})")
    check(launches["assemble_obs"] == n_it, f"launches {launches}")
    # cost evaluations: initial + one per LM iteration + one per trim round
    check(launches["cost_obs"] == N_SOLVES + n_it + n_rounds,
          f"launches {launches}")
    w0, s0, i0 = results[0]
    for wi, si, ii in results[1:]:
        for a, b in zip(w0, wi):
            check(torch.equal(a, b), "repeated solves differ (window)")
        check(torch.equal(s0.lm_selected, si.lm_selected)
              and torch.equal(i0.final_cost, ii.final_cost)
              and ii.n_iterations == i0.n_iterations,
              "repeated solves differ (selection, cost or iterations)")
    final = float(i0.final_cost)
    rel = abs(final - REF_FINAL_COST) / REF_FINAL_COST
    print(f"solve: LM iterations {i0.n_iterations}, rounds {i0.n_rounds}, "
          f"trimmed {int(i0.n_trimmed)}, cost {float(i0.initial_cost):.4f} "
          f"-> {final:.4f} (reference {REF_FINAL_COST}, rel {rel:.2e}); "
          f"{N_SOLVES} repeats bit-identical")
    check(i0.n_rounds == 1 and int(i0.n_trimmed) == REF_TRIMMED,
          f"solve shape: rounds {i0.n_rounds}, trimmed {int(i0.n_trimmed)}")
    check(rel < 1e-4, f"final cost {final} vs {REF_FINAL_COST}: rel {rel}")
    check(bool(torch.isfinite(w0.poses).all()
               and torch.isfinite(w0.lm_pos).all()), "non-finite state")
    print(f"ms/solve: device-event median {statistics.median(dev_ms):.3f} "
          f"(min {min(dev_ms):.3f}, max {max(dev_ms):.3f}); host median "
          f"{statistics.median(host_ms):.3f}; solves/s "
          f"{1e3 / statistics.median(dev_ms):.2f}; host syncs/solve "
          f"{i0.n_host_syncs}")

    wn, seln, rign, cfgn = make_problem(20, 1536, 12, 800, torch.float32,
                                        with_depth=False, seed=1,
                                        device=device)
    _, _, info_n = solve_trimmed(wn, seln, rign, cfgn)
    c0, c1 = float(info_n.initial_cost), float(info_n.final_cost)
    print(f"no-depth solve: iterations {info_n.n_iterations}, trimmed "
          f"{int(info_n.n_trimmed)}, cost {c0:.4f} -> {c1:.4f}")
    check(bool(np.isfinite(c1)) and c1 < c0,
          f"no-depth solve did not decrease the cost: {c0} -> {c1}")
    return launches, (w, sel, rig, cfg), {
        "ms_per_solve": statistics.median(dev_ms), "host_ms": host_ms,
        "device_ms": dev_ms, "iterations": i0.n_iterations,
        "host_syncs": i0.n_host_syncs, "final_cost": final}


@contextlib.contextmanager
def counting_syncs():
    """Count the synchronizing operations PyTorch reports (sync debug mode)
    inside the block, by their innermost caller in the port (the warning is
    raised inside the operation's call); yields the Counter."""
    syncs = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            own = [f for f in traceback.extract_stack()
                   if "limo_tpu_torch" in f.filename]
            f = own[-1] if own else None
            syncs[f"{Path(f.filename).name}:{f.lineno}" if f
                  else f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode("default")


def profiled(fn):
    """(result of fn(), profile, wall ms) with ``fn`` under torch.profiler,
    the card synchronized at the end."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return result, prof, wall_ms


def trace_summary(prof, wall_ms, name, per=1):
    """Device operations, busy time and idle share from a trace, the two
    kernels' own launches, and host/device ms per ``limo.*`` range, each
    divided by ``per``; printed, written under chiprun_out/ and returned
    (None if the trace holds no device time). Sums the trace's events in
    one pass: ``key_averages()`` recomputes every operation's device time
    through its children and takes minutes on a fused drive's trace."""
    from torch.autograd import DeviceType
    ops, ranges = {}, {}
    for e in prof.events():
        key = e.name
        if e.device_type == DeviceType.CUDA:
            if not key.startswith("limo."):  # skip ranges' device annotations
                c, ms = ops.get(key, (0, 0.0))
                ops[key] = (c + 1, ms + e.device_time_total / 1e3)
        elif key.startswith("limo."):
            c, host, dev = ranges.get(key, (0, 0.0, 0.0))
            ranges[key] = (c + 1, host + e.cpu_time_total / 1e3,
                           dev + e.device_time_total / 1e3)
    kernels = sorted([(k, c, ms) for k, (c, ms) in ops.items()],
                     key=lambda r: -r[2])
    # each range's host time (incl. nested) and the device time of the
    # operations it launched
    layers = sorted([(k, c, h / per, d / per)
                     for k, (c, h, d) in ranges.items()], key=lambda r: -r[2])
    busy = sum(r[2] for r in kernels)
    OUT.mkdir(exist_ok=True)
    (OUT / f"chip_smoke_profile_{name.replace(' ', '_')}.txt").write_text(
        "device ms | count | device operation\n" + "".join(
            f"{ms:10.4f} | {c:6d} | {k}\n" for k, c, ms in kernels[:40])
        + "host ms | device ms | calls | range\n" + "".join(
            f"{h * per:10.3f} | {d * per:9.4f} | {c:5d} | {k}\n"
            for k, c, h, d in layers))
    if busy == 0:
        print("device time by kernel: not measured (the profiler saw no "
              "device time)")
        return None
    n_ops = sum(r[1] for r in kernels)
    print(f"{name} under the profiler: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, device idle share {1 - busy / wall_ms:.3f}, "
          f"{n_ops} device operations" + (f" ({n_ops / per:.1f} per frame)"
                                          if per > 1 else ""))
    own = {k: [{"count": c, "ms": ms} for key, c, ms in kernels
               if SYMBOL[k] in key] for k in ("assemble_obs", "cost_obs")}
    print(f"the two kernels in this trace: {own}")
    unit = " per frame" if per > 1 else ""
    print(f"  host ms{unit} (incl. nested) | device ms{unit} | calls | layer")
    for key, count, host, dev in layers:
        print(f"  {host:10.3f} | {dev:9.4f} | {count:5d} | {key}")
    print("  device ms | count | top device operations")
    for key, count, ms in kernels[:12]:
        print(f"  {ms:9.4f} | {count:5d} | {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "device_ops": n_ops,
            "per": per, "kernels_in_trace": own,
            "layers": [{"name": k, "count": c, "host_ms": h, "device_ms": d}
                       for k, c, h, d in layers],
            "top": [{"name": k[:120], "count": c, "ms": m}
                    for k, c, m in kernels[:12]]}


def where_time_goes(problem):
    """Phase 5: device time by kernel over one solve, and the host syncs
    PyTorch reports for one solve."""
    w, sel, rig, cfg = problem
    torch.cuda.synchronize()
    with counting_syncs() as syncs:
        solve_trimmed(w, sel, rig, cfg)
    print(f"synchronizing operations in one solve (sync debug mode): "
          f"{sum(syncs.values())}, by caller: {dict(syncs.most_common())}")
    _, prof, wall_ms = profiled(lambda: solve_trimmed(w, sel, rig, cfg))
    summary = trace_summary(prof, wall_ms, "solve")
    return {"profile": summary or "not measured", "syncs": dict(syncs)}


@contextlib.contextmanager
def recording_solves():
    """Record every solve the scan step attempts: yields a list that gets
    (window, selection, (window, selection, SolveInfo)) per solve."""
    calls, inner = [], so.solve_trimmed

    def recorded(w, sel, rig, cfg):
        out = inner(w, sel, rig, cfg)
        calls.append((w, sel, out))
        return out

    so.solve_trimmed = recorded
    try:
        yield calls
    finally:
        so.solve_trimmed = inner


def drive_frames(step, st, xs, frames, timed=False):
    """Run ``step`` over ``frames`` of the channels ``xs``; returns (final
    state, stacked FrameOut, per-frame ms or None). Timed frames end in a
    synchronize, so each time is the frame's wall time."""
    outs, ms = [], []
    for i in frames:
        t0 = time.perf_counter()
        st, out = step(st, tuple(x[i] for x in xs))
        if timed:
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return st, so.FrameOut(*[torch.stack(f) for f in zip(*outs)]), \
        (ms if timed else None)


def drive_counts(out):
    return {"keyframes": int(out.is_keyframe.sum()),
            "attempted": int((out.cost != 0).sum()),
            "accepted": int(out.solved.sum()), "po_ok": int(out.po_ok.sum())}


def to_cpu_f64(t):
    t = t.detach().cpu()
    return t.double() if t.is_floating_point() else t


def against_f64(calls, rig, cfg, final_factor=SCAN_FINAL_FACTOR):
    """Each attempted solve against the port's f64 solve of the same input
    on the CPU; gates the initial cost (SCAN_INITIAL_RTOL) and the final
    cost (finite, below the initial cost, within ``final_factor`` of the
    f64 one)."""
    rig64 = CameraRig(*[to_cpu_f64(x) for x in rig])
    rows = []
    print("  solve | card f32: cost0 -> cost, iterations, trimmed | CPU f64: "
          "cost0 -> cost, iterations, trimmed | rel gap: cost0, after the "
          "first LM iteration, final")
    for j, (w, sel, (_, _, info)) in enumerate(calls):
        w64 = type(w)(*[to_cpu_f64(x) for x in w])
        sel64 = type(sel)(*[to_cpu_f64(x) for x in sel])
        _, _, ref = solve_trimmed(w64, sel64, rig64, cfg)
        c0, c1 = float(info.initial_cost), float(info.final_cost)
        r0, r1 = float(ref.initial_cost), float(ref.final_cost)
        s1, q1 = float(info.cost_trace[0]), float(ref.cost_trace[0])
        gap0, gap_step, gap1 = (abs(c0 - r0) / r0, abs(s1 - q1) / q1,
                                abs(c1 - r1) / r1)
        rows.append({"initial_cost": c0, "final_cost": c1,
                     "iterations": info.n_iterations,
                     "trimmed": int(info.n_trimmed), "f64_initial_cost": r0,
                     "f64_final_cost": r1, "f64_iterations": ref.n_iterations,
                     "f64_trimmed": int(ref.n_trimmed), "rel_gap_initial": gap0,
                     "rel_gap_first_step": gap_step, "rel_gap_final": gap1})
        print(f"  {j:5d} | {c0:.4f} -> {c1:.4f}, {info.n_iterations}, "
              f"{int(info.n_trimmed)} | {r0:.4f} -> {r1:.4f}, "
              f"{ref.n_iterations}, {int(ref.n_trimmed)} | {gap0:.2e}, "
              f"{gap_step:.2e}, {gap1:.2e}")
        check(gap0 <= SCAN_INITIAL_RTOL,
              f"solve {j}: initial cost {c0} vs f64 {r0} (rel {gap0:.2e})")
        check(np.isfinite(c1) and c1 < c0
              and r1 / final_factor <= c1 <= r1 * final_factor,
              f"solve {j}: final cost {c1} vs f64 {r1} (initial {c0})")
    return rows


def states_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.window, b.window)) and \
        all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


def scan_phase(device, card, errs):
    """Phase 6: the scan drive at full width. Returns (scan launches, the
    updated kernel errors, the phase's record)."""
    stamps, uvd, valid, rig, cfg, world = scan_drive(device=device)
    F = len(stamps)
    plan = ba_core.assembly_plan(torch.float32, device, cfg)
    print(f"assembly plan: {plan}; {F} frames, capacity "
          f"{cfg.capacity.max_keyframes} x {cfg.capacity.max_landmarks} x "
          f"{cfg.capacity.max_cameras}, float32")
    check(plan.startswith("cuda["), f"plan {plan} is not the kernel path")
    xs = so.frame_arrays(stamps, uvd, valid, cfg, device=device)

    # pass 1: the timed drive, launches counted from zero
    st0 = so.init_state(cfg.capacity, torch.float32, cfg.prior.default_speed,
                        device)
    step = so.make_scan_step(rig, cfg)
    torch.cuda.synchronize()
    for k in ca.launches:
        ca.launches[k] = 0
    with recording_solves() as calls:
        _, out1, frame_ms = drive_frames(step, st0, xs, range(F),
                                           timed=True)
    launches = dict(ca.launches)
    infos = step.stats.solves
    n_it = sum(i.n_iterations for i in infos)
    n_rounds = sum(i.n_rounds for i in infos)
    counts = drive_counts(out1)
    print(f"launches in the drive: {launches} ({len(infos)} attempted "
          f"solves, LM iterations {n_it}, trim rounds {n_rounds})")
    check(all(launches[k] > 0 for k in launches), f"launches {launches}")
    check(launches["assemble_obs"] == n_it, f"launches {launches}")
    check(launches["cost_obs"] == len(infos) + n_it + n_rounds,
          f"launches {launches}")
    check(counts["attempted"] == len(infos), f"{counts} vs {len(infos)}")
    ate = ate_rmse(world.kitti_gt(), so.poses_kitti(out1))
    solve_ms = [m for m, s in zip(frame_ms, out1.cost != 0) if s]
    other_ms = [m for m, s in zip(frame_ms, out1.cost != 0) if not s]
    syncs_per_frame = step.stats.host_syncs / F
    print(f"{card}: ms per frame median {statistics.median(frame_ms):.3f} "
          f"(frames with a solve {statistics.median(solve_ms):.3f} over "
          f"{len(solve_ms)}, without {statistics.median(other_ms):.3f} over "
          f"{len(other_ms)}); drive {sum(frame_ms):.1f} ms; host syncs per "
          f"frame {syncs_per_frame:.2f} ({step.stats.host_syncs} in {F} "
          f"frames); launches per frame "
          f"{launches['assemble_obs'] / F:.2f} / {launches['cost_obs'] / F:.2f}")
    print(f"counts {counts}, ATE {ate:.4f} m (reference package: {REF_SCAN})")
    check(all(bool(torch.isfinite(f).all()) for f in
              (out1.pose, out1.refined, out1.cost)), "non-finite FrameOut")
    check(tuple(out1.pose.shape) == (F, 7), f"pose shape {out1.pose.shape}")
    check(counts["keyframes"] == REF_SCAN["keyframes"]
          and counts["attempted"] == REF_SCAN["attempted"],
          f"counts {counts} vs the reference's {REF_SCAN}")

    # the kernels on the windows the scan step handed to its first solves
    scan_windows = [(f"scan solve {j} (frame window)", (w, sel, rig, cfg))
                    for j, (w, sel, _) in enumerate(calls[:N_SCAN_CHECK])]
    errs = check_windows(scan_windows, errs)

    print(f"the first {N_SCAN_F64} attempted solves against the port's f64 "
          f"solve on the CPU:")
    solves = against_f64(calls[:N_SCAN_F64], rig, cfg)

    # where the time goes: the first frames under the profiler
    n_prof = min(SCAN_PROFILE_FRAMES, F)
    step3 = so.make_scan_step(rig, cfg)
    (st3, out3, _), prof, wall_ms = profiled(
        lambda: drive_frames(step3, st0, xs, range(n_prof)))
    check(all(torch.equal(a, b[:n_prof]) for a, b in zip(out3, out1)),
          "the profiled frames differ from pass 1")
    trace = trace_summary(prof, wall_ms, f"scan frames 0-{n_prof - 1}",
                          per=n_prof)
    print(f"  ({len(step3.stats.solves)} attempted solves in those frames)")

    mono = mono_accepted(device)
    return launches, errs, {
        "card": card, "frames": F, "counts": counts, "ate_m": ate,
        "reference": REF_SCAN, "ms_per_frame": statistics.median(frame_ms),
        "ms_per_frame_solve": statistics.median(solve_ms),
        "ms_per_frame_no_solve": statistics.median(other_ms),
        "frame_ms": frame_ms, "host_syncs_per_frame": syncs_per_frame,
        "launches": launches, "solves": solves,
        "profile": trace or "not measured",
        "profiled_solves": len(step3.stats.solves), "mono": mono}


def mono_accepted(device):
    """The same world without depth, with external priors, for MONO_FRAMES
    frames: at least one solve accepted, and it moves the window. The host
    syncs of the drive are counted in sync debug mode."""
    stamps, uvd, valid, rig, cfg, world = scan_drive(with_depth=False,
                                                     device=device)
    rng = np.random.default_rng(9)
    priors = np.asarray(world.poses_veh).copy()
    priors[:, 4:] += rng.normal(0, 0.05, priors[:, 4:].shape)
    F = MONO_FRAMES
    xs = so.frame_arrays(stamps[:F], uvd[:F], valid[:F], cfg,
                         priors=priors[:F], device=device)
    st = so.init_state(cfg.capacity, torch.float32, cfg.prior.default_speed,
                       device)
    step = so.make_scan_step(rig, cfg)
    outs, after = [], []
    with recording_solves() as calls, counting_syncs() as syncs:
        for i in range(F):
            after.append((len(calls), st.window.poses))
            st, out = step(st, tuple(x[i] for x in xs))
            after[-1] = (after[-1][0], st.window.poses)
            outs.append(out)
    out = so.FrameOut(*[torch.stack(f) for f in zip(*outs)])
    moved = []
    for (n0, poses), solved in zip(after, out.solved.tolist()):
        if solved:
            w_in, _, (w_out, _, _) = calls[n0]
            moved.append(torch.equal(poses, w_out.poses)
                         and not torch.equal(w_out.poses, w_in.poses))
    counts = drive_counts(out)
    ate = ate_rmse(world.kitti_gt()[:F], so.poses_kitti(out))
    own = sum(syncs.values())
    print(f"mono + external priors, {F} frames: {counts}, ATE {ate:.4f} m "
          f"(reference package: {REF_MONO}); accepted solves whose result "
          f"replaced the window: {sum(moved)} of {len(moved)}; synchronizing "
          f"operations (sync debug mode) {own}, the step's own count "
          f"{step.stats.host_syncs}; by caller {dict(syncs.most_common(8))}")
    check(counts["accepted"] >= 1 and moved and all(moved),
          f"no accepted solve moved the window: {counts}, {moved}")
    return {"counts": counts, "ate_m": ate, "reference": REF_MONO,
            "moved": sum(moved), "syncs": dict(syncs),
            "step_host_syncs": step.stats.host_syncs}


# ---------------------------------------------------------------------------
# Phase 7: the fused drive
# ---------------------------------------------------------------------------

def compare_detect(fc, fh, i):
    """Frame ``i``'s features on the card against the f64 CPU run: matched
    by integer pixel; returns (unmatched features, each with its f64
    response over the frame's k-th response, and the gaps of the matched)."""
    W = 1 << 16
    key = lambda f: (torch.floor(f.uv[i, :, 1].double() + 0.5) * W
                     + torch.floor(f.uv[i, :, 0].double() + 0.5)).long()
    kc, kh = key(fc).cpu(), key(fh).cpu()
    vc, vh = fc.valid[i].cpu(), fh.valid[i].cpu()
    pos_h = {int(k): j for j, k in enumerate(kh) if vh[j]}
    pos_c = {int(k): j for j, k in enumerate(kc) if vc[j]}
    kth = float(fh.response[i][vh].min()) if vh.any() else 0.0
    unmatched = [("card only", int(k), float(fc.response[i, j]) / kth)
                 for k, j in pos_c.items() if k not in pos_h] + \
        [("cpu only", int(k), float(fh.response[i, j]) / kth)
         for k, j in pos_h.items() if k not in pos_c]
    both = [(pos_c[k], pos_h[k]) for k in pos_c if k in pos_h]
    jc = torch.tensor([a for a, _ in both], dtype=torch.long)
    jh = torch.tensor([b for _, b in both], dtype=torch.long)
    gap = lambda a, b: float((a[i].cpu().double()[jc]
                              - b[i].cpu().double()[jh]).abs().max())
    resp = fh.response[i].cpu()[jh].abs().clamp_min(1e-30)
    return unmatched, {
        "features": len(pos_c), "matched": len(both),
        "uv_px": gap(fc.uv, fh.uv), "desc": gap(fc.desc, fh.desc),
        "response_rel": float(((fc.response[i].cpu().double()[jc]
                                - fh.response[i].cpu()[jh]).abs()
                               / resp).max()),
        "rank_moves": int((jc != jh).sum())}


def fused_stage_parity(device, drive):
    """The stages of the drive's first FUSED_PARITY_FRAMES frames on the
    card against the port's f64 run of each stage on the same inputs on the
    CPU (the card's inputs of each stage, cast to f64). Gates at the
    FUSED_STAGE_* tolerances; returns the phase's record."""
    stamps, imgs, clouds, labels, rig, cfg, pcfg, world = drive
    n = FUSED_PARITY_FRAMES
    tcfg = pcfg.tracker
    rig_h = CameraRig(*[to_cpu_f64(x) for x in rig])
    size = world.image_size
    L = cfg.capacity.max_landmarks
    _, xs = next(fused.chunks(stamps[:n], imgs[:n], clouds[:n], pcfg,
                              labels[:n], None, torch.float32, device))
    xs_h = [to_cpu_f64(x) for x in xs]
    rec = {"frames": n, "detect": [], "depth": [], "match": []}

    # detect (batched over the frames) and the labels at the card's features
    inv_gamma = 1.0 / pcfg.gamma
    fc = trk.detect((xs[1].float() / 255.0) ** inv_gamma, tcfg)
    fh = trk.detect((xs_h[1].double() / 255.0) ** inv_gamma, tcfg)
    out_tab = torch.as_tensor(sorted(DEFAULT_OUTLIER_LABELS),
                              dtype=torch.int32)

    def labels_at(li, uv):
        li = li.to(torch.int32)
        return sample_labels(dilate_labels(
            li, torch.isin(li, out_tab.to(li.device))), uv)

    lab_c = labels_at(xs[4], fc.uv)
    lab_h = labels_at(xs_h[4], to_cpu_f64(fc.uv))
    check(torch.equal(lab_c.cpu(), lab_h), "labels differ from the CPU's")
    for i in range(n):
        unmatched, gaps = compare_detect(fc, fh, i)
        rec["detect"].append({"unmatched": unmatched, **gaps})
        print(f"  frame {i} detect: {gaps['features']} features, "
              f"{gaps['matched']} at the CPU's pixels ({gaps['rank_moves']} "
              f"in another rank); max |uv| {gaps['uv_px']:.2e} px, |desc| "
              f"{gaps['desc']:.2e}, response rel {gaps['response_rel']:.2e}; "
              f"unmatched (response / k-th): {unmatched}")
        check(len(unmatched) <= FUSED_STAGE_FLIPS
              and gaps["uv_px"] <= FUSED_STAGE_UV_PX
              and gaps["desc"] <= FUSED_STAGE_DESC
              and gaps["response_rel"] <= FUSED_STAGE_RESPONSE_REL,
              f"frame {i}: detect outside its tolerances")

    # lidar depth and plane, per frame, at the card's features
    frames = [[] for _ in range(8)]
    for i in range(n):
        dc = frontend_depth_plane(xs[2][i], xs[3][i], rig.T_cam_veh[0],
                                  fc.uv[i], rig.focal[0], rig.principal[0],
                                  size, pcfg.lidar, pcfg.use_groundplane,
                                  tuple(pcfg.gp_band))
        dh = frontend_depth_plane(xs_h[2][i], xs_h[3][i], rig_h.T_cam_veh[0],
                                  to_cpu_f64(fc.uv[i]), rig_h.focal[0],
                                  rig_h.principal[0], size, pcfg.lidar,
                                  pcfg.use_groundplane, tuple(pcfg.gp_band))
        d_c, d_h = dc[0].cpu().double(), dh[0]
        flips = torch.nonzero((d_c > 0) != (d_h > 0))[:, 0].tolist()
        both = (d_c > 0) & (d_h > 0)
        d_rel = float(((d_c - d_h).abs() / d_h.abs().clamp_min(1e-9))[both]
                      .max())
        p_c, p_h = dc[1].cpu().double(), dh[1]
        r = {"valid": int((d_h > 0).sum()), "flips": [
            (j, float(d_c[j]), float(d_h[j])) for j in flips],
            "depth_rel": d_rel, "normal": float((p_c[:3] - p_h[:3]).abs().max()),
            "distance_rel": float(abs(p_c[3] - p_h[3]) / abs(p_h[3])),
            "plane_ok": (bool(dc[2]), bool(dh[2]))}
        rec["depth"].append(r)
        print(f"  frame {i} depth: {r['valid']} valid on the CPU, flips "
              f"(feature, card, CPU) {r['flips']}; max depth rel "
              f"{d_rel:.2e}; plane |n| {r['normal']:.2e}, d rel "
              f"{r['distance_rel']:.2e}, ok {r['plane_ok']}")
        check(len(flips) <= FUSED_STAGE_FLIPS
              and d_rel <= FUSED_STAGE_DEPTH_REL
              and r["normal"] <= FUSED_STAGE_NORMAL
              and r["distance_rel"] <= FUSED_STAGE_DEPTH_REL
              and r["plane_ok"][0] == r["plane_ok"][1],
              f"frame {i}: depth or plane outside its tolerances")
        for k, v in enumerate((xs[0][i], fc.uv[i], fc.desc[i], fc.valid[i],
                               dc[0], lab_c[i], dc[1], dc[2])):
            frames[k].append(v)

    # the sequential stages from the card's state: guided match, slots and
    # per-slot channels (slots and channels from the same inputs: exact)
    step = fused.make_fused_step(rig, cfg, pcfg)
    st = fused.init_fused_state(cfg, pcfg, torch.float32, device)
    for i in range(n):
        frame = [f[i] for f in frames]
        st_h = fused.FusedState(so.ScanState(
            type(st.scan.window)(*[to_cpu_f64(x) for x in st.scan.window]),
            *[to_cpu_f64(x) for x in st.scan[1:]]),
            *[to_cpu_f64(x) for x in st[1:]])
        cur = trk.Features(frame[1], torch.zeros_like(frame[4]), frame[2],
                           frame[3])
        cur_h = trk.Features(*[to_cpu_f64(x) for x in cur])
        m = [trk.match(c, trk.Features(s.prev_uv, c.response, s.prev_desc,
                                       s.prev_valid), tcfg,
                       *fused.predict_uv(s, r, tcfg))
             for c, s, r in ((cur, st, rig), (cur_h, st_h, rig_h))]
        pi_c, pi_h = m[0].prev_index.cpu(), m[1].prev_index
        flips = torch.nonzero(pi_c != pi_h)[:, 0].tolist()
        slot_c = fused._assign_slots(m[0].prev_index, st.slot_of_feat,
                                     frame[3], st.scan.window.lm_valid)
        slot_h = fused._assign_slots(pi_c, st_h.slot_of_feat, cur_h.valid,
                                     st_h.scan.window.lm_valid)
        ok_c = frame[3] & (slot_c >= 0)
        uvd_c = torch.cat([frame[1], frame[4][:, None]], -1)
        ch_c = fused._slot_channels(slot_c, ok_c, uvd_c, frame[5], L)
        ch_h = fused._slot_channels(slot_h, to_cpu_f64(ok_c),
                                    to_cpu_f64(uvd_c), frame[5].cpu(), L)
        same = torch.equal(slot_c.cpu(), slot_h) and all(
            torch.equal(to_cpu_f64(a), b) for a, b in zip(ch_c, ch_h))
        rec["match"].append({"matches": int(m[0].n_matches),
                             "cpu_matches": int(m[1].n_matches),
                             "flips": [(j, int(pi_c[j]), int(pi_h[j]))
                                       for j in flips],
                             "slots_and_channels_equal": same})
        print(f"  frame {i} match: {int(m[0].n_matches)} matches (CPU "
              f"{int(m[1].n_matches)}), flips (feature, card, CPU) "
              f"{rec['match'][-1]['flips']}; slots and per-slot channels "
              f"equal: {same}")
        check(len(flips) <= FUSED_STAGE_FLIPS and same,
              f"frame {i}: match, slots or channels differ")
        st, _ = step(st, tuple(frame))
    return rec


def timed_fused(runner, st, drive, chunk, device):
    """``run_fused``'s loop with a synchronize and a clock after each chunk's
    upload, each chunk's front end and each frame's step. Returns (state,
    FusedOut, per-frame step ms, per-chunk (frames, upload ms, front-end
    ms))."""
    stamps, imgs, clouds, labels, rig, cfg, pcfg, world = drive
    outs, frame_ms, chunk_ms = [], [], []
    it = fused.chunks(stamps, imgs, clouds, pcfg, labels, chunk,
                      torch.float32, device)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        if item is None:
            break
        n, xs = item
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = runner.front_end(xs, torch.float32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        chunk_ms.append((n, (t1 - t0) * 1e3, (t2 - t1) * 1e3))
        step_outs = []
        for i in range(len(frames[0])):
            t0 = time.perf_counter()
            st, out = runner.step(st, tuple(f[i] for f in frames))
            torch.cuda.synchronize()
            if i < n:
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            step_outs.append(out)
        outs.append(fused.FusedOut(*[torch.stack(f)[:n]
                                     for f in zip(*step_outs)]))
    return st, fused.FusedOut(*[torch.cat(f) for f in zip(*outs)]), \
        frame_ms, chunk_ms


def fused_counts(out, world):
    F = out.pose.shape[0]
    est = fused.poses_kitti(out)
    gt = world.kitti_gt()[:F]
    drift = kitti_drift(gt, est)
    return {"keyframes": int(out.is_keyframe.sum()),
         "attempted": int((out.cost != 0).sum()),
         "accepted": int(out.solved.sum()), "po_ok": int(out.po_ok.sum()),
         "min_n_tracks": int(out.n_tracks[5:].min()),
         "min_n_matches": int(out.n_matches[5:].min()),
         "min_n_depth": int(out.n_depth[5:].min()),
         "ate_m": ate_rmse(gt, est), "drift_t_percent": drift["t_err_percent"],
         "drift_r_deg_per_m": drift["r_err_deg_per_m"],
         "drift_segments": drift["num_segments"]}


def outs_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def fused_states_equal(a, b):
    return states_equal(a.scan, b.scan) and outs_equal(a[1:], b[1:])


def fused_phase(device, card, errs):
    """Phase 7: the fused drive at full width. Returns (fused launches, the
    updated kernel errors, the phase's record)."""
    t0 = time.perf_counter()
    drive = fused_drive(device=device)
    stamps, imgs, clouds, labels, rig, cfg, pcfg, world = drive
    F = len(stamps)
    render_s = time.perf_counter() - t0
    max_cloud = max(len(c) for c in clouds)
    print(f"{F} frames rendered in {render_s:.1f} s ({imgs.shape[2]} x "
          f"{imgs.shape[1]}, largest cloud {max_cloud} points, capacity "
          f"{pcfg.cloud_capacity}); capacity {cfg.capacity.max_keyframes} x "
          f"{cfg.capacity.max_landmarks} x {cfg.capacity.max_cameras}, "
          f"{pcfg.tracker.max_features} features, float32")
    check(max_cloud <= pcfg.cloud_capacity, "a cloud exceeds the capacity")
    plan = ba_core.assembly_plan(torch.float32, device, cfg)
    check(plan.startswith("cuda["), f"plan {plan} is not the kernel path")

    print(f"stages of frames 0-{FUSED_PARITY_FRAMES - 1} against the port's "
          f"f64 run on the CPU (at {time.perf_counter() - T0:.1f} s):")
    parity = fused_stage_parity(device, drive)

    # pass 1: the timed drive, launches counted from zero
    runner = fused.make_fused_runner(rig, cfg, pcfg, world.image_size, True)
    st0 = fused.init_fused_state(cfg, pcfg, torch.float32, device)
    torch.cuda.synchronize()
    for k in ca.launches:
        ca.launches[k] = 0
    with recording_solves() as calls:
        st1, out1, frame_ms, chunk_ms = timed_fused(runner, st0, drive,
                                                    FUSED_CHUNK, device)
    launches = dict(ca.launches)
    infos = runner.stats.solves
    n_it = sum(i.n_iterations for i in infos)
    n_rounds = sum(i.n_rounds for i in infos)
    counts = fused_counts(out1, world)
    print(f"launches in the drive: {launches} ({len(infos)} solves run, "
          f"LM iterations {n_it}, trim rounds {n_rounds})")
    check(all(launches[k] > 0 for k in launches), f"launches {launches}")
    check(launches["assemble_obs"] == n_it, f"launches {launches}")
    check(launches["cost_obs"] == len(infos) + n_it + n_rounds,
          f"launches {launches}")

    solve = (out1.cost != 0).tolist()
    front = [(up + fe) / n for n, up, fe in chunk_ms for _ in range(n)]
    total = [s + f for s, f in zip(frame_ms, front)]
    pick = lambda xs, want: [x for x, s in zip(xs, solve) if s == want]
    syncs_per_frame = runner.stats.host_syncs / runner.stats.frames
    timing = {
        "ms_per_frame": statistics.median(total),
        "ms_per_frame_solve": statistics.median(pick(total, True)),
        "ms_per_frame_no_solve": statistics.median(pick(total, False)),
        "step_ms_median": statistics.median(frame_ms),
        "front_end_ms_per_chunk": [fe for _, _, fe in chunk_ms],
        "upload_ms_per_chunk": [up for _, up, _ in chunk_ms],
        "front_end_ms_per_frame": sum(fe for _, _, fe in chunk_ms) / F,
        "upload_ms_per_frame": sum(up for _, up, _ in chunk_ms) / F,
        "drive_s": (sum(frame_ms) + sum(up + fe for _, up, fe in chunk_ms))
        / 1e3,
        "host_syncs_per_frame": syncs_per_frame,
        "frame_step_ms": frame_ms}
    print(f"{card}: ms per fused frame median {timing['ms_per_frame']:.3f} "
          f"(frames with a solve {timing['ms_per_frame_solve']:.3f} over "
          f"{sum(solve)}, without {timing['ms_per_frame_no_solve']:.3f}); "
          f"step alone median {timing['step_ms_median']:.3f}; front end "
          f"{timing['front_end_ms_per_frame']:.3f} ms per frame (per chunk "
          f"{[round(x, 1) for x in timing['front_end_ms_per_chunk']]}), "
          f"uploads {timing['upload_ms_per_frame']:.3f} ms per frame; drive "
          f"{timing['drive_s']:.1f} s; host syncs per frame of the step "
          f"{syncs_per_frame:.2f} ({runner.stats.host_syncs} in "
          f"{runner.stats.frames} frames stepped, the last chunk's replays "
          f"included); launches per frame "
          f"{launches['assemble_obs'] / F:.2f} / {launches['cost_obs'] / F:.2f}")
    print(f"counts {counts}")
    print(f"reference package (JAX f32, CPU): {REF_FUSED}")
    check(all(bool(torch.isfinite(f).all()) for f in
              (out1.pose, out1.refined, out1.cost)), "non-finite FusedOut")
    check(tuple(out1.pose.shape) == (F, 7), f"pose shape {out1.pose.shape}")
    check(all(counts[k] > v for k, v in FUSED_STRUCTURE.items()),
          f"structure gates {FUSED_STRUCTURE}: {counts}")
    for key, (lo, hi) in FUSED_BAND.items():
        check(lo * REF_FUSED[key] <= counts[key] <= hi * REF_FUSED[key],
              f"{key} {counts[key]} outside [{lo}, {hi}] x the reference's "
              f"{REF_FUSED[key]}")

    scan_windows = [(f"fused solve {j} (frame window)", (w, sel, rig, cfg))
                    for j, (w, sel, _) in enumerate(calls[:N_SCAN_CHECK])]
    errs = check_windows(scan_windows, errs)
    print(f"the first {FUSED_F64_SOLVES} solves against the port's f64 solve "
          f"on the CPU (at {time.perf_counter() - T0:.1f} s):")
    solves = against_f64(calls[:FUSED_F64_SOLVES], rig, cfg,
                         FUSED_FINAL_FACTOR)

    # pass 2: run_fused, bit-identical to pass 1, its host syncs counted
    print(f"second pass (at {time.perf_counter() - T0:.1f} s)")
    with counting_syncs() as syncs:
        st2, out2 = fused.run_fused(stamps, imgs, clouds, rig, cfg, pcfg,
                                    label_images=labels, chunk=FUSED_CHUNK,
                                    device=device)
        torch.cuda.synchronize()
    check(outs_equal(out1, out2), "two passes of the drive differ (FusedOut)")
    check(fused_states_equal(st1, st2), "two passes differ (FusedState)")
    n_syncs = sum(syncs.values())
    print(f"second pass (run_fused): FusedOut and final FusedState "
          f"bit-identical; synchronizing operations (sync debug mode) "
          f"{n_syncs}, {n_syncs / F:.2f} per frame; by caller "
          f"{dict(syncs.most_common(8))}")

    # chunked against whole: the first FUSED_CHUNK_FRAMES frames
    print(f"chunked against whole (at {time.perf_counter() - T0:.1f} s)")
    nc = FUSED_CHUNK_FRAMES
    part = (stamps[:nc], imgs[:nc], clouds[:nc], rig, cfg, pcfg)
    _, out_a = fused.run_fused(*part, label_images=labels[:nc], device=device)
    _, out_b = fused.run_fused(*part, label_images=labels[:nc], chunk=16,
                               device=device)
    pose_gap = float((out_a.pose - out_b.pose).abs().max())
    first = fused.FusedOut(*[x[:nc] for x in out1])
    print(f"first {nc} frames, chunks of 16 against one chunk: max |pose| "
          f"gap {pose_gap:.3g}, bit-identical {outs_equal(out_a, out_b)}; "
          f"one chunk of {nc} against pass 1 (chunks of {FUSED_CHUNK}): "
          f"bit-identical {outs_equal(out_a, first)}")
    check(pose_gap <= 1e-6
          and torch.equal(out_a.is_keyframe, out_b.is_keyframe)
          and torch.equal(out_a.solved, out_b.solved),
          "chunked and whole runs differ")

    # where the time goes: the first frames under the profiler
    print(f"profile (at {time.perf_counter() - T0:.1f} s)")
    npf = FUSED_PROFILE_FRAMES
    runner3 = fused.make_fused_runner(rig, cfg, pcfg, world.image_size, True)
    (_, out3), prof, wall_ms = profiled(lambda: fused.run_fused(
        stamps[:npf], imgs[:npf], clouds[:npf], rig, cfg, pcfg,
        label_images=labels[:npf], device=device, runner=runner3))
    print(f"  ({len(runner3.stats.solves)} solves in the profiled frames; "
          f"bit-identical to pass 1: "
          f"{outs_equal(out3, fused.FusedOut(*[x[:npf] for x in out1]))})")
    trace = trace_summary(prof, wall_ms, f"fused frames 0-{npf - 1}", per=npf)

    return launches, errs, {
        "card": card, "frames": F, "render_s": render_s,
        "max_cloud": max_cloud, "counts": counts, "reference": REF_FUSED,
        "band": FUSED_BAND, "structure": FUSED_STRUCTURE,
        "stage_parity": parity, **timing,
        "launches": launches, "solves": solves, "syncs": dict(syncs),
        "syncs_per_frame": n_syncs / F, "chunk_pose_gap": pose_gap,
        "profile": trace or "not measured",
        "profiled_solves": len(runner3.stats.solves)}


def main():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is false)")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    run(torch.device("cuda"), card)


def run(device, card):
    """Phases 2-7 on ``device``; prints the result lines."""
    phase("build")
    b = ca.build()
    print(f"built {b.path.name} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())

    phase("kernels against their plain versions")
    records = check_kernels(device)

    phase("main path: trimmed windowed BA, 20x1536 (12x800 used)")
    launches, problem, solve = main_path(device)
    for name, r in records.items():
        r["launches"] = launches[name]

    phase("where the time goes")
    prof = where_time_goes(problem)

    phase("scan drive at full width: 20x1536, 60 frames, f32")
    errs = {k: (r["max_abs_err"], r["max_rel_err"]) for k, r in records.items()}
    scan_launches, errs, scan = scan_phase(device, card, errs)

    phase("fused drive at full width: images + clouds, 200 frames, f32")
    fused_launches, errs, fused_rec = fused_phase(device, card, errs)
    for name, r in records.items():
        r["max_abs_err"], r["max_rel_err"] = errs[name]
        r["scan_launches"] = scan_launches[name]
        r["scan_launches_per_frame"] = scan_launches[name] / scan["frames"]
        r["fused_launches"] = fused_launches[name]
        r["fused_launches_per_frame"] = (fused_launches[name]
                                         / fused_rec["frames"])

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": list(records.values()), "solve": solve,
         "profile": prof, "scan": scan, "fused": fused_rec}, indent=1))
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
