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
   host syncs counted; the first 44 frames in one chunk bit-identical to
   the first pass, and in chunks of 16 against one chunk; 10 frames under
   torch.profiler. To keep the script well inside
   its 1200 s limit, phase 6 runs its drive once (its second pass through
   ``run_sequence`` was cut; phase 7's second pass holds the same step to
   bit-identical repeats), solves only its first five windows in f64 and
   profiles 10 frames, not 20, and phase 7 profiles 10 frames, not 20
   (cut when phase 8 came: the script would pass ~950 s on a slow host);
8. the host engine at full width (``entry.kitti_host_drive(60)``: the
   reference package's rendered host-engine gate world, 512 x 192, labels,
   written to a temporary directory in the KITTI layout; ``LimoConfig()``'s
   20 x 1536 x 1, 256 features, groundplane on, f32):
   ``evaluate_kitti_sequence(engine="host")`` frame by frame through
   ``LimoPipeline`` (tracker, lidar depth, labels, the 5-point prior, the
   motion-only solve with rotation compensation, keyframes, push and the
   throttled windowed solve through both kernels), with the launch
   identity over its solves, ms per frame split by whether the frame
   solved and the host syncs per frame (sync debug mode, in the same pass);
   its frames again up to its first windowed solve after frame 5, that
   frame and the one before it (each with a motion-only solve) under
   torch.profiler (a profile of frames 0-9 took ~140 s with its trace's
   parsing, one of frames 5-9 ~120 s);
   the kernels against their plain versions on the windows of its first
   three solves and those solves against the port's f64 solves on the CPU;
   its counts, ATE and drift in a band around the reference package's run
   of the same 60 frames (``REF_HOST``); the 5-point prior of three of its
   frame pairs on the card (f64 and f32) against the port's f64 call on
   the CPU, one call profiled (device time, launches); then
   ``evaluate_kitti_sequence(engine="fused")`` over the same sequence with
   its launch identity;
9. many sequences, the tuning grid and the long drive, each cut in length
   only: ``run_batch`` over two scan drives (``entry.scan_drive``'s world
   and a second seed, 20 x 1536, ``BATCH_FRAMES`` frames each), each
   element bit-identical to ``run_sequence`` of its sequence, the launch
   identity summed over both (``run_batch`` is ``run_fleet`` on one card,
   and a fleet's default devices are every visible card);
   ``run_tuning_grid`` on ``grid_search_fused``'s world
   (12 x 512, labelled vegetation, ``TUNE_FRAMES`` frames) over the
   default point, non-default thresholds (0.10 / 1.0) and a non-default
   shrubbery weight (0.3), each point bit-identical to ``run_sequence``
   under ``apply_point``'s config, both kernels against their plain
   versions on the first window of each non-default point (the loss scales
   reach the kernels as runtime scalars, the shrubbery weight through the
   landmark weights), the ``GridPoint`` metrics; ``evaluate_long_drive``
   at 12 x 768 over ``LONG_FRAMES`` frames (rows reused), with the
   launch identity, ms per frame split by solve, host syncs per frame
   (sync debug mode, in the same pass), the kernels on its first window,
   its first solves against the port's f64 solves on the CPU, and its
   counts, ATE and drift in a band around the reference package's run of
   the same drive (``REF_LONG``);
10. the landmark-sharded solve, the multi-process helpers and the native
   loader: the bench problem's landmarks split over M = 1, 2 and 4 ranks
   sharing the card (``parallel.make_shard_map_solver``; one rank in this
   process, else new processes over ``gloo``; 1536 / M rows each), three
   solves per rank after a warm-up, with the launch identity per rank,
   both kernels against their plain versions on each rank's shard, the
   bench shape on every rank, SolveInfo, poses and planes bit-identical
   across ranks and the gathered trimmed mask equal to phase 4's; ms per
   sharded solve and per LM iteration and the collectives' share of a
   solve's wall time; at M = 4 a data = 2 x model = 2 batched tiny solve
   with equal elements; at M = 2 a fleet of three 12-frame scan drives
   (20 x 1536) over the two processes (``process_local_batch``,
   ``run_fleet``, ``host_local_to_global``), every row on both ranks
   bit-identical to ``run_sequence`` on the card; the port's native
   library (``native/limo_native.cpp``, built with g++) loaded, its reads
   equal to numpy, and phase 8's KITTI reads counted through it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. The profile table and a JSON record of
the run are written under chiprun_out/.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from limo_tpu_torch import window_manager
from limo_tpu_torch.entry import (KITTI_HOST_DRIFT_KW, fused_drive,
                                  kernel_check_windows, kitti_host_drive,
                                  make_problem, scan_drive)
from limo_tpu_torch.frontend import essential
from limo_tpu_torch.frontend import tracker as trk
from limo_tpu_torch.frontend.semantics import dilate_labels, sample_labels
from limo_tpu_torch.geometry.camera import CameraRig
from limo_tpu_torch.io import native_loader
from limo_tpu_torch.parallel import (gather_window, global_mesh,
                                     host_local_to_global, make_mesh,
                                     make_shard_map_solver,
                                     make_sharded_solver, multihost,
                                     process_local_batch, shard_selection,
                                     shard_window, spawn)
from limo_tpu_torch.parallel.multihost import mesh_device
from limo_tpu_torch.pipeline import evaluation, fused
from limo_tpu_torch.pipeline import full as host_full
from limo_tpu_torch.pipeline import odometry as host_odometry
from limo_tpu_torch.pipeline import scan_odometry as so
from limo_tpu_torch.pipeline.full import frontend_depth_plane
from limo_tpu_torch.pipeline.metrics import ate_rmse, kitti_drift
from limo_tpu_torch.solver import ba_core, cuda_assemble as ca
from limo_tpu_torch.solver import solve_trimmed
from limo_tpu_torch.utils import collectives
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
# 10 frames (20 until phase 8 came: its profile and trace parsing took
# 180-280 s of the script)
FUSED_PROFILE_FRAMES = 10
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
# phase 8: the reference package's host engine on entry.kitti_host_drive(60)
# (JAX f32 on the CPU; python scripts/host_drive.py --package reference
# --frames 60)
HOST_FRAMES = 60
REF_HOST = {"keyframes": 17, "solves": 11, "ate_m": 0.3709,
            "drift_t_percent": 2.343, "drift_r_deg_per_m": 0.04779,
            "drift_segments": 4}
# the card's run against REF_HOST: each within [lo, hi] times the
# reference's. The port's f32 run of the same drive on the CPU (4 threads;
# scripts/host_prior_probe.py record --upto 60) made 14 keyframes and 11
# solves, ATE 0.261 m: the 5-point prior's RANSAC winner moves with f32
# rounding and with the nullspace basis the linear algebra returns, so
# the drive is a draw, held to a band
HOST_BAND = {"keyframes": (0.7, 1.4), "solves": (0.6, 1.6),
             "ate_m": (0.0, 5.0), "drift_t_percent": (0.0, 3.0),
             "drift_r_deg_per_m": (0.0, 3.0)}
HOST_CHECK = 3
# the 5-point prior of the frame pairs of these frames, on the card in f64
# and in f32 against the port's f64 call on the CPU: ok equal; the
# rotation, the translation direction (rad) and the inlier set's symmetric
# difference (share of the matches) within these bounds. The nullspace
# basis the card's linear algebra returns moves the RANSAC winner, and f32
# rounding moves it further. Set from the CPU's calls against f64 under
# four random bases (and, in f32, the CPU's own) over the 136 prior calls
# of a 137-frame run (scripts/host_prior_probe.py record --upto 137, then
# spread): largest f64 gaps 1.75e-2 rad, 0.296 rad, 0.23 of the matches;
# f32 4.1e-2 rad, 0.36 of the matches, and a direction within 0.32 rad in
# all but 5 of 680 calls (0.8-2.3 rad off), so the f32 bounds hold 99.3 %
# of its calls
HOST_ESSENTIAL_FRAMES = (15, 30, 45)
HOST_ESSENTIAL_TOL = {"float64": (2e-2, 0.3, 0.25),
                      "float32": (5e-2, 0.4, 0.4)}
# phase 9: many sequences, tuning and the long drive, each cut in length
# only. run_batch over the scan drive's world and a second seed, BATCH_FRAMES
# frames each, at the scan drive's 20 x 1536
BATCH_SEEDS = (3, 8)
BATCH_FRAMES = 12
# run_tuning_grid on grid_search_fused's world (12 x 512, labelled
# vegetation), TUNE_FRAMES frames: the default point, non-default
# thresholds, a non-default shrubbery weight
TUNE_FRAMES = 30
TUNE_GRID = ((0.16, 1.6, 0.9), (0.10, 1.0, 0.9), (0.16, 1.6, 0.3))
# the long drive at 12 x 768 (evaluate_long_drive's defaults), LONG_FRAMES
# frames: rows are reused after 60 frames, and 120 m hold 100 m segments
LONG_FRAMES = 120
LONG_F64_SOLVES = 3
# the reference package's run of that drive (JAX f32 on the CPU; python
# scripts/long_drive_cpu.py --package reference --frames 120); 49 rows
# reused. Other CPU runs of it: the port in f32 32 / 22 / 22, ATE 0.01173 m,
# 0.0193 %; both packages in f64 33 / 23 / 23, ATE 0.01796 m, 0.0391 %,
# 0.000157 deg/m (equal to 1e-12). The band holds that spread with a margin;
# ATE and drift are a few centimetres over two 100 m segments, so their
# bands are ratios up to 5
REF_LONG = {"keyframes": 32, "attempted": 22, "accepted": 22,
            "ate_m": 0.011440, "drift_t_percent": 0.016827,
            "drift_r_deg_per_m": 0.00028324}
LONG_BAND = {"keyframes": (0.85, 1.2), "attempted": (0.75, 1.35),
             "accepted": (0.75, 1.35), "ate_m": (0.0, 5.0),
             "drift_t_percent": (0.0, 5.0), "drift_r_deg_per_m": (0.0, 5.0)}
# phase 10: the bench problem's landmark shards on 1, 2 and 4 ranks sharing
# the card (gloo), SHARD_SOLVES timed solves each; a fleet over 2 processes
SHARD_MODELS = (1, 2, 4)
SHARD_SOLVES = 3
SHARD_TIMEOUT_S = 300
FLEET_SEEDS = (3, 8, 13)
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

    check_launch_identity(f"{N_SOLVES} solves", launches,
                          [r[2] for r in results])
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
    return launches, (w, sel, rig, cfg), s0.lm_selected.cpu().numpy(), {
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


@contextlib.contextmanager
def profiled_calls(cls, calls):
    """torch.profiler over the calls of ``cls.process`` numbered ``calls``
    (a range; the first call is 0), the card synchronized at both ends;
    yields a dict that gets the profile ("prof") and its wall ms
    ("wall_ms")."""
    from torch.profiler import ProfilerActivity, profile
    out = {"prof": profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])}
    process, n = cls.process, [0]

    def profiled_process(self, *args, **kw):
        i, n[0] = n[0], n[0] + 1
        if i == calls.start:
            torch.cuda.synchronize()
            out["prof"].start()
            out["t0"] = time.perf_counter()
        r = process(self, *args, **kw)
        if i == calls.stop - 1:
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - out["t0"]) * 1e3
            out["prof"].stop()
        return r

    cls.process = profiled_process
    try:
        yield out
    finally:
        cls.process = process


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


def check_launch_identity(name, launches, infos):
    """Both kernels launched over the solves whose SolveInfos are
    ``infos``: one assembly per LM iteration; one cost evaluation per
    solve (the initial cost), LM iteration and trim round."""
    n_it = sum(i.n_iterations for i in infos)
    n_rounds = sum(i.n_rounds for i in infos)
    print(f"{name}: launches {launches} ({len(infos)} solves, LM iterations "
          f"{n_it}, trim rounds {n_rounds})")
    check(all(launches[k] > 0 for k in launches), f"{name}: {launches}")
    check(launches["assemble_obs"] == n_it, f"{name}: {launches}")
    check(launches["cost_obs"] == len(infos) + n_it + n_rounds,
          f"{name}: {launches}")


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
    counts = drive_counts(out1)
    check_launch_identity("scan drive", launches, infos)
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
    counts = fused_counts(out1, world)
    check_launch_identity("fused drive", launches, infos)

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

    # chunked against whole: the first FUSED_CHUNK_FRAMES frames in one
    # chunk, bit-identical to pass 1 (chunks of FUSED_CHUNK), and in chunks
    # of 16 against it
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
    check(outs_equal(out_a, first),
          f"one chunk of the first {nc} frames differs from pass 1")
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


# ---------------------------------------------------------------------------
# Phase 8: the host engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_host(sync, pipeline_cls=None):
    """Record the host engine's frames (FrameResult, wall ms ending in
    ``sync()``) around ``pipeline_cls.process``. For the port's
    LimoPipeline (the default) also the windowed solves of its
    BundleAdjuster ((window, selection, (window, selection, SolveInfo), rig,
    cfg) each) and the inputs of its 5-point prior calls (frame index, args,
    kwargs); another package's pipeline records frames only."""
    rec = {"frames": [], "solves": [], "priors": []}
    cls = pipeline_cls or host_full.LimoPipeline
    process = cls.process

    def timed_process(self, *args, **kw):
        t0 = time.perf_counter()
        r = process(self, *args, **kw)
        sync()
        rec["frames"].append((r, (time.perf_counter() - t0) * 1e3))
        return r

    patches = [(cls, "process", timed_process)]
    if pipeline_cls is None:
        solve, estimate = (window_manager.solve_trimmed,
                           host_odometry.estimate_essential)

        def recorded_solve(w, sel, rig, cfg):
            out = solve(w, sel, rig, cfg)
            rec["solves"].append((w, sel, out, rig, cfg))
            return out

        def recorded_estimate(*args, **kw):
            rec["priors"].append((len(rec["frames"]), args, kw))
            return estimate(*args, **kw)

        patches += [(window_manager, "solve_trimmed", recorded_solve),
                    (host_odometry, "estimate_essential", recorded_estimate)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield rec
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def essential_gap(ref, got):
    """(rotation angle, translation direction angle, inlier symmetric
    difference) between two EssentialResults."""
    q0, q1 = (to_cpu_f64(r.q).numpy() for r in (ref, got))
    t0, t1 = (to_cpu_f64(r.t).numpy() for r in (ref, got))
    rot = 2 * np.arccos(min(abs(float(np.dot(q0, q1))), 1.0))
    n = np.linalg.norm(t0) * np.linalg.norm(t1)
    tra = float(np.arccos(np.clip(np.dot(t0, t1) / n, -1, 1))) if n else 0.0
    flips = int((ref.inliers.cpu() != got.inliers.cpu()).sum())
    return rot, tra, flips


def host_essential(device, priors):
    """The 5-point prior of HOST_ESSENTIAL_FRAMES' pairs on the card, in f64
    and f32, against the port's f64 call on the CPU; one f32 call timed and
    profiled. Returns the record."""
    rows = []
    picked = [(f, a, k) for f, a, k in priors if f in HOST_ESSENTIAL_FRAMES]
    check(len(picked) == len(HOST_ESSENTIAL_FRAMES),
          f"prior calls at frames {[f for f, _, _ in priors]}")
    print("  frame | matches | ok | inliers f64 CPU / card f64 / card f32 | "
          "card f64: rot, t (rad), flips | card f32: rot, t, flips")
    for frame, args, kw in picked:
        on = lambda dev, dt: [x.to(dev, dt) if x.is_floating_point()
                              else x.to(dev) for x in args]
        ref = essential.estimate_essential(*on("cpu", torch.float64), **kw)
        row = {"frame": frame, "matches": int(args[2].sum()),
               "ok": bool(ref.ok), "n_inliers": int(ref.n_inliers)}
        for name in ("float64", "float32"):
            got = essential.estimate_essential(
                *on(device, getattr(torch, name)), **kw)
            rot, tra, flips = essential_gap(ref, got)
            r_tol, t_tol, f_tol = HOST_ESSENTIAL_TOL[name]
            row[name] = {"ok": bool(got.ok), "n_inliers": int(got.n_inliers),
                         "rot_rad": rot, "t_rad": tra, "flips": flips}
            check(bool(got.ok) == bool(ref.ok) and rot <= r_tol
                  and tra <= t_tol and flips <= f_tol * row["matches"],
                  f"5-point prior, frame {frame}, card {name}: {row[name]} "
                  f"against the CPU's f64 {row}")
        rows.append(row)
        print(f"  {frame:5d} | {row['matches']:7d} | {row['ok']} | "
              f"{row['n_inliers']} / {row['float64']['n_inliers']} / "
              f"{row['float32']['n_inliers']} | "
              + " | ".join(f"{row[n]['rot_rad']:.2e}, {row[n]['t_rad']:.2e}, "
                           f"{row[n]['flips']}" for n in ("float64",
                                                          "float32")))
    _, args, kw = picked[0]
    call = lambda: essential.estimate_essential(*args, **kw)
    ms = events_ms(call, 5, 4)
    _, prof, wall_ms = profiled(call)
    trace = trace_summary(prof, wall_ms, "one estimate_essential")
    return {"pairs": rows, "ms_per_call": ms, "profile":
            trace or "not measured",
            "num_hypotheses": kw.get("num_hypotheses")}


def host_phase(device, card, errs):
    """Phase 8: the host engine at full width. Returns (host launches, the
    updated kernel errors, the phase's record)."""
    F = HOST_FRAMES
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "seq")
        t0 = time.perf_counter()
        gt, pcfg = kitti_host_drive(F, root)
        write_s = time.perf_counter() - t0
        cfg = pcfg.limo
        plan = ba_core.assembly_plan(torch.float32, device, cfg)
        check(plan.startswith("cuda["), f"plan {plan} is not the kernel path")
        print(f"{F} frames written in {write_s:.1f} s (512 x 192, labels); "
              f"capacity {cfg.capacity.max_keyframes} x "
              f"{cfg.capacity.max_landmarks} x {cfg.capacity.max_cameras}, "
              f"{pcfg.tracker.max_features} features, float32")

        torch.cuda.synchronize()
        for k in ca.launches:
            ca.launches[k] = 0
        t0 = time.perf_counter()
        with recording_host(torch.cuda.synchronize) as rec, \
                counting_syncs() as syncs:
            rep = evaluation.evaluate_kitti_sequence(
                root, str(Path(tmp) / "host.txt"), gt, cfg=pcfg,
                drift_kw=KITTI_HOST_DRIFT_KW, device=device)
        drive_s = time.perf_counter() - t0
        launches = dict(ca.launches)
        infos = [out[2] for _, _, out, _, _ in rec["solves"]]
        check_launch_identity("host drive", launches, infos)

        results = [r for r, _ in rec["frames"]]
        frame_ms = [m for _, m in rec["frames"]]
        solved = [r.solved for r in results]
        pick = lambda want: [m for m, s in zip(frame_ms, solved) if s == want]
        n_syncs = sum(syncs.values())
        counts = {"keyframes": sum(r.is_keyframe for r in results),
                  "solves": sum(solved), "ate_m": rep.ate,
                  "drift_t_percent": rep.drift["t_err_percent"],
                  "drift_r_deg_per_m": rep.drift["r_err_deg_per_m"],
                  "drift_segments": rep.drift["num_segments"]}
        timing = {
            "ms_per_frame": statistics.median(frame_ms),
            "ms_per_frame_solve": statistics.median(pick(True)),
            "ms_per_frame_no_solve": statistics.median(pick(False)),
            "drive_s": drive_s, "frame_ms": frame_ms,
            "host_syncs_per_frame": n_syncs / F}
        print(f"{card}: ms per host-engine frame median "
              f"{timing['ms_per_frame']:.3f} (frames with a solve "
              f"{timing['ms_per_frame_solve']:.3f} over {sum(solved)}, "
              f"without {timing['ms_per_frame_no_solve']:.3f}); drive "
              f"{drive_s:.1f} s incl. loading; host syncs per frame "
              f"{n_syncs / F:.2f} (sync debug mode, counted in this pass); by "
              f"caller {dict(syncs.most_common(8))}; launches per frame "
              f"{launches['assemble_obs'] / F:.2f} / "
              f"{launches['cost_obs'] / F:.2f}")
        print(f"counts {counts}")
        print(f"reference package (JAX f32, CPU): {REF_HOST}")
        check(len(results) == F and rep.n_frames == F, "frames missing")
        check(all(np.all(np.isfinite(r.pose)) for r in results),
              "non-finite pose")
        for key, (lo, hi) in HOST_BAND.items():
            check(lo * REF_HOST[key] <= counts[key] <= hi * REF_HOST[key],
                  f"{key} {counts[key]} outside [{lo}, {hi}] x the "
                  f"reference's {REF_HOST[key]}")

        windows = [(f"host solve {j} (frame window)", (w, sel, rig, c))
                   for j, (w, sel, _, rig, c) in
                   enumerate(rec["solves"][:HOST_CHECK])]
        errs = check_windows(windows, errs)
        print(f"the first {HOST_CHECK} solves against the port's f64 solve "
              f"on the CPU (at {time.perf_counter() - T0:.1f} s):")
        calls = [(w, sel, out) for w, sel, out, _, _ in
                 rec["solves"][:HOST_CHECK]]
        solves = against_f64(calls, rec["solves"][0][3], rec["solves"][0][4])

        # where the time goes: the drive's first frames again, the frame of
        # its first windowed solve after frame 5 (one keyframe until frame 5,
        # so that frame also runs a motion-only solve) and the frame before
        # it under the profiler. Parsing a trace takes ~0.9 s per thousand
        # device operations: frames 5-9 (129k) took 118 s, frames 0-9 142 s
        f = next(i for i, r in enumerate(results) if r.solved and i >= 6)
        npf = range(f - 1, f + 1)
        name = f"host frames {npf.start}-{npf.stop - 1}"
        print(f"profile of {name} (at {time.perf_counter() - T0:.1f} s)")
        with profiled_calls(host_full.LimoPipeline, npf) as p, \
                recording_host(torch.cuda.synchronize) as rec3:
            evaluation.evaluate_kitti_sequence(
                root, str(Path(tmp) / "prof.txt"), gt, cfg=pcfg,
                max_frames=npf.stop, device=device)
        same = all(np.array_equal(a.pose, b.pose) for (a, _), (b, _) in
                   zip(rec3["frames"], rec["frames"]))
        print(f"  ({sum(rec3['frames'][i][0].solved for i in npf)} solves in "
              f"the profiled frames; poses bit-identical to the drive's: "
              f"{same})")
        trace = trace_summary(p["prof"], p["wall_ms"], name, per=len(npf))

        print(f"the 5-point prior on three frame pairs (at "
              f"{time.perf_counter() - T0:.1f} s):")
        prior = host_essential(device, rec["priors"])
        print(f"  one estimate_essential ({prior['num_hypotheses']} "
              f"hypotheses, f32): {prior['ms_per_call']:.3f} ms (CUDA events)")

        print(f"the fused engine over the same sequence (at "
              f"{time.perf_counter() - T0:.1f} s)")
        for k in ca.launches:
            ca.launches[k] = 0
        with recording_solves() as fused_calls:
            frep = evaluation.evaluate_kitti_sequence(
                root, str(Path(tmp) / "fused.txt"), gt, cfg=pcfg,
                drift_kw=KITTI_HOST_DRIFT_KW, engine="fused", device=device)
        fused_launches = dict(ca.launches)
        print(f"fused engine: ATE {frep.ate:.4f} m, drift {frep.drift}, "
              f"{frep.fps:.2f} frames/s")
        check(frep.n_frames == F and np.isfinite(frep.ate), "fused engine")
        check_launch_identity("fused engine", fused_launches,
                              [out[2] for _, _, out in fused_calls])
    return launches, errs, {
        "card": card, "frames": F, "write_s": write_s, "counts": counts,
        "reference": REF_HOST, "band": HOST_BAND, **timing,
        "launches": launches, "syncs": dict(syncs), "solves": solves,
        "profile": trace or "not measured", "essential": prior,
        "fused": {"ate_m": frep.ate, "drift": frep.drift, "fps": frep.fps,
                  "launches": fused_launches, "solves": len(fused_calls)}}


# ---------------------------------------------------------------------------
# Phase 9: many sequences, the tuning grid and the long drive
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_scan_steps():
    """Time every frame of every scan step made inside the block (each
    frame ends in a synchronize): yields a list that gets (wall ms,
    FrameOut) per frame."""
    frames, make = [], so.make_scan_step

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(st, frame):
            t0 = time.perf_counter()
            st, out = step(st, frame)
            torch.cuda.synchronize()
            frames.append(((time.perf_counter() - t0) * 1e3, out))
            return st, out

        timed.stats = step.stats
        return timed

    so.make_scan_step = timed_make
    try:
        yield frames
    finally:
        so.make_scan_step = make


def counted(fn):
    """(fn(), kernel launches it made): the counts set to 0 just before and
    read just after."""
    torch.cuda.synchronize()
    for k in ca.launches:
        ca.launches[k] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ca.launches)


def trees_equal(a, b):
    """Two (nested) named tuples of tensors equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))


def element(tree, b):
    if isinstance(tree, torch.Tensor):
        return tree[b]
    items = [element(x, b) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def batch_check(device):
    """run_batch over two scan sequences: each element bit for bit
    run_sequence of its sequence, the launch identity summed over both.
    run_batch is run_fleet on one card, so a second fleet run would
    compare the code with itself; the fleet's default devices are checked
    to be every visible card."""
    drives = [scan_drive(BATCH_FRAMES, seed=s, device=device)
              for s in BATCH_SEEDS]
    rig, cfg = drives[0][3], drives[0][4]
    check(all(trees_equal(d[3], rig) for d in drives), "rigs differ")
    sb, ub, vb = (np.stack([d[i] for d in drives]) for i in range(3))
    t0 = time.perf_counter()
    with recording_solves() as calls:
        batch, launches = counted(lambda: so.run_batch(sb, ub, vb, rig, cfg,
                                                       device=device))
    batch_s = time.perf_counter() - t0
    check_launch_identity("run_batch", launches,
                          [out[2] for _, _, out in calls])
    for b in range(len(BATCH_SEEDS)):
        one = so.run_sequence(sb[b], ub[b], vb[b], rig, cfg, device=device)
        check(trees_equal(element(batch, b), one),
              f"run_batch element {b} != run_sequence of sequence {b}")
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    check(so.fleet_devices() == cards, "a fleet's default devices are not "
          "every visible card")
    counts = [drive_counts(element(batch[1], b))
              for b in range(len(BATCH_SEEDS))]
    fps = len(BATCH_SEEDS) * BATCH_FRAMES / batch_s
    print(f"run_batch over seeds {BATCH_SEEDS}, {BATCH_FRAMES} frames each "
          f"(20 x 1536): {counts}; each element bit-identical to "
          f"run_sequence; fleet devices {cards}; "
          f"{batch_s:.1f} s, aggregate {fps:.2f} frames/s")
    return {"seeds": BATCH_SEEDS, "frames": BATCH_FRAMES, "counts": counts,
            "launches": launches, "solves": len(calls), "seconds": batch_s,
            "frames_per_s": fps}


def tuning_check(device, errs):
    """run_tuning_grid on grid_search_fused's world: each point bit for
    bit run_sequence under apply_point's config, both kernels against
    their plain versions on the first window of each non-default point,
    the launch identity, the GridPoint metrics. Returns (record, errs)."""
    from limo_tpu_torch.pipeline import tuning
    world, stamps, uvd, valid, labels, cfg = tuning.fused_grid_world(
        TUNE_FRAMES)
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1], T_cam_veh=world.T_cam_veh,
                           device=device)
    t0 = time.perf_counter()
    with recording_solves() as calls:
        (_, outs), launches = counted(lambda: so.run_tuning_grid(
            stamps, uvd, valid, rig, cfg, np.asarray(TUNE_GRID),
            labels=labels, device=device))
    grid_s = time.perf_counter() - t0
    check_launch_identity("run_tuning_grid", launches,
                          [out[2] for _, _, out in calls])
    default = (cfg.robust.depth_thres, cfg.robust.reprojection_thres,
               cfg.regularization.shrubbery_weight)
    gt = world.kitti_gt()
    points = []
    for g, row in enumerate(TUNE_GRID):
        pcfg = tuning.apply_point(cfg, *row)
        with recording_solves() as pcalls:
            _, one = so.run_sequence(stamps, uvd, valid, rig, pcfg,
                                     labels=labels, device=device)
        check(trees_equal(element(outs, g), one),
              f"grid point {row} != run_sequence under apply_point")
        if tuple(row) != default:
            w, sel, _ = pcalls[0]
            errs = check_windows([(f"grid point {row} first window",
                                   (w, sel, rig, pcfg))], errs)
        est = so.poses_kitti(one)
        drift = kitti_drift(gt, est, lengths=(20.0, 30.0), step=5)
        points.append(tuning.GridPoint(*row, ate=ate_rmse(gt, est),
                                       drift_t=drift["t_err_percent"],
                                       drift_r=drift["r_err_deg_per_m"]))
        print(f"  {points[-1].to_json()}")
    print(f"run_tuning_grid: {len(TUNE_GRID)} points, {TUNE_FRAMES} frames "
          f"(12 x 512), each bit-identical to run_sequence under "
          f"apply_point; {grid_s:.1f} s, {len(TUNE_GRID) / grid_s:.3f} "
          f"points/s")
    return {"grid": TUNE_GRID, "frames": TUNE_FRAMES,
            "points": [json.loads(p.to_json()) for p in points],
            "launches": launches, "seconds": grid_s,
            "points_per_s": len(TUNE_GRID) / grid_s}, errs


def long_check(device, card, errs):
    """evaluate_long_drive at 12 x 768: kernels on its first window, its
    first solves against f64, rows reused, the band around REF_LONG, ms
    per frame, host syncs per frame, the launch identity. Returns (launches,
    errs, record)."""
    t0 = time.perf_counter()
    with recording_solves() as calls, timed_scan_steps() as frames, \
            counting_syncs() as syncs:
        rep, launches = counted(lambda: evaluation.evaluate_long_drive(
            num_frames=LONG_FRAMES, device=device))
    drive_s = time.perf_counter() - t0
    check_launch_identity("long drive", launches,
                          [out[2] for _, _, out in calls])
    # the drive's inputs again (rows reused) and its rig and config
    cfg = evaluation._long_drive_config(768)
    world, _, _, valid, _ = evaluation._long_drive_inputs(
        LONG_FRAMES, 10.0, 768, 0, 4.0, 1.0, cfg)
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1], T_cam_veh=world.T_cam_veh,
                           device=device)
    frame_ms = [m for m, _ in frames]
    solved = [bool(out.cost != 0) for _, out in frames]
    pick = lambda want: [m for m, s in zip(frame_ms, solved) if s == want]
    n_syncs = sum(syncs.values())
    outs = so.FrameOut(*[torch.stack(f) for f in zip(*[o for _, o in frames])])
    counts = drive_counts(outs)
    starts = (valid[1:] & ~valid[:-1]).sum(axis=0) + valid[0]
    counts.update(rows_reused=int((starts > 1).sum()), ate_m=rep.ate,
                  drift_t_percent=rep.drift["t_err_percent"],
                  drift_r_deg_per_m=rep.drift["r_err_deg_per_m"],
                  drift_segments=rep.drift["num_segments"])
    timing = {"ms_per_frame": statistics.median(frame_ms),
              "ms_per_frame_solve": statistics.median(pick(True)),
              "ms_per_frame_no_solve": statistics.median(pick(False)),
              "drive_s": drive_s, "frame_ms": frame_ms,
              "host_syncs_per_frame": n_syncs / LONG_FRAMES}
    print(f"{card}: ms per long-drive frame median "
          f"{timing['ms_per_frame']:.3f} (frames with a solve "
          f"{timing['ms_per_frame_solve']:.3f} over {sum(solved)}, without "
          f"{timing['ms_per_frame_no_solve']:.3f}); drive {drive_s:.1f} s; "
          f"host syncs per frame {n_syncs / LONG_FRAMES:.2f} (sync debug "
          f"mode; by caller {dict(syncs.most_common(6))}); launches per "
          f"frame {launches['assemble_obs'] / LONG_FRAMES:.2f} / "
          f"{launches['cost_obs'] / LONG_FRAMES:.2f}")
    print(f"counts {counts}")
    print(f"reference package (JAX f32, CPU): {REF_LONG}")
    check(len(frame_ms) == LONG_FRAMES, "frames missing")
    check(bool(torch.isfinite(outs.pose).all()), "non-finite pose")
    check(counts["rows_reused"] > 0, "no row reused")
    for key, (lo, hi) in LONG_BAND.items():
        check(lo <= counts[key] / REF_LONG[key] <= hi,
              f"{key} {counts[key]} outside [{lo}, {hi}] x the reference's "
              f"{REF_LONG[key]}")
    errs = check_windows([("long drive solve 0 (frame window)",
                           (calls[0][0], calls[0][1], rig, cfg))], errs)
    print(f"the first {LONG_F64_SOLVES} solves against the port's f64 solve "
          f"on the CPU:")
    solves = against_f64(calls[:LONG_F64_SOLVES], rig, cfg)
    return launches, errs, {
        "card": card, "frames": LONG_FRAMES, "counts": counts,
        "reference": REF_LONG, "band": LONG_BAND, **timing,
        "launches": launches, "syncs": dict(syncs), "solves": solves,
        "fps": rep.fps}


def many_phase(device, card, errs):
    """Phase 9. Returns (long-drive launches, the updated kernel errors,
    the phase's record)."""
    batch = batch_check(device)
    print(f"(at {time.perf_counter() - T0:.1f} s)")
    tune, errs = tuning_check(device, errs)
    print(f"(at {time.perf_counter() - T0:.1f} s)")
    launches, errs, long = long_check(device, card, errs)
    return launches, errs, {"batch": batch, "tuning": tune, "long": long}


# ---------------------------------------------------------------------------
# Phase 10: the landmark-sharded solve, the multi-process helpers and the
# native loader.
# ---------------------------------------------------------------------------

def rank_solves(model, device_type):
    """In one rank of a ``model``-rank run on the card: the bench problem's
    landmark shard (1536 / model rows) solved SHARD_SOLVES times after one
    warm-up, each through both kernels with its launch identity checked;
    both kernels against their plain versions on the shard's first window.
    Returns the rank's record (numpy and Python values)."""
    mesh = make_mesh(model, data=1, device_type=device_type)
    device = mesh_device(mesh)
    w, sel, rig, cfg = make_problem(20, 1536, 12, 800, torch.float32,
                                    seed=1, device="cpu")
    ws, ss = shard_window(w, mesh), shard_selection(sel, mesh)
    solve = make_shard_map_solver(mesh, rig, cfg)
    solve(ws, ss)                                      # warm-up
    ms, coll_s, coll_calls, infos = [], [], [], []
    launches = {k: 0 for k in ca.launches}
    for _ in range(SHARD_SOLVES):
        dist.barrier()
        collectives.stats.update(calls=0, seconds=0.0)
        t0 = time.perf_counter()
        (out_w, out_s, info), counts = counted(lambda: solve(ws, ss))
        ms.append((time.perf_counter() - t0) * 1e3)
        coll_s.append(collectives.stats["seconds"])
        coll_calls.append(collectives.stats["calls"])
        infos.append(info)
        launches = {k: launches[k] + counts[k] for k in launches}
    rank = dist.get_rank()
    check_launch_identity(f"M={model} rank {rank}", launches, infos)
    for a, b in zip(infos, infos[1:]):
        check(torch.equal(a.final_cost, b.final_cost)
              and a.n_iterations == b.n_iterations,
              f"M={model} rank {rank}: repeated solves differ")
    rig_d = type(rig)(*[x.to(device) for x in rig])
    errs = check_windows(
        [(f"M={model} rank {rank} shard ({ws.L} landmarks)",
          (ws, ss, rig_d, cfg))],
        {"assemble_obs": (0.0, 0.0), "cost_obs": (0.0, 0.0)})
    info = infos[-1]
    return {"rank": rank, "model": model, "rows": ws.L, "ms": ms,
            "collective_s": coll_s, "collective_calls": coll_calls,
            "launches": launches, "errs": errs,
            "info": {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                     for k, v in info._asdict().items()},
            "poses": out_w.poses.cpu().numpy(),
            "planes": out_w.planes.cpu().numpy(),
            "selected": out_s.lm_selected.cpu().numpy()}


def rank_tiny_batched(device_type):
    """data = 2 x model = 2: two equal tiny windows, one per data group;
    returns their initial and final costs."""
    mesh = make_mesh(4, data=2, device_type=device_type)
    w, sel, rig, cfg = make_problem(5, 64, 5, 24, torch.float32,
                                    device="cpu")
    two = lambda t: type(t)(*[torch.stack([x, x]) for x in t])
    out_w, _, info = make_sharded_solver(mesh, rig, cfg)(
        shard_window(two(w), mesh, batched=True),
        shard_selection(two(sel), mesh, batched=True))
    full = gather_window(out_w, mesh, batched=True)
    check(all(torch.equal(x[0], x[1]) for x in full),
          "tiny batched solve: the two elements differ")
    check(bool(torch.isfinite(full.poses).all()
               and (info.final_cost < info.initial_cost).all()),
          "tiny batched solve: no decrease")
    return {"final_cost": info.final_cost.cpu().numpy(),
            "initial_cost": info.initial_cost.cpu().numpy()}


def rank_fleet(device_type):
    """A fleet of FLEET_SEEDS scan drives over the ranks (data axis): this
    rank's rows loaded and run here, the batch gathered on every rank."""
    mesh = global_mesh(data=dist.get_world_size(), model=1,
                       devices=device_type)
    device = mesh_device(mesh)
    B = len(FLEET_SEEDS)
    start, stop, total = process_local_batch(B, mesh)
    drives = [scan_drive(BATCH_FRAMES, seed=FLEET_SEEDS[i % B],
                         device=device) for i in range(start, stop)]
    rig, cfg = drives[0][3], drives[0][4]
    final, frames = so.run_fleet(
        *[np.stack([d[i] for d in drives]) for i in range(3)], rig, cfg,
        devices=[device])
    window, frames = host_local_to_global((final.window, frames), mesh)
    return {"rows": (start, stop, total),
            "window": [x.cpu().numpy() for x in window],
            "frames": [x.cpu().numpy() for x in frames]}


def sharded_rank(model, device_type):
    """Phase 10's work in each of ``model`` ranks sharing the card."""
    if device_type == "cuda":
        ca.build()           # the parent's build: loaded, not rebuilt
    out = {"solves": rank_solves(model, device_type)}
    if model == 4:
        out["tiny"] = rank_tiny_batched(device_type)
    if model == 2:
        out["fleet"] = rank_fleet(device_type)
    return out


def run_ranks(model, device_type):
    """``sharded_rank`` on ``model`` ranks over gloo: new processes, or
    this one for a single rank (a process group of one)."""
    if model > 1:
        return spawn(sharded_rank, model, "gloo", args=(model, device_type),
                     timeout_s=SHARD_TIMEOUT_S)
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("gloo", f"file://{tmp}/store", 1, 0,
                             timeout_s=SHARD_TIMEOUT_S)
        try:
            return [sharded_rank(1, device_type)]
        finally:
            dist.destroy_process_group()


def check_sharded(model, ranks, single_mask):
    """The ranks of one run: the bench shape on each, the replicated
    results bit-identical across ranks, the gathered trimmed mask equal to
    phase 4's single-card solve. Returns the run's record."""
    recs = [r["solves"] for r in ranks]
    first = recs[0]
    for rec in recs:
        info = rec["info"]
        final = float(info["final_cost"])
        rel = abs(final - REF_FINAL_COST) / REF_FINAL_COST
        check(info["n_rounds"] == 1 and int(info["n_trimmed"]) == REF_TRIMMED
              and rel < 1e-4,
              f"M={model} rank {rec['rank']}: rounds {info['n_rounds']}, "
              f"trimmed {int(info['n_trimmed'])}, cost {final} (rel {rel})")
        for key in ("poses", "planes"):
            check(np.array_equal(rec[key], first[key]),
                  f"M={model}: rank {rec['rank']} {key} != rank 0's")
        for key, value in first["info"].items():
            check(np.array_equal(rec["info"][key], value),
                  f"M={model}: rank {rec['rank']} SolveInfo.{key} != rank 0's")
    mask = np.concatenate([rec["selected"] for rec in recs])
    check(np.array_equal(mask, single_mask),
          f"M={model}: trimmed mask != the single-card solve's "
          f"({int((mask != single_mask).sum())} landmarks differ)")
    ms = statistics.median(m for rec in recs for m in rec["ms"])
    iters = first["info"]["n_iterations"]
    share = statistics.median(c / (m / 1e3) for rec in recs
                              for c, m in zip(rec["collective_s"], rec["ms"]))
    calls = first["collective_calls"][-1]
    per_solve = {k: v / SHARD_SOLVES for k, v in first["launches"].items()}
    print(f"M={model} ({first['rows']} landmark rows per rank, gloo on one "
          f"card): {ms:.3f} ms per sharded solve (median over ranks and "
          f"{SHARD_SOLVES} solves), {iters} LM iterations, {ms / iters:.3f} "
          f"ms per LM iteration; collectives {calls} per solve, "
          f"{share:.3f} of its wall time; launches per solve per rank "
          f"{per_solve}; final cost {float(first['info']['final_cost']):.6f}"
          f"; ranks bit-identical, mask == single-card solve's")
    return {"model": model, "rows_per_rank": first["rows"],
            "ms_per_solve": ms, "iterations": iters,
            "ms_per_iteration": ms / iters, "collective_calls": calls,
            "collective_share": share, "launches_per_solve": per_solve,
            "final_cost": float(first["info"]["final_cost"]),
            "ms_by_rank": [rec["ms"] for rec in recs]}


def check_fleet(device, ranks):
    """The fleet's rows, on every rank, bit for bit run_sequence of their
    drives on the card; the padded row replays the first drive."""
    B = len(FLEET_SEEDS)
    fleets = [r["fleet"] for r in ranks]
    check([f["rows"] for f in fleets] == [(0, 2, 4), (2, 4, 4)],
          f"fleet rows {[f['rows'] for f in fleets]}")
    for seed in FLEET_SEEDS:
        stamps, uvd, valid, rig, cfg, _ = scan_drive(BATCH_FRAMES, seed=seed,
                                                     device=device)
        final, frames = so.run_sequence(stamps, uvd, valid, rig, cfg,
                                        device=device)
        want = [x.cpu().numpy() for x in (*final.window, *frames)]
        for b in [b for b in range(4) if FLEET_SEEDS[b % B] == seed]:
            for r, fleet in enumerate(fleets):
                got = [x[b] for x in (*fleet["window"], *fleet["frames"])]
                check(all(np.array_equal(g, x) for g, x in zip(got, want)),
                      f"fleet row {b} (seed {seed}) on rank {r} != "
                      f"run_sequence")
    print(f"fleet of {B} {BATCH_FRAMES}-frame scan drives (seeds "
          f"{FLEET_SEEDS}, 20 x 1536) over 2 processes: every row, on both "
          f"ranks, bit-identical to run_sequence on the card; the padded "
          f"row replays seed {FLEET_SEEDS[0]}")
    return {"seeds": FLEET_SEEDS, "frames": BATCH_FRAMES, "processes": 2}


def native_check(host_reads):
    """The port's native library built and loaded; its velodyne reads equal
    np.fromfile; phase 8's KITTI reads went through it."""
    t0 = time.perf_counter()
    lib = native_loader.get_lib()
    check(lib is not None, "native library: no g++ on the machine")
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        paths, scans = [], []
        for i in range(3):
            pts = rng.normal(size=(120000 + 1000 * i, 4)).astype(np.float32)
            paths.append(str(Path(tmp) / f"{i:06d}.bin"))
            pts.tofile(paths[-1])
            scans.append(pts)
        for path, pts in zip(paths, scans):
            check(np.array_equal(native_loader.read_velodyne(path),
                                 np.fromfile(path, np.float32).reshape(-1, 4)),
                  "native read_velodyne != np.fromfile")
        batch, counts = native_loader.read_velodyne_batch(paths, 125000)
        check(all(np.array_equal(batch[i, :counts[i]], scans[i])
                  for i in range(3)), "native batch read != numpy")
    check(host_reads["numpy"] == 0 and host_reads["native"] >= HOST_FRAMES,
          f"phase 8's KITTI reads: {host_reads}")
    print(f"native library {native_loader.library_path().name} (loaded in "
          f"{load_s:.3f} s after phase 8 built it): read_velodyne and "
          f"read_velodyne_batch equal numpy; phase 8 read {host_reads['native']}"
          f" scans through it, {host_reads['numpy']} through numpy")
    return {"library": native_loader.library_path().name,
            "phase8_reads": dict(host_reads)}


def sharded_phase(device, single_mask, host_reads, errs):
    """Phase 10. Returns (the updated kernel errors, per-rank launches per
    solve by model, the phase's record)."""
    native = native_check(host_reads)
    runs, launches = {}, {}
    for model in SHARD_MODELS:
        t0 = time.perf_counter()
        ranks = run_ranks(model, device.type)
        runs[model] = check_sharded(model, ranks, single_mask)
        runs[model]["seconds"] = time.perf_counter() - t0
        launches[model] = runs[model]["launches_per_solve"]
        for r in ranks:
            errs = {k: tuple(map(max, errs[k], r["solves"]["errs"][k]))
                    for k in errs}
        if model == 4:
            tiny = ranks[0]["tiny"]
            check(all(np.array_equal(r["tiny"]["final_cost"],
                                     tiny["final_cost"]) for r in ranks),
                  "tiny batched solve: data groups differ")
            print(f"data = 2 x model = 2 batched tiny solve: elements "
                  f"bit-identical, cost {tiny['initial_cost']} -> "
                  f"{tiny['final_cost']}")
        if model == 2:
            runs["fleet"] = check_fleet(device, ranks)
        print(f"(at {time.perf_counter() - T0:.1f} s)")
    return errs, launches, {"native": native, "runs": runs}


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
    """Phases 2-10 on ``device``; prints the result lines."""
    phase("build")
    b = ca.build()
    print(f"built {b.path.name} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())

    phase("kernels against their plain versions")
    records = check_kernels(device)

    phase("main path: trimmed windowed BA, 20x1536 (12x800 used)")
    launches, problem, single_mask, solve = main_path(device)
    for name, r in records.items():
        r["launches"] = launches[name]

    phase("where the time goes")
    prof = where_time_goes(problem)

    phase("scan drive at full width: 20x1536, 60 frames, f32")
    errs = {k: (r["max_abs_err"], r["max_rel_err"]) for k, r in records.items()}
    scan_launches, errs, scan = scan_phase(device, card, errs)

    phase("fused drive at full width: images + clouds, 200 frames, f32")
    fused_launches, errs, fused_rec = fused_phase(device, card, errs)

    phase(f"host engine at full width: KITTI layout on disk, {HOST_FRAMES} "
          f"frames, f32")
    native_loader.reads.update(native=0, numpy=0)
    host_launches, errs, host_rec = host_phase(device, card, errs)
    host_reads = dict(native_loader.reads)

    phase("many sequences, the tuning grid and the long drive on the card")
    long_launches, errs, many_rec = many_phase(device, card, errs)

    phase("the landmark-sharded solve on ranks sharing the card (gloo), the "
          "multi-process helpers, the native loader")
    errs, sharded_launches, sharded_rec = sharded_phase(
        device, single_mask, host_reads, errs)
    for name, r in records.items():
        r["max_abs_err"], r["max_rel_err"] = errs[name]
        r["scan_launches"] = scan_launches[name]
        r["scan_launches_per_frame"] = scan_launches[name] / scan["frames"]
        r["fused_launches"] = fused_launches[name]
        r["fused_launches_per_frame"] = (fused_launches[name]
                                         / fused_rec["frames"])
        r["host_launches"] = host_launches[name]
        r["host_launches_per_frame"] = host_launches[name] / host_rec["frames"]
        r["long_launches"] = long_launches[name]
        r["long_launches_per_frame"] = long_launches[name] / LONG_FRAMES
        r["batch_launches"] = many_rec["batch"]["launches"][name]
        r["tuning_launches"] = many_rec["tuning"]["launches"][name]
        r["sharded_launches_per_solve_per_rank"] = {
            m: sharded_launches[m][name] for m in SHARD_MODELS}

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": list(records.values()), "solve": solve,
         "profile": prof, "scan": scan, "fused": fused_rec,
         "host": host_rec, "many": many_rec, "sharded": sharded_rec},
        indent=1))
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
