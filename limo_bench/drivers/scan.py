"""Driver kind ``scan``: the program's scan step, frame by frame, over a
dense-track drive that loops from its initial state.

The window drives ``limo_tpu_torch.pipeline.scan_odometry.make_scan_step``
as ``run_sequence`` does: one call per frame, each frame's time its call's
wall time ending in ``torch.cuda.synchronize()``. A pass is the cell's
drive from the initial state; the window runs whole passes until at least
``--seconds`` have passed, so every window holds the same work per frame
whatever the host's speed (a pass's frames differ by far in cost: those
that run a trimmed solve take ~40× the others). With ``--trace 1`` the
window is one pass, the cell's ``trace_frames`` of it under the profiler
(a whole pass traced took too long to read back: PERF.md).

Set-up builds the inputs from the seed (``traffic/scan.py``), the program's
configuration from the configuration file, builds the kernels, and warms
every path the window runs: frames from the initial state up to and past
the first trimmed solve with its trim round (the whole pass where none
solves).

``correct`` follows the program step by step (``follow.py``) over frames
of the first pass drawn from the seed.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import follow, harness
from .. import trace as tr
from ..traffic.scan import world_and_tracks

# frames past the first solve that the warm-up runs
WARM_AFTER_SOLVE = 2


@dataclass
class System:
    """What runs the frames: the program's scan step module, its
    configuration and camera rig."""

    so: Any          # the scan_odometry module
    cfg: Any         # its LimoConfig
    rig: Any         # its CameraRig
    dtype: torch.dtype


def limo_config(config_mod, config: dict):
    """The configuration file's LimoConfig, built with the program's
    classes: every group the file states, field by field."""
    import dataclasses
    cfg = config_mod.LimoConfig(capacity=config_mod.CapacityConfig(
        **config["capacity"]))
    groups = {}
    for group, fields in config["limo"].items():
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()}
        groups[group] = dataclasses.replace(getattr(cfg, group), **fields)
    return dataclasses.replace(cfg, **groups)


def make_rig(rig_cls, world, dtype, device):
    on = lambda a: torch.as_tensor(np.asarray(a)[None], dtype=dtype,
                                   device=device)
    return rig_cls(focal=on(world.focal), principal=on(world.principal),
                   T_cam_veh=on(world.T_cam_veh))


def port_system(config, world, device) -> System:
    from limo_tpu_torch import config as config_mod
    from limo_tpu_torch.geometry.camera import CameraRig
    from limo_tpu_torch.pipeline import scan_odometry as so
    from limo_tpu_torch.solver import cuda_assemble as ca
    ca.build()
    return System(so=so, cfg=limo_config(config_mod, config),
                  rig=make_rig(CameraRig, world, torch.float32, device),
                  dtype=torch.float32)


def reference_camera(world):
    """The reference's camera, from the generator's world."""
    from ..reference.plain import Camera
    return Camera(focal=float(np.asarray(world.focal).reshape(-1)[0]),
                  principal=np.asarray(world.principal, np.float64),
                  T_cam_veh=np.asarray(world.T_cam_veh, np.float64))


def inputs(traffic, config, seed):
    cam = config["camera"]
    t = dict(traffic["traffic"], rows=config["capacity"]["max_landmarks"])
    return world_and_tracks(t, seed, focal=cam["focal"],
                            pp=tuple(cam["principal"]),
                            image_size=tuple(cam["image_size"]),
                            cam_height=cam["height_m"])


def frames_of(system: System, stamps, uvd, valid, device):
    """Per-frame channel tuples on ``device``: float32 stamps (the
    configuration's clock, on both sides), the rest in the system's type."""
    xs = system.so.frame_arrays(stamps, uvd, valid, system.cfg,
                                system.dtype, stamp_dtype=torch.float32,
                                device=device)
    return [tuple(x[i] for x in xs) for i in range(len(stamps))]


class SolveRecorder:
    """Keeps (input window, input selection, output) of each solve the
    step runs while ``keep`` is set; the wrapped call is the program's."""

    def __init__(self, so):
        self.so, self.inner, self.calls, self.keep = so, so.solve_trimmed, \
            [], False

    def __call__(self, w, sel, rig, cfg):
        out = self.inner(w, sel, rig, cfg)
        if self.keep:
            self.calls.append((w, sel, out))
        return out

    def __enter__(self):
        self.so.solve_trimmed = self
        return self

    def __exit__(self, *exc):
        self.so.solve_trimmed = self.inner


def warm_up(system, frames, st0):
    step = system.so.make_scan_step(system.rig, system.cfg)
    st, after = st0, None
    for i, fr in enumerate(frames):
        st, _ = step(st, fr)
        if after is None and step.stats.solves:
            after = i
        if after is not None and i >= after + WARM_AFTER_SOLVE:
            break
    torch.cuda.synchronize()


def measure(system, frames, st0, seconds, trace_range):
    """The window. Returns (frame ms, kinds, window s, first pass: pre-frame
    states [F+1], outputs [F], solve records by frame, outputs of every
    frame, the traced frames' (range, counters, trace summary) or None).
    With ``trace_range`` = (a, b) the window is one pass, frames a to b - 1
    of it under the profiler."""
    step = system.so.make_scan_step(system.rig, system.cfg)
    frame_ms, kinds, outs_all = [], [], []
    states, outs, solve_at = [st0], [], {}
    traced = None
    if trace_range is not None:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        a, b = trace_range
    with SolveRecorder(system.so) as rec:
        rec.keep = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = True
        while True:
            st = st0
            for i, fr in enumerate(frames):
                if first and trace_range is not None and i == a:
                    prof.start()
                    mark = (time.perf_counter(), step.stats.frames,
                            step.stats.host_syncs, len(step.stats.solves))
                n0 = len(step.stats.solves)
                t = time.perf_counter()
                st, out = step(st, fr)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
                solved = len(step.stats.solves) > n0
                kinds.append("solve" if solved else "track")
                outs_all.append(out)
                if first:
                    states.append(st)
                    outs.append(out)
                    if solved:
                        solve_at[i] = len(rec.calls) - 1
                if first and trace_range is not None and i == b - 1:
                    window = time.perf_counter() - mark[0]
                    prof.stop()
                    infos = step.stats.solves[mark[3]:]
                    traced = ((a, b), {
                        "frames": step.stats.frames - mark[1],
                        "host_syncs": step.stats.host_syncs - mark[2],
                        "solves": len(infos),
                        "lm_iterations": sum(x.n_iterations for x in infos)},
                        window)
            rec.keep = False
            first = False
            if trace_range is not None or \
                    time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    if traced is not None:
        traced = traced[:2] + (tr.summarize(prof, traced[2]),)
    return (frame_ms, kinds, window_s, states, outs,
            {i: rec.calls[j] for i, j in solve_at.items()}, outs_all, traced)


def solve_rows(solves, frames):
    """The byte-count inputs of the solves run on ``frames``."""
    rows = []
    for i, (w, sel, (_, _, info)) in sorted(solves.items()):
        if i in frames:
            rows.append({"K": int(w.kf_valid.sum()),
                         "L": int((w.lm_valid & sel.lm_selected).sum()),
                         "C": int(w.C), "iterations": info.n_iterations,
                         "rounds": info.n_rounds})
    return rows


def record_of(frame_ms, kinds, window_s, setup_s, memory_peak, outs_all,
              solves, traced):
    """The run's Record: the whole window's frames, or with a trace the
    traced frames, their counters and solves."""
    poses = torch.stack([o.pose for o in outs_all])
    failed = int((~torch.isfinite(poses).all(dim=1)).sum())
    if traced is None:
        return harness.Record(frame_ms=frame_ms, frame_kind=kinds,
                              window_s=window_s, setup_s=setup_s,
                              memory_peak_bytes=memory_peak, failed=failed)
    (a, b), counters, summary = traced
    return harness.Record(
        frame_ms=frame_ms[a:b], frame_kind=kinds[a:b],
        window_s=summary["window_s"] if summary else 0.0, setup_s=setup_s,
        memory_peak_bytes=memory_peak, failed=failed, counters=counters,
        solves=solve_rows(solves, range(a, b)), trace=summary)


def run(cell, traffic, config, seed, seconds, trace, device,
        t_process) -> harness.Record:
    t = time.perf_counter()
    stamps, uvd, valid, world = inputs(traffic, config, seed)
    t_inputs = time.perf_counter() - t
    system = port_system(config, world, device)
    t_system = time.perf_counter() - t - t_inputs
    frames = frames_of(system, stamps, uvd, valid, device)
    st0 = system.so.init_state(system.cfg.capacity, system.dtype,
                               system.cfg.prior.default_speed, device)
    t = time.perf_counter()
    warm_up(system, frames, st0)
    setup_s = time.perf_counter() - t_process
    print(f"set-up {setup_s:.3f} s: inputs {t_inputs:.3f} s, program and "
          f"kernels {t_system:.3f} s, warm-up {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    trace_range = tuple(traffic["traffic"]["trace_frames"]) if trace else None
    (frame_ms, kinds, window_s, states, outs, solves, outs_all,
     traced) = measure(system, frames, st0, seconds, trace_range)
    record = record_of(frame_ms, kinds, window_s, setup_s,
                       torch.cuda.max_memory_allocated(device), outs_all,
                       solves, traced)
    del outs_all
    record.compare = lambda: compare(
        config, world, (stamps, uvd, valid), seed, frame_ms, states, outs,
        solves, traffic["limits"], traffic["compare"])
    return record


def compare(config, world, inputs_np, seed, frame_ms, states, outs,
            solves, limits, sample):
    """Judge the first pass's sampled frames (``follow.judge``); returns
    (name, value, limit) rows."""
    kinds = ["solve" if i in solves else "track" for i in range(len(outs))]
    stamps, uvd, valid = inputs_np
    numbers = follow.judge(
        follow.sample_frames(seed, kinds, frame_ms, sample["solve_frames"],
                             sample["track_frames"]),
        config["limo"], reference_camera(world),
        (np.asarray(stamps, np.float32), uvd, valid), states, outs, solves)
    numbers["flips"] += follow.start_flips(
        follow.to_np(states[0]), config["limo"]["prior"]["default_speed"])
    return follow.rows(numbers, limits)
