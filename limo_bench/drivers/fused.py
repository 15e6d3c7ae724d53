"""Driver kind ``fused``: the program's fused path, camera images and lidar
scans in, poses out, online: one frame at a time.

The window drives ``limo_tpu_torch.pipeline.fused.make_fused_runner`` (the
front end, then ``make_fused_step``, then ``make_scan_step``) with chunks
of one frame, as an online node takes them: each frame's image, padded
scan and label image are copied from pinned host memory to the card
inside the frame (the program's ``fused.upload``), and each frame's time
is that copy and the runner's call, ending in ``torch.cuda.synchronize()``.
A pass is the cell's drive from ``init_fused_state``; the window runs
whole passes until at least ``--seconds`` have passed. With ``--trace 1``
the window is one pass, the cell's ``trace_frames`` of it under the
profiler.

Set-up loads the drive (``traffic/hdl64.py``; built into the cache on the
first run), permutes each scan's returns by the seed, pads the scans to
the configuration's ``cloud_capacity`` and pins every frame's inputs,
builds the program's configuration from the configuration file and the
kernels, and warms every path the window runs: frames from the initial
state up to and past the first trimmed solve.

``correct`` follows the program frame by frame over the first pass:

- the front end (``reference/frontend.py``, NumPy float64) on every
  solve frame and on frames drawn from the seed, each stage from the
  program's own inputs to it: the features from the image, the labels at
  the program's features, the depths and the ground plane from the scan at
  the program's features, the matches from the program's features and
  previous state;
- the scan step (``follow.judge``) on every solve frame and on tracking
  frames drawn from the seed, from the fused state's scan state and the
  scan step's own input, with the motion-only solve's central differences
  kept on one side of the projection guard (``reference/motion.py``).

Read-only rows report the traffic as the program saw it: returns per
scan, returns dropped at the capacity and by the search's per-cell cap,
features detected, with a depth and matched, frames whose ground plane
held.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import follow, harness
from .. import trace as tr
from ..reference import frontend as ref
from ..reference import motion
from ..traffic import hdl64
from . import scan

# frames past the first solve that the warm-up runs
WARM_AFTER_SOLVE = 2


@dataclass
class System:
    """The program's modules, configurations, camera rig and runner."""

    fu: Any          # pipeline.fused
    so: Any          # pipeline.scan_odometry
    cfg: Any         # LimoConfig
    pcfg: Any        # LimoPipelineConfig
    rig: Any
    runner: Any
    dtype: torch.dtype


class Recorder:
    """What each frame of the first pass handed the fused step, the scan
    step and the matcher, and what the matcher gave, by frame index, while
    ``keep`` is set."""

    def __init__(self):
        self.keep, self.i = False, -1
        self.fused_in, self.scan_in, self.match = {}, {}, {}


def modules():
    from limo_tpu_torch.frontend import tracker as trk
    from limo_tpu_torch.pipeline import fused as fu
    from limo_tpu_torch.pipeline import scan_odometry as so
    return fu, so, trk


@contextlib.contextmanager
def recording(rec: Recorder):
    """The program's fused and scan steps (as the runner builds them) and
    its matcher (as the step calls it), each wrapped to keep its input in
    ``rec``; the program's own functions do the work."""
    fu, so, trk = modules()
    mk_fused, mk_scan, match = fu.make_fused_step, so.make_scan_step, \
        trk.match

    def keeping(make, store):
        def build(*a, **k):
            step = make(*a, **k)

            def wrapped(state, frame):
                if rec.keep:
                    store[rec.i] = frame
                return step(state, frame)
            wrapped.stats = step.stats
            return wrapped
        return build

    def matcher(*a, **k):
        m = match(*a, **k)
        if rec.keep:
            rec.match[rec.i] = m
        return m

    fu.make_fused_step = keeping(mk_fused, rec.fused_in)
    so.make_scan_step = keeping(mk_scan, rec.scan_in)
    trk.match = matcher
    try:
        yield
    finally:
        fu.make_fused_step, so.make_scan_step, trk.match = \
            mk_fused, mk_scan, match


def fixed_values(config):
    """The values the configuration states that the program does not take
    as parameters (the RANSAC plane's, the label dilation's) must be the
    program's own."""
    from limo_tpu_torch.frontend import groundplane, semantics
    gp = inspect.signature(groundplane.estimate_groundplane).parameters
    dil = inspect.signature(semantics.dilate_labels).parameters
    g = config["ground_plane"]
    want = {"hypotheses": (g["hypotheses"], gp["num_hypotheses"].default),
            "inlier_m": (g["inlier_m"], gp["inlier_thres"].default),
            "min_inliers": (g["min_inliers"], gp["min_inliers"].default),
            "label_dilation_half_kernel": (
                config["label_dilation_half_kernel"],
                dil["half_kernel"].default)}
    bad = {k: v for k, v in want.items() if v[0] != v[1]}
    if bad:
        raise SystemExit(f"the configuration states values the program "
                         f"fixes otherwise (stated, program's): {bad}")


def port_system(config, world, device) -> System:
    from limo_tpu_torch import config as config_mod
    from limo_tpu_torch.frontend.lidar_depth import LidarDepthConfig
    from limo_tpu_torch.frontend.tracker import TrackerConfig
    from limo_tpu_torch.geometry.camera import CameraRig
    from limo_tpu_torch.pipeline.full import LimoPipelineConfig
    from limo_tpu_torch.solver import cuda_assemble as ca
    fu, so, _ = modules()
    fixed_values(config)
    ca.build()
    cfg = scan.limo_config(config_mod, config)
    pcfg = LimoPipelineConfig(
        limo=cfg, tracker=TrackerConfig(**config["tracker"]),
        lidar=LidarDepthConfig(**config["lidar"]), gamma=config["gamma"],
        use_groundplane=config["groundplane"],
        gp_band=tuple(config["ground_plane"]["z_band_m"]),
        cloud_capacity=int(config["cloud_capacity"]))
    rig = scan.make_rig(CameraRig, world, torch.float32, device)
    runner = fu.make_fused_runner(
        rig, cfg, pcfg, tuple(config["camera"]["image_size"]), True,
        outlier_labels=frozenset(config["outlier_labels"]))
    return System(fu=fu, so=so, cfg=cfg, pcfg=pcfg, rig=rig, runner=runner,
                  dtype=torch.float32)


def inputs(traffic, config, seed):
    """(stamps, images, label images, scans in the seed's order, returns
    per scan, world, whether the drive was built now)."""
    (stamps, images, labels, points, counts), world, built = hdl64.load(
        traffic["traffic"], config["camera"], config["sensor"])
    return (stamps, images, labels, hdl64.permuted(points, counts, seed),
            counts, world, built)


def host_frames(system, stamps, images, labels, clouds, device):
    """Per frame, the runner's chunk of one frame on the host (pinned where
    the device is a card): (stamp, image, padded scan, its valid mask,
    label image). Returns (frames, padded scans, masks); the returns
    dropped at the capacity go to the runner's ``front_stats``."""
    buf, msk = system.fu.pad_clouds(clouds, system.pcfg.cloud_capacity,
                                    np.float32,
                                    stats=system.runner.front_stats)
    pin = device.type == "cuda"
    host = lambda a: (torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                      if pin else torch.from_numpy(np.ascontiguousarray(a)))
    st32 = np.asarray(stamps, np.float32)
    frames = [tuple(host(a[i:i + 1]) for a in (st32, images, buf, msk,
                                               labels))
              for i in range(len(stamps))]
    return frames, buf, msk


def uploader(system, device):
    return lambda h: tuple(system.fu.upload(list(h), device))


def warm_up(system, frames, st0, upload):
    runner = system.runner
    st, after, n0 = st0, None, len(runner.stats.solves)
    for i, h in enumerate(frames):
        st, _ = runner(st, upload(h))
        if after is None and len(runner.stats.solves) > n0:
            after = i
        if after is not None and i >= after + WARM_AFTER_SOLVE:
            break
    torch.cuda.synchronize()


def measure(system, frames, st0, seconds, trace_range, rec, upload):
    """The window. Returns (frame ms, kinds, window s, first pass: pre-frame
    states [F+1], outputs [F], solve records by frame; matches and poses of
    every frame, the traced frames' (range, counters, summary) or None)."""
    runner = system.runner
    frame_ms, kinds, matches, poses = [], [], [], []
    states, outs, solve_at = [st0], [], {}
    traced = None
    if trace_range is not None:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        a, b = trace_range
    with scan.SolveRecorder(system.so) as srec:
        srec.keep = rec.keep = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = True
        while True:
            st = st0
            for i, h in enumerate(frames):
                if first and trace_range is not None and i == a:
                    prof.start()
                    mark = (time.perf_counter(), runner.stats.frames,
                            runner.stats.host_syncs, len(runner.stats.solves))
                rec.i = i
                n0 = len(runner.stats.solves)
                t = time.perf_counter()
                st, out = runner(st, upload(h))
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
                solved = len(runner.stats.solves) > n0
                kinds.append("solve" if solved else "track")
                matches.append(out.n_matches)
                poses.append(out.pose)
                if first:
                    states.append(st)
                    outs.append(type(out)(*[x[0] for x in out]))
                    if solved:
                        solve_at[i] = len(srec.calls) - 1
                if first and trace_range is not None and i == b - 1:
                    window = time.perf_counter() - mark[0]
                    prof.stop()
                    infos = runner.stats.solves[mark[3]:]
                    traced = ((a, b), {
                        "frames": runner.stats.frames - mark[1],
                        "host_syncs": runner.stats.host_syncs - mark[2],
                        "solves": len(infos),
                        "lm_iterations": sum(x.n_iterations for x in infos)},
                        window)
            srec.keep = rec.keep = False
            first = False
            if trace_range is not None or \
                    time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    if traced is not None:
        traced = traced[:2] + (tr.summarize(prof, traced[2]),)
    return (frame_ms, kinds, window_s, states, outs,
            {i: srec.calls[j] for i, j in solve_at.items()}, matches, poses,
            traced)


def traffic_rows(counts, before, after, matches):
    """The read-only rows of the traffic as the program saw it, from the
    runner's ``front_stats`` read before and after the window."""
    frames = len(matches)
    n = after["frames"] - before["frames"]
    d = {k: after[k] - before[k] for k in
         ("cell_overflow", "detected", "with_depth", "plane_ok")}
    return {"returns_mean": float(np.mean(counts)),
            "returns_min": float(np.min(counts)),
            "matched_per_frame": float(torch.cat(matches).sum()) / frames,
            "dropped_at_capacity": float(after["cloud_overflow"]),
            "dropped_by_cell_cap": float(d["cell_overflow"]),
            "features_per_frame": d["detected"] / n,
            "depth_features_per_frame": d["with_depth"] / n,
            "plane_ok_frames": float(d["plane_ok"]),
            "frames_counted": float(n)}


def run(cell, traffic, config, seed, seconds, trace, device,
        t_process) -> harness.Record:
    t = time.perf_counter()
    stamps, images, labels, clouds, counts, world, built = inputs(
        traffic, config, seed)
    t_inputs = time.perf_counter() - t
    rec = Recorder()
    with recording(rec):
        system = port_system(config, world, device)
        t_system = time.perf_counter() - t - t_inputs
        frames, buf, msk = host_frames(system, stamps, images, labels,
                                       clouds, device)
        upload = uploader(system, device)
        st0 = system.fu.init_fused_state(system.cfg, system.pcfg,
                                         system.dtype, device)
        t = time.perf_counter()
        warm_up(system, frames, st0, upload)
        setup_s = time.perf_counter() - t_process
        print(f"set-up {setup_s:.3f} s: inputs {t_inputs:.3f} s"
              f"{' (built now)' if built else ''}, program and kernels "
              f"{t_system:.3f} s, warm-up {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        trace_range = (tuple(traffic["traffic"]["trace_frames"]) if trace
                       else None)
        before = system.runner.front_stats.read()
        (frame_ms, kinds, window_s, states, outs, solves, matches, poses,
         traced) = measure(system, frames, st0, seconds, trace_range, rec,
                           upload)
        after = system.runner.front_stats.read()
    rows = traffic_rows(counts, before, after, matches)
    failed = int((~torch.isfinite(torch.cat(poses)).all(dim=1)).sum())
    memory_peak = torch.cuda.max_memory_allocated(device)
    if traced is None:
        record = harness.Record(
            frame_ms=frame_ms, frame_kind=kinds, window_s=window_s,
            setup_s=setup_s, memory_peak_bytes=memory_peak, failed=failed,
            counters={"frames": len(frame_ms),
                      "solves": kinds.count("solve"), **rows})
    else:
        (a, b), tcount, summary = traced
        record = harness.Record(
            frame_ms=frame_ms[a:b], frame_kind=kinds[a:b],
            window_s=summary["window_s"] if summary else 0.0,
            setup_s=setup_s, memory_peak_bytes=memory_peak, failed=failed,
            counters={**rows, **tcount},
            solves=scan.solve_rows(solves, range(a, b)), trace=summary)
    host_np = (np.asarray(stamps, np.float32), images, labels, buf, msk)
    record.compare = lambda: compare(
        config, world, host_np, seed, frame_ms, kinds, states, outs, solves,
        rec, rows, traffic["limits"], traffic["compare"])
    return record


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def front_frames(seed, kinds, n):
    """The first pass's frames whose front end is judged: every solve
    frame and ``n`` more drawn from the seed."""
    rng = np.random.default_rng([seed, 0xF2E0])
    solve = [i for i, k in enumerate(kinds) if k == "solve"]
    track = [i for i, k in enumerate(kinds) if k == "track"]
    drawn = rng.choice(track, size=min(n, len(track)), replace=False)
    return sorted(set(solve) | {int(i) for i in drawn})


def judge_front(frames, config, cam, host_np, states, rec):
    """The front end's numbers over ``frames``."""
    _, images, labels, buf, msk = host_np
    tcfg, lcfg = config["tracker"], config["lidar"]
    size = tuple(config["camera"]["image_size"])
    n = dict.fromkeys(("feature_flips", "uv_px", "desc_err", "match_flips",
                       "label_flips", "depth_flips", "depth_rel",
                       "plane_deg", "plane_m", "depth_ambiguous"), 0.0)
    rel = []
    for i in frames:
        (_, uv, desc, valid, d, lab, plane, plane_ok) = (
            _np(x) for x in rec.fused_in[i])
        valid, plane_ok = valid.astype(bool), bool(plane_ok)
        feats = ref.detect(ref.gamma(images[i], config["gamma"]), tcfg)
        flips, uv_px, desc_err = ref.compare_features(feats, uv, valid, desc)
        n["feature_flips"] += flips
        n["uv_px"] = max(n["uv_px"], uv_px)
        n["desc_err"] = max(n["desc_err"], desc_err)
        lab_r = ref.labels(labels[i], uv, config["outlier_labels"],
                           config["label_dilation_half_kernel"])
        n["label_flips"] += float(np.sum((lab_r != lab)[valid]))
        d_r, amb, (nrm, dv, pok) = ref.depths(
            buf[i], msk[i], uv, cam, size, lcfg, config["ground_plane"],
            config["groundplane"])
        judged = valid & ~amb
        n["depth_ambiguous"] += float(np.sum(valid & amb))
        n["depth_flips"] += float(np.sum(((d > 0) != (d_r > 0)) & judged))
        both = judged & (d > 0) & (d_r > 0)
        gap = np.abs(d[both] - d_r[both]) / d_r[both]
        rel += list(gap)
        # each frame's median: a depth whose neighbours float32 rounds
        # differently (a ground inlier at the threshold) moves alone
        if len(gap):
            n["depth_rel"] = max(n["depth_rel"], float(np.median(gap)))
        if pok != plane_ok:
            n["plane_deg"] = 180.0
        elif pok:
            cosang = float(np.clip(np.dot(plane[:3], nrm)
                                   / np.linalg.norm(plane[:3]), -1, 1))
            n["plane_deg"] = max(n["plane_deg"],
                                 float(np.degrees(np.arccos(cosang))))
            n["plane_m"] = max(n["plane_m"], abs(float(plane[3]) - dv))
        st = states[i]
        pred, known = ref.predict(_np(st.prev_uv), _np(st.prev_depth),
                                  _np(st.scan.vel), _np(st.prev_matches),
                                  _np(st.scan.n_kf), cam, tcfg)
        m_r = ref.match(uv, desc, valid, _np(st.prev_uv), _np(st.prev_desc),
                        _np(st.prev_valid), pred, known, tcfg)
        n["match_flips"] += float(np.sum(
            m_r != _np(rec.match[i].prev_index)))
    print(f"front end judged on frames {frames}: depths compared "
          f"{len(rel)}, largest relative gap "
          f"{max(rel) if rel else 0.0:.3g}", file=sys.stderr)
    return n


def compare(config, world, host_np, seed, frame_ms, kinds, states, outs,
            solves, rec, rows, limits, sample):
    """Judge the first pass: the front end on every solve frame and on
    ``front_frames`` drawn frames, the scan step (``follow.judge``) on
    every solve frame and ``track_frames`` drawn tracking frames; returns
    (name, value, limit) rows."""
    F = len(outs)
    kinds = kinds[:F]
    cam = scan.reference_camera(world)
    numbers = judge_front(front_frames(seed, kinds, sample["front_frames"]),
                          config, cam, host_np, states, rec)
    picked = follow.sample_frames(seed, kinds, frame_ms[:F], F,
                                  sample["track_frames"])
    uvd = {i: _np(rec.scan_in[i][1]).astype(np.float64) for i in picked}
    valid = {i: _np(rec.scan_in[i][2]) for i in picked}
    with motion.guarded():
        scan_numbers = follow.judge(picked, config["limo"], cam,
                                    (host_np[0], uvd, valid),
                                    [s.scan for s in states], outs, solves)
    scan_numbers["flips"] += follow.start_flips(
        follow.to_np(states[0].scan),
        config["limo"]["prior"]["default_speed"])
    return follow.rows({**scan_numbers, **numbers, **rows}, limits)
