"""``correct`` comes out false in the fused cell when the front end or the
solve is broken underneath.

Each test skips the harness's look for a card and drives the rest of a
``fused.kitti`` run on the CPU (the kernels' plain versions) over a small
cell: the cell's drive cut to a 640 × 193 camera (the focal length and
principal point scaled with it), a 32-beam × 1024-column scan, 12 frames
(one trimmed solve) and every frame's front end judged, with the cell's
limits; the drive is built once per module into a temporary cache. Once
sound, and once for each fault the front end can have: features shifted
0.25 px, descriptors rounded to bfloat16, gamma skipped, a depth search that asks for one neighbour more,
depths × 1.01, the ground plane tilted 0.5°, half of one scan's returns
dropped, labels ignored; and once for each fault of the scan step that
``test_bench_faults.py`` plants in the scan cell: a step that returns its
state unchanged, the motion-only solve over half of the landmarks, the
frame's pose altered where it is produced, and a trimmed solve that
returns its input window, one cut to one Levenberg-Marquardt iteration,
and one that keeps the candidate where its accept test rejects it and the
old window where it accepts.

    python -m pytest limo_bench/tests/test_bench_fused.py -q
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time

import pytest
import torch

from limo_bench import harness
from limo_bench.drivers import fused
from limo_bench.tests.test_bench_faults import _wrap_solve, _wrap_step
from limo_bench.traffic import hdl64

W = 640
FRAMES = 12
SEED = 2**31 + 29


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("hdl64")


def small_cell():
    manifest = harness.load_manifest()
    cell, _, traffic, config = harness.cell_files("fused.kitti", manifest)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    cam = config["camera"]
    s = W / cam["image_size"][0]
    cam.update(focal=cam["focal"] * s,
               principal=[p * s for p in cam["principal"]],
               image_size=[W, int(round(cam["image_size"][1] * s))])
    config["sensor"].update(beams=32, columns=1024)
    traffic["traffic"]["frames"] = FRAMES
    traffic["compare"]["front_frames"] = FRAMES
    return cell, traffic, config


@pytest.fixture
def cpu_run(monkeypatch, cache):
    """Run the small cell's driver on the CPU; returns (correct, compared
    rows) and keeps the run's frame kinds in ``go.kinds``."""
    import limo_tpu_torch.solver.cuda_assemble as ca
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(ca, "build", lambda: None)
    monkeypatch.setattr(hdl64, "CACHE", cache)
    torch.set_num_threads(4)

    def go():
        cell, traffic, config = small_cell()
        record = fused.run(cell=cell, traffic=traffic, config=config,
                           seed=SEED, seconds=0.0, trace=False,
                           device=torch.device("cpu"),
                           t_process=time.perf_counter())
        go.kinds = record.frame_kind
        compared = record.compare()
        line = harness.result_line(record, [], False, compared,
                                   {"platform": "cpu"}, None)
        return line["correct"], compared
    return go


def _failed(compared):
    return [n for n, v, lim in compared if lim is not None and not v <= lim]


def _wrap_depth_plane(monkeypatch, wrap):
    """The lidar front end of every frame, wrapped: ``wrap(fn, call, *a,
    **k)`` with ``call`` its call's number."""
    from limo_tpu_torch.pipeline import fused as fu
    fn = fu.frontend_depth_plane
    calls = [0]

    def wrapped(*a, **k):
        calls[0] += 1
        return wrap(fn, calls[0], *a, **k)
    monkeypatch.setattr(fu, "frontend_depth_plane", wrapped)


def _wrap_runner(monkeypatch, change):
    """The runner built from changed arguments: ``change(args, kwargs)``."""
    from limo_tpu_torch.pipeline import fused as fu
    make = fu.make_fused_runner

    def broken(*a, **k):
        a, k = change(list(a), dict(k))
        return make(*a, **k)
    monkeypatch.setattr(fu, "make_fused_runner", broken)


def test_sound_run_is_correct(cpu_run):
    correct, compared = cpu_run()
    assert "solve" in cpu_run.kinds
    assert correct, compared


def test_motion_only_differences_stay_on_one_side_of_the_guard(
        monkeypatch):
    """A landmark 2e-5 m past the projection guard and 70 m from the
    origin: ``plain``'s step of 1e-6 takes one side of its difference
    across the guard, the guarded reference takes that column at a
    shorter step (a step of 1e-8 as the yardstick: both lie within its
    truncation error), and every other column is ``plain``'s."""
    import numpy as np
    from limo_bench.reference import motion, plain
    cam = plain.Camera(focal=700.0, principal=np.array([600.0, 180.0]),
                       T_cam_veh=np.array([1.0, 0, 0, 0, 0, 0, 0]))
    lm = np.array([[70.0, 0.0, plain.Z_GUARD + 2e-5], [1.0, 2.0, 10.0]])
    uvd = np.array([[600.0, 180.0, 0.0], [660.0, 320.0, 10.0]])
    args = (lm, uvd, np.ones(2, bool), np.ones(2), cam, {})
    pose = np.array([1.0, 0, 0, 0, 0, 0, 0])
    coarse = plain.MotionOnly(*args).jac(pose)
    guarded = motion.GuardedMotionOnly(*args).jac(pose)
    monkeypatch.setattr(plain, "FD_STEP", 1e-8)
    fine = plain.MotionOnly(*args).jac(pose)
    assert np.abs(coarse[0] - fine[0]).max() > 1e-2 * np.abs(fine[0]).max()
    np.testing.assert_allclose(guarded[0], fine[0], rtol=1e-4)
    np.testing.assert_array_equal(guarded[1], coarse[1])


def test_features_shifted(cpu_run, monkeypatch):
    from limo_tpu_torch.frontend import tracker as trk
    detect = trk.detect

    def shifted(*a, **k):
        f = detect(*a, **k)
        return f._replace(uv=f.uv + 0.25)
    monkeypatch.setattr(trk, "detect", shifted)
    correct, compared = cpu_run()
    assert not correct and "uv_px" in _failed(compared), compared


def test_descriptors_in_half_precision(cpu_run, monkeypatch):
    from limo_tpu_torch.frontend import tracker as trk
    detect = trk.detect

    def rounded(*a, **k):
        f = detect(*a, **k)
        return f._replace(desc=f.desc.to(torch.bfloat16).to(f.desc.dtype))
    monkeypatch.setattr(trk, "detect", rounded)
    correct, compared = cpu_run()
    assert not correct and "desc_err" in _failed(compared), compared


def test_gamma_skipped(cpu_run, monkeypatch):
    def no_gamma(a, k):
        a[2] = dataclasses.replace(a[2], gamma=1.0)
        return a, k
    _wrap_runner(monkeypatch, no_gamma)
    correct, compared = cpu_run()
    assert not correct and "feature_flips" in _failed(compared), compared


def test_labels_ignored(cpu_run, monkeypatch):
    def no_labels(a, k):
        a[4] = False
        return a, k
    _wrap_runner(monkeypatch, no_labels)
    correct, compared = cpu_run()
    assert not correct and "label_flips" in _failed(compared), compared


def test_depth_search_asking_one_neighbour_more(cpu_run, monkeypatch):
    def more(a, k):
        lidar = a[2].lidar
        a[2] = dataclasses.replace(a[2], lidar=dataclasses.replace(
            lidar, min_neighbors=lidar.min_neighbors + 1))
        return a, k
    _wrap_runner(monkeypatch, more)
    correct, compared = cpu_run()
    assert not correct and "depth_flips" in _failed(compared), compared


def test_depths_scaled(cpu_run, monkeypatch):
    def scaled(fn, call, *a, **k):
        d, *rest = fn(*a, **k)
        return (torch.where(d > 0, d * 1.01, d), *rest)
    _wrap_depth_plane(monkeypatch, scaled)
    correct, compared = cpu_run()
    assert not correct and "depth_rel" in _failed(compared), compared


def test_plane_tilted(cpu_run, monkeypatch):
    a = math.radians(0.5)

    def tilted(fn, call, *args, **k):
        d, plane, ok, *rest = fn(*args, **k)
        c, s = math.cos(a), math.sin(a)
        n = plane[:3]
        n = torch.stack([n[0], c * n[1] - s * n[2], s * n[1] + c * n[2]])
        return (d, torch.cat([n, plane[3:]]), ok, *rest)
    _wrap_depth_plane(monkeypatch, tilted)
    correct, compared = cpu_run()
    assert not correct and "plane_deg" in _failed(compared), compared


def test_half_of_one_scan_dropped(cpu_run, monkeypatch):
    """Frame 5's scan (stamp 0.5 s) loses every other return on its way
    to the device, in every pass."""
    from limo_tpu_torch.pipeline import fused as fu
    upload = fu.upload

    def halved(arrays, device, dtypes=None):
        out = upload(arrays, device, dtypes)
        if float(arrays[0][0]) == 0.5:
            keep = torch.arange(out[3].shape[-1]) % 2 == 0
            out[3] = out[3] & keep
        return out
    monkeypatch.setattr(fu, "upload", halved)
    correct, compared = cpu_run()
    assert not correct and "depth_rel" in _failed(compared), compared


def test_step_returning_its_state_unchanged(cpu_run, monkeypatch):
    _wrap_step(monkeypatch, lambda step, st, frame: (st, step(st, frame)[1]))
    correct, compared = cpu_run()
    assert not correct and _failed(compared), compared


def test_motion_only_solve_over_half_the_landmarks(cpu_run, monkeypatch):
    from limo_tpu_torch.pipeline import scan_odometry as so
    pose_only = so.pose_only_step

    def broken(prior, lm_pos, obs, obs_mask, lm_mask, *a, **k):
        half = (torch.arange(obs_mask.shape[0]) % 2 == 0)[:, None]
        return pose_only(prior, lm_pos, obs, obs_mask & half, lm_mask, *a,
                         **k)
    monkeypatch.setattr(so, "pose_only_step", broken)
    correct, compared = cpu_run()
    assert not correct and "pose_cost" in _failed(compared), compared


def test_pose_altered_where_it_is_produced(cpu_run, monkeypatch):
    def altered(step, st, frame):
        st2, out = step(st, frame)
        shift = (torch.arange(7) == 4).to(out.pose.dtype) * 1e-2
        return st2, out._replace(pose=out.pose + shift)
    _wrap_step(monkeypatch, altered)
    correct, compared = cpu_run()
    assert not correct and "pose_m" in _failed(compared), compared


def test_solve_returning_its_input_window(cpu_run, monkeypatch):
    def stale(solve, w, sel, rig, cfg):
        _, sel2, info = solve(w, sel, rig, cfg)
        return w, sel2, info
    _wrap_solve(monkeypatch, stale)
    correct, compared = cpu_run()
    assert not correct and "final_rel" in _failed(compared), compared


def test_solve_cut_to_one_iteration(cpu_run, monkeypatch):
    def one(solve, w, sel, rig, cfg):
        cut = dataclasses.replace(
            cfg, robust=dataclasses.replace(cfg.robust,
                                            num_trim_iterations=0),
            solver=dataclasses.replace(cfg.solver, refinement_iterations=1))
        return solve(w, sel, rig, cut)
    _wrap_solve(monkeypatch, one)
    correct, compared = cpu_run()
    assert not correct and "flips" in _failed(compared), compared


def test_solve_keeping_the_window_its_accept_test_rejects(cpu_run,
                                                          monkeypatch):
    from limo_tpu_torch.solver import lm, trimmed
    monkeypatch.setattr(trimmed, "select",
                        lambda accept, cand, old: lm.select(~accept, cand,
                                                            old))
    correct, compared = cpu_run()
    assert not correct and "final_rel" in _failed(compared), compared
