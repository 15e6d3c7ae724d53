"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU (the kernels' plain versions; a scan drive cut to a few frames
so that a test run holds it, with the cell's limits): once sound, and once
for each fault the scan cells can have: a step that returns its state
unchanged; the motion-only solve over half of the landmarks; the frame's
pose altered where it is produced; a trimmed solve that returns its input
window, one cut to one Levenberg-Marquardt iteration, and one that keeps
the candidate where its accept test rejects it and the old window where
it accepts. (There is no exchange between cards to leave out: every cell
runs on one.)

    python -m pytest limo_bench/tests/test_bench_faults.py -q
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from limo_bench import harness
from limo_bench.drivers import scan

FRAMES = 14        # three trimmed solves
SEED = 2**31 + 17


@pytest.fixture
def cpu_run(monkeypatch):
    """Run the scan.drive cell's driver on the CPU over FRAMES frames;
    returns (correct, compared rows)."""
    import limo_tpu_torch.solver.cuda_assemble as ca
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(ca, "build", lambda: None)
    torch.set_num_threads(4)

    def go():
        manifest = harness.load_manifest()
        cell, _, traffic, config = harness.cell_files("scan.drive", manifest)
        traffic = dict(traffic, traffic=dict(traffic["traffic"],
                                             frames=FRAMES))
        record = scan.run(cell=cell, traffic=traffic, config=config,
                          seed=SEED, seconds=0.0, trace=False,
                          device=torch.device("cpu"),
                          t_process=time.perf_counter())
        compared = record.compare()
        line = harness.result_line(record, [], False, compared,
                                   {"platform": "cpu"}, None)
        return line["correct"], compared
    return go


def _failed(compared):
    return [n for n, v, lim in compared if lim is not None and not v <= lim]


def _wrap_step(monkeypatch, wrap):
    """Every scan step the run makes, wrapped: ``wrap(step, st, frame)``."""
    from limo_tpu_torch.pipeline import scan_odometry as so
    make = so.make_scan_step

    def broken(*a, **k):
        step = make(*a, **k)

        def wrapped(st, frame):
            return wrap(step, st, frame)
        wrapped.stats = step.stats
        return wrapped
    monkeypatch.setattr(so, "make_scan_step", broken)


def _wrap_solve(monkeypatch, wrap):
    """The trimmed solve, wrapped: ``wrap(solve, w, sel, rig, cfg)``."""
    from limo_tpu_torch.pipeline import scan_odometry as so
    solve = so.solve_trimmed
    monkeypatch.setattr(so, "solve_trimmed",
                        lambda *a, **k: wrap(solve, *a, **k))


def test_sound_run_is_correct(cpu_run):
    correct, compared = cpu_run()
    assert correct, compared


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
