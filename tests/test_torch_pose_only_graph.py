"""The motion-only solve as a captured CUDA graph
(``limo_tpu_torch.solver.pose_only``): when a call replays the graph and
when it runs eagerly, what the graph's cache key holds, and — on a card —
the graph's results against the eager body's, bit for bit.

This file needs neither JAX nor the reference package, so the card's tests
run where only PyTorch is installed (the repository's tests/conftest.py
imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pose_only_graph.py -m gpu
"""

import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

from limo_tpu_torch.entry import scan_drive
from limo_tpu_torch.geometry import pose as pose_ops
from limo_tpu_torch.pipeline import scan_odometry as so
from limo_tpu_torch.solver import pose_only as po

CPU_FRAMES = 8


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _recorded_calls(device, num_frames, monkeypatch):
    """(the scan step's motion-only calls over ``num_frames`` frames of the
    full-width scan drive, as (args, kwargs) with the tensors cloned; rig,
    cfg; the final state and frame outputs of the run)."""
    stamps, uvd, valid, rig, cfg, _ = scan_drive(num_frames=num_frames,
                                                 device=device)
    calls, inner = [], so.pose_only_step

    def record(*args, **kwargs):
        clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
        calls.append(([clone(a) for a in args],
                      {k: clone(v) for k, v in kwargs.items()
                       if k != "stats"}))
        return inner(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(so, "pose_only_step", record)
        final, outs = so.run_sequence(stamps, uvd, valid, rig, cfg,
                                      device=device)
    return calls, rig, cfg, final, outs


def _eager(args, kwargs):
    """The body alone, as an eager call runs it."""
    (pose_prior, lm_pos, obs, obs_mask, lm_mask, rig, cfg) = args
    return po._pose_only(pose_prior, lm_pos, obs, obs_mask, lm_mask, rig,
                         cfg.robust, cfg.solver, kwargs.get("speed_reg"),
                         kwargs.get("max_iters", 4),
                         kwargs.get("compensate_rotation", False),
                         kwargs.get("lm_weight"),
                         kwargs.get("graduated_init", 1.0))


def _with_cfg(args, cfg):
    return list(args[:6]) + [cfg]


def _robust(cfg, **kw):
    return cfg.replace(robust=dataclasses.replace(cfg.robust, **kw))


# ---- on the CPU: every call eager, and the key ---------------------------

@pytest.fixture(scope="module")
def cpu_calls():
    mp = pytest.MonkeyPatch()
    try:
        return _recorded_calls("cpu", CPU_FRAMES, mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("route", ["plain", "rotation-compensated",
                                   "speed regularizer"])
def test_eager_on_the_cpu_and_on_the_func_routes(cpu_calls, route):
    """On the CPU every call runs the body eagerly, with its result, and
    the counter says so; ``graphable`` refuses each route (the
    rotation-compensated and speed rows would run eagerly on a card
    too)."""
    calls = cpu_calls[0]
    args, kwargs = calls[-1]
    kwargs = dict(kwargs)
    if route == "rotation-compensated":
        kwargs["compensate_rotation"] = True
    if route == "speed regularizer":
        prior = args[0]
        kwargs["speed_reg"] = (pose_ops.inverse(prior),
                               torch.tensor([0.2, -0.1, 9.5]),
                               torch.tensor(0.1), torch.tensor(0.5))
    tensors = list(args[:5]) + [kwargs["lm_weight"]] + list(args[5])
    assert not po.graphable(tensors, kwargs.get("compensate_rotation"),
                            kwargs.get("speed_reg"))
    stats = po.PoseOnlyGraphStats()
    got = [po.pose_only_step(*args, **kwargs, stats=stats)
           for _ in range(2)]
    assert (stats.captures, stats.replays, stats.eager) == (0, 0, 2)
    want = _eager(args, kwargs)
    for g in got:
        for a, b in zip(g, want):
            assert torch.equal(a, b)


def test_scan_step_counts_eager_calls_on_the_cpu():
    """A scan step on the CPU runs every motion-only solve eagerly:
    ``step.stats.pose_only`` reads one eager call a frame."""
    stamps, uvd, valid, rig, cfg, _ = scan_drive(num_frames=3, device="cpu")
    step = so.make_scan_step(rig, cfg)
    st = so.init_state(cfg.capacity, torch.float32, cfg.prior.default_speed,
                       "cpu")
    xs = so.frame_arrays(stamps, uvd, valid, cfg, torch.float32,
                         stamp_dtype=st.window.stamps.dtype, device="cpu")
    so._run_frames(step, st, xs)
    assert step.stats.pose_only == po.PoseOnlyGraphStats(eager=3)
    assert step.stats.frames == 3


def _key_of(args, kwargs):
    args, kwargs = list(args), dict(kwargs)
    tensors = list(args[:5]) + ([] if kwargs.get("lm_weight") is None
                                else [kwargs["lm_weight"]]) + list(args[5])
    return po.graph_key(tensors, args[6], kwargs["max_iters"],
                        kwargs["graduated_init"],
                        kwargs.get("lm_weight") is not None)


def _changed(setting, args, kwargs):
    """(args, kwargs) of the call with one baked-in setting changed."""
    args, kwargs = list(args), dict(kwargs)
    cfg = args[6]
    L = args[1].shape[0]
    if setting == "landmarks":
        args[1:5] = [a[:L - 8] for a in args[1:5]]
        kwargs["lm_weight"] = kwargs["lm_weight"][:L - 8]
    elif setting == "cameras":
        args[2:4] = [torch.cat([a, a], 1) for a in args[2:4]]
        args[5] = type(args[5])(*[torch.cat([x, x]) for x in args[5]])
    elif setting == "dtype":
        args[:5] = [a.double() if a.is_floating_point() else a
                    for a in args[:5]]
    elif setting == "strides":
        # the same values, laid out component-major
        args[2] = args[2].permute(2, 1, 0).contiguous().permute(2, 1, 0)
    elif setting == "max_iters":
        kwargs["max_iters"] += 1
    elif setting == "graduated_init":
        kwargs["graduated_init"] = 4.0
    elif setting == "lm_weight":
        kwargs["lm_weight"] = None
    elif setting in ("reprojection_thres", "depth_thres",
                     "reprojection_quantile", "depth_quantile"):
        args[6] = _robust(cfg, **{setting: getattr(cfg.robust, setting) * 0.9})
    elif setting in ("min_residual_groups", "trim_iteration_lm_steps"):
        args[6] = _robust(cfg, **{setting: getattr(cfg.robust, setting) + 1})
    elif setting in ("initial_lambda", "function_tolerance", "lambda_up",
                     "min_lambda"):
        args[6] = cfg.replace(solver=dataclasses.replace(
            cfg.solver, **{setting: getattr(cfg.solver, setting) * 10}))
    elif setting == "max_iterations":
        args[6] = cfg.replace(solver=dataclasses.replace(
            cfg.solver, max_iterations=cfg.solver.max_iterations + 1))
    else:
        raise ValueError(setting)
    return args, kwargs


@pytest.mark.parametrize("setting", [
    "landmarks", "cameras", "dtype", "strides", "max_iters",
    "graduated_init", "lm_weight", "reprojection_thres", "depth_thres",
    "reprojection_quantile", "depth_quantile", "min_residual_groups",
    "trim_iteration_lm_steps", "initial_lambda", "function_tolerance",
    "lambda_up", "min_lambda", "max_iterations"])
def test_graph_key_changes_with_each_baked_in_setting(cpu_calls, setting):
    """Every setting a capture may bake in (shapes, strides, type, loop
    counts, the graduated schedule, any field of the robust and solver
    configurations, read by the body today or not, whether a landmark
    weight is given) changes the key; so a configuration never replays
    another's graph."""
    args, kwargs = cpu_calls[0][-1]
    assert _key_of(*_changed(setting, args, kwargs)) != _key_of(args, kwargs)


def test_graph_key_ignores_values_and_unread_settings(cpu_calls):
    """Another frame's inputs (values only, copied in by a replay) and the
    configuration's parts the body is never given (anything outside
    ``cfg.robust`` and ``cfg.solver``) leave the key as it is."""
    (a1, k1), (a2, k2) = cpu_calls[0][-2:]
    assert not torch.equal(a1[0], a2[0])
    cfg = a2[6]
    a2 = list(a2)
    a2[6] = cfg.replace(prior=dataclasses.replace(
        cfg.prior, default_speed=cfg.prior.default_speed + 1.0))
    assert a2[6] != cfg
    assert _key_of(a1, k1) == _key_of(a2, k2)


# ---- on the card: graphed against eager, bit for bit ---------------------

def _assert_equal(got, want, what):
    for name, a, b in zip(po.PoseOnlyResult._fields, got, want):
        assert torch.equal(a, b), (what, name, a, b)


@pytest.mark.gpu
def test_graph_replays_equal_eager_calls_on_card(cuda, monkeypatch):
    """The scan drive's first 20 motion-only calls (prior and observations
    change every call, the masks with each push, the landmark weights are
    scaled anew each call) through the graph
    against the eager body: every result equal bit for bit when returned,
    and again after the last call (a replay overwrites no earlier result);
    one capture, then replays."""
    calls, *_ = _recorded_calls(cuda, 20, monkeypatch)
    assert len(calls) == 20
    assert all(not torch.equal(calls[i][0][0], calls[i + 1][0][0])
               and not torch.equal(calls[i][0][2], calls[i + 1][0][2])
               for i in range(len(calls) - 1))
    assert any(not torch.equal(calls[i][0][4], calls[i + 1][0][4])
               for i in range(len(calls) - 1))
    monkeypatch.setattr(po._local, "graphs", OrderedDict(), raising=False)
    stats = po.PoseOnlyGraphStats()
    got, want = [], []
    for i, (args, kwargs) in enumerate(calls):
        # a weight of its own each call, beside the drive's
        kwargs = dict(kwargs, lm_weight=kwargs["lm_weight"] * (1 - 0.02 * i))
        want.append(_eager(args, kwargs))
        got.append(po.pose_only_step(*args, **kwargs, stats=stats))
        _assert_equal(got[-1], want[-1], i)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_equal(g, w, ("kept", i))
    assert stats == po.PoseOnlyGraphStats(captures=1, replays=19)


@pytest.mark.gpu
def test_graphs_per_configuration_on_card(cuda, monkeypatch):
    """Two configurations whose Cauchy scales differ, called in turns over
    the same 16 frames: each replays its own graph (two captures), each
    result equal to its own configuration's eager result bit for bit, and
    the two configurations' results differ."""
    calls, _, cfg, _, _ = _recorded_calls(cuda, 16, monkeypatch)
    other = _robust(cfg, reprojection_thres=2.4, depth_thres=0.3)
    monkeypatch.setattr(po._local, "graphs", OrderedDict(), raising=False)
    stats = po.PoseOnlyGraphStats()
    differ = 0
    for i, (args, kwargs) in enumerate(calls):
        outs = []
        for c in (cfg, other):
            a = _with_cfg(args, c)
            want = _eager(a, kwargs)
            got = po.pose_only_step(*a, **kwargs, stats=stats)
            _assert_equal(got, want, (i, c.robust.reprojection_thres))
            outs.append(got)
        differ += not torch.equal(outs[0].pose, outs[1].pose)
    assert stats == po.PoseOnlyGraphStats(captures=2,
                                          replays=2 * len(calls) - 2)
    assert differ > len(calls) // 2


@pytest.mark.gpu
def test_scan_sequence_graphed_equals_eager_on_card(cuda, monkeypatch):
    """20 frames of the scan drive through one scan step with the graph,
    and through one whose motion-only solve runs the eager body: every
    FrameOut field and the final ScanState equal bit for bit; the graphed
    step's counter reads one capture and 19 replays."""
    stamps, uvd, valid, rig, cfg, _ = scan_drive(num_frames=20, device=cuda)
    st0 = so.init_state(cfg.capacity, torch.float32, cfg.prior.default_speed,
                        cuda)
    xs = so.frame_arrays(stamps, uvd, valid, cfg, torch.float32,
                         stamp_dtype=st0.window.stamps.dtype, device=cuda)
    monkeypatch.setattr(po._local, "graphs", OrderedDict(), raising=False)
    step = so.make_scan_step(rig, cfg)
    final_g, outs_g = so._run_frames(step, st0, xs)
    assert step.stats.pose_only == po.PoseOnlyGraphStats(captures=1,
                                                         replays=19)
    with monkeypatch.context() as m:
        m.setattr(so, "pose_only_step",
                  lambda *a, stats=None, **k: _eager(a, k))
        final_e, outs_e = so._run_frames(so.make_scan_step(rig, cfg), st0,
                                         xs)
    for name, a, b in zip(so.FrameOut._fields, outs_g, outs_e):
        assert torch.equal(a, b), name
    for name, a, b in zip(so.ScanState._fields, final_g, final_e):
        if name == "window":
            for wn, x, y in zip(type(a)._fields, a, b):
                assert torch.equal(x, y), (name, wn)
        else:
            assert torch.equal(a, b), name
    assert int(outs_g.solved.sum()) >= 1


@pytest.mark.gpu
def test_no_capture_under_the_profiler_on_card(cuda, monkeypatch):
    """Inside a profiled window a call whose graph is not captured yet runs
    eagerly; once captured (outside it), a profiled call replays it."""
    from torch.profiler import ProfilerActivity, profile
    calls, *_ = _recorded_calls(cuda, 12, monkeypatch)
    args, kwargs = calls[-1]
    monkeypatch.setattr(po._local, "graphs", OrderedDict(), raising=False)
    stats = po.PoseOnlyGraphStats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        po.pose_only_step(*args, **kwargs, stats=stats)
    assert stats == po.PoseOnlyGraphStats(eager=1)
    po.pose_only_step(*args, **kwargs, stats=stats)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = po.pose_only_step(*args, **kwargs, stats=stats)
    assert stats == po.PoseOnlyGraphStats(captures=1, replays=1, eager=1)
    _assert_equal(got, _eager(args, kwargs), "profiled replay")


@pytest.mark.gpu
def test_graph_on_a_fleets_second_card(cuda, monkeypatch):
    """A fleet over two cards runs sequence 1 on the second card while the
    first stays current (``run_fleet`` switches no card), after sequence 0
    captured its graph on the first. The second card's graph is captured
    on that card's own stream, so its replays run: every ``FrameOut``
    field and the final ``ScanState`` of sequence 1 equal bit for bit a
    run of the same 16 frames on the second card with the eager body, and
    the refined pose moves from frame to frame."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    torch.cuda.set_device(cards[0])
    stamps, uvd, valid, rig, cfg, _ = scan_drive(num_frames=16,
                                                 device=cards[0])
    monkeypatch.setattr(po._local, "graphs", OrderedDict(), raising=False)
    two = lambda a: np.stack([np.asarray(a)] * 2)
    final_g, outs_g = so.run_fleet(two(stamps), two(uvd), two(valid), rig,
                                   cfg, devices=cards)
    assert torch.cuda.current_device() == 0
    assert len(po._local.graphs) == 2
    rig1 = type(rig)(*[x.to(cards[1]) for x in rig])
    with monkeypatch.context() as m:
        m.setattr(so, "pose_only_step",
                  lambda *a, stats=None, **k: _eager(a, k))
        final_e, outs_e = so.run_sequence(stamps, uvd, valid, rig1, cfg,
                                          device=cards[1])
    for name, a, b in zip(so.FrameOut._fields, outs_g, outs_e):
        assert torch.equal(a[1], b.to(cards[0])), name
    for name, a, b in zip(so.ScanState._fields, final_g, final_e):
        if name == "window":
            for wn, x, y in zip(type(a)._fields, a, b):
                assert torch.equal(x[1], y.to(cards[0])), (name, wn)
        else:
            assert torch.equal(a[1], b.to(cards[0])), name
    refined = outs_g.refined[1]
    assert all(not torch.equal(refined[i], refined[i + 1])
               for i in range(1, refined.shape[0] - 1))
