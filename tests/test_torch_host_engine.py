"""The host engine's front end and window manager in the port against the
reference package's, in float64 on the CPU.

- ``FeatureTracker`` and ``MulticamFeatureTracker`` on rendered frames of
  test_fused.py's world: the tracklets exactly (the reference tracks in
  float32 whatever its caller's type; here both packages detect and match
  in float64 on the same float32-rounded images, the reference through its
  own ``_detect_and_match`` given a float64 image);
- ``attach_labels`` and ``select_keyframes``: exactly;
- ``BundleAdjuster`` on test_window_manager.py's cases: every host mirror
  after ``push``, ``update_labels`` and ``deactivate_keyframes`` exactly;
  ``build_selection``, ``adjust_pose_only`` (rotation compensation on, as
  the host engine runs it) and ``solve`` from the same state: poses,
  landmarks and the solve's costs within 1e-9 relative, selection and
  categories exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.config import CapacityConfig, LimoConfig
from limo_tpu.frontend import semantics as jsem
from limo_tpu.frontend import tracker as jtr
from limo_tpu.pipeline.tracklets import Tracklets as JTracklets
from limo_tpu.selection import keyframe as jkf
from limo_tpu.window_manager import (FIX_NONE, FIX_POSE, BundleAdjuster,
                                     NotEnoughKeyframesException)
from limo_tpu_torch import state as tstate
from limo_tpu_torch.frontend import semantics as tsem
from limo_tpu_torch.frontend import tracker as ttr
from limo_tpu_torch.selection import keyframe as tkf
from limo_tpu_torch.window_manager import \
    NotEnoughKeyframesException as TNotEnough
from test_window_manager import RIG, make_sequence, project_tracklets
from torch_parity import fused_world

N_FRAMES = 5
TRACKLET_FIELDS = ("stamps", "uvd", "mask", "ids", "age", "is_outlier",
                   "label")
BA_RTOL = 1e-9


@pytest.fixture(scope="module")
def frames():
    """Gamma-corrected rendered frames (float32-rounded), label images,
    tracker config."""
    _, stamps, imgs, _, labels, _, pcfg, _ = fused_world(N_FRAMES)
    gamma = ((imgs.astype(np.float64) / 255.0) ** (1.0 / 1.2)).astype(
        np.float32)
    return stamps, gamma, labels, pcfg.tracker


@pytest.fixture
def f64_reference_tracker(monkeypatch):
    """The reference's detect + match in float64 (its tracker casts every
    image to float32 first; the images here are float32 values)."""
    inner = jtr._detect_and_match
    monkeypatch.setattr(
        jtr, "_detect_and_match",
        lambda img, prev, cfg, has_prev: inner(img.astype(jnp.float64), prev,
                                               cfg, has_prev))


def depth_of(uv):
    """A depth hook: smooth in the pixel position, none in the left third."""
    u, v = uv[:, 0], uv[:, 1]
    return (u > 100) * (5.0 + 0.01 * u + 0.02 * v) - (u <= 100) * 1.0


def assert_tracklets_equal(port, ref, where=""):
    for f in TRACKLET_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f"{where} {f}")


def run_trackers(frames, window=None):
    stamps, imgs, _, tcfg = frames
    ref = jtr.FeatureTracker(tcfg)
    port = ttr.FeatureTracker(tcfg, device="cpu", dtype=torch.float64)
    for i in range(N_FRAMES):
        ref.process(stamps[i], imgs[i], depth_fn=lambda uv: np.asarray(
            depth_of(np.asarray(uv))))
        port.process(stamps[i], imgs[i], depth_fn=depth_of)
        assert_tracklets_equal(port.tracklets(window), ref.tracklets(window),
                               f"frame {i}")
    return ref, port


def test_feature_tracker(frames, f64_reference_tracker):
    ref, port = run_trackers(frames)
    tl = port.tracklets()
    assert tl.mask[:, 0].sum() > 100 and (tl.mask.sum(1) >= 3).sum() > 50
    assert (tl.uvd[..., 2] > 0).any() and (tl.uvd[..., 2] == -1.0).any()
    # the handed-over tracker continues as the reference does
    stamps, imgs, _, _ = frames
    cont = tstate.feature_tracker_from_numpy(ref, "cpu", torch.float64)
    ref.process(stamps[-1] + 0.1, imgs[-1][:, ::-1].copy())
    cont.process(stamps[-1] + 0.1, imgs[-1][:, ::-1].copy())
    assert_tracklets_equal(cont.tracklets(8), ref.tracklets(8), "handed over")


def test_multicam_feature_tracker(frames, f64_reference_tracker):
    stamps, imgs, _, tcfg = frames
    ref = jtr.MulticamFeatureTracker(2, tcfg)
    port = ttr.MulticamFeatureTracker(2, tcfg, device="cpu",
                                      dtype=torch.float64)
    for i in range(3):
        cams = [imgs[i], np.ascontiguousarray(imgs[i][:, ::-1])]
        ref.process(stamps[i], cams)
        port.process(stamps[i], cams)
    (tl_r, cam_r), (tl_p, cam_p) = ref.tracklets(), port.tracklets()
    assert_tracklets_equal(tl_p, tl_r, "multicam")
    assert cam_p == cam_r and set(cam_p.values()) == {0, 1}


def test_attach_labels(frames, f64_reference_tracker):
    _, port = run_trackers(frames)
    _, _, labels, _ = frames
    tl = port.tracklets()
    ref_tl = JTracklets(**{f: getattr(tl, f) for f in TRACKLET_FIELDS})
    for lab in (labels[-1], labels[0]):
        ref = jsem.attach_labels(ref_tl, lab)
        got = tsem.attach_labels(tl, lab, device="cpu")
        assert_tracklets_equal(got, ref, "labels")
        assert len(set(got.label[tl.mask[:, 0]].tolist())) >= 3


@pytest.mark.parametrize("seed,has_last", [(0, True), (1, False), (2, True)])
def test_select_keyframes(seed, has_last):
    """Burst keyframe selection over 24 frames: flows around the rejection
    threshold, rotations around the selection threshold, irregular
    stamps."""
    rng = np.random.default_rng(seed)
    F_, R = 24, 48
    stamps = np.cumsum(rng.uniform(0.02, 0.3, F_))
    uvs = rng.uniform(0, 600, (F_, R, 2))
    drift = np.cumsum(rng.uniform(0, 6.0, F_))
    uvs = uvs[:1] + drift[:, None, None] * rng.normal(0, 1, (1, R, 2))
    valid = rng.uniform(size=(F_, R)) > 0.2
    ang = np.cumsum(rng.uniform(0, 0.04, F_))
    quats = np.stack([np.cos(ang / 2), np.zeros(F_), np.sin(ang / 2),
                      np.zeros(F_)], 1)
    last = (uvs[0] + rng.normal(0, 2, (R, 2)), valid[0],
            np.array([1.0, 0, 0, 0]), stamps[0] - 0.2)
    cfg = LimoConfig()
    ref = jkf.select_keyframes(
        *(jnp.asarray(x) for x in (stamps, uvs, valid, quats) + last),
        jnp.asarray(has_last), cfg)
    port = tkf.select_keyframes(
        *(torch.from_numpy(np.asarray(x)) for x in
          (stamps, uvs, valid, quats) + last), has_last, cfg)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert 0 < int(port.sum()) < F_


# ---------------------------------------------------------------------------
# BundleAdjuster: test_window_manager.py's cases, both packages
# ---------------------------------------------------------------------------

def small_config(**window):
    cfg = LimoConfig(capacity=CapacityConfig(max_keyframes=8,
                                             max_landmarks=128))
    if window:
        cfg = dataclasses.replace(
            cfg, window=dataclasses.replace(cfg.window, **window))
    return cfg


def assert_ba_equal(port, ref, where=""):
    """Every host mirror and bookkeeping field exactly."""
    for k in tstate.BUNDLE_ADJUSTER_STATE:
        a, b = getattr(port, k), getattr(ref, k)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")
        elif isinstance(b, dict):
            assert a.keys() == b.keys(), (where, k)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key],
                                              err_msg=f"{where} {k}")
        else:
            assert a == b, (where, k)


def both_adjusters(cfg, n_kf, with_depth=False, perturb=None):
    """Both packages' adjusters fed the same pushes of a projected drive."""
    poses, lms, stamps = make_sequence(n_kf, with_depth=with_depth)
    ref = BundleAdjuster(RIG, cfg, jnp.float64)
    port = tstate.bundle_adjuster_from_numpy(ref, "cpu")
    for k in range(n_kf):
        tl = project_tracklets(poses[: k + 1], lms, stamps[: k + 1],
                               with_depth=with_depth)
        p = np.asarray(poses[k], float).copy()
        if perturb is not None and k >= 2:
            p[4:] += perturb[k]
        fix = FIX_POSE if k == 0 else FIX_NONE
        ref.push(stamps[k], tl, p, fix)
        port.push(stamps[k], tl, p, fix)
        assert_ba_equal(port, ref, f"push {k}")
    return ref, port, tl


@pytest.mark.parametrize("with_depth", [False, True])
def test_push_and_labels(with_depth):
    ref, port, tl = both_adjusters(small_config(), 3, with_depth)
    assert port.num_keyframes == 3 and port._lm_known.sum() > 50
    lab = tl.label.copy()
    lab[:3] = [26, 21, 7]
    flags = tl.is_outlier.copy()
    flags[5] = True
    tl2 = JTracklets(stamps=tl.stamps, uvd=tl.uvd, mask=tl.mask, ids=tl.ids,
                     age=tl.age, is_outlier=flags, label=lab)
    ref.update_labels(tl2, shrubbery_weight=0.9)
    port.update_labels(tl2, shrubbery_weight=0.9)
    assert_ba_equal(port, ref, "update_labels")
    assert port._lm_outlier.sum() == 2 and port._lm_is_gp.sum() == 1


@pytest.mark.parametrize("max_window,min_connecting", [(4, 3), (3, 3),
                                                       (5, 200)])
def test_deactivate_keyframes(max_window, min_connecting):
    cfg = small_config(max_size_optimization_window=max_window,
                       min_num_connecting_landmarks=min_connecting)
    ref, port, _ = both_adjusters(cfg, 6)
    for ba in (ref, port):
        slot = ba._alloc_lm_slot(99999)
        ba._obs_mask[slot, ba._kf_order[0], 0] = True
        ba.deactivate_keyframes()
    assert_ba_equal(port, ref, "deactivate")
    assert port.num_keyframes <= max_window and port._archive
    with pytest.raises(TNotEnough):
        tstate.bundle_adjuster_from_numpy(
            BundleAdjuster(RIG, cfg, jnp.float64), "cpu").solve()


def test_solve_and_adjust_pose_only():
    """A perturbed 4-keyframe window with depth: the trimmed solve, then
    the motion-only solve of a fifth frame with and without the
    constant-velocity regularizer, both from the same host state."""
    cfg = small_config()
    pert = np.random.default_rng(42).normal(0, 0.1, (4, 3))
    ref, port, _ = both_adjusters(cfg, 4, with_depth=True, perturb=pert)
    with pytest.raises(NotEnoughKeyframesException):
        BundleAdjuster(RIG, cfg, jnp.float64).solve()
    ref.deactivate_keyframes()
    port.deactivate_keyframes()
    sel_r = ref.build_selection(ref.to_window())
    sel_p = port.build_selection(port.to_window()[0])
    np.testing.assert_array_equal(sel_p.lm_selected.numpy(),
                                  np.asarray(sel_r.lm_selected))
    np.testing.assert_array_equal(port._last_categories,
                                  ref._last_categories)
    info_r, info_p = ref.solve(), port.solve()
    for f in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(info_p, f)),
                                   float(getattr(info_r, f)), rtol=BA_RTOL)
    assert info_p.n_iterations == int(info_r.n_iterations)
    assert float(info_p.final_cost) < float(info_p.initial_cost)
    for k in ("_poses", "_lm_pos", "_planes"):
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k),
                                   rtol=BA_RTOL, atol=BA_RTOL, err_msg=k)
    for k in ("_last_selection", "_last_categories"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    assert port.unselected_landmarks() == ref.unselected_landmarks()

    poses, lms, stamps = make_sequence(5, with_depth=True)
    tl = project_tracklets(poses, lms, stamps, with_depth=True)
    prior = np.asarray(poses[4], float) + np.r_[0, 0, 0, 0, 0.05, -0.03, 0.1]
    for gate in (0.03, 0.0):      # the regularizer on, then gated off
        for ba in (ref, port):
            ba.cfg = dataclasses.replace(ba.cfg, regularization=(
                dataclasses.replace(ba.cfg.regularization,
                                    speed_reg_rotation_gate=gate)))
        ref._pose_only_fn = None
        got_r = ref.adjust_pose_only(stamps[4], prior, tl)
        got_p = port.adjust_pose_only(stamps[4], prior, tl)
        np.testing.assert_allclose(got_p, got_r, rtol=0, atol=BA_RTOL)
        assert np.linalg.norm(got_p[4:] - poses[4][4:]) < 0.05
