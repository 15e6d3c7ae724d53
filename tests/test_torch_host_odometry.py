"""The port's odometry drivers (limo_tpu_torch.pipeline.odometry) against
the reference package's, in float64 on the CPU, on SyntheticTracker drives.

Before every frame the reference driver's host state (its BundleAdjuster's
mirrors and bookkeeping, trajectory and stamps) is handed to a fresh port
driver (``state.odometry_from_numpy``); both then run the frame on the same
tracklets. Held on every frame: ``is_keyframe`` and ``solved`` exactly,
the adjuster's integer and boolean state exactly, and the frame's pose and
the adjuster's poses and landmarks within a tolerance:

- with external pose priors (``process_frame(..., pose_prior)``, the
  reference's ``mono_lidar.cpp:119-150`` path): ODO_POSE_ATOL = 1e-9
  (measured 3.6e-15);
- with the drivers' own 5-point prior: ODO_PRIOR_TOL = 1e-6, absolute and
  relative (landmarks lie 30-90 m out). The prior's essential matrices
  are solved to about 1e-4 (the back-substitution's conditioning,
  tests/test_torch_essential.py), so the two packages' priors differ by up
  to 1.3e-4; the motion-only solve's four LM iterations damp that to
  6.5e-7 in the poses, and the landmarks triangulated from them move by
  up to 2.4e-7 relative (measured). The prior's nullspace basis is
  implementation-defined, so the port is given the reference's basis.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from limo_tpu.config import CapacityConfig, LandmarkSelectionConfig, LimoConfig
from limo_tpu.geometry.camera import CameraRig
from limo_tpu.pipeline import odometry as jodo
from limo_tpu.pipeline.synthetic import SyntheticTracker, make_world
from limo_tpu_torch import state as tstate
from limo_tpu_torch.frontend import essential as te
from limo_tpu_torch.pipeline import synthetic as tsyn
from test_torch_essential import reference_basis

ODO_POSE_ATOL = 1e-9
ODO_PRIOR_TOL = 1e-6
N_FRAMES = 24


@pytest.fixture(autouse=True)
def with_reference_basis(monkeypatch):
    monkeypatch.setattr(te, "_nullspace_basis", reference_basis)


def drive(with_depth):
    """test_evaluation-style synthetic drive at a small capacity: (world,
    rig, cfg, tracker)."""
    world = make_world(num_frames=N_FRAMES, speed=8.0, yaw_rate=0.015,
                       n_landmarks=150, n_ground=50, seed=0)
    rig = CameraRig.single(world.focal, world.principal[0],
                           world.principal[1],
                           T_cam_veh=jnp.asarray(world.T_cam_veh, jnp.float64),
                           dtype=jnp.float64)
    cfg = LimoConfig(
        capacity=CapacityConfig(max_keyframes=8, max_landmarks=256),
        landmark_selection=dataclasses.replace(LandmarkSelectionConfig(),
                                               height_over_ground=1.65))
    tracker = SyntheticTracker(world, with_depth=with_depth, pixel_noise=0.3,
                               label_ground=with_depth)
    return world, rig, cfg, tracker


def assert_adjusters(port, ref, atol, rtol, where):
    for k in tstate.BUNDLE_ADJUSTER_STATE:
        a, b = getattr(port, k), getattr(ref, k)
        if isinstance(b, np.ndarray) and b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{where} {k}")
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")
        elif k == "_archive":
            assert a.keys() == b.keys(), where
            for s in b:
                np.testing.assert_allclose(a[s], b[s], rtol=rtol, atol=atol)
        else:
            assert a == b, (where, k)


@pytest.mark.parametrize("prior", ["external", "5point"])
@pytest.mark.parametrize("kind", ["lidar", "mono"])
def test_drive_handed_over(kind, prior):
    world, rig, cfg, tracker = drive(with_depth=kind == "lidar")
    cls = jodo.LidarOdometry if kind == "lidar" else jodo.MonoOdometry
    ref = cls(rig, cfg, jnp.float64)
    atol = ODO_POSE_ATOL if prior == "external" else ODO_PRIOR_TOL
    rtol = 0.0 if prior == "external" else ODO_PRIOR_TOL
    rng = np.random.default_rng(9)
    n_kf = n_solved = 0
    for i in range(N_FRAMES):
        tracker.observe(i)
        tl = tracker.tracklets()
        pose_prior = None
        if prior == "external":
            pose_prior = np.asarray(world.poses_veh[i]).copy()
            pose_prior[4:] += rng.normal(0, 0.05, 3)
        port = tstate.odometry_from_numpy(ref, "cpu")
        assert type(port).__name__ == cls.__name__
        r = ref.process_frame(world.stamps[i], tl, pose_prior)
        p = port.process_frame(world.stamps[i], tl, pose_prior)
        where = f"{kind} {prior} frame {i}"
        assert (p.is_keyframe, p.solved) == (r.is_keyframe, r.solved), where
        np.testing.assert_allclose(p.pose, r.pose, rtol=0, atol=atol,
                                   err_msg=where)
        assert_adjusters(port.adjuster, ref.adjuster, atol, rtol, where)
        n_kf += r.is_keyframe
        n_solved += r.solved
    assert n_kf >= 6 and n_solved >= 2, (n_kf, n_solved)
    np.testing.assert_allclose(port.poses_kitti(), ref.poses_kitti(), rtol=0,
                               atol=atol)


def test_synthetic_tracker_copy():
    """The port's SyntheticTracker copy emits the reference's tracklets."""
    world, _, _, ref = drive(with_depth=True)
    port = tsyn.SyntheticTracker(tsyn.make_world(
        num_frames=N_FRAMES, speed=8.0, yaw_rate=0.015, n_landmarks=150,
        n_ground=50, seed=0), with_depth=True, pixel_noise=0.3)
    for i in range(6):
        ref.observe(i)
        port.observe(i)
    a, b = ref.tracklets(), port.tracklets()
    for f in ("stamps", "uvd", "mask", "ids", "age", "is_outlier", "label"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
