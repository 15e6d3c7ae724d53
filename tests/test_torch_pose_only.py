"""The port's motion-only solve (limo_tpu_torch.solver.pose_only) against
the reference package's, in float64 on the CPU.

One frame of a synthetic drive: kitti-like extrinsics, pixel noise, gross
pixel and depth outliers on a fifth of the landmarks (so the trim round
removes groups: 150 > 30), label weights, and a prior 0.3 m and ~1° off.
Every combination of rotation compensation (the jacfwd route) and the
analytic route, with and without the speed regularizer, at graduated_init
1 and 8, on one camera and on two. Tolerance: the pose within 1e-8
absolute plus 1e-8 relative and the cost within 1e-8 relative (the
rotation-compensated cases with the speed row differ by up to 1.4e-9 in
the pose and 1.2e-9 relative in the cost: the compensation divides by a
small rotation-only error, which magnifies f64 sum-order differences), the
group count equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu.config import LimoConfig
from limo_tpu.geometry import pose_host as ph
from limo_tpu.geometry.camera import CameraRig as JaxRig
from limo_tpu.pipeline.synthetic import kitti_like_extrinsics
from limo_tpu.solver.pose_only import pose_only_step as j_pose_only
from limo_tpu_torch import state as tstate
from limo_tpu_torch.solver.pose_only import pose_only_step as t_pose_only
from torch_parity import assert_close

L = 150


def _frame(cameras, seed=0):
    """(inputs as numpy, reference rig): prior, landmarks, observations."""
    rng = np.random.default_rng(seed)
    tcv = kitti_like_extrinsics()
    q = np.array([0.999, 0.0, 0.04, 0.0])
    second = ph.compose(np.r_[q / np.linalg.norm(q), -0.5, 0.0, 0.0], tcv)
    T = np.stack([tcv, second][:cameras])
    truth = ph.inverse(np.array([np.cos(0.05), 0, 0, np.sin(0.05),
                                 12.0, 1.0, 0.0]))
    lm_veh = rng.uniform([5, -15, -1.5], [45, 15, 4], (L, 3))
    lms = ph.apply(ph.inverse(truth), lm_veh)
    obs = np.zeros((L, cameras, 3))
    for c in range(cameras):
        pc = ph.apply(ph.compose(T[c], truth), lms)
        obs[:, c, :2] = 718.0 * pc[:, :2] / pc[:, 2:3] + [607.0, 185.0] \
            + rng.normal(0, 0.4, (L, 2))
        obs[:, c, 2] = np.where(rng.uniform(size=L) < 0.6,
                                pc[:, 2] + rng.normal(0, 0.05, L), -1.0)
    bad = rng.uniform(size=L) < 0.2
    obs[bad, :, :2] += rng.uniform(10, 40, (bad.sum(), cameras, 2))
    obs[bad, :, 2] = np.where(obs[bad, :, 2] > 0, obs[bad, :, 2] * 1.5, -1.0)
    prior = ph.compose(np.array([np.cos(0.008), 0.0, 0.0, np.sin(0.008),
                                 0.3, -0.1, 0.05]), truth)
    rig = JaxRig(focal=jnp.full((cameras,), 718.0),
                 principal=jnp.tile(jnp.asarray([[607.0, 185.0]]),
                                    (cameras, 1)),
                 T_cam_veh=jnp.asarray(T))
    inputs = dict(pose_prior=prior, lm_pos=lms, obs=obs,
                  obs_mask=rng.uniform(size=(L, cameras)) < 0.9,
                  lm_mask=rng.uniform(size=L) < 0.95,
                  lm_weight=rng.uniform(0.5, 1.0, L))
    prev = ph.compose(np.array([1.0, 0, 0, 0, 1.0, 0.0, 0.0]), truth)
    speed = (ph.inverse(prev), np.array([-10.0, 0.2, 0.0]), 0.1, 0.5)
    return inputs, speed, rig


@pytest.mark.parametrize("cameras", [1, 2])
@pytest.mark.parametrize("graduated_init", [1.0, 8.0])
@pytest.mark.parametrize("with_speed", [False, True])
@pytest.mark.parametrize("compensate_rotation", [False, True])
def test_pose_only_matches_reference(compensate_rotation, with_speed,
                                     graduated_init, cameras):
    cfg = LimoConfig()
    inputs, speed, rig = _frame(cameras)
    kw = dict(max_iters=4, compensate_rotation=compensate_rotation,
              graduated_init=graduated_init)
    ref = jax.jit(lambda a, s: j_pose_only(
        a["pose_prior"], a["lm_pos"], a["obs"], a["obs_mask"], a["lm_mask"],
        rig, cfg, speed_reg=s, lm_weight=a["lm_weight"], **kw))(
        {k: jnp.asarray(v) for k, v in inputs.items()},
        tuple(jnp.asarray(v) for v in speed) if with_speed else None)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    port = t_pose_only(
        t["pose_prior"], t["lm_pos"], t["obs"], t["obs_mask"], t["lm_mask"],
        tstate.rig_from_numpy(rig, "cpu"),
        tstate.config_from_dict(dataclasses.asdict(cfg)),
        speed_reg=(tuple(torch.as_tensor(v) for v in speed) if with_speed
                   else None),
        lm_weight=t["lm_weight"], **kw)
    assert int(port.n_used) == int(ref.n_used)
    # the trim round removed groups
    assert int(ref.n_used) < int(inputs["lm_mask"].sum())
    assert_close(port.pose, ref.pose, 1e-8, 1e-8, "pose")
    assert_close(port.cost, ref.cost, 1e-8, 0.0, "cost")
    # the solve moved the prior
    assert np.abs(np.asarray(ref.pose) - inputs["pose_prior"]).max() > 1e-3
