"""Geometry, residuals and losses of the PyTorch port against the reference
package, op by op in float64 (rtol 1e-12: the two evaluate the same
formulas, so only the last bits of rounding may differ; atol 1e-12 covers
entries that cancel to ~0).

One parametrised test per module; each case is one function pair on the
same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from limo_tpu import residuals as j_res
from limo_tpu import robust as j_rob
from limo_tpu.geometry import camera as j_cam
from limo_tpu.geometry import pose as j_pose
from limo_tpu.geometry import quaternion as j_quat
from limo_tpu_torch import residuals as t_res
from limo_tpu_torch import robust as t_rob
from limo_tpu_torch.geometry import camera as t_cam
from limo_tpu_torch.geometry import pose as t_pose
from limo_tpu_torch.geometry import quaternion as t_quat

RTOL = ATOL = 1e-12
N = 16
_rng = np.random.default_rng(7)


def _unit_quats(n):
    q = _rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(n, t_scale=3.0):
    return np.concatenate([_unit_quats(n), _rng.normal(0, t_scale, (n, 3))], 1)


def _tangents(n):
    w = _rng.normal(0, 0.2, (n, 3))
    w[:3] = [[0.0, 0.0, 0.0], [1e-8, 0.0, 0.0], [0.0, 3e-7, -2e-7]]  # Taylor
    return w


Q1, Q2 = _unit_quats(N), _unit_quats(N)
V3 = _rng.normal(0, 5.0, (N, 3))
W3 = _tangents(N)
P1, P2, P3 = _poses(N), _poses(N), _poses(N)
D6 = np.concatenate([_tangents(N), _rng.normal(0, 0.3, (N, 3))], 1)
D2 = np.stack([np.r_[0.0, 5e-4, _rng.normal(0, 0.1, N - 2)],
               _rng.normal(0, 1.0, N)], 1)
D3 = np.concatenate([_rng.normal(0, 0.1, (N, 1)), D2[:, :1],
                     _rng.normal(0, 0.1, (N, 1))], 1)
ROT_M = np.asarray(j_quat.qto_matrix(jnp.asarray(Q1)))
PCAM = np.concatenate([_rng.normal(0, 5.0, (N, 2)),
                       np.r_[0.005, -0.004, _rng.uniform(1, 40, N - 2)][:, None]],
                      1)
FOCAL = np.full((N,), 600.0)
PP = np.tile([300.0, 200.0], (N, 1))
UV = _rng.uniform(0, 600, (N, 2))
DEPTH = _rng.uniform(1, 40, N)
LM = _rng.uniform(-1, 1, (N, 3)) * [20, 10, 8] + [0, 0, 35]
TCV = _poses(N, 0.5)
TCV[:, :4] = np.array([1.0, 0, 0, 0]) + 0.02 * _rng.normal(size=(N, 4))
TCV[:, :4] /= np.linalg.norm(TCV[:, :4], axis=1, keepdims=True)
NORMALS = _rng.normal(size=(N, 3))
NORMALS /= np.linalg.norm(NORMALS, axis=1, keepdims=True)
SCORES = _rng.exponential(1.0, 300)
VALID = _rng.uniform(size=300) > 0.2
SQ = _rng.exponential(2.0, N) * np.r_[0.0, np.ones(N - 1)]


def _check(jax_fn, torch_fn, args):
    """Call both on the same numpy inputs and compare every output."""
    ja = jax_fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in args])
    ta = torch_fn(*[torch.tensor(a) if isinstance(a, np.ndarray) else a
                    for a in args])
    ja = ja if isinstance(ja, tuple) else (ja,)
    ta = ta if isinstance(ta, tuple) else (ta,)
    assert len(ja) == len(ta)
    for i, (x, y) in enumerate(zip(ja, ta)):
        x, y = np.asarray(x), y.numpy()
        assert x.shape == y.shape, (i, x.shape, y.shape)
        if x.dtype == bool:
            np.testing.assert_array_equal(y, x, err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL,
                                       err_msg=f"output {i}")


QUATERNION = {
    "qmul": ("qmul", (Q1, Q2)),
    "qconj": ("qconj", (Q1,)),
    "qinv": ("qinv", (Q1 * 1.7,)),
    "qnormalize": ("qnormalize", (Q1 * 2.3,)),
    "qrot": ("qrot", (Q1, V3)),
    "qexp": ("qexp", (W3,)),
    "qlog": ("qlog", (np.concatenate([Q1, [[1.0, 1e-11, 0, 0]]]),)),
    "qboxplus": ("qboxplus", (Q1, W3)),
    "qangle": ("qangle", (Q1, Q2)),
    "qfrom_axis_angle": ("qfrom_axis_angle", (V3, W3[:, 0] * 10)),
    "qto_matrix": ("qto_matrix", (Q1,)),
    "qfrom_matrix": ("qfrom_matrix", (ROT_M,)),
}


@pytest.mark.parametrize("case", sorted(QUATERNION))
def test_quaternion(case):
    name, args = QUATERNION[case]
    _check(getattr(j_quat, name), getattr(t_quat, name), args)


POSE = {
    "apply": (j_pose.apply, t_pose.apply, (P1, V3)),
    "compose": (j_pose.compose, t_pose.compose, (P1, P2)),
    "inverse": (j_pose.inverse, t_pose.inverse, (P1,)),
    "relative": (j_pose.relative, t_pose.relative, (P1, P2)),
    "boxplus": (j_pose.boxplus, t_pose.boxplus, (P1, D6)),
    "boxplus_circular_2d": (j_pose.boxplus_circular_2d,
                            t_pose.boxplus_circular_2d, (P1, D2)),
    "boxplus_fix_scale_circular": (j_pose.boxplus_fix_scale_circular,
                                   t_pose.boxplus_fix_scale_circular,
                                   (P1, D3, 1.3)),
    "normalize": (j_pose.normalize, t_pose.normalize,
                  (np.concatenate([Q1 * 1.5, V3], 1),)),
    "to_matrix": (j_pose.to_matrix, t_pose.to_matrix, (P1,)),
    "from_matrix": (j_pose.from_matrix, t_pose.from_matrix,
                    (np.asarray(j_pose.to_matrix(jnp.asarray(P1))),)),
    **{f"tangent_basis_{m}": (lambda p, m=m: j_pose.tangent_basis(p, m),
                              lambda p, m=m: t_pose.tangent_basis(p, m),
                              (P1,))
       for m in ("full_dof", "fix_rotation", "circular_2d")},
}


@pytest.mark.parametrize("case", sorted(POSE))
def test_pose(case):
    _check(*POSE[case])


CAMERA = {
    "project": (j_cam.project, t_cam.project, (PCAM, FOCAL, PP)),
    "backproject": (j_cam.backproject, t_cam.backproject,
                    (UV, DEPTH, FOCAL, PP)),
    "rig_single": (lambda tcv: tuple(j_cam.CameraRig.single(
        610.0, 301.0, 199.0, tcv, dtype=jnp.float64)),
                   lambda tcv: tuple(t_cam.CameraRig.single(
                       610.0, 301.0, 199.0, tcv, dtype=torch.float64,
                       device="cpu")), (TCV[0],)),
}


@pytest.mark.parametrize("case", sorted(CAMERA))
def test_camera(case):
    _check(*CAMERA[case])


RESIDUALS = {
    "_safe_norm": ("_safe_norm", (np.concatenate([V3, np.zeros((1, 3))]),)),
    "reprojection": ("reprojection", (P1, LM, UV, FOCAL, PP, TCV)),
    "reprojection_rotrocc": (
        lambda *a: j_res.reprojection(*a, compensate_rotation=True),
        lambda *a: t_res.reprojection(*a, compensate_rotation=True),
        (P1, LM, UV, FOCAL, PP, TCV)),
    "landmark_depth": ("landmark_depth", (P1, LM, DEPTH, TCV)),
    "pose_scale": ("pose_scale", (P1, P2, DEPTH)),
    "speed": ("speed", (P1, P2, P3, DEPTH, DEPTH[::-1].copy())),
    "speed_vector": ("speed_vector", (P1, P2, V3, DEPTH[:, None])),
    "groundplane_height": ("groundplane_height",
                           (P1, NORMALS, DEPTH, LM)),
    "vector_difference": ("vector_difference", (NORMALS, V3)),
    "translation_difference": ("translation_difference", (P1, P2, P3)),
    "groundplane_distance": ("groundplane_distance", (DEPTH, UV[:, 0])),
    "groundplane_motion": ("groundplane_motion", (P1, P2, NORMALS)),
    "motion_model_circular": ("motion_model_circular", (P1, P2)),
}


@pytest.mark.parametrize("case", sorted(RESIDUALS))
def test_residuals(case):
    spec = RESIDUALS[case]
    if isinstance(spec[0], str):
        _check(getattr(j_res, spec[0]), getattr(t_res, spec[0]), spec[1])
    else:
        _check(*spec)


ROBUST = {
    "cauchy_weight": (j_rob.cauchy_weight, t_rob.cauchy_weight, (SQ, 1.6)),
    "huber_weight": (j_rob.huber_weight, t_rob.huber_weight, (SQ, 0.1)),
    "trim_fixed": (j_rob.trim_fixed, t_rob.trim_fixed,
                   (SCORES, VALID, 1.5)),
    **{f"trim_quantile_{q}": (
        lambda s, v, q=q: j_rob.trim_quantile(s, v, q),
        lambda s, v, q=q: t_rob.trim_quantile(s, v, q), (SCORES, VALID))
       for q in (0.95, 0.9, 0.5, 1.0)},
    "trim_quantile_f32": (
        lambda s, v: j_rob.trim_quantile(s.astype(jnp.float32), v, 0.95),
        lambda s, v: t_rob.trim_quantile(s.float(), v, 0.95),
        (SCORES, VALID)),
}


@pytest.mark.parametrize("case", sorted(ROBUST))
def test_robust(case):
    _check(*ROBUST[case])
