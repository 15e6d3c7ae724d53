"""Assembly of the PyTorch port against the reference package.

- The plain versions of the two CUDA kernels against the reference's
  Pallas kernels in interpret mode, on the same f32 operands, with the
  reference's own kernel tolerances (``cuda_assemble.TOLERANCES``, from
  tests/test_pallas_assemble.py:84-89, :173): V/b_l/W rtol 2e-4 atol 2e-3,
  U/b_pose rtol 2e-3 atol 0.1 (sums over all landmarks in another order),
  cost rtol 1e-4, cost kernel rtol 2e-5.
- The port's full ``assemble`` (plain path) against the reference's
  autodiff einsum path in f64, every NormalEqs field, rtol 1e-9 with an
  atol of 1e-9 × the field's largest entry (entries that cancel to ~0).
- The closed-form groundplane and regularizer Jacobians against
  ``torch.func`` of the residual functions they differentiate, in f64:
  rtol 1e-10, with an atol of 1e-10 × the largest entry of the row.

The kernels themselves are held against these plain versions on the card
in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev, vmap

from __graft_entry__ import _make_problem
from limo_tpu.solver import ba_core as j_ba
from limo_tpu.solver import analytic as j_analytic
from limo_tpu.solver.pallas_assemble import assemble_obs_pallas, cost_obs_pallas
from limo_tpu_torch import residuals as t_res
from limo_tpu_torch.entry import make_problem, speed_regularizer, \
    two_camera_window
from limo_tpu_torch.geometry import pose as t_pose
from limo_tpu_torch.solver import analytic as t_analytic
from limo_tpu_torch.solver import ba_core as t_ba
from limo_tpu_torch.solver import cuda_assemble as ca
from torch_parity import assert_close, rich_problem, to_jax, to_torch


def _jax_operands(case):
    """Lane-major f32 operands of the reference's _kernel_inputs, numpy."""
    if case == "c2":
        tw, _, trig = two_camera_window(K=2, L=128, seed=4, device="cpu")
        w, rig = to_jax(tw, trig)
        active = w.lm_valid
    else:
        w, sel, rig, _ = _make_problem(3, 128, 3, 100, jnp.float32,
                                       with_depth=case == "c1_depth", seed=3)
        active = w.lm_valid & sel.lm_selected
    ins = j_ba._kernel_inputs(w, rig, active)[:7]
    return [np.asarray(x) for x in ins], w.K, w.C


@pytest.mark.parametrize("case", ["c1_depth", "c1_nodepth", "c2"])
def test_plain_matches_pallas_interpret(case):
    ins, K, C = _jax_operands(case)
    a2r, a2d = 1.6 ** 2, 0.16 ** 2
    ref = assemble_obs_pallas(*[jnp.asarray(x) for x in ins], K=K, C=C,
                              a2r=a2r, a2d=a2d, interpret=True, tl=128)
    ref_cost = cost_obs_pallas(*[jnp.asarray(x) for x in ins], K=K, C=C,
                               a2r=a2r, a2d=a2d, interpret=True, tl=128)
    t_ins = [torch.tensor(x) for x in ins]
    out = ca.assemble_obs_plain(*t_ins, K, C, a2r, a2d)
    for field in out._fields:
        assert_close(getattr(out, field), getattr(ref, field),
                     *ca.TOLERANCES[field], err_msg=field)
    assert_close(ca.cost_obs_plain(*t_ins, K, C, a2r, a2d), ref_cost,
                 *ca.TOLERANCES["cost_obs"])


def _with_mode(cfg, mode):
    return cfg.replace(solver=dataclasses.replace(
        cfg.solver, motion_parameterization=mode))


@pytest.mark.parametrize("mode", ["full_dof", "fix_rotation", "circular_2d"])
def test_assemble_matches_einsum_f64(mode):
    w, sel, rig, cfg = rich_problem()
    cfg = _with_mode(cfg, mode)
    ref, _ = jax.jit(lambda a, b: j_ba.assemble(a, b, rig, cfg))(w, sel)
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    out = t_ba.assemble(tw, tsel, trig, tcfg)
    assert set(out._fields) == set(ref._fields)
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert_close(a, b, 1e-9, 1e-9 * max(np.abs(b).max(), 1e-300),
                         err_msg=field)


def test_cost_and_stats_match_f64():
    w, sel, rig, cfg = rich_problem(seed=2)
    tw, tsel, trig, tcfg = to_torch(w, sel, rig, cfg)
    ref_cost = jax.jit(lambda a, b: j_ba.compute_cost(a, b, rig, cfg))(w, sel)
    assert_close(t_ba.compute_cost(tw, tsel, trig, tcfg), ref_cost, 1e-9)
    ref = jax.jit(lambda a, b: j_ba.residual_stats(a, b, rig, cfg))(w, sel)
    out = t_ba.residual_stats(tw, tsel, trig, tcfg)
    for field in out._fields:
        a, b = getattr(out, field).numpy(), np.asarray(getattr(ref, field))
        if b.dtype == bool or b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert_close(a, b, 1e-9, 1e-12, err_msg=field)


def test_kernel_inputs_and_jacobians_match_f64():
    """The operand layout the kernels read and the closed-form Jacobians
    they compute, against the reference's."""
    w, sel, rig, cfg = rich_problem(seed=3)
    tw, tsel, trig, _ = to_torch(w, sel, rig, cfg)
    active = w.lm_valid & sel.lm_selected
    ref = j_ba._kernel_inputs(w, rig, active)[:7]
    out = t_ba._kernel_inputs(tw, trig, tw.lm_valid & tsel.lm_selected)
    for a, b in zip(out, ref):
        assert a.is_contiguous()
        assert_close(a, b, 1e-12, 1e-12)
    R, t = np.asarray(ref[5])[:, :9].reshape(-1, 3, 3), np.asarray(ref[5])[:, 9:]
    x, uvd = np.asarray(w.lm_pos)[:40, None], np.asarray(w.obs)[:40, :, 0]
    cam = np.asarray(ref[6])[0]
    args = (R[None], t[None], x, uvd, cam[12], cam[13:15], cam[:9].reshape(3, 3),
            cam[9:12])
    j_out = j_analytic.obs_residual_jac(*[jnp.asarray(a) for a in args])
    t_out = t_analytic.obs_residual_jac(*[torch.tensor(a) for a in args])
    for a, b in zip(t_out, j_out):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert_close(a, b, 1e-12, 1e-9)


# ---------------------------------------------------------------------------
# Closed-form groundplane and regularizer Jacobians against torch.func
# ---------------------------------------------------------------------------

def _drawn_window(seed, scale_pair):
    """An f64 window of 8 slots for the closed forms: unit quaternions drawn
    at random, stamps shuffled over the slots (not sorted), slots 2 and 6
    invalid with the empty window's identity pose (their padding pair's
    relative translation is exactly 0), plane 4 invalid, stored normals of
    norm 0.6-1.5, every landmark a groundplane landmark on a random slot.
    ``scale_pair``: "valid" (two active slots), "same" (one slot twice) or
    "padding" (the two invalid slots, which a padding pair links)."""
    w, sel, _, cfg = make_problem(8, 40, 8, 40, torch.float64, seed=seed,
                                  device="cpu")
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    K, L = w.K, w.L
    q = torch.randn(K, 4, generator=g, **f64)
    poses = torch.cat([q / torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                       3.0 * torch.randn(K, 3, generator=g, **f64)], -1)
    kf_valid = torch.ones(K, dtype=torch.bool)
    kf_valid[[2, 6]] = False
    poses[[2, 6]] = t_pose.identity(torch.float64)
    n = torch.tensor([0.0, 0.0, 1.0], **f64) \
        + 0.2 * torch.randn(K, 3, generator=g, **f64)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True) \
        * (0.6 + 0.9 * torch.rand(K, 1, generator=g, **f64))
    planes = torch.cat([n, -1.6 + 0.1 * torch.randn(K, 1, generator=g,
                                                      **f64)], -1)
    plane_valid = torch.ones(K, dtype=torch.bool)
    plane_valid[4] = False
    w = w._replace(
        stamps=torch.randperm(K, generator=g).to(w.stamps.dtype) * 0.4,
        poses=poses, kf_valid=kf_valid, planes=planes,
        plane_valid=plane_valid, lm_is_gp=torch.ones(L, dtype=torch.bool))
    kf0, kf1 = {"valid": (5, 1), "same": (3, 3), "padding": (2, 6)}[
        scale_pair]
    scalar = lambda v, dt: torch.full((), v, dtype=dt)
    sel = sel._replace(
        gp_kf=torch.randint(0, K, (L,), generator=g, dtype=torch.int32),
        gp_weight=0.2 + torch.rand(L, generator=g, **f64),
        scale_kf0=scalar(kf0, torch.int32), scale_kf1=scalar(kf1, torch.int32),
        scale_target=scalar(1.7, torch.float64),
        scale_weight=scalar(50.0, torch.float64))
    return w, sel, cfg


def _regularizer_families(w, sel, speed_reg):
    """Each regularizer family's residuals as a function of the tangents
    [K,10], from the residual functions of ``limo_tpu_torch.residuals`` at
    the retracted keyframes (pose ``boxplus``, ``plane_boxplus``): the
    forward pass the closed forms differentiate. Keyed by family, in the
    row order of ``_regularizer_system``."""
    order = torch.argsort(torch.where(
        w.kf_valid, w.stamps, torch.full_like(w.stamps, torch.inf)),
        stable=True)
    a, b = order[:-1], order[1:]
    kf_i, pose_origin_before, vel_before, dt, _ = speed_reg

    def at(delta):
        return (t_pose.boxplus(w.poses, delta[:, :6]),
                t_ba.plane_boxplus(w.planes, delta[:, 6:]))

    def scale(delta):
        poses, _ = at(delta)
        return t_res.pose_scale(poses[sel.scale_kf1.long()],
                                poses[sel.scale_kf0.long()],
                                sel.scale_target)[0]

    def normal_chain(delta):
        planes = at(delta)[1]
        return t_res.vector_difference(planes[a, :3],
                                       planes[b, :3])[0].reshape(-1)

    def distance_chain(delta):
        planes = at(delta)[1]
        return planes[a, 3] - planes[b, 3]

    def motion(delta):
        poses, planes = at(delta)
        return t_res.groundplane_motion(poses[a], poses[b],
                                        planes[a, :3])[0].reshape(-1)

    def prior(delta):
        planes = at(delta)[1]
        return (planes[:, :3] - torch.tensor([0.0, 0.0, 1.0],
                                             dtype=planes.dtype)).reshape(-1)

    def speed(delta):
        poses = at(delta)[0]
        return t_res.speed_vector(poses[kf_i], pose_origin_before,
                                  vel_before, dt)[0]

    return dict(scale=scale, normal_chain=normal_chain,
                distance_chain=distance_chain, motion=motion, prior=prior,
                speed=speed)


def _gp_autodiff(w, sel):
    """(r [L], J_pose [L,6], J_plane [L,4], J_lm [L,3]) of the groundplane
    height by ``vmap(jacfwd)`` of ``residuals.groundplane_height`` at the
    retracted keyframe, plane and landmark."""
    def height(pose_t, plane_t, lm_d, pose, plane, lm):
        p = t_pose.boxplus(pose, pose_t)
        pl = t_ba.plane_boxplus(plane, plane_t)
        return t_res.groundplane_height(p, pl[..., :3], pl[..., 3],
                                        lm + lm_d)[0][..., 0]

    gp_kf = sel.gp_kf.long()
    zeros = [torch.zeros((w.L, n), dtype=w.poses.dtype) for n in (6, 4, 3)]
    args = (*zeros, w.poses[gp_kf], w.planes[gp_kf], w.lm_pos)
    return (height(*args), *vmap(jacfwd(height, argnums=(0, 1, 2)))(*args))


def _assert_rows_close(actual, desired, rtol, what):
    """|a − d| ≤ rtol (|d| + the largest |d| of the row), row by row."""
    scale = desired.abs().amax(-1, keepdim=True)
    err = (actual - desired).abs() - rtol * (desired.abs() + scale)
    assert float(err.max()) <= 0.0, (what, float(err.max()), float(
        scale.max()))


_REG_FAMILIES = ("scale", "normal_chain", "distance_chain", "motion",
                 "prior", "speed")
_GP_BLOCKS = ("gp_pose", "gp_plane", "gp_landmark")


@pytest.mark.parametrize("family", _REG_FAMILIES + _GP_BLOCKS)
def test_closed_form_jacobians_match_autodiff_f64(family):
    """Each family's closed-form rows (``_regularizer_system``'s J, with
    the speed regularizer on, and ``_gp_system``'s Jgp_kp / Jgp_lm) equal
    ``jacrev`` / ``vmap(jacfwd)`` of the residual functions, and the
    residuals equal the forward pass, on three drawn windows with the
    scale pair on two active slots, on one slot, and on the padding pair's
    slots, with ``pose_only`` off and on."""
    for seed, scale_pair in ((11, "valid"), (12, "same"), (13, "padding")):
        w, sel, cfg = _drawn_window(seed, scale_pair)
        K, P = w.K, w.K * t_ba.PD
        speed_reg = speed_regularizer(w)
        for pose_only in (False, True):
            what = (family, scale_pair, pose_only)
            if family in _GP_BLOCKS:
                r, _, _, _, J_kp, J_lm = t_ba._gp_system(
                    w, sel, cfg, with_jacobians=True)
                ref = _gp_autodiff(w, sel)
                torch.testing.assert_close(r, ref[0], rtol=1e-12, atol=1e-12)
                got, want = {"gp_pose": (J_kp[:, :6], ref[1]),
                             "gp_plane": (J_kp[:, 6:], ref[2]),
                             "gp_landmark": (J_lm, ref[3])}[family]
                _assert_rows_close(got, want, 1e-10, what)
                continue
            r, _, J = t_ba._regularizer_system(w, sel, cfg, speed_reg,
                                               pose_only)
            fns = _regularizer_families(w, sel, speed_reg)
            sizes = [fns[f](torch.zeros((K, t_ba.PD), dtype=torch.float64)
                            ).shape[0] for f in _REG_FAMILIES]
            start = sum(sizes[:_REG_FAMILIES.index(family)])
            rows = slice(start, start + sizes[_REG_FAMILIES.index(family)])
            assert J.shape == (sum(sizes), P) == (r.shape[0], P)
            fn = fns[family]
            delta0 = torch.zeros((K * t_ba.PD,), dtype=torch.float64)
            torch.testing.assert_close(r[rows], fn(delta0.reshape(K, -1)),
                                       rtol=1e-12, atol=1e-12)
            want = jacrev(lambda d: fn(d.reshape(K, -1)))(delta0)
            _assert_rows_close(J[rows], want, 1e-10, what)
