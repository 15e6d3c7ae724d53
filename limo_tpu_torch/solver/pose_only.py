"""Motion-only (pose-only) adjustment — ``adjustPoseOnly`` in PyTorch.

Reference (``bundle_adjuster_keyframes.cpp:820-888``): the newest frame's
pose is optimized against the *fixed* landmarks of the last selection with
Cauchy-weighted reprojection + depth residuals, an optional constant-velocity
``SpeedRegularizationVector2`` residual (weight 1−rot/0.03 when recent
rotation < 0.03 rad), quantile trimming (groups ≥ 30), and ≤4 LM iterations.

The problem has exactly 6 unknowns, so the normal equations are a single
6×6 solve (``torch.linalg.solve_ex``, which does not check for errors on
the host). The LM loop runs a fixed ``max_iters`` masked iterations: once an
iteration converges, the pose, the damping and the iteration count are
frozen with ``torch.where``, so the loop never reads a value back to the
host. Jacobians of the plain reprojection and depth rows are the analytic
forms of :mod:`limo_tpu_torch.solver.analytic`; the rotation-compensated
rows and the speed row, which have none here, come from
``torch.func.jacfwd`` w.r.t. the pose tangent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from .. import residuals as res_k
from ..geometry import pose as pose_ops
from ..geometry.quaternion import qnormalize, qto_matrix
from ..robust import cauchy_weight, trim_quantile
from ..utils.precision import full_f32
from ..utils.profiling import traced
from .analytic import obs_residual_jac


class PoseOnlyResult(NamedTuple):
    pose: torch.Tensor        # [7] optimized pose
    cost: torch.Tensor
    n_used: torch.Tensor      # residual groups used after trimming


def _residuals(pose, lm_pos, obs, rig, compensate_rotation):
    """(r [L,C,3], proj_ok [L,C]) at the given pose, through the residual
    functions (the route ``jacfwd`` differentiates)."""
    dtype = pose.dtype
    f = rig.focal.to(dtype)
    pp = rig.principal.to(dtype)
    tcv = rig.T_cam_veh.to(dtype)
    x = lm_pos[:, None, :]
    rr, ok = res_k.reprojection(pose, x, obs[..., :2], f, pp, tcv,
                                compensate_rotation=compensate_rotation)
    rd, _ = res_k.landmark_depth(pose, x, obs[..., 2], tcv)
    return torch.cat([rr, rd], -1), ok


def _camera_constants(rig, dtype):
    """(focal [C], principal [C,2], R_cv [C,3,3], t_cv [C,3]) of the rig."""
    tcv = rig.T_cam_veh.to(dtype)
    return (rig.focal.to(dtype), rig.principal.to(dtype),
            qto_matrix(qnormalize(tcv[:, :4])), tcv[:, 4:])


def _residuals_analytic(pose, lm_pos, obs, cams):
    """(r [L,C,3], proj_ok [L,C], J [L,C,3,6]) at the given pose, with the
    analytic Jacobians w.r.t. the pose tangent; ``cams`` from
    :func:`_camera_constants`."""
    f, pp, R_cv, t_cv = cams
    R_kf = qto_matrix(qnormalize(pose[:4]))
    r, ok, Jp, _ = obs_residual_jac(R_kf, pose[4:], lm_pos[:, None, :], obs,
                                    f, pp, R_cv, t_cv)
    return r, ok, Jp


@traced("limo.pose_only")
@full_f32
def pose_only_step(pose_prior, lm_pos, obs, obs_mask, lm_mask, rig, cfg,
                   speed_reg=None, max_iters: int = 4,
                   compensate_rotation: bool = False,
                   lm_weight=None,
                   graduated_init: float = 1.0) -> PoseOnlyResult:
    """Optimize one pose against fixed landmarks.

    lm_pos [L,3], obs [L,C,3], obs_mask [L,C], lm_mask [L] (last selection).
    speed_reg: (pose_origin_before [7], vel_before [3], dt, weight) or None.
    lm_weight [L]: per-landmark loss scale — the reference applies
    ``ScaledLoss(CauchyLoss, landmark.weight)`` in adjustPoseOnly's residuals
    (bundle_adjuster_keyframes.cpp:589-591,832).

    graduated_init > 1 enables graduated non-convexity: iteration ``it``
    runs with the Cauchy scales multiplied by ``max(ginit·2^-it, 1)``, so a
    prior that starts far outside the robust basin still sees full gradient
    early, while the final iterations re-tighten to the true scale (the scan
    path passes 8.0, ``SolverConfig.scan_pose_only_graduated_init``). 1.0 =
    reference behavior.
    """
    rcfg = cfg.robust
    dtype = pose_prior.dtype
    device = pose_prior.device
    ginit = float(graduated_init)
    w_lm = (torch.ones((obs.shape[0], 1), dtype=dtype, device=device)
            if lm_weight is None else lm_weight[:, None].to(dtype))
    zero6 = torch.zeros((6,), dtype=dtype, device=device)
    cams = _camera_constants(rig, dtype)

    def residuals(pose):
        if compensate_rotation:
            return _residuals(pose, lm_pos, obs, rig, True)
        r, ok, _ = _residuals_analytic(pose, lm_pos, obs, cams)
        return r, ok

    def speed_rows(pose):
        pob, vel, dt, _w = speed_reg
        return res_k.speed_vector(pose, pob, vel, dt)[0]

    def masks(r, proj_ok, lm_use):
        valid = obs_mask & lm_use[:, None]
        # cheirality guard on the depth residual: z_cam = r_d + d_measured
        # must be positive (a landmark behind the camera adds no depth row)
        z_cam = r[..., 2] + obs[..., 2]
        return valid & proj_ok, valid & (obs[..., 2] > 0) & (z_cam > 0)

    def robust_terms(r, repr_ok, depth_ok, smul):
        """(cost, w3 [L,C,3]) at Cauchy scales × smul."""
        thr_r = rcfg.reprojection_thres * smul
        thr_d = rcfg.depth_thres * smul
        s_repr = torch.sum(r[..., :2] ** 2, -1)
        s_depth = r[..., 2] ** 2
        zero = torch.zeros_like(s_repr)
        w_repr = torch.where(repr_ok, w_lm * cauchy_weight(s_repr, thr_r), zero)
        w_depth = torch.where(depth_ok, w_lm * cauchy_weight(s_depth, thr_d),
                              zero)
        a2r, a2d = thr_r ** 2, thr_d ** 2
        cost = 0.5 * (torch.sum(torch.where(
            repr_ok, w_lm * a2r * torch.log1p(s_repr / a2r), zero))
            + torch.sum(torch.where(
                depth_ok, w_lm * a2d * torch.log1p(s_depth / a2d), zero)))
        return cost, torch.stack([w_repr, w_repr, w_depth], -1)

    def cost_at(pose, lm_use, smul):
        r, proj_ok = residuals(pose)
        cost, _ = robust_terms(r, *masks(r, proj_ok, lm_use), smul)
        if speed_reg is not None:
            cost = cost + 0.5 * speed_reg[3] * torch.sum(speed_rows(pose) ** 2)
        return cost

    def system(pose, lm_use, smul):
        """(cost, H [6,6], g [6]) at the pose."""
        if compensate_rotation:
            r, proj_ok = residuals(pose)
            J = jacfwd(lambda t: residuals(pose_ops.boxplus(pose, t))[0])(
                zero6)                                       # [L,C,3,6]
        else:
            r, proj_ok, J = _residuals_analytic(pose, lm_pos, obs, cams)
        cost, w3 = robust_terms(r, *masks(r, proj_ok, lm_use), smul)
        H = torch.einsum("lcr,lcri,lcrj->ij", w3, J, J)
        g = -torch.einsum("lcr,lcri,lcr->i", w3, J, r)
        if speed_reg is not None:
            w_s = speed_reg[3]
            rs = speed_rows(pose)
            Js = jacfwd(lambda t: speed_rows(pose_ops.boxplus(pose, t)))(zero6)
            H = H + w_s * Js.T @ Js
            g = g - w_s * Js.T @ rs
            cost = cost + 0.5 * w_s * torch.sum(rs ** 2)
        return cost, H, g

    eye6 = torch.eye(6, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    def smul_at(it):
        if ginit <= 1.0:
            return one
        return torch.clamp_min(ginit * torch.pow(0.5, it.to(dtype)), 1.0)

    def lm_loop(pose, lm_use, iters):
        lam = torch.full((), cfg.solver.initial_lambda, dtype=dtype,
                         device=device)
        it = torch.zeros((), dtype=torch.int32, device=device)
        done = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(iters):
            smul = smul_at(it)
            # current-pose cost at THIS iteration's scale so accept/reject
            # compares like with like under the graduated schedule
            cost, H, g = system(pose, lm_use, smul)
            Hd = H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
            delta = torch.linalg.solve_ex(Hd + 1e-12 * eye6, g[:, None])[0][:, 0]
            cand = pose_ops.normalize(pose_ops.boxplus(pose, delta))
            new_cost = cost_at(cand, lm_use, smul)
            accept = torch.isfinite(new_cost) & (new_cost < cost)
            rel = (cost - new_cost) / torch.clamp_min(cost, 1e-12)
            # no convergence exit while the scale is still relaxed
            converged = accept & (rel < cfg.solver.function_tolerance) \
                & (smul <= 1.0)
            live = ~done
            pose = torch.where(live & accept, cand, pose)
            lam = torch.where(live, torch.where(
                accept, torch.clamp_min(lam * 0.5, 1e-10),
                torch.clamp_max(lam * 4.0, 1e8)), lam)
            it = it + live.to(torch.int32)
            done = done | converged
        return pose, cost_at(pose, lm_use, one)

    # trim round (2 iters) then refinement, reference trimmer spec
    pose, _ = lm_loop(pose_prior, lm_mask, rcfg.trim_iteration_lm_steps)
    r, proj_ok = residuals(pose)
    repr_ok, depth_ok = masks(r, proj_ok, lm_mask)
    zero = torch.zeros_like(r[..., 0])
    score_repr = torch.where(repr_ok, torch.sqrt(torch.sum(r[..., :2] ** 2, -1)),
                             zero).amax(-1)
    score_depth = torch.where(depth_ok, torch.abs(r[..., 2]), zero).amax(-1)
    grp_repr = repr_ok.any(-1)
    grp_depth = depth_ok.any(-1)
    trim_on = grp_repr.sum() > 30
    out = (trim_quantile(score_repr, grp_repr, rcfg.reprojection_quantile)
           & (grp_repr.sum() >= rcfg.min_residual_groups))
    out = out | (trim_quantile(score_depth, grp_depth, rcfg.depth_quantile)
                 & (grp_depth.sum() >= rcfg.min_residual_groups))
    lm_use = lm_mask & ~(out & trim_on)

    pose, cost = lm_loop(pose, lm_use, max_iters)
    return PoseOnlyResult(pose=pose, cost=cost,
                          n_used=lm_use.sum(dtype=torch.int32))
