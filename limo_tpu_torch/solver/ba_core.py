"""Normal-equation assembly with per-landmark Schur elimination.

This replaces Ceres' problem graph + DENSE_SCHUR
(``bundle_adjuster_keyframes.cpp:564-627`` residual wiring,
``robust_solving.hpp:93-108`` solver config) with a fixed-shape, masked
pipeline:

  parameters  δ = [pose tangents K×6 | plane tangents K×4 | landmarks L×3]
  residuals   r = [reprojection 2/obs | depth 1/obs | gp-height 1/lm | regs]

The observation blocks come from the fused assembly kernel
(:mod:`limo_tpu_torch.solver.cuda_assemble`) on a card (f32 only), and from
its plain PyTorch version on the CPU; both implement the analytic Jacobians
of :mod:`limo_tpu_torch.solver.analytic`. Groundplane and regularizer
Jacobians come from ``torch.func`` (forward/reverse mode) w.r.t. the local
tangents (the ``boxplus`` retractions of
:mod:`limo_tpu_torch.geometry.pose`). The reduced (pose+plane) system is
dense (P = 10K ≈ 200 — the same size Ceres dense-solves after Schur
elimination); landmark blocks are eliminated with batched 3×3 inverses.

Robust losses enter as IRLS row weights (Cauchy for reprojection/depth,
Huber for groundplane height), matching Ceres' ScaledLoss(CauchyLoss(a), w)
wiring in ``addKeyframeToProblem``.

Landmark-sharded solves (``parallel.sharding``) pass the model process
group as ``axis``: the landmark contributions to the reduced system, the
cost and the counts are then summed over the ranks
(:mod:`limo_tpu_torch.utils.collectives`), before anything that depends
only on the poses and planes (regularizers, the motion parameterization,
the gauge masks) is added once.

Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, jacrev, vmap

from .. import residuals as res_k
from ..geometry import pose as pose_ops
from ..geometry.quaternion import qnormalize, qto_matrix
from ..robust import huber_weight
from ..state import Selection, Window
from ..utils.collectives import all_reduce_sum
from ..utils.profiling import traced
from . import cuda_assemble

PD = 10  # per-keyframe parameter dims: 6 pose tangent + 4 plane tangent


def plane_boxplus(plane, delta):
    """Plane retraction: additive-then-renormalize normal (reference
    ``FixScaleVectorPlus``, local_parameterizations.hpp:135-165) +
    additive distance."""
    n = plane[..., :3] + delta[..., :3]
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    d = plane[..., 3] + delta[..., 3]
    return torch.cat([n, d[..., None]], dim=-1)


class NormalEqs(NamedTuple):
    """Cross blocks are stored in BLOCK form, not as a dense [L,P,3]:
    every landmark couples to at most K pose blocks (6 dims each) plus the
    plane block (4 dims) of its ONE attached groundplane keyframe."""

    H_pp: torch.Tensor   # [P,P] pose+plane block (undamped, gauge-masked)
    b_p: torch.Tensor    # [P]   -J_pᵀ r
    V: torch.Tensor      # [L,3,3] landmark blocks
    b_l: torch.Tensor    # [L,3]
    W6: torch.Tensor     # [L,K,6,3] pose↔landmark cross blocks
    Wp: torch.Tensor     # [L,4,3] plane↔landmark cross block (gp keyframe)
    gp_oh: torch.Tensor  # [L,K] one-hot of the attached gp keyframe
    cost: torch.Tensor   # robust cost (0.5 Σ w·ρ(s)), Ceres convention
    param_mask: torch.Tensor  # [P] 1 for free dims, 0 for fixed/gauge dims
    lm_mask: torch.Tensor     # [L] bool landmarks participating


class ResidualStats(NamedTuple):
    """Raw (loss-free) per-landmark max block norms per family + counts —
    the inputs to trimming (``robust_solving.cpp:16-91``)."""

    repr_score: torch.Tensor   # [L] max ‖r_repr‖ over obs of landmark
    depth_score: torch.Tensor  # [L]
    gp_score: torch.Tensor     # [L]
    repr_valid: torch.Tensor   # [L] bool has ≥1 repr residual
    depth_valid: torch.Tensor  # [L]
    gp_valid: torch.Tensor     # [L]
    n_depth: torch.Tensor      # scalar int — depth residual count
    n_gp: torch.Tensor         # scalar int — gp residual count


def assembly_plan(dtype, device, cfg) -> str:
    """Which observation assembly a solve with these parameters takes.

    The device alone decides: ``"plain(cpu)"`` on the CPU (the kernels'
    plain versions, any float dtype), ``"cuda[block=N]"`` on a card (the
    hand-written kernels, N threads per block). A card has no
    plain path, so this raises for a card window that is not float32 and
    for ``SolverConfig.use_pallas_assembly=False`` there (the field stays in
    the config for parity with the reference package)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "plain(cpu)"
    if device.type != "cuda":
        raise ValueError(f"no observation assembly for device {device}")
    if dtype != torch.float32:
        raise ValueError(f"the CUDA kernels take float32 windows, not {dtype}")
    if not cfg.solver.use_pallas_assembly:
        raise ValueError("use_pallas_assembly=False: the port has no "
                         "assembly on the card other than its kernels")
    return f"cuda[block={cuda_assemble.block_size()}]"


def _one_hot(idx, n, dtype):
    """Exact one-hot rows by comparison (no scatter, no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _kernel_inputs(window: Window, rig, lm_active):
    """Lane-major operand layout shared by the fused assembly kernel and
    the cost-only kernel (solver/cuda_assemble.py)."""
    K, L, C = window.K, window.L, window.C
    dtype = window.poses.dtype
    f = rig.focal.to(dtype)
    pp = rig.principal.to(dtype)
    Tcv = rig.T_cam_veh.to(dtype)
    obs_t = window.obs.permute(1, 2, 3, 0).reshape(K * C * 3, L)
    base = (window.obs_mask & lm_active[:, None, None]
            & window.kf_valid[None, :, None])
    repr_base = base.to(dtype).permute(1, 2, 0).reshape(K * C, L)
    depth_base = (base & (window.obs[..., 2] > 0)
                  & window.lm_has_depth[:, None, None]
                  ).to(dtype).permute(1, 2, 0).reshape(K * C, L)
    lm_t = window.lm_pos.T
    wlm = window.lm_weight[None, :]
    R_kf = qto_matrix(qnormalize(window.poses[:, :4]))
    pose_mats = torch.cat([R_kf.reshape(K, 9), window.poses[:, 4:]], -1)
    R_cv = qto_matrix(qnormalize(Tcv[:, :4]))
    cam_mats = torch.cat([R_cv.reshape(C, 9), Tcv[:, 4:], f[:, None], pp], -1)
    ops = (obs_t, repr_base, depth_base, lm_t, wlm, pose_mats, cam_mats)
    return tuple(t.contiguous() for t in ops)


@traced("limo.kernel_inputs")
def _obs_kernel_args(window: Window, sel: Selection, rig, cfg):
    """Operands and sizes of the observation kernels for this window."""
    lm_active = window.lm_valid & sel.lm_selected
    return (_kernel_inputs(window, rig, lm_active),
            dict(K=window.K, C=window.C,
                 a2r=float(cfg.robust.reprojection_thres) ** 2,
                 a2d=float(cfg.robust.depth_thres) ** 2))


# ---------------------------------------------------------------------------
# Per-observation residuals (forward pass, for the trim scores).
# ---------------------------------------------------------------------------

@traced("limo.obs_residuals")
def _obs_system(window: Window, sel: Selection, rig):
    """Residuals for every (l,k,c) slot on the dense grid, with the masks.

    Returns (r [L,K,C,3], repr_ok [L,K,C], depth_ok [L,K,C])."""
    dtype = window.poses.dtype
    f = rig.focal.to(dtype)
    pp = rig.principal.to(dtype)
    Tcv = rig.T_cam_veh.to(dtype)
    uvd = window.obs                                        # [L,K,C,3]
    pose = window.poses[None, :, None, :]                   # [1,K,1,7]
    lm = window.lm_pos[:, None, None, :]                    # [L,1,1,3]
    rr, proj_ok = res_k.reprojection(pose, lm, uvd[..., :2], f, pp,
                                     Tcv[None, None])
    rd, _ = res_k.landmark_depth(pose, lm, uvd[..., 2], Tcv[None, None])
    r = torch.cat([rr, rd], -1)
    lm_active = window.lm_valid & sel.lm_selected
    base_ok = (window.obs_mask & lm_active[:, None, None]
               & window.kf_valid[None, :, None])
    repr_ok = base_ok & proj_ok
    # cheirality guard on depth rows: z_cam = r_d + d_measured must be > 0
    z_cam = r[..., 2] + window.obs[..., 2]
    depth_ok = base_ok & (window.obs[..., 2] > 0) \
        & window.lm_has_depth[:, None, None] & (z_cam > 0)
    return r, repr_ok, depth_ok


def _gp_residual(pose_tangent, plane_tangent, lm_delta, pose, plane, lm):
    """Groundplane height residual for one landmark vs its attached keyframe."""
    p = pose_ops.boxplus(pose, pose_tangent)
    pl = plane_boxplus(plane, plane_tangent)
    r, _ = res_k.groundplane_height(p, pl[..., :3], pl[..., 3], lm + lm_delta)
    return r


@traced("limo.gp_system")
def _gp_system(window: Window, sel: Selection, cfg, with_jacobians: bool):
    """Groundplane height residuals per landmark vs the attached keyframe.

    Returns (r_gp [L], w_gp [L], gp_on [L], cost, Jgp_kp [L,10]|None,
    Jgp_lm [L,3]|None)."""
    L = window.L
    kw = dict(dtype=window.poses.dtype, device=window.poses.device)
    reg_cfg = cfg.regularization
    gp_kf = sel.gp_kf.long()
    lm_active = window.lm_valid & sel.lm_selected
    gp_on = lm_active & window.lm_is_gp & (sel.gp_weight > 0) \
        & window.kf_valid[gp_kf]
    gp_poses = window.poses[gp_kf]
    gp_planes = window.planes[gp_kf]
    z6 = torch.zeros((L, 6), **kw)
    z4 = torch.zeros((L, 4), **kw)
    z3 = torch.zeros((L, 3), **kw)
    r_gp = _gp_residual(z6, z4, z3, gp_poses, gp_planes, window.lm_pos)[:, 0]
    s_gp = r_gp ** 2
    w_gp = torch.where(gp_on, sel.gp_weight * huber_weight(
        s_gp, reg_cfg.gp_height_huber_delta), torch.zeros_like(s_gp))
    hd = reg_cfg.gp_height_huber_delta
    rho = torch.where(s_gp <= hd * hd, s_gp,
                      2.0 * hd * torch.sqrt(torch.clamp_min(s_gp, 1e-20))
                      - hd * hd)
    cost = 0.5 * torch.sum(torch.where(gp_on, sel.gp_weight * rho,
                                       torch.zeros_like(rho)))
    if with_jacobians:
        Jgp = vmap(jacfwd(_gp_residual, argnums=(0, 1, 2)))(
            z6, z4, z3, gp_poses, gp_planes, window.lm_pos)
        Jgp_pose, Jgp_plane, Jgp_lm = (j[:, 0, :] for j in Jgp)
        Jgp_kp = torch.cat([Jgp_pose, Jgp_plane], -1)
    else:
        Jgp_kp = Jgp_lm = None
    return r_gp, w_gp, gp_on, cost, Jgp_kp, Jgp_lm


@traced("limo.assemble")
def assemble(window: Window, sel: Selection, rig, cfg,
             axis=None) -> NormalEqs:
    """Build the (masked, undamped) normal equations at the current state.

    The trim scores are not a by-product here: :func:`residual_stats`
    computes them when a trim round needs them. With ``axis`` (the model
    group of a landmark-sharded solve) ``H_pp``, ``b_p`` and the cost are
    summed over the shards in one ``all_reduce``; the landmark blocks
    (``V``, ``b_l``, ``W6``, ``Wp``) stay the shard's own."""
    K, L = window.K, window.L
    P = K * PD
    dtype = window.poses.dtype
    kw = dict(dtype=dtype, device=window.poses.device)
    lm_active = window.lm_valid & sel.lm_selected

    # ---- observation blocks: fused kernel (plain version on the CPU) ----
    ops, sizes = _obs_kernel_args(window, sel, rig, cfg)
    obs = cuda_assemble.assemble_obs(*ops, **sizes)
    U_k, b_pose_k, V, b_l, W_lk6, cost = (obs.U, obs.b_pose, obs.V, obs.b_l,
                                          obs.W, obs.cost)

    # ---- groundplane height residuals (one per gp landmark) ------------
    r_gp, w_gp, gp_on, gp_cost, Jgp_kp, Jgp_lm = _gp_system(
        window, sel, cfg, with_jacobians=True)
    cost = cost + gp_cost
    # one-hot over the attached keyframe turns every gp "scatter" into an
    # exact product (no atomics, so the sums keep a fixed order)
    gp_oh = _one_hot(sel.gp_kf, K, dtype)                   # [L,K]
    U_gp = torch.einsum("lk,l,li,lj->kij", gp_oh, w_gp, Jgp_kp, Jgp_kp)
    b_gp_k = -torch.einsum("lk,l,li->ki", gp_oh, w_gp * r_gp, Jgp_kp)
    V = V + w_gp[:, None, None] * Jgp_lm[:, :, None] * Jgp_lm[:, None, :]
    b_l = b_l - (w_gp * r_gp)[:, None] * Jgp_lm
    # gp cross blocks in BLOCK form: pose part routes to the attached
    # keyframe's 6 pose dims; plane part is one [4,3] block per landmark
    W6 = W_lk6 + torch.einsum("lk,l,li,lj->lkij", gp_oh, w_gp,
                              Jgp_kp[:, :6], Jgp_lm)
    Wp = w_gp[:, None, None] * Jgp_kp[:, 6:, None] * Jgp_lm[:, None, :]

    # ---- assemble dense H_pp [P,P] (block-diagonal embed) ---------------
    blocks = torch.nn.functional.pad(U_k, (0, PD - 6, 0, PD - 6)) + U_gp
    H_pp = (blocks[:, :, None, :]
            * torch.eye(K, **kw)[:, None, :, None]).reshape(P, P)
    b_p = (torch.nn.functional.pad(b_pose_k, (0, PD - 6)) + b_gp_k).reshape(P)
    # landmark-sharded: the one collective of the assembly, before the
    # regularizers so that they enter once (reference ba_core.py:407-419)
    if axis is not None:
        flat = torch.cat([H_pp.reshape(-1), b_p, cost.reshape(1)])
        (flat,) = all_reduce_sum([flat], axis)
        H_pp, b_p, cost = flat[:P * P].reshape(P, P), flat[P * P:-1], flat[-1]

    # ---- regularization residuals (dense over pose+plane params) -------
    reg_r, reg_w, reg_J = _regularizer_system(window, sel, cfg)
    H_pp = H_pp + torch.einsum("r,ri,rj->ij", reg_w, reg_J, reg_J)
    b_p = b_p - torch.einsum("r,ri,r->i", reg_w, reg_J, reg_r)
    cost = cost + 0.5 * torch.sum(reg_w * reg_r * reg_r)

    # ---- alternate motion parameterization (tangent-basis projection) ---
    # setParameterization variants (bundle_adjuster_keyframes.cpp:172-183):
    # Gauss-Newton in the reduced coordinates d with step B@d is exactly the
    # restricted parameterization to first order, so the assembled system
    # is projected once instead of re-deriving every jacobian.
    mode = getattr(cfg.solver, "motion_parameterization", "full_dof")
    if mode != "full_dof":
        B, tangent_mask = pose_ops.tangent_basis(window.poses, mode)
        T = torch.zeros((K, PD, PD), **kw)
        T[:, :6, :6] = B
        T[:, 6:, 6:] = torch.eye(PD - 6, **kw)
        H4 = H_pp.reshape(K, PD, K, PD)
        H_pp = torch.einsum("kai,kalb,lbj->kilj", T, H4, T).reshape(P, P)
        b_p = torch.einsum("kai,ka->ki", T, b_p.reshape(K, PD)).reshape(P)
        # project the pose part of the cross blocks (plane part is identity)
        W6 = torch.einsum("kai,lkab->lkib", B, W6)
    else:
        tangent_mask = torch.ones((6,), **kw)

    # ---- gauge / fixation masks ---------------------------------------
    kf_free = window.kf_valid & (~window.fix_pose)
    pose_dim_mask = kf_free[:, None].to(dtype) * tangent_mask[None, :]
    plane_free = window.plane_valid & window.kf_valid
    plane_dim_mask = torch.cat(
        [plane_free[:, None].expand(K, 3),
         (plane_free & (~sel.plane_dist_fixed))[:, None]], dim=-1).to(dtype)
    param_mask = torch.cat([pose_dim_mask, plane_dim_mask], -1).reshape(P)

    # apply masks: zero fixed rows/cols; unit diagonal added later w/ damping
    H_pp = H_pp * param_mask[:, None] * param_mask[None, :]
    b_p = b_p * param_mask
    lm_f = lm_active.to(dtype)
    W6 = W6 * pose_dim_mask[None, :, :, None] * lm_f[:, None, None, None]
    # the plane block's gauge mask gathered at each landmark's gp keyframe
    Wp = Wp * (gp_oh @ plane_dim_mask)[:, :, None] * lm_f[:, None, None]
    V = torch.where(lm_active[:, None, None], V,
                    torch.eye(3, **kw).expand(L, 3, 3))
    b_l = b_l * lm_f[:, None]
    return NormalEqs(H_pp=H_pp, b_p=b_p, V=V, b_l=b_l, W6=W6, Wp=Wp,
                     gp_oh=gp_oh, cost=cost, param_mask=param_mask,
                     lm_mask=lm_active)


@traced("limo.compute_cost")
def compute_cost(window: Window, sel: Selection, rig, cfg,
                 axis=None) -> torch.Tensor:
    """Robust cost only — no jacobians. Used for LM accept/reject.

    On a card the observation cost comes from the cost-only kernel (the
    same f32 arithmetic as assemble's cost, so accept/reject comparisons
    are internally consistent). With ``axis`` the observation and
    groundplane cost is summed over the shards before the regularizers'
    cost is added."""
    ops, sizes = _obs_kernel_args(window, sel, rig, cfg)
    cost = cuda_assemble.cost_obs(*ops, **sizes)
    _, _, _, gp_cost, _, _ = _gp_system(window, sel, cfg, with_jacobians=False)
    (cost,) = all_reduce_sum([cost + gp_cost], axis)
    reg_r, reg_w, _ = _regularizer_system(window, sel, cfg,
                                          with_jacobian=False)
    return cost + 0.5 * torch.sum(reg_w * reg_r * reg_r)


@traced("limo.residual_stats")
def residual_stats(window: Window, sel: Selection, rig, cfg,
                   axis=None) -> ResidualStats:
    """Loss-free per-landmark residual scores for trimming — forward pass
    only (``calculateResiduals``/``getMaximumResidual``,
    robust_solving.cpp:16-91 evaluate without loss). The scores are the
    shard's own; with ``axis`` the two counts are summed over the
    shards."""
    r_obs, repr_ok, depth_ok = _obs_system(window, sel, rig)
    r_gp, _, gp_on, _, _, _ = _gp_system(window, sel, cfg, with_jacobians=False)
    s_repr = torch.linalg.vector_norm(r_obs[..., :2], dim=-1)
    s_depth = torch.abs(r_obs[..., 2])
    zero = torch.zeros_like(s_repr)
    n_depth, n_gp = all_reduce_sum(
        [depth_ok.sum(dtype=torch.int32).reshape(1),
         gp_on.sum(dtype=torch.int32).reshape(1)], axis)
    return ResidualStats(
        repr_score=torch.where(repr_ok, s_repr, zero).amax(dim=(1, 2)),
        depth_score=torch.where(depth_ok, s_depth, zero).amax(dim=(1, 2)),
        gp_score=torch.where(gp_on, torch.abs(r_gp), torch.zeros_like(r_gp)),
        repr_valid=repr_ok.any(dim=2).any(dim=1),
        depth_valid=depth_ok.any(dim=2).any(dim=1),
        gp_valid=gp_on,
        n_depth=n_depth[0],
        n_gp=n_gp[0],
    )


@traced("limo.regularizers")
def _regularizer_system(window: Window, sel: Selection, cfg,
                        with_jacobian: bool = True):
    """All pose/plane-only regularizers as one stacked residual vector with
    a dense jacobian over the P parameters. Fixed residual count R.

    Families (reference wiring in solve(), :703-818):
      scale:        1 residual — ‖t(T_k1 ∘ T_k0⁻¹)‖ − target
      plane normal chain:   3(K-1) — n_k − n_{k+1} (weight 3w)
      plane dist chain:     (K-1)  — d_k − d_{k+1} (weight w)
      plane motion:         (K-1)  — n_k · Δt̂ (weight 2w)
      plane prior:          3K     — n_k − (0,0,1) (weight w)
    """
    K = window.K
    P = K * PD
    dtype = window.poses.dtype
    kw = dict(dtype=dtype, device=window.poses.device)
    w_gp = cfg.regularization.gp_reg_weight

    # consecutive-in-TIME active keyframe chain. Window slots are NOT
    # time-ordered in general (slot allocators reuse evicted slots), so the
    # chain pairs come from a stamp sort: pair i links the i-th and
    # (i+1)-th oldest active keyframes — exactly the reference's
    # consecutive-keyframe chains (addGroundplaneRegularization,
    # bundle_adjuster_keyframes.cpp:769-818).
    kf_valid = window.kf_valid
    order = torch.argsort(torch.where(
        kf_valid, window.stamps, torch.full_like(window.stamps, torch.inf)),
        stable=True)
    ia, ib = order[:-1], order[1:]
    n_valid = kf_valid.sum()
    pair_ok = torch.arange(K - 1, device=kw["device"]) < (n_valid - 1)
    plane_ok = window.plane_valid & kf_valid
    chain_plane_ok = pair_ok & plane_ok[ia] & plane_ok[ib]
    # One-hot row-selection matrices: exact products (rows are one-hot)
    oh_a = _one_hot(ia, K, dtype)                # [K-1,K]
    oh_b = _one_hot(ib, K, dtype)
    oh_s0 = _one_hot(sel.scale_kf0, K, dtype)    # [K]
    oh_s1 = _one_hot(sel.scale_kf1, K, dtype)
    prior = torch.eye(3, **kw)[2]                # (0,0,1), made on the device

    def pick(oh, x):
        return oh @ x

    def all_res(delta):
        poses = pose_ops.boxplus(window.poses, delta[:, :6])
        planes = plane_boxplus(window.planes, delta[:, 6:])
        poses_a, poses_b = pick(oh_a, poses), pick(oh_b, poses)
        planes_a, planes_b = pick(oh_a, planes), pick(oh_b, planes)
        r_scale, _ = res_k.pose_scale(pick(oh_s1, poses), pick(oh_s0, poses),
                                      sel.scale_target)
        r_ndiff, _ = res_k.vector_difference(planes_a[:, :3], planes_b[:, :3])
        r_ddiff = planes_a[:, 3] - planes_b[:, 3]
        r_motion, _ = res_k.groundplane_motion(poses_a, poses_b,
                                               planes_a[:, :3])
        r_prior = planes[:, :3] - prior
        return torch.cat([r_scale, r_ndiff.reshape(-1), r_ddiff,
                          r_motion.reshape(-1), r_prior.reshape(-1)])

    delta0 = torch.zeros((K * PD,), **kw)
    r = all_res(delta0.reshape(K, PD))
    J = (jacrev(lambda d: all_res(d.reshape(K, PD)))(delta0)
         if with_jacobian else None)

    # weights per residual row
    w = torch.cat([
        sel.scale_weight.reshape(1).to(dtype),
        (3.0 * w_gp) * chain_plane_ok.to(dtype).repeat_interleave(3),
        w_gp * chain_plane_ok.to(dtype),
        (2.0 * w_gp) * (pair_ok & plane_ok[ia]).to(dtype),
        w_gp * plane_ok.to(dtype).repeat_interleave(3),
    ])
    return r, w, (J.reshape(r.shape[0], P) if with_jacobian else None)
