"""Normal-equation assembly with per-landmark Schur elimination.

This replaces Ceres' problem graph + DENSE_SCHUR
(``bundle_adjuster_keyframes.cpp:564-627`` residual wiring,
``robust_solving.hpp:93-108`` solver config) with a fixed-shape, masked
pipeline:

  parameters  δ = [pose tangents K×6 | plane tangents K×4 | landmarks L×3]
  residuals   r = [reprojection 2/obs | depth 1/obs | gp-height 1/lm | regs]

The observation blocks come from the fused assembly kernel
(:mod:`limo_tpu_torch.solver.cuda_assemble`) on a card (f32), and from
its plain PyTorch version on the CPU; both implement the analytic Jacobians
of :mod:`limo_tpu_torch.solver.analytic`. Where the reference package takes
its non-kernel route (:func:`assembly_plan`: the kernels turned off,
rotation-compensated residuals, a float64 window on a card), they come from
its ``_obs_system`` instead: ``vmap(jacfwd)`` over the flattened
observation grid and five full-f32 contractions. Groundplane and regularizer
Jacobians are closed forms (:mod:`limo_tpu_torch.solver.analytic`) w.r.t.
the local tangents (the ``boxplus`` retractions of
:mod:`limo_tpu_torch.geometry.pose` and :func:`plane_boxplus`), batched over
the landmarks and the keyframe pairs. The reduced (pose+plane) system is
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
from torch.func import jacfwd, vmap

from .. import residuals as res_k
from ..geometry import pose as pose_ops
from ..geometry.quaternion import qnormalize, qto_matrix
from ..robust import cauchy_weight, huber_weight
from ..state import Selection, Window
from ..utils.collectives import all_reduce_sum
from ..utils.precision import full_f32
from ..utils.profiling import traced
from . import analytic, cuda_assemble

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


def assembly_plan(dtype, device, cfg, compensate_rotation: bool = False
                  ) -> str:
    """Which observation assembly a solve with these parameters takes.

    The kernels' route: ``"plain(cpu)"`` on the CPU (their plain versions,
    any float dtype), ``"cuda[block=N]"`` on a card (the hand-written
    kernels, N threads per block, float32). Where the reference package
    takes its non-kernel ``einsum(<reason>)`` route, the port takes
    ``"torch(<reason>)"`` (:func:`_torch_obs_blocks`) on either device, for
    the reference's reasons: ``disabled`` (``SolverConfig.
    use_pallas_assembly=False``), ``rotation-compensated`` (the kernels
    compute plain reprojection residuals only) and ``dtype`` (a float64
    window on a card). The caller's arguments alone decide; a card window
    of another float type and any other device raise."""
    reason = _torch_reason(dtype, device, cfg, compensate_rotation)
    if reason is not None:
        return f"torch({reason})"
    if torch.device(device).type == "cpu":
        return "plain(cpu)"
    return f"cuda[block={cuda_assemble.block_size()}]"


def _torch_reason(dtype, device, cfg, compensate_rotation: bool):
    """The reference's reason for its non-kernel route, or None where the
    port takes the kernels' route (see :func:`assembly_plan`)."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no observation assembly for device {device}")
    if device.type == "cuda" and dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no observation assembly on a card for {dtype}")
    if not cfg.solver.use_pallas_assembly:
        return "disabled"
    if compensate_rotation:
        return "rotation-compensated"
    if device.type == "cuda" and dtype != torch.float32:
        return "dtype"
    return None


def _kernel_route(window: Window, cfg, compensate_rotation: bool) -> bool:
    """True where :func:`assembly_plan` picks the kernels (or their plain
    versions), False for the ``torch(...)`` route."""
    return _torch_reason(window.poses.dtype, window.poses.device, cfg,
                         compensate_rotation) is None


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
# Per-observation residuals on the dense [L,K,C] grid: the forward pass (trim
# scores, the torch route's cost) and the reference's non-kernel assembly.
# ---------------------------------------------------------------------------

@traced("limo.obs_residuals")
def _obs_system(window: Window, sel: Selection, rig,
                compensate_rotation: bool):
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
                                     Tcv[None, None],
                                     compensate_rotation=compensate_rotation)
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


def _obs_weights(window: Window, cfg, r, repr_ok, depth_ok):
    """IRLS row weights [L,K,C,3] (Cauchy × landmark weight) and the robust
    observation cost of the residuals of :func:`_obs_system`."""
    robust_cfg = cfg.robust
    s_repr = torch.sum(r[..., :2] ** 2, -1)
    s_depth = r[..., 2] ** 2
    w_lm = window.lm_weight[:, None, None]
    zero = torch.zeros_like(s_repr)
    w_repr = torch.where(repr_ok, w_lm * cauchy_weight(
        s_repr, robust_cfg.reprojection_thres), zero)
    w_depth = torch.where(depth_ok, w_lm * cauchy_weight(
        s_depth, robust_cfg.depth_thres), zero)
    row_w = torch.stack([w_repr, w_repr, w_depth], -1)
    a2r = robust_cfg.reprojection_thres ** 2
    a2d = robust_cfg.depth_thres ** 2
    cost = 0.5 * torch.sum(torch.where(
        repr_ok, w_lm * a2r * torch.log1p(s_repr / a2r), zero)) \
        + 0.5 * torch.sum(torch.where(
            depth_ok, w_lm * a2d * torch.log1p(s_depth / a2d), zero))
    return row_w, cost


def _obs_residual(pose_tangent, lm_delta, pose, lm, uvd, focal, principal,
                  T_cam_veh, compensate_rotation):
    """3-vector residual [repr_u, repr_v, depth] of one observation as a
    function of the local tangents (for ``jacfwd``)."""
    p = pose_ops.boxplus(pose, pose_tangent)
    x = lm + lm_delta
    rr, _ = res_k.reprojection(p, x, uvd[:2], focal, principal, T_cam_veh,
                               compensate_rotation=compensate_rotation)
    rd, _ = res_k.landmark_depth(p, x, uvd[2], T_cam_veh)
    return torch.cat([rr, rd])


@traced("limo.obs_jacobians")
def _obs_jacobians(window: Window, rig, compensate_rotation: bool):
    """Tangent Jacobians of every observation residual, by ``vmap(jacfwd)``
    over the flattened landmark-major [L·K·C] grid (the reference's
    ``_obs_system``). Returns (Jp [L,K,C,3,6], Jl [L,K,C,3,3])."""
    K, L, C = window.K, window.L, window.C
    N = L * K * C
    dtype = window.poses.dtype
    kw = dict(dtype=dtype, device=window.poses.device)

    def flat(x):
        """[..., d] broadcast to the grid → [N, d]."""
        return x.expand(L, K, C, x.shape[-1]).reshape(N, x.shape[-1])

    args = (torch.zeros((N, 6), **kw), torch.zeros((N, 3), **kw),
            flat(window.poses[None, :, None]),
            flat(window.lm_pos[:, None, None]),
            window.obs.reshape(N, 3),
            flat(rig.focal.to(dtype)[None, None, :, None])[:, 0],
            flat(rig.principal.to(dtype)[None, None]),
            flat(rig.T_cam_veh.to(dtype)[None, None]))

    def one(pt, ld, *obs):
        return _obs_residual(pt, ld, *obs, compensate_rotation)

    Jp, Jl = vmap(jacfwd(one, argnums=(0, 1)))(*args)
    return Jp.reshape(L, K, C, 3, 6), Jl.reshape(L, K, C, 3, 3)


@traced("limo.torch_obs_blocks")
@full_f32
def _torch_obs_blocks(window: Window, sel: Selection, rig, cfg,
                      compensate_rotation: bool) -> cuda_assemble.ObsBlocks:
    """The observation blocks on the reference's non-kernel route: residuals,
    masks and weights on the dense grid, ``vmap(jacfwd)`` Jacobians, and the
    five contractions over the observation axes in full f32."""
    r, repr_ok, depth_ok = _obs_system(window, sel, rig, compensate_rotation)
    row_w, cost = _obs_weights(window, cfg, r, repr_ok, depth_ok)
    Jp, Jl = _obs_jacobians(window, rig, compensate_rotation)
    Jp_w = Jp * row_w[..., None]                            # rows scaled by w
    Jl_w = Jl * row_w[..., None]
    return cuda_assemble.ObsBlocks(
        V=torch.einsum("lkcri,lkcrj->lij", Jl_w, Jl),
        b_l=-torch.einsum("lkcri,lkcr->li", Jl_w, r),
        W=torch.einsum("lkcri,lkcrj->lkij", Jp_w, Jl),
        U=torch.einsum("lkcri,lkcrj->kij", Jp_w, Jp),
        b_pose=-torch.einsum("lkcri,lkcr->ki", Jp_w, r),
        cost=cost)


def _obs_blocks(window: Window, sel: Selection, rig, cfg,
                compensate_rotation: bool) -> cuda_assemble.ObsBlocks:
    """The observation blocks on the route :func:`assembly_plan` picks."""
    if not _kernel_route(window, cfg, compensate_rotation):
        return _torch_obs_blocks(window, sel, rig, cfg, compensate_rotation)
    ops, sizes = _obs_kernel_args(window, sel, rig, cfg)
    return cuda_assemble.assemble_obs(*ops, **sizes)


def _obs_cost(window: Window, sel: Selection, rig, cfg,
              compensate_rotation: bool) -> torch.Tensor:
    """The robust observation cost on the route :func:`assembly_plan`
    picks (the cost-only kernel on the kernels' route)."""
    if not _kernel_route(window, cfg, compensate_rotation):
        r, repr_ok, depth_ok = _obs_system(window, sel, rig,
                                           compensate_rotation)
        return _obs_weights(window, cfg, r, repr_ok, depth_ok)[1]
    ops, sizes = _obs_kernel_args(window, sel, rig, cfg)
    return cuda_assemble.cost_obs(*ops, **sizes)


@traced("limo.gp_system")
def _gp_system(window: Window, sel: Selection, cfg, with_jacobians: bool):
    """Groundplane height residuals per landmark vs the attached keyframe,
    with their closed-form Jacobians
    (:func:`~limo_tpu_torch.solver.analytic.groundplane_height_jac`).

    Returns (r_gp [L], w_gp [L], gp_on [L], cost, Jgp_kp [L,10]|None,
    Jgp_lm [L,3]|None)."""
    K = window.K
    reg_cfg = cfg.regularization
    gp_kf = sel.gp_kf.long()
    lm_active = window.lm_valid & sel.lm_selected
    gp_on = lm_active & window.lm_is_gp & (sel.gp_weight > 0) \
        & window.kf_valid[gp_kf]
    # each landmark's keyframe (R, t) and plane, gathered in one index
    kf = torch.cat([analytic.rotations(window.poses).reshape(K, 9),
                    window.poses[:, 4:], window.planes], -1)[gp_kf]
    r_gp, J_pose, J_plane, Jgp_lm = analytic.groundplane_height_jac(
        kf[:, :9].reshape(-1, 3, 3), kf[:, 9:12], kf[:, 12:], window.lm_pos)
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
        Jgp_kp = torch.cat([J_pose, J_plane], -1)
    else:
        Jgp_kp = Jgp_lm = None
    return r_gp, w_gp, gp_on, cost, Jgp_kp, Jgp_lm


@traced("limo.assemble")
def assemble(window: Window, sel: Selection, rig, cfg,
             compensate_rotation: bool = False, pose_only: bool = False,
             speed_reg=None, axis=None) -> NormalEqs:
    """Build the (masked, undamped) normal equations at the current state.

    ``compensate_rotation``: RotRocc reprojection residuals (divided by the
    norm of the rotation-only reprojection error), on the ``torch(...)``
    route. ``pose_only``: the motion-only solve of a window, landmarks held
    fixed (``deactivateLandmarks``, :221-270) and every regularizer but the
    speed family weighted 0. ``speed_reg``: ``(kf_index,
    pose_origin_before, vel_before, dt, weight)`` for the constant-velocity
    residual of keyframe ``kf_index`` (``adjustPoseOnly``:835-853).

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

    # ---- observation blocks: fused kernel (plain version on the CPU), or
    # the torch route where the reference takes its einsum route ----------
    obs = _obs_blocks(window, sel, rig, cfg, compensate_rotation)
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
    reg_r, reg_w, reg_J = _regularizer_system(window, sel, cfg, speed_reg,
                                              pose_only)
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
    # motion-only: landmarks fixed (deactivateLandmarks, :221-270); the
    # observation blocks above are the same, the masks below drop them
    lm_free = torch.zeros_like(lm_active) if pose_only else lm_active

    # apply masks: zero fixed rows/cols; unit diagonal added later w/ damping
    H_pp = H_pp * param_mask[:, None] * param_mask[None, :]
    b_p = b_p * param_mask
    lm_f = lm_free.to(dtype)
    W6 = W6 * pose_dim_mask[None, :, :, None] * lm_f[:, None, None, None]
    # the plane block's gauge mask gathered at each landmark's gp keyframe
    Wp = Wp * (gp_oh @ plane_dim_mask)[:, :, None] * lm_f[:, None, None]
    V = torch.where(lm_free[:, None, None], V,
                    torch.eye(3, **kw).expand(L, 3, 3))
    b_l = b_l * lm_f[:, None]
    return NormalEqs(H_pp=H_pp, b_p=b_p, V=V, b_l=b_l, W6=W6, Wp=Wp,
                     gp_oh=gp_oh, cost=cost, param_mask=param_mask,
                     lm_mask=lm_free)


@traced("limo.compute_cost")
def compute_cost(window: Window, sel: Selection, rig, cfg,
                 compensate_rotation: bool = False, pose_only: bool = False,
                 speed_reg=None, axis=None) -> torch.Tensor:
    """Robust cost only — no jacobians. Used for LM accept/reject; the
    modes are :func:`assemble`'s.

    On a card's kernel route the observation cost comes from the cost-only
    kernel (the same f32 arithmetic as assemble's cost, so accept/reject
    comparisons are internally consistent); on the torch route from the
    forward pass of the grid. With ``axis`` the observation and
    groundplane cost is summed over the shards before the regularizers'
    cost is added."""
    cost = _obs_cost(window, sel, rig, cfg, compensate_rotation)
    _, _, _, gp_cost, _, _ = _gp_system(window, sel, cfg, with_jacobians=False)
    (cost,) = all_reduce_sum([cost + gp_cost], axis)
    reg_r, reg_w, _ = _regularizer_system(window, sel, cfg, speed_reg,
                                          pose_only, with_jacobian=False)
    return cost + 0.5 * torch.sum(reg_w * reg_r * reg_r)


@traced("limo.residual_stats")
def residual_stats(window: Window, sel: Selection, rig, cfg,
                   compensate_rotation: bool = False,
                   axis=None) -> ResidualStats:
    """Loss-free per-landmark residual scores for trimming — forward pass
    only (``calculateResiduals``/``getMaximumResidual``,
    robust_solving.cpp:16-91 evaluate without loss). The scores are the
    shard's own; with ``axis`` the two counts are summed over the
    shards."""
    r_obs, repr_ok, depth_ok = _obs_system(window, sel, rig,
                                           compensate_rotation)
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
def _regularizer_system(window: Window, sel: Selection, cfg, speed_reg=None,
                        pose_only: bool = False, with_jacobian: bool = True):
    """All pose/plane-only regularizers as one stacked residual vector with
    a dense jacobian over the P parameters. Fixed residual count R.

    Families (reference wiring in solve(), :703-818):
      scale:        1 residual — ‖t(T_k1 ∘ T_k0⁻¹)‖ − target
      plane normal chain:   3(K-1) — n_k − n_{k+1} (weight 3w)
      plane dist chain:     (K-1)  — d_k − d_{k+1} (weight w)
      plane motion:         (K-1)  — n_k · Δt̂ (weight 2w)
      plane prior:          3K     — n_k − (0,0,1) (weight w)
      speed (motion-only):  3      — constant-velocity vector residual of
                                     keyframe ``speed_reg[0]`` (weight
                                     ``speed_reg[4]``)
    Under ``pose_only`` every family but the speed one has weight 0.

    The Jacobian is in closed form (:mod:`.analytic`): each row depends on
    the tangents of at most two keyframes, and their blocks enter the dense
    J through the one-hot pickers, so a pair on one slot sums both.
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
    if speed_reg is not None:
        kf_i, pose_origin_before, vel_before, dt, speed_w = speed_reg
        if not torch.is_tensor(kf_i):        # a fill, not an upload
            kf_i = torch.full((), kf_i, dtype=torch.long, device=kw["device"])
        oh_sp = _one_hot(kf_i, K, dtype)         # [K]

    def pick(oh, x):
        """Rows of the per-keyframe ``x`` [K,...] that ``oh`` [...,K]
        picks (exact: one-hot products)."""
        return (oh @ x.reshape(K, -1)).reshape(oh.shape[:-1] + x.shape[1:])

    # per keyframe: the pose as (R, t), the plane's unit normal n̂ and its
    # retraction Jacobian dn (plane_boxplus at δ = 0)
    R = analytic.rotations(window.poses)
    t = window.poses[:, 4:]
    nh, dn = analytic.plane_normal_jac(window.planes[:, :3])
    d = window.planes[:, 3]
    # u = translation(T_1 ∘ T_0⁻¹) of the K-1 chain pairs (1, 0) = (a, b),
    # then of the scale pair (kf1, kf0)
    oh_1 = torch.cat([oh_a, oh_s1[None]])
    oh_0 = torch.cat([oh_b, oh_s0[None]])
    t_0 = pick(oh_0, t)
    u, c, R_rel = analytic.relative_translation(pick(oh_1, R), pick(oh_1, t),
                                                pick(oh_0, R), t_0)
    u_norm = res_k._safe_norm(u)                  # 0 where ‖u‖² ≤ 1e-20
    unit = u / torch.clamp_min(u_norm, 1e-12)[:, None]
    nh_a, nh_b = pick(oh_a, nh), pick(oh_b, nh)
    r_motion = torch.sum(nh_a * unit[:-1], -1)
    parts = [u_norm[-1:] - sel.scale_target, (nh_a - nh_b).reshape(-1),
             pick(oh_a, d) - pick(oh_b, d), r_motion,
             (nh - prior).reshape(-1)]
    if speed_reg is not None:
        r_speed, J_speed = analytic.speed_vector_jac(
            pick(oh_sp, R), pick(oh_sp, t), pose_origin_before[4:],
            vel_before, dt)
        parts.append(r_speed)
    r = torch.cat(parts)

    # weights per residual row
    w = [sel.scale_weight.reshape(1).to(dtype),
         (3.0 * w_gp) * chain_plane_ok.to(dtype).repeat_interleave(3),
         w_gp * chain_plane_ok.to(dtype),
         (2.0 * w_gp) * (pair_ok & plane_ok[ia]).to(dtype),
         w_gp * plane_ok.to(dtype).repeat_interleave(3)]
    if speed_reg is not None:
        w.append(torch.ones((3,), **kw) * speed_w)
    w = torch.cat(w)
    if pose_only:
        # the motion-only solve keeps only the speed family
        n_speed = 3 if speed_reg is not None else 0
        w = w * torch.cat([torch.zeros((w.shape[0] - n_speed,), **kw),
                           torch.ones((n_speed,), **kw)])
    if not with_jacobian:
        return r, w, None

    def place(oh, blocks):
        """Blocks [...,n,PD] at the keyframe ``oh`` [...,K] picks, as rows
        [...,n,P] of the dense Jacobian (exact: one-hot products)."""
        return (oh[..., None, :, None] * blocks[..., :, None, :]).reshape(
            blocks.shape[:-1] + (P,))

    pad = torch.nn.functional.pad
    # ∂r/∂u of the scalar residuals of u: n̂_a·u/‖u‖ (motion) and ‖u‖
    # (scale). Where ‖u‖ is guarded to 0, autodiff of the forward pass
    # gives I/1e-12 for ∂(u/‖u‖)/∂u (the clamp) and 0 for ∂‖u‖/∂u.
    scale_ok = (u_norm[-1:] > 0).to(dtype)[:, None]
    v = torch.cat([(nh_a - unit[:-1] * r_motion[:, None])
                   / torch.clamp_min(u_norm[:-1], 1e-12)[:, None],
                   unit[-1:] * scale_ok])
    J_1, J_0 = analytic.relative_translation_vjp(v, c, R_rel, t_0)
    # chain pair i: its normal (3), distance (1) and motion (1) rows at
    # keyframes a and b; the plane tangent is columns 6-8 (δn) and 9 (δd)
    e_d = torch.eye(PD, **kw)[PD - 1].expand(K - 1, 1, PD)
    dn_a, dn_b = pick(oh_a, dn), pick(oh_b, dn)
    motion_a = torch.cat([J_1[:-1], (dn_a @ unit[:-1, :, None])[..., 0]], -1)
    blocks_a = torch.cat([pad(dn_a, (6, 1)), e_d,
                          pad(motion_a, (0, 1))[:, None]], 1)
    blocks_b = torch.cat([pad(-dn_b, (6, 1)), -e_d,
                          pad(J_0[:-1], (0, 4))[:, None]], 1)
    J_pair = place(oh_a, blocks_a) + place(oh_b, blocks_b)   # [K-1,5,P]
    rows = [place(oh_s1, pad(J_1[-1:], (0, 4)))
            + place(oh_s0, pad(J_0[-1:], (0, 4))),
            J_pair[:, :3].reshape(-1, P), J_pair[:, 3], J_pair[:, 4],
            place(torch.eye(K, **kw), pad(dn, (6, 1))).reshape(-1, P)]
    if speed_reg is not None:
        rows.append(place(oh_sp, pad(J_speed, (0, 4))))
    return r, w, torch.cat(rows)
