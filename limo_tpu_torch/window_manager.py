"""The solve-time selector stack of the optimization-graph manager.

Reference: ``BundleAdjusterKeyframes::solve`` (``bundle_adjuster_keyframes.cpp``)
runs outlier flags → cheirality → voxel sparsification → AddDepth(gp)
guarantees, then wires the groundplane and scale residuals. This module
holds that stack as one device function (:func:`selection_for_solve`) and
the semantic label sets the scan step reads. The host-side manager of the
reference package (``BundleAdjuster``) is not part of the port yet.
"""

from __future__ import annotations

import torch

from .geometry import pose as pose_ops
from .selection.landmark import (add_depth_scheme, cheirality_mask, norm,
                                 kf_positions, take, voxel_scheme)
from .state import Selection, Window

# cityscapes label sets preloaded by the reference
# (bundle_adjuster_keyframes.hpp:226-255, res/outlier_labels.yaml)
DEFAULT_OUTLIER_LABELS = frozenset(
    [0, 1, 2, 3, 5, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, -1])
DEFAULT_SHRUBBERY_LABELS = frozenset([21, 22, 23])
DEFAULT_GROUND_LABELS = frozenset([6, 7, 8, 9])


def selection_for_solve(window: Window, newest, k0, k1, lm_outlier, rig, cfg):
    """Landmark selection + solve wiring, on the device.

    Mirrors the reference solve()'s selector stack: outlier flags →
    cheirality → voxel sparsification → AddDepth(gp) guarantees; then the
    scale / groundplane regularization weight logic (:703-728).

    newest/k0/k1: slots of the newest and two oldest active keyframes
    (0-d tensors). Returns (Selection, voxel categories [L])."""
    dtype = window.lm_pos.dtype
    device = window.lm_pos.device
    K = window.K
    keep = cheirality_mask(window, rig) & (~lm_outlier) & window.lm_valid
    # second-newest active keyframe by stamp (slots are NOT time-ordered once
    # the allocator reuses evicted slots) — the flow anchor for the near bin
    slots = torch.arange(K, device=device)
    small = torch.full_like(window.stamps, -torch.inf)
    s = torch.where(window.kf_valid & (slots != newest), window.stamps, small)
    last_kf = torch.argmax(s).to(torch.int32)
    vox = voxel_scheme(window, newest, keep, cfg, last_kf=last_kf)
    selected = add_depth_scheme(
        window, vox.selected, keep & window.lm_is_gp,
        cfg.landmark_selection.min_number_landmarks_gp)
    selected = selected & keep

    # gp residual wiring: nearest active keyframe with enabled plane,
    # weight 10*(1 − d/25) when d < 25 (addGroundPlaneResiduals :517-562)
    d_all = norm(window.lm_pos[:, None] - kf_positions(window)[None])
    d_all = torch.where((window.kf_valid & window.plane_valid)[None], d_all,
                        torch.full_like(d_all, torch.inf))
    gp_kf = torch.argmin(d_all, dim=1).to(torch.int32)
    d_min = d_all.amin(dim=1)
    reg = cfg.regularization
    gmax = reg.gp_max_distance
    zero = torch.zeros_like(d_min)
    gp_w = torch.where(d_min < gmax,
                       reg.gp_height_weight * (1.0 - d_min / gmax), zero)
    gp_w = torch.where(window.lm_is_gp & selected, gp_w, zero)

    # scale logic (:703-728): counts decide regularization weight
    depth_cnt = torch.sum((window.obs_mask & (window.obs[..., 2] > 0)
                           & selected[:, None, None]
                           & window.lm_has_depth[:, None, None]
                           & window.kf_valid[None, :, None]).to(torch.int32),
                          dtype=torch.int32)
    gp_cnt = torch.sum((gp_w > 0).to(torch.int32), dtype=torch.int32)
    observed = (depth_cnt > 10) | (gp_cnt > 10)
    n_obs = torch.clamp_min(depth_cnt + gp_cnt, 1).to(dtype)
    scale_w = torch.where(
        observed,
        torch.where(gp_cnt < 30, reg.scale_reg_weight_observed_base / n_obs,
                    torch.zeros_like(n_obs)),
        torch.full_like(n_obs, reg.scale_reg_weight_unobserved))
    # two oldest active keyframes anchor the scale
    t0 = pose_ops.translation(pose_ops.relative(take(window.poses, k1),
                                                take(window.poses, k0)))
    target = torch.sqrt(torch.sum(t0 * t0))
    plane_dist_fixed = depth_cnt < 10  # :731-737

    as_i32 = lambda k: torch.as_tensor(k, device=device).to(torch.int32)
    sel = Selection(
        lm_selected=selected,
        gp_kf=gp_kf,
        gp_weight=gp_w,
        scale_kf0=as_i32(k0),
        scale_kf1=as_i32(k1),
        scale_target=target,
        scale_weight=scale_w,
        plane_dist_fixed=plane_dist_fixed,
    )
    return sel, vox.category
