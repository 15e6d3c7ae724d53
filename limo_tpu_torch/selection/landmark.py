"""Landmark selection schemes as mask functions on the device.

Reference: ``keyframe_bundle_adjustment`` selection stack
(``landmark_selector.hpp:118-253`` 3-phase pattern:
rejection → selection(force-include) → sparsification; union at the end).

Every scheme takes the Window (+ per-landmark features) and returns boolean
masks / category codes over the fixed [L] axis. "Choosing K of N" is a
masked top-k; "voxel-grid downsampling" is a quantize + stable sort-based
unique; "random shuffle take N" is a top-k over hashed scores. No
data-dependent shapes, and nothing reads a value back to the host.

The masks are the reference package's bit for bit: its sorts are stable
(ties go to the lowest index, here ``stable=True``), its uint32 hashes wrap
(here emulated in int64 under a 32-bit mask, with every product kept below
2^63), and a hash cast to float rounds to the nearest value as there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import pose as pose_ops
from ..state import Window
from ..utils import uint32

# category codes
CAT_NONE = -1
CAT_NEAR = 0
CAT_MIDDLE = 1
CAT_FAR = 2


def norm(x):
    """‖x‖ over the last axis as the reference package forms it."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def take(x, idx, dim=0):
    """``x`` at the 0-d index tensor ``idx`` along ``dim``, read on the
    device (indexing with a 0-d tensor would read it back to the host)."""
    idx = torch.as_tensor(idx, device=x.device).reshape(1).long()
    return x.index_select(dim, idx).squeeze(dim)


def kf_positions(window: Window):
    """[K,3] keyframe positions in the origin frame."""
    return pose_ops.translation(pose_ops.inverse(window.poses))


# ---------------------------------------------------------------------------
# Rejection schemes
# ---------------------------------------------------------------------------

def cheirality_mask(window: Window, rig) -> torch.Tensor:
    """``LandmarkRejectionSchemeCheirality``
    (landmark_selection_scheme_cheirality.cpp:22-60): a landmark survives iff
    it projects with z>0 in every observing camera of every active keyframe.

    Returns keep-mask [L].
    """
    tcv = rig.T_cam_veh.to(window.lm_pos.dtype)
    p_kf = pose_ops.apply(window.poses[None, :, None, :],
                          window.lm_pos[:, None, None, :])        # [L,K,1,3]
    z = pose_ops.apply(tcv[None, None], p_kf)[..., 2]             # [L,K,C]
    relevant = window.obs_mask & window.kf_valid[None, :, None]
    bad = relevant & (z <= 0)
    return ~bad.any(dim=2).any(dim=1)


def dimension_plausibility_mask(window: Window, newest_kf, min_xyz,
                                max_xyz) -> torch.Tensor:
    """``LandmarkRejectionSchemeDimensionPlausibility``
    (landmark_selection_scheme_dimension_plausibility.hpp:33-76): landmark in
    the newest keyframe's frame must lie inside [min,max] box."""
    p = pose_ops.apply(take(window.poses, newest_kf), window.lm_pos)
    ok = [(p[:, i] >= min_xyz[i]) & (p[:, i] <= max_xyz[i]) for i in range(3)]
    return ok[0] & ok[1] & ok[2]


# ---------------------------------------------------------------------------
# Helpers (landmark_selection_scheme_helpers.cpp)
# ---------------------------------------------------------------------------

def track_lengths(window: Window) -> torch.Tensor:
    """Number of (valid-keyframe) observations per landmark [L]."""
    m = window.obs_mask & window.kf_valid[None, :, None]
    return torch.sum(m.to(torch.int32), dim=(1, 2), dtype=torch.int32)


def landmark_flow(window: Window, kf_a, kf_b):
    """Per-landmark flow between two keyframes: max over cameras of pixel
    displacement (``calcFlow``, landmark_selection_scheme_helpers.cpp:14-231
    computes max per-cam mean flow between consecutive keyframes; per-landmark
    it is the feature displacement). Returns (flow [L], has_flow [L])."""
    uv_a = take(window.obs, kf_a, 1)[..., :2]
    uv_b = take(window.obs, kf_b, 1)[..., :2]
    ok = take(window.obs_mask, kf_a, 1) & take(window.obs_mask, kf_b, 1)
    d = norm(uv_a - uv_b)
    return torch.where(ok, d, torch.zeros_like(d)).amax(dim=-1), ok.any(dim=-1)


def _inverse_permutation(order):
    """rank[order[i]] = i, without a scatter."""
    return torch.argsort(order)


def _masked_topk_mask(scores, mask, k: int) -> torch.Tensor:
    """Boolean mask of the top-k scoring entries among ``mask`` (ties broken
    by index). Fixed-shape replacement for sort-and-take-N."""
    if k >= scores.shape[0]:
        return mask
    neg = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.full_like(scores, neg))
    kth = torch.sort(s).values[-k]
    sel = mask & (s >= kth)
    # tie overflow guard: keep at most k by cumulative count
    order = torch.argsort(-s, stable=True)
    rank = _inverse_permutation(order)
    return sel & (rank < k)


def _hash_u32(x) -> torch.Tensor:
    """Cheap integer hash (xorshift-multiply) for pseudo-random choice: the
    reference package's uint32 arithmetic, in int64 under a 32-bit mask."""
    x = x.to(torch.int64) & uint32.MASK
    x = uint32.mul(x ^ (x >> 16), 0x7FEB352D)
    x = uint32.mul(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _hash_scores(window: Window, offset, dtype):
    """Hashed row scores, rounded to the nearest ``dtype`` value."""
    rows = torch.arange(window.L, dtype=torch.int32,
                        device=window.lm_pos.device)
    return _hash_u32(rows + offset).to(dtype)


# ---------------------------------------------------------------------------
# Voxel sparsification + categorization (the production scheme)
# ---------------------------------------------------------------------------

class VoxelResult(NamedTuple):
    selected: torch.Tensor   # [L] bool
    category: torch.Tensor   # [L] int32 (CAT_*)


def _dist_to_path(points, path, path_valid):
    """Min distance of each point to the polyline through path vertices.

    points [L,3], path [K,3] (positions of active keyframes in the current
    keyframe frame), path_valid [K]. Replaces boost::geometry distance to
    linestring (landmark_selection_scheme_voxel.cpp:96-113).
    """
    a = path[:-1]          # [K-1,3]
    b = path[1:]
    seg_ok = path_valid[:-1] & path_valid[1:]
    ab = b - a
    denom = torch.clamp_min(torch.sum(ab * ab, dim=-1), 1e-12)  # [K-1]
    ap = points[:, None, :] - a[None, :, :]                      # [L,K-1,3]
    t = torch.clamp(torch.sum(ap * ab[None], dim=-1) / denom[None], 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    inf = torch.full((), torch.inf, dtype=points.dtype, device=points.device)
    d_seg = torch.where(seg_ok[None], norm(points[:, None, :] - proj), inf)
    # degenerate: single valid vertex → distance to that vertex
    d_vert = torch.where(path_valid[None],
                         norm(points[:, None, :] - path[None]), inf)
    return torch.minimum(d_seg.amin(dim=1), d_vert.amin(dim=1))


def _categorize(near_sel, middle_sel, far_sel):
    category = torch.full(near_sel.shape, CAT_NONE, dtype=torch.int32,
                          device=near_sel.device)
    category = torch.where(far_sel, CAT_FAR, category)
    category = torch.where(middle_sel, CAT_MIDDLE, category)
    category = torch.where(near_sel, CAT_NEAR, category)
    return VoxelResult(selected=near_sel | middle_sel | far_sel,
                       category=category)


def _capped_bins(window: Window, flow, near_mask, middle_mask, far_mask, ls):
    """Caps: near = top flow, middle = pseudo-random, far = longest tracks."""
    dtype = window.lm_pos.dtype
    near_sel = _masked_topk_mask(flow, near_mask,
                                 ls.max_number_landmarks_near_bin)
    middle_sel = _masked_topk_mask(_hash_scores(window, window.lm_id, dtype),
                                   middle_mask,
                                   ls.max_number_landmarks_middle_bin)
    far_sel = _masked_topk_mask(track_lengths(window).to(dtype), far_mask,
                                ls.max_number_landmarks_far_bin)
    return _categorize(near_sel, middle_sel, far_sel)


def _previous_slot(newest_kf):
    """Slot adjacency fallback (time-ordered slots) for the flow anchor."""
    return torch.clamp_min(torch.as_tensor(newest_kf) - 1, 0)


def voxel_scheme(window: Window, newest_kf, candidates, cfg,
                 last_kf=None) -> VoxelResult:
    """``LandmarkSparsificationSchemeVoxel``
    (landmark_selection_scheme_voxel.cpp:37-233):

      1. landmarks → current-keyframe frame; z-passthrough [-20,100]
         (outside ⇒ dropped entirely)
      2. distance-to-trajectory > roi_far ⇒ far bin; else middle candidates
      3. voxel-grid downsample middle candidates (one representative/voxel)
      4. of the survivors, distance < roi_middle ⇒ near bin, else middle bin
      5. caps: near = top flow, middle = pseudo-random, far = longest tracks
    """
    ls = cfg.landmark_selection
    cur_pose = take(window.poses, newest_kf)
    p = pose_ops.apply(cur_pose, window.lm_pos)       # [L,3] current-kf frame

    z_ok = (p[..., 2] >= ls.z_range[0]) & (p[..., 2] <= ls.z_range[1])
    alive = candidates & window.lm_valid & z_ok

    # trajectory path: active keyframe positions in current-kf frame
    path = pose_ops.apply(cur_pose, kf_positions(window))    # [K,3]
    dist = _dist_to_path(p, path, window.kf_valid)

    # roi_*_xyz[0] as a SCALAR distance-to-path threshold is the reference's
    # actual behavior (landmark_selection_scheme_voxel.cpp:162,:171); the
    # per-axis box filter (filterXYZ, :49-91) has no caller upstream.
    far_thres = ls.roi_far_xyz[0]
    mid_thres = ls.roi_middle_xyz[0]
    far_mask = alive & (dist >= far_thres)
    mid_cand = alive & (dist < far_thres)

    # --- voxel dedup of middle candidates (fixed-grid hash + sort-unique) ---
    cell = [torch.floor(p[:, i] / ls.voxel_size_xyz[i]).to(torch.int32)
            + 1_000_00 for i in range(3)]           # offset to positive
    # uint32 spatial hash (wraparound is defined). The low bit is cleared so
    # the all-ones sentinel is unreachable by any real cell.
    u32 = [c.to(torch.int64) & uint32.MASK for c in cell]
    key = (uint32.mul(u32[0], 73856093) ^ uint32.mul(u32[1], 19349663)
           ^ uint32.mul(u32[2], 83492791)) & 0xFFFFFFFE
    sentinel = uint32.MASK
    key = torch.where(mid_cand, key, torch.full_like(key, sentinel))
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    first = torch.ones_like(mid_cand)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    rep_sorted = first & (sorted_key != sentinel)
    rep = rep_sorted[_inverse_permutation(order)]

    near_mask = rep & (dist < mid_thres)
    middle_mask = rep & (dist >= mid_thres)

    if last_kf is None:
        last_kf = _previous_slot(newest_kf)
    flow, _ = landmark_flow(window, newest_kf, last_kf)
    return _capped_bins(window, flow, near_mask, middle_mask, far_mask, ls)


# ---------------------------------------------------------------------------
# Observability sparsification (mono fallback scheme)
# ---------------------------------------------------------------------------

def observability_scheme(window: Window, newest_kf, candidates, cfg,
                         bin_bounds=(0.4, 0.2), last_kf=None) -> VoxelResult:
    """``LandmarkSparsificationSchemeObservability``
    (landmark_selection_scheme_observability.cpp:52-169): bin landmarks
    near/middle/far by flow relative to the maximum flow (bounds 0.4/0.2 of
    max); near = biggest flow, middle = pseudo-random, far = longest track."""
    ls = cfg.landmark_selection
    alive = candidates & window.lm_valid
    if last_kf is None:
        last_kf = _previous_slot(newest_kf)
    flow, has_flow = landmark_flow(window, newest_kf, last_kf)
    max_flow = torch.where(alive & has_flow, flow, torch.zeros_like(flow)).max()
    hi = bin_bounds[0] * max_flow
    lo = bin_bounds[1] * max_flow
    near_mask = alive & has_flow & (flow > hi)
    far_mask = alive & (~has_flow | (flow < lo))
    middle_mask = alive & ~near_mask & ~far_mask
    return _capped_bins(window, flow, near_mask, middle_mask, far_mask, ls)


# ---------------------------------------------------------------------------
# Random sparsification + AddDepth force-include
# ---------------------------------------------------------------------------

def random_scheme(window: Window, candidates, n: int,
                  seed: int = 0) -> torch.Tensor:
    """``LandmarkSparsificationSchemeRandom``
    (landmark_selection_scheme_random.cpp:13-31): shuffle, take N."""
    scores = _hash_scores(window, seed, torch.float32)
    return _masked_topk_mask(scores, candidates & window.lm_valid, n)


def add_depth_scheme(window: Window, selected, comparator_mask,
                     n_per_frame: int, newest_kf=None) -> torch.Tensor:
    """``LandmarkSelectionSchemeAddDepth``
    (landmark_selection_scheme_add_depth.cpp:16-86): per window frame, ensure
    ``n_per_frame`` landmarks satisfying the comparator (e.g. is_ground_plane
    or has_measured_depth) are selected, preferring smallest distance to the
    keyframe (Sorter). Force-include on top of ``selected``."""
    out = selected
    # distance of each landmark to each keyframe [L,K]
    d = norm(window.lm_pos[:, None, :] - kf_positions(window)[None])
    obs_at = window.obs_mask.any(dim=-1)  # [L,K]
    for k in range(window.K):
        cand = (window.lm_valid & comparator_mask & obs_at[:, k]
                & window.kf_valid[k])
        # prefer nearest (top-k of negative distance)
        out = out | _masked_topk_mask(-d[:, k], cand, n_per_frame)
    return out
