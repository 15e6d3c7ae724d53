"""Lidar → per-feature depth estimation.

The reference package's ``limo_tpu/frontend/lidar_depth.py`` as PyTorch
ops. It re-implements the reference's ``monolidar_fusion`` depth estimator
as its config pins it (``mono_lidar_fusion_parameters.yaml``):

  1. project the cloud into the image (cut points behind the camera);
  2. per feature, select neighbour lidar points in a 6×9 px rectangle
     (or a radius), at least 3;
  3. segment the neighbour depths (a histogram's nearest local maximum,
     bin 0.3 m; or region growing);
  4. fit a local patch: the largest-area triangle of segment points with
     planarity and view-ray checks (the default), or a PCA plane;
  5. intersect the feature's viewing ray with the patch → depth;
  6. a global [0, 100] m and a local (relative 0.5) threshold.

Ground features instead intersect an M-estimator local plane through the
RANSAC ground inliers (:func:`ground_patch_depths`).

The neighbour search is a fixed pixel-grid bucketing (a stable sort by cell
id + capped gathers from the surrounding cells) and the triangle search
enumerates all C(K,3) index triples: fixed shapes, no host reads. Sorts are
stable and ``argmax``/``argmin`` take the first extremum, as the
reference's do, so the neighbours kept and the triangle chosen are its own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..geometry.quaternion import cross
from ..selection.landmark import norm
from ..utils.eig3 import smallest_eigvec3
from ..utils.precision import full_f32


@dataclass(frozen=True)
class LidarDepthConfig:
    """Mirrors mono_lidar_fusion_parameters.yaml."""

    search_width: float = 6.0         # pixelarea_search_witdh
    search_height: float = 9.0        # pixelarea_search_height
    min_neighbors: int = 3            # radiusSearch_count_min
    hist_bin_width: float = 0.3       # histogram_segmentation_bin_witdh
    hist_min_count: int = 1           # histogram_segmentation_min_pointcount
    depth_min: float = 0.0            # treshold_depth_min
    depth_max: float = 100.0          # treshold_depth_max
    local_thres_rel: float = 0.5      # treshold_depth_local_value (relative)
    crossnorm_thres: float = 0.1      # triangleplanar_crossnorm_treshold
    viewray_ortho_thres: float = 0.1  # viewray_plane_orthoganality_treshold
    max_neighbors: int = 24           # static cap on the rect's points
    grid_cell_px: int = 8             # bucket grid cell size
    points_per_cell: int = 16         # static per-cell cap (the returns
                                      # past it are dropped; see
                                      # gather_neighbors' overflow)
    # neighbour selection (neighbor_search_mode: 0 rect / 1 radius)
    neighbor_mode: str = "rect"       # "rect" | "radius"
    radius_px: float = 10.0           # radiusSearch_radius (px, radius mode)
    # local patch estimator (do_use_triangle_size_maximation / do_use_PCA)
    patch_mode: str = "triangle"      # "triangle" | "pca"
    pca_abs_min: float = 0.005        # pca_treshold_3_abs_min
    pca_rel_32_max: float = 15.0      # pca_treshold_3_2_rel_max
    pca_rel_21_min: float = 1.5       # pca_treshold_2_1_rel_min
    # segmentation (do_use_histogram_segmentation / do_use_depth_segmentation)
    segmentation_mode: str = "histogram"  # "histogram" | "region_growing"
    rg_thres_gradient_depth: float = 10.0
    rg_max_neighbor_dist: float = 0.2
    rg_max_neighbor_dist_grad: float = 0.02
    rg_max_seed_dist: float = 0.5
    rg_max_seed_dist_grad: float = 0.05
    rg_max_points: int = 4
    rg_rounds: int = 4                      # static growth iterations


class DepthResult(NamedTuple):
    depth: torch.Tensor        # [F] estimated depth, -1 invalid
    valid: torch.Tensor        # [F] bool
    n_neighbors: torch.Tensor  # [F] int
    overflow: torch.Tensor     # [F] int64, gather_neighbors' overflow


def _triples(k: int, device) -> torch.Tensor:
    """[C(k,3), 3] index triples i < j < l in lexicographic order (that of
    ``itertools.combinations``), made on the device: the linear indices of
    the valid cells of the k³ grid, sorted to the front."""
    lin = torch.arange(k ** 3, device=device)
    valid = (lin // (k * k) < lin // k % k) & (lin // k % k < lin % k)
    first = torch.sort(torch.where(valid, lin, k ** 3)).values
    first = first[:k * (k - 1) * (k - 2) // 6]
    return torch.stack([first // (k * k), first // k % k, first % k], -1)


def _pick(x, idx):
    """``x[..., idx, :]`` for idx [...] (one row per leading index)."""
    i = idx[..., None, None].expand(*idx.shape, 1, x.shape[-1])
    return torch.gather(x, -2, i)[..., 0, :]


def _ray(uv_feat, focal, principal, dtype):
    """Unit viewing ray per feature."""
    ones = torch.ones((uv_feat.shape[0], 1), dtype=dtype,
                      device=uv_feat.device)
    ray = torch.cat([(uv_feat - principal) / focal, ones], -1)
    return ray / norm(ray)[..., None]


def project_cloud(points_cam, focal, principal):
    """Camera-frame cloud → pixel coords + in-front mask
    (``do_use_cut_behind_camera``)."""
    z = points_cam[..., 2]
    front = z > 0.1
    safe_z = torch.where(front, z, torch.ones_like(z))
    uv = focal * points_cam[..., :2] / safe_z[..., None] + principal
    return uv, front


def _cell(x, cell, n):
    """Grid cell index of pixel coordinate(s) ``x``, clipped to [0, n)."""
    return torch.clamp(torch.div(x, cell, rounding_mode="floor")
                       .to(torch.int32), 0, n - 1).long()


def gather_neighbors(cloud_cam, cloud_valid, uv_feat, focal, principal,
                     image_size, cfg: LidarDepthConfig):
    """For each feature, up to ``max_neighbors`` lidar points whose projection
    falls in the search region: points sorted by pixel-cell id, then capped
    slots gathered from the cells around each feature's cell, then the K
    nearest (pixel distance) kept.

    Returns (pts [F,K,3], uvs [F,K,2], mask [F,K], overflow [F] int64):
    the overflow is the returns the feature's cells hold past
    ``points_per_cell``, which its search never saw.
    """
    W, H = image_size
    cell = cfg.grid_cell_px
    gw, gh = (W + cell - 1) // cell, (H + cell - 1) // cell
    n_cells = gw * gh
    P = cloud_cam.shape[0]
    F = uv_feat.shape[0]
    K = cfg.max_neighbors
    PC = cfg.points_per_cell
    dev = cloud_cam.device

    uv_pts, front = project_cloud(cloud_cam, focal, principal)
    inside = (front & cloud_valid
              & (uv_pts[:, 0] >= 0) & (uv_pts[:, 0] < W)
              & (uv_pts[:, 1] >= 0) & (uv_pts[:, 1] < H))
    cid = torch.where(inside, _cell(uv_pts[:, 1], cell, gh) * gw
                      + _cell(uv_pts[:, 0], cell, gw),
                      torch.full_like(inside, n_cells, dtype=torch.int64))

    order = torch.argsort(cid, stable=True)
    starts = torch.searchsorted(cid[order],
                                torch.arange(n_cells + 1, device=dev))
    counts = torch.diff(starts)
    starts = starts[:n_cells]

    fx = _cell(uv_feat[:, 0], cell, gw)
    fy = _cell(uv_feat[:, 1], cell, gh)
    # a ring of cells wide enough for the search region
    if cfg.neighbor_mode == "radius":
        extent = cfg.radius_px
    else:
        extent = max(cfg.search_width, cfg.search_height) / 2.0
    ring = max(1, int(math.ceil(extent / cell)))
    # the cells' offsets, dy-major as the reference lists them (made on the
    # device: a tensor built from a list would synchronize)
    d = torch.arange(-ring, ring + 1, device=dev)
    rx = fx[:, None] + d.repeat(2 * ring + 1)[None, :]
    ry = fy[:, None] + d.repeat_interleave(2 * ring + 1)[None, :]
    cell_in = (rx >= 0) & (rx < gw) & (ry >= 0) & (ry < gh)
    ncid = torch.clamp(ry, 0, gh - 1) * gw + torch.clamp(rx, 0, gw - 1)
    nstart = starts[ncid]                                  # [F,NC]
    # out-of-image cells would alias their clipped neighbour: no points
    ncount = torch.where(cell_in, counts[ncid], torch.zeros_like(ncid))

    slot = torch.arange(PC, device=dev)
    idx_sorted = torch.clamp(nstart[..., None] + slot, 0, P - 1)
    cand_ok = (slot < ncount[..., None]).reshape(F, -1)
    pt_idx = order[idx_sorted.reshape(F, -1)]              # [F,NC*PC]

    cand_uv = uv_pts[pt_idx]                               # [F,NC*PC,2]
    cand_pts = cloud_cam[pt_idx]
    du = torch.abs(cand_uv[..., 0] - uv_feat[:, None, 0])
    dv = torch.abs(cand_uv[..., 1] - uv_feat[:, None, 1])
    if cfg.neighbor_mode == "radius":
        in_region = du * du + dv * dv <= cfg.radius_px ** 2
    else:
        in_region = (du <= cfg.search_width / 2) & (dv <= cfg.search_height / 2)
    ok = cand_ok & in_region

    # keep the K nearest (pixel distance) valid candidates
    d2 = torch.where(ok, du * du + dv * dv, torch.full_like(du, torch.inf))
    top = torch.argsort(d2, dim=1, stable=True)[:, :K]     # [F,K]
    mask = torch.gather(ok, 1, top)
    pts = torch.gather(cand_pts, 1, top[..., None].expand(-1, -1, 3))
    uvs = torch.gather(cand_uv, 1, top[..., None].expand(-1, -1, 2))
    return pts, uvs, mask, torch.clamp_min(ncount - PC, 0).sum(-1)


def _histogram_segment(depths, mask, cfg: LidarDepthConfig):
    """The nearest local-maximum depth bin among the neighbours: the
    foreground object in front of a denser background wins by proximity.
    Bin counts come from pairwise same-bin comparisons."""
    bins = torch.floor(depths / cfg.hist_bin_width).to(torch.int32)
    bins = torch.where(mask, bins, torch.full_like(bins, -100000))
    m = mask[..., None, :]
    counts = ((bins[..., :, None] == bins[..., None, :]) & m).sum(-1)
    prev = ((bins[..., :, None] - 1 == bins[..., None, :]) & m).sum(-1)
    nxt = ((bins[..., :, None] + 1 == bins[..., None, :]) & m).sum(-1)
    counts = torch.where(mask, counts, torch.zeros_like(counts))
    local_max = mask & (counts >= prev) & (counts >= nxt) \
        & (counts >= cfg.hist_min_count)
    # nearest (smallest depth) point whose bin is a local maximum
    d_masked = torch.where(local_max, depths, torch.full_like(depths, torch.inf))
    best = torch.argmin(d_masked, -1)
    best_bin = torch.gather(bins, -1, best[..., None])[..., 0]
    seg = mask & (bins == best_bin[..., None])
    return seg, local_max.any(-1)


def _triangle_patch(pts, seg, ray, cfg: LidarDepthConfig, triples):
    """Largest-triangle plane through segment points + validity checks.

    Returns (normal [.,3], support point [.,3], ok)."""
    t0, t1, t2 = triples.unbind(-1)
    a = pts.index_select(-2, t0)
    b = pts.index_select(-2, t1)
    c = pts.index_select(-2, t2)
    t_ok = (seg.index_select(-1, t0) & seg.index_select(-1, t1)
            & seg.index_select(-1, t2))
    ab, ac = b - a, c - a
    cr = cross(ab, ac)
    area2 = norm(cr)
    # planarity: normalized cross norm (inner-angle quality)
    crossnorm = area2 / torch.clamp_min(norm(ab) * norm(ac), 1e-12)
    planar = crossnorm >= cfg.crossnorm_thres
    score = torch.where(t_ok & planar, area2, torch.full_like(area2, -1.0))
    best = torch.argmax(score, -1)
    n = _pick(cr, best)
    n = n / torch.clamp_min(norm(n)[..., None], 1e-12)
    sup = _pick(a, best)
    found = torch.gather(score, -1, best[..., None])[..., 0] > 0
    ortho = torch.abs(torch.sum(n * ray, -1)) >= cfg.viewray_ortho_thres
    return n, sup, found & ortho


def _one_hot(idx, n, dtype):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def eigh3_sym(A):
    """Closed-form symmetric 3×3 eigendecomposition → (eigenvalues
    ascending [...,3], smallest-eigenvalue eigenvector [...,3]).

    Trigonometric eigenvalues (Smith's method) + cross-product null-space
    recovery for the eigenvector, with the reference's fallbacks for a
    repeated smallest eigenvalue and for (near-)diagonal matrices. Its
    relative accuracy in λ_min degrades as ~eps·(λ_max/λ_min)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    dtype = A.dtype
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = ((a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1)
    diagish = p2 <= 1e-14 * torch.clamp_min(q * q, 1e-30)
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-38))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    l3 = q + 2.0 * p * torch.cos(phi)                        # largest
    l1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    l2 = 3.0 * q - l1 - l3
    evals = torch.stack([l1, l2, l3], -1)

    # null-space of (A − λ1 I): the largest row-pair cross product
    r0 = torch.stack([a00 - l1, a01, a02], -1)
    r1 = torch.stack([a01, a11 - l1, a12], -1)
    r2 = torch.stack([a02, a12, a22 - l1], -1)
    cands = torch.stack([cross(r0, r1), cross(r0, r2), cross(r1, r2)], -2)
    oh = _one_hot(torch.argmax(norm(cands), -1), 3, dtype)
    v = torch.sum(cands * oh[..., None], -2)
    vn = norm(v)[..., None]
    # degenerate fallbacks: a repeated λ1 (every row cross product
    # vanishes) takes the basis axis least aligned with the largest row,
    # projected onto that row's null plane; (near-)diagonal matrices keep
    # the smallest-diagonal axis
    rows = torch.stack([r0, r1, r2], -2)
    roh = _one_hot(torch.argmax(norm(rows), -1), 3, dtype)
    rbig = torch.sum(rows * roh[..., None], -2)
    rbn = norm(rbig)[..., None]
    rhat = rbig / torch.clamp_min(rbn, 1e-30)
    e_min = _one_hot(torch.argmin(torch.abs(rhat), -1), 3, dtype)
    proj = e_min - torch.sum(e_min * rhat, -1, keepdim=True) * rhat
    pn = norm(proj)[..., None]
    null_v = torch.where(rbn > 1e-20, proj / torch.clamp_min(pn, 1e-20), e_min)
    diag3 = torch.stack([a00, a11, a22], -1)
    axis_v = _one_hot(torch.argmin(diag3, -1), 3, dtype)
    repeated = (vn[..., 0] <= 1e-20)[..., None] & ~diagish[..., None]
    v = torch.where(diagish[..., None], axis_v,
                    torch.where(repeated, null_v,
                                v / torch.clamp_min(vn, 1e-20)))
    evals = torch.where(diagish[..., None], torch.sort(diag3, -1).values,
                        evals)
    return evals, v


def _pca_patch(pts, seg, ray, cfg: LidarDepthConfig):
    """PCA local patch (``do_use_PCA``): plane through the segment's centroid
    with the smallest-eigenvalue normal (cyclic Jacobi), gated on the
    eigenvalue shape λ1 ≤ λ2 ≤ λ3: λ3 ≥ ``pca_abs_min``, λ3 ≤
    ``pca_rel_32_max``·λ2 (not a line), λ2 ≥ ``pca_rel_21_min``·λ1 (planar).

    Returns (normal, support point, ok) like :func:`_triangle_patch`."""
    segf = seg.to(pts.dtype)
    n_seg = torch.sum(segf, -1)
    denom = torch.clamp_min(n_seg, 1.0)[..., None]
    c = torch.sum(pts * segf[..., None], -2) / denom
    dp = (pts - c[..., None, :]) * segf[..., None]
    cov = torch.einsum("...ki,...kj->...ij", dp, dp) / denom[..., None]
    evals, n = smallest_eigvec3(cov)             # ascending, unit n
    l1, l2, l3 = evals.unbind(-1)
    shape_ok = ((l3 >= cfg.pca_abs_min)
                & (l3 <= cfg.pca_rel_32_max * torch.clamp_min(l2, 1e-12))
                & (l2 >= cfg.pca_rel_21_min * l1))
    ortho = torch.abs(torch.sum(n * ray, -1)) >= cfg.viewray_ortho_thres
    return n, c, (n_seg >= 3) & shape_ok & ortho


def _region_grow_segment(pts, mask, uvs, uv_feat, cfg: LidarDepthConfig):
    """Region-growing depth segmentation (``do_use_depth_segmentation``):
    seed at the neighbour nearest the feature in the image, grow by 3D
    proximity with depth-scaled thresholds ``base + max(d − gradient_depth,
    0)·grad``, and keep at most ``rg_max_points`` points nearest the seed.
    Returns (seg, found)."""
    inf = torch.full_like(mask, torch.inf, dtype=pts.dtype)
    d2px = torch.where(mask, torch.sum((uvs - uv_feat[..., None, :]) ** 2, -1),
                       inf)
    seed = torch.argmin(d2px, -1)
    seed_pt = _pick(pts, seed)
    excess = torch.clamp_min(seed_pt[..., 2] - cfg.rg_thres_gradient_depth,
                             0.0)
    thr_nb = cfg.rg_max_neighbor_dist + excess * cfg.rg_max_neighbor_dist_grad
    thr_seed = cfg.rg_max_seed_dist + excess * cfg.rg_max_seed_dist_grad

    dist_seed = norm(pts - seed_pt[..., None, :])
    cand = mask & (dist_seed <= thr_seed[..., None])
    K = pts.shape[-2]
    sel = (seed[..., None] == torch.arange(K, device=pts.device)) & mask
    pair = norm(pts[..., :, None, :] - pts[..., None, :, :])     # [F,K,K]
    near = pair <= thr_nb[..., None, None]
    for _ in range(cfg.rg_rounds):
        reachable = (near & sel[..., None, :]).any(-1)
        sel = sel | (cand & reachable)
    if cfg.rg_max_points > 0:
        # keep the rg_max_points selected points nearest the seed
        ds = torch.where(sel, dist_seed, inf)
        rank = (ds[..., None, :] < ds[..., :, None]).sum(-1)
        sel = sel & (rank < cfg.rg_max_points)
    return sel, sel.any(-1)


@full_f32
def estimate_depths(cloud_cam, cloud_valid, uv_feat, focal, principal,
                    image_size, cfg: LidarDepthConfig = LidarDepthConfig()
                    ) -> DepthResult:
    """The per-feature depth pipeline (steps 1-6 above).

    cloud_cam [P,3] camera frame, uv_feat [F,2]. Returns a
    :class:`DepthResult`, depth -1 where there is no valid estimate (the
    reference's FeaturePoint d = -1).
    """
    dtype = cloud_cam.dtype
    pts, uvs, mask, over = gather_neighbors(cloud_cam, cloud_valid, uv_feat,
                                            focal, principal, image_size, cfg)
    n_neigh = mask.sum(-1)
    enough = n_neigh >= cfg.min_neighbors

    zero = torch.zeros_like(pts[..., 2])
    depths = torch.where(mask, pts[..., 2], zero)
    if cfg.segmentation_mode == "region_growing":
        seg, seg_ok = _region_grow_segment(pts, mask, uvs, uv_feat, cfg)
    else:
        seg, seg_ok = _histogram_segment(depths, mask, cfg)

    ray = _ray(uv_feat, focal, principal, dtype)
    if cfg.patch_mode == "pca":
        n, sup, tri_ok = _pca_patch(pts, seg, ray, cfg)
    else:
        n, sup, tri_ok = _triangle_patch(pts, seg, ray, cfg,
                                         _triples(cfg.max_neighbors,
                                                  pts.device))

    # ray ∩ plane: t = (n·sup)/(n·ray); depth = z of intersection
    nr = torch.sum(n * ray, -1)
    t = torch.sum(n * sup, -1) / torch.where(torch.abs(nr) < 1e-9,
                                             torch.full_like(nr, 1e-9), nr)
    depth = t * ray[..., 2]

    # too few points for a triangle but a segment: its mean depth
    seg_n = seg.sum(-1)
    seg_mean = torch.sum(torch.where(seg, depths, zero), -1) \
        / torch.clamp_min(seg_n, 1)
    depth = torch.where(tri_ok & (seg_n >= 3), depth, seg_mean)

    glob_ok = (depth >= cfg.depth_min) & (depth <= cfg.depth_max)
    smin = torch.amin(torch.where(seg, depths, torch.full_like(zero, torch.inf)),
                      -1)
    smax = torch.amax(torch.where(seg, depths,
                                  torch.full_like(zero, -torch.inf)), -1)
    local_ok = ((depth >= smin * (1.0 - cfg.local_thres_rel))
                & (depth <= smax * (1.0 + cfg.local_thres_rel)))

    valid = enough & seg_ok & glob_ok & local_ok & (seg_n >= 1)
    depth = torch.where(valid, depth, torch.full_like(depth, -1.0))
    return DepthResult(depth=depth, valid=valid, n_neighbors=n_neigh,
                       overflow=over)


@full_f32
def ground_patch_depths(cloud_cam, gp_inlier, uv_feat, plane_normal,
                        plane_dist, focal, principal, image_size,
                        cfg: LidarDepthConfig = LidarDepthConfig()):
    """M-estimator local ground patch depth (the reference's
    ``plane_estimator_use_mestimator``): a local plane through the RANSAC
    ground inliers near each feature, each weighted by inverse distance to
    the global plane, intersected with the viewing ray.

    cloud_cam [P,3] camera frame; gp_inlier [P] bool; plane_normal /
    plane_dist: the global plane in the camera frame (n·p + d = 0).
    Features without enough local inliers fall back to the global plane.
    Returns (depth [F] (-1 invalid), valid [F]).
    """
    dtype = cloud_cam.dtype
    pts, _, mask, _ = gather_neighbors(cloud_cam, gp_inlier, uv_feat, focal,
                                       principal, image_size, cfg)
    d_plane = torch.abs(pts @ plane_normal + plane_dist)
    w = torch.where(mask, 1.0 / (d_plane + 0.05), torch.zeros_like(d_plane))

    wsum = torch.clamp_min(torch.sum(w, -1, keepdim=True), 1e-9)
    c = torch.sum(pts * w[..., None], -2) / wsum
    dp = (pts - c[:, None, :]) * w[..., None]
    cov = torch.einsum("fki,fkj->fij", dp, pts - c[:, None, :])
    _, n_loc = smallest_eigvec3(cov)
    # orient like the global plane
    n_loc = n_loc * torch.sign(torch.sum(n_loc * plane_normal, -1,
                                         keepdim=True) + 1e-12)
    d_loc = -torch.sum(n_loc * c, -1)

    have_local = mask.sum(-1) >= cfg.min_neighbors
    n_use = torch.where(have_local[:, None], n_loc, plane_normal[None])
    d_use = torch.where(have_local, d_loc, plane_dist)
    return _plane_depths(n_use, d_use, uv_feat, focal, principal, dtype,
                         cfg.depth_max)


def _plane_depths(n, d, uv_feat, focal, principal, dtype, max_depth):
    ray = _ray(uv_feat, focal, principal, dtype)
    nr = torch.sum(n * ray, -1)
    t = -d / torch.where(torch.abs(nr) < 1e-9, torch.full_like(nr, 1e-9), nr)
    depth = t * ray[:, 2]
    valid = (t > 0) & (depth > 0) & (depth <= max_depth)
    return torch.where(valid, depth, torch.full_like(depth, -1.0)), valid


def ground_feature_depths(plane_normal, plane_dist, uv_feat, focal, principal,
                          max_depth: float = 100.0):
    """Depth of road features by intersecting the RANSAC ground plane
    (plane in the camera frame: n·p + d = 0)."""
    return _plane_depths(plane_normal, plane_dist, uv_feat, focal, principal,
                         uv_feat.dtype, max_depth)
