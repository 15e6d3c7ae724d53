"""Rendered-sequence generator: images + semantic label images + lidar
clouds from a :class:`~limo_tpu_torch.pipeline.synthetic.SyntheticWorld`.

A copy of the reference package's ``limo_tpu/pipeline/render.py``
(``SequenceRenderer``; ``write_kitti_sequence`` is left out), so that a
rendered drive is built without that package: the same world and seed give
the same images, labels and clouds, bit for bit. It produces the three
streams the reference's front end consumes (camera images, velodyne
clouds, semantic label images) with consistent geometry:

- **occlusion** via painter's algorithm (far-to-near overwrite, both in the
  intensity image and the label image);
- **perspective-correct textured ground**: every below-horizon pixel is
  backprojected onto the world ground plane and shaded by a hash-noise
  texture fixed in the world frame, so ground texture flows correctly with
  egomotion;
- **dynamic objects**: landmarks with world velocities move between frames
  in the imagery AND in the lidar returns;
- **label images** with cityscapes ids: road 7, building 11 (static
  structure), vegetation 21 (shrubbery down-weighting target), car 26
  (outlier set), sky 10.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..geometry import pose_host
from .synthetic import SyntheticWorld

LABEL_ROAD = 7        # in DEFAULT_GROUND_LABELS
LABEL_SKY = 10        # neutral
LABEL_BUILDING = 11   # neutral (static structure)
LABEL_SHRUB = 21      # in DEFAULT_SHRUBBERY_LABELS
LABEL_CAR = 26        # in DEFAULT_OUTLIER_LABELS (dynamic objects)


def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic integer-lattice value noise in [0,1)."""
    h = (ix.astype(np.int64) * 73856093) ^ (iy.astype(np.int64) * 19349663) \
        ^ np.int64(seed * 83492791)
    h = (h ^ (h >> 13)) * 0x5BD1E995
    h = h ^ (h >> 15)
    return (h & 0xFFFF).astype(np.float32) / 65535.0


class SequenceRenderer:
    """Renders frames of a SyntheticWorld. Patch textures are fixed per
    landmark (appearance constancy — descriptors need stable texture);
    ground texture is fixed in the world frame."""

    def __init__(self, world: SyntheticWorld, patch_r: int = 7,
                 texture_seed: int = 1234, ground_cell: float = 0.4,
                 max_draw_range: float = 70.0,
                 patch_world_halfsize: float = 0.45,
                 patch_px_max: int = 20):
        from scipy.ndimage import gaussian_filter

        self.w = world
        self.patch_r = patch_r
        self.ground_cell = ground_cell
        self.max_draw_range = max_draw_range
        self.patch_world_halfsize = patch_world_halfsize
        self.patch_px_max = patch_px_max
        M = world.landmarks.shape[0]
        side = 2 * patch_r + 1
        style = np.random.default_rng(texture_seed)
        # textures in [0.3, 1]: solid patches so nearer objects fully
        # occlude (a 0-valued texel would "see through")
        tex = gaussian_filter(
            style.uniform(0, 1, (M, side, side)).astype(np.float32),
            sigma=(0, 1.0, 1.0))
        lo, hi = tex.min(axis=(1, 2), keepdims=True), tex.max(axis=(1, 2), keepdims=True)
        self.tex = 0.3 + 0.7 * (tex - lo) / np.maximum(hi - lo, 1e-6)
        labels = (world.labels if world.labels is not None
                  else np.full(M, -2, np.int32))
        self.lm_label = np.where(labels == -2, LABEL_BUILDING, labels)
        self.is_ground_pt = world.is_ground

    # ------------------------------------------------------------------

    def _cam_pose(self, frame: int) -> np.ndarray:
        return pose_host.compose(self.w.T_cam_veh, self.w.poses_veh[frame])

    def frame(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """Render frame ``frame`` → (intensity [H,W] float32 in [0,1],
        label image [H,W] uint8)."""
        w = self.w
        W, H = w.image_size
        F = w.focal
        cx, cy = w.principal
        T_co = self._cam_pose(frame)          # cam ← origin

        # ---- ground plane: backproject each pixel ray ------------------
        img = np.zeros((H, W), np.float32)
        lab = np.full((H, W), LABEL_SKY, np.uint8)
        T_oc = pose_host.inverse(T_co)        # origin ← cam
        R_oc = pose_host.to_matrix(T_oc)[:3, :3]
        c_o = pose_host.to_matrix(T_oc)[:3, 3]
        us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        rays_c = np.stack([(us - cx) / F, (vs - cy) / F,
                           np.ones_like(us)], -1)          # [H,W,3]
        rays_o = rays_c @ R_oc.T
        gz = -w.cam_height                                  # world ground z
        denom = rays_o[..., 2]
        t = np.where(denom < -1e-6, (gz - c_o[2]) / np.where(
            np.abs(denom) > 1e-6, denom, 1.0), -1.0)
        hit = (t > 0.5) & (t * np.linalg.norm(rays_o, axis=-1)
                           < self.max_draw_range)
        gx = c_o[0] + t * rays_o[..., 0]
        gy = c_o[1] + t * rays_o[..., 1]

        def value_noise(px, py, cell, seed):
            """Bilinear value noise — continuous in world coords, so ground
            texture moves sub-pixel-correctly with egomotion, and its soft
            gradients don't out-compete object patches for corner scores
            (piecewise-constant cells put razor edges everywhere and starved
            the tracker of structure features)."""
            fx, fy = px / cell, py / cell
            ix, iy = np.floor(fx), np.floor(fy)
            tx, ty = (fx - ix).astype(np.float32), (fy - iy).astype(np.float32)
            n00 = _hash01(ix, iy, seed)
            n10 = _hash01(ix + 1, iy, seed)
            n01 = _hash01(ix, iy + 1, seed)
            n11 = _hash01(ix + 1, iy + 1, seed)
            return ((n00 * (1 - tx) + n10 * tx) * (1 - ty)
                    + (n01 * (1 - tx) + n11 * tx) * ty)

        cell = self.ground_cell
        n0 = value_noise(gx, gy, cell, 11)
        n1 = value_noise(gx, gy, 6 * cell, 7)
        # contrast fades with range (real optics can't resolve far texture;
        # un-attenuated cells alias at the horizon into untrackable flicker)
        dist = t * np.linalg.norm(rays_o, axis=-1)
        att = np.clip(10.0 / np.maximum(dist, 1e-3), 0.0, 1.0).astype(np.float32)
        shade = 0.45 + att * (0.3 * (n0 - 0.5)) + 0.3 * (n1 - 0.5)
        img = np.where(hit, shade.astype(np.float32), img)
        lab = np.where(hit, np.uint8(LABEL_ROAD), lab)

        # ---- landmark patches, painter's algorithm ---------------------
        pts = w.landmarks_at(frame)
        p_cam = pose_host.apply(T_co, pts)
        z = p_cam[:, 2]
        uv = F * p_cam[:, :2] / np.maximum(z[:, None], 1e-6) \
            + np.asarray([cx, cy])
        # PERSPECTIVE patch size: each landmark is a billboard square of
        # fixed WORLD half-size, so its on-screen radius scales with F/z and
        # its corners track consistent 3-D points. The texture is always
        # mapped at the true scale ru_all; patch_px_max only bounds the
        # drawn bbox (binding below z ≈ F·halfsize/Rmax ≈ 5 m).
        ru_all = F * self.patch_world_halfsize / np.maximum(z, 1e-6)
        Rmax = self.patch_px_max
        vis = ((z > 2.0) & (z < self.max_draw_range) & (ru_all >= 1.5)
               & (uv[:, 0] > 2) & (uv[:, 0] < W - 3)
               & (uv[:, 1] > 2) & (uv[:, 1] < H - 3)
               & ~self.is_ground_pt)      # ground points ARE the plane
        order = np.flatnonzero(vis)[np.argsort(-z[vis])]   # far → near
        side = self.tex.shape[1]
        for i in order:
            ru = ru_all[i]                       # TRUE perspective scale
            R = int(np.ceil(min(ru, Rmax)))      # bbox bound only
            u0, v0 = int(np.floor(uv[i, 0])), int(np.floor(uv[i, 1]))
            # bbox clipped to the image (patches may straddle the border —
            # excluding them starved exactly the high-parallax edge regions)
            xlo, xhi = max(u0 - R, 0), min(u0 + R + 2, W)
            ylo, yhi = max(v0 - R, 0), min(v0 + R + 2, H)
            if xhi <= xlo or yhi <= ylo:
                continue
            xs = np.arange(xlo, xhi, dtype=np.float32)
            ys = np.arange(ylo, yhi, dtype=np.float32)
            # texture coords: bbox pixel → [0, side-1] billboard coords,
            # bilinear sample (sub-pixel correct, scale correct)
            txc = (xs - uv[i, 0]) / (2 * ru) + 0.5
            tyc = (ys - uv[i, 1]) / (2 * ru) + 0.5
            inx = (txc >= 0.0) & (txc <= 1.0)
            iny = (tyc >= 0.0) & (tyc <= 1.0)
            sx = np.clip(txc * (side - 1), 0, side - 1)
            sy = np.clip(tyc * (side - 1), 0, side - 1)
            ix0 = np.minimum(sx.astype(np.int32), side - 2)
            iy0 = np.minimum(sy.astype(np.int32), side - 2)
            fx = (sx - ix0)[None, :]
            fy = (sy - iy0)[:, None]
            T = self.tex[i]
            S = ((1 - fy) * ((1 - fx) * T[iy0][:, ix0]
                             + fx * T[iy0][:, ix0 + 1])
                 + fy * ((1 - fx) * T[iy0 + 1][:, ix0]
                         + fx * T[iy0 + 1][:, ix0 + 1]))
            alpha = (iny[:, None] & inx[None, :]).astype(np.float32)
            rows, cols = slice(ylo, yhi), slice(xlo, xhi)
            img[rows, cols] = alpha * S + (1.0 - alpha) * img[rows, cols]
            lab[rows, cols] = np.where(alpha > 0.5, self.lm_label[i],
                                       lab[rows, cols])
        return np.clip(img, 0.0, 1.0), lab

    # ------------------------------------------------------------------

    def cloud(self, frame: int, rng: np.random.Generator,
              pts_per_lm: int = 20, n_ground: int = 800,
              surf_sigma: float = 0.2, max_range: float = 70.0
              ) -> np.ndarray:
        """Lidar returns in the VEHICLE frame at ``frame``: surface patches
        around every (currently-positioned) landmark + ground samples.
        Dynamic objects return their moved positions — metrically correct
        lidar, but attached to features whose world point is moving."""
        w = self.w
        pts = w.landmarks_at(frame)
        stat = pts[~self.is_ground_pt]
        # returns lie on a BILLBOARD surface facing the sensor (lidar sees
        # front faces): in-plane spread surf_sigma, ~1 cm out-of-plane
        veh_pos = pose_host.translation(pose_host.inverse(w.poses_veh[frame]))
        view = stat - veh_pos[None]
        view = view / np.maximum(np.linalg.norm(view, axis=1, keepdims=True),
                                 1e-9)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(up[None], view)
        right /= np.maximum(np.linalg.norm(right, axis=1, keepdims=True), 1e-9)
        bup = np.cross(view, right)
        a = rng.normal(0, surf_sigma, (stat.shape[0], pts_per_lm))
        b = rng.normal(0, surf_sigma, (stat.shape[0], pts_per_lm))
        c = rng.normal(0, 0.01, (stat.shape[0], pts_per_lm))
        surf_w = (stat[:, None]
                  + a[..., None] * right[:, None]
                  + b[..., None] * bup[:, None]
                  + c[..., None] * view[:, None]).reshape(-1, 3)
        # ground disk ahead of the vehicle (vehicle frame → world)
        gx = rng.uniform(2.0, max_range * 0.7, n_ground)
        gy = rng.uniform(-10, 10, n_ground)
        g_local = np.stack([gx, gy, np.full(n_ground, -w.cam_height)], -1)
        T_ov = pose_host.inverse(w.poses_veh[frame])
        g_w = pose_host.apply(T_ov, g_local)
        all_w = np.concatenate([surf_w, g_w])
        p_veh = pose_host.apply(w.poses_veh[frame], all_w)
        keep = np.linalg.norm(p_veh, axis=1) < max_range
        return p_veh[keep]
