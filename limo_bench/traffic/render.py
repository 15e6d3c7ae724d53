"""The camera images and label images of a rendered drive.

A frozen copy of the port's ``pipeline/render.py`` (``SequenceRenderer``'s
textures and ``frame``): the same world gives the same pixels, bit for
bit. The benchmark renders its fused cells here and never calls the
program's own renderer. What the copy renders:

- a perspective-correct textured ground: every pixel below the horizon is
  backprojected onto the world's ground plane and shaded by value noise
  fixed in the world, so its texture flows with the vehicle's motion;
- each landmark (but ground points) as a billboard: a square of fixed
  world half-size, facing the camera (a plane of constant camera depth),
  textured per landmark and drawn far to near (occlusion);
- a label image with cityscapes ids: road 7, sky 10, building 11 (static
  structure), vegetation 21, car 26.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import pose_host

LABEL_ROAD = 7
LABEL_SKY = 10
LABEL_BUILDING = 11


def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic integer-lattice value noise in [0,1)."""
    h = (ix.astype(np.int64) * 73856093) ^ (iy.astype(np.int64) * 19349663) \
        ^ np.int64(seed * 83492791)
    h = (h ^ (h >> 13)) * 0x5BD1E995
    h = h ^ (h >> 15)
    return (h & 0xFFFF).astype(np.float32) / 65535.0


def _value_noise(px, py, cell, seed):
    """Bilinear value noise, continuous in world coordinates."""
    fx, fy = px / cell, py / cell
    ix, iy = np.floor(fx), np.floor(fy)
    tx, ty = (fx - ix).astype(np.float32), (fy - iy).astype(np.float32)
    n00 = _hash01(ix, iy, seed)
    n10 = _hash01(ix + 1, iy, seed)
    n01 = _hash01(ix, iy + 1, seed)
    n11 = _hash01(ix + 1, iy + 1, seed)
    return ((n00 * (1 - tx) + n10 * tx) * (1 - ty)
            + (n01 * (1 - tx) + n11 * tx) * ty)


class Renderer:
    """Renders frames of a ``synthetic.SyntheticWorld``: per-landmark
    textures fixed at construction, the ground's texture fixed in the
    world."""

    def __init__(self, world, patch_r: int = 7, texture_seed: int = 1234,
                 ground_cell: float = 0.4, max_draw_range: float = 70.0,
                 patch_world_halfsize: float = 0.45, patch_px_max: int = 20):
        from scipy.ndimage import gaussian_filter

        self.w = world
        self.ground_cell = ground_cell
        self.max_draw_range = max_draw_range
        self.patch_world_halfsize = patch_world_halfsize
        self.patch_px_max = patch_px_max
        M = world.landmarks.shape[0]
        side = 2 * patch_r + 1
        style = np.random.default_rng(texture_seed)
        # textures in [0.3, 1]: solid, so nearer billboards occlude fully
        tex = gaussian_filter(
            style.uniform(0, 1, (M, side, side)).astype(np.float32),
            sigma=(0, 1.0, 1.0))
        lo = tex.min(axis=(1, 2), keepdims=True)
        hi = tex.max(axis=(1, 2), keepdims=True)
        self.tex = 0.3 + 0.7 * (tex - lo) / np.maximum(hi - lo, 1e-6)
        labels = (world.labels if world.labels is not None
                  else np.full(M, -2, np.int32))
        self.lm_label = np.where(labels == -2, LABEL_BUILDING, labels)
        self.is_ground_pt = world.is_ground

    def cam_pose(self, frame: int) -> np.ndarray:
        """camera ← origin at ``frame``."""
        return pose_host.compose(self.w.T_cam_veh, self.w.poses_veh[frame])

    def frame(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """(intensity [H,W] float32 in [0,1], label image [H,W] uint8)."""
        w = self.w
        W, H = w.image_size
        F = w.focal
        cx, cy = w.principal
        T_co = self.cam_pose(frame)

        # ---- ground plane: backproject each pixel ray ------------------
        img = np.zeros((H, W), np.float32)
        lab = np.full((H, W), LABEL_SKY, np.uint8)
        T_oc = pose_host.inverse(T_co)
        R_oc = pose_host.to_matrix(T_oc)[:3, :3]
        c_o = pose_host.to_matrix(T_oc)[:3, 3]
        us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        rays_c = np.stack([(us - cx) / F, (vs - cy) / F,
                           np.ones_like(us)], -1)
        rays_o = rays_c @ R_oc.T
        gz = -w.cam_height
        denom = rays_o[..., 2]
        t = np.where(denom < -1e-6, (gz - c_o[2]) / np.where(
            np.abs(denom) > 1e-6, denom, 1.0), -1.0)
        hit = (t > 0.5) & (t * np.linalg.norm(rays_o, axis=-1)
                           < self.max_draw_range)
        gx = c_o[0] + t * rays_o[..., 0]
        gy = c_o[1] + t * rays_o[..., 1]
        cell = self.ground_cell
        n0 = _value_noise(gx, gy, cell, 11)
        n1 = _value_noise(gx, gy, 6 * cell, 7)
        # contrast fades with range
        dist = t * np.linalg.norm(rays_o, axis=-1)
        att = np.clip(10.0 / np.maximum(dist, 1e-3), 0.0, 1.0) \
            .astype(np.float32)
        shade = 0.45 + att * (0.3 * (n0 - 0.5)) + 0.3 * (n1 - 0.5)
        img = np.where(hit, shade.astype(np.float32), img)
        lab = np.where(hit, np.uint8(LABEL_ROAD), lab)

        # ---- landmark billboards, far to near --------------------------
        pts = w.landmarks_at(frame)
        p_cam = pose_host.apply(T_co, pts)
        z = p_cam[:, 2]
        uv = F * p_cam[:, :2] / np.maximum(z[:, None], 1e-6) \
            + np.asarray([cx, cy])
        ru_all = F * self.patch_world_halfsize / np.maximum(z, 1e-6)
        Rmax = self.patch_px_max
        vis = ((z > 2.0) & (z < self.max_draw_range) & (ru_all >= 1.5)
               & (uv[:, 0] > 2) & (uv[:, 0] < W - 3)
               & (uv[:, 1] > 2) & (uv[:, 1] < H - 3)
               & ~self.is_ground_pt)
        order = np.flatnonzero(vis)[np.argsort(-z[vis])]
        side = self.tex.shape[1]
        for i in order:
            ru = ru_all[i]
            R = int(np.ceil(min(ru, Rmax)))
            u0, v0 = int(np.floor(uv[i, 0])), int(np.floor(uv[i, 1]))
            xlo, xhi = max(u0 - R, 0), min(u0 + R + 2, W)
            ylo, yhi = max(v0 - R, 0), min(v0 + R + 2, H)
            if xhi <= xlo or yhi <= ylo:
                continue
            xs = np.arange(xlo, xhi, dtype=np.float32)
            ys = np.arange(ylo, yhi, dtype=np.float32)
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
