"""The fused cells' traffic: a rendered KITTI-geometry drive with camera
images, label images and Velodyne HDL-64E-class scans.

Parameters come from two files. The cell file's ``traffic`` object fixes
the drive:

- ``frames``, ``hz``, ``speed``: one pass, its frame rate and its speed
  (m/s, held);
- ``bend``: ``[first frame, end frame, rad per metre]``, the yaw rate over
  those frames (0 elsewhere);
- ``landmarks_per_m``, ``ground_per_m``: structure and ground points per
  metre of the landmark corridor (the path and the 40 m past its end);
  ``shrubbery``, ``dynamic``, ``dynamic_speed``: vegetation points and
  points on moving cars (clusters of ~10 sharing one motion, m/s);
- ``world_seed``, ``noise_seed``, ``texture_seed``: the draws of the
  world, of the scans' range noise and of the billboards' textures.

The configuration file's ``camera`` (focal, principal point, image size,
height over the road) and ``sensor`` fix the sensors. The scan model
(``sensor``): ``beams`` beams at elevations spread evenly over
``elevation_deg`` (first to last), ``columns`` azimuth columns over 360°,
mounted at ``mount_veh_m`` in the vehicle frame; each ray returns its
nearest hit on the road or on a landmark's billboard (the renderer's
squares of world half-size 0.45 m, facing the camera, at the landmark's
position in that frame, so moving cars return where they are), within
``max_range_m``, its range perturbed by Gaussian noise of
``range_noise_m``; a ray that hits nothing returns nothing. Returns come
in the vehicle frame, beam-major.

The drive is the file's, as a KITTI sequence is fixed: the run's seed only
permutes the order of each scan's returns (:func:`permuted`). Building it
takes minutes, so it is built once into ``.limo_bench_cache/`` under a key
of the parameters and of this generator's source (:func:`load`).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from . import pose_host
from .render import Renderer
from .synthetic import make_world

CORRIDOR_EXTENSION_M = 40.0
BILLBOARD_HALF_M = 0.45
# the cache, at a fixed path inside the checkout
CACHE = Path(__file__).resolve().parents[2] / ".limo_bench_cache" / "hdl64"


def world_of(traffic: dict, camera: dict):
    """The drive's ``SyntheticWorld``."""
    F, hz, v = int(traffic["frames"]), float(traffic["hz"]), \
        float(traffic["speed"])
    lo, hi, rate = traffic["bend"]
    yaw = np.zeros(F)
    yaw[int(lo):int(hi)] = float(rate)
    corridor = F * v / hz + CORRIDOR_EXTENSION_M
    return make_world(
        num_frames=F, hz=hz, speed=v, yaw_rate_profile=yaw,
        n_landmarks=int(round(traffic["landmarks_per_m"] * corridor)),
        n_ground=int(round(traffic["ground_per_m"] * corridor)),
        n_shrubbery=int(traffic["shrubbery"]),
        n_dynamic=int(traffic["dynamic"]),
        dynamic_speed=float(traffic["dynamic_speed"]),
        seed=int(traffic["world_seed"]), focal=float(camera["focal"]),
        pp=tuple(camera["principal"]), image_size=tuple(camera["image_size"]),
        cam_height=float(camera["height_m"]))


def ray_directions(sensor: dict) -> np.ndarray:
    """[beams, columns, 3] unit rays in the vehicle frame (x forward,
    z up): beam b at elevation ``elevation_deg`` spread evenly, column c
    at azimuth 2π c / columns."""
    top, bottom = sensor["elevation_deg"]
    el = np.deg2rad(np.linspace(top, bottom, int(sensor["beams"])))
    az = 2 * np.pi * np.arange(int(sensor["columns"])) / sensor["columns"]
    ce = np.cos(el)[:, None]
    return np.stack([ce * np.cos(az)[None], ce * np.sin(az)[None],
                     np.broadcast_to(np.sin(el)[:, None],
                                     (len(el), len(az)))], -1)


def ground_rays(sensor: dict, cam_height: float) -> int:
    """Rays whose road hit lies within range: each returns (the road or a
    nearer billboard), so a scan holds at least this many returns and at
    most every ray."""
    d = ray_directions(sensor)
    h = cam_height + float(sensor["mount_veh_m"][2])
    down = d[..., 2] < 0
    t = np.where(down, h / np.where(down, -d[..., 2], 1.0), np.inf)
    return int(np.sum(t <= float(sensor["max_range_m"])))


def scan(world, frame: int, sensor: dict, rng) -> np.ndarray:
    """[N,3] float32 returns in the vehicle frame at ``frame``."""
    d = ray_directions(sensor)
    B, C = d.shape[:2]
    s = np.asarray(sensor["mount_veh_m"], np.float64)
    rmax = float(sensor["max_range_m"])
    # the road: z = -cam_height in the vehicle frame
    down = d[..., 2] < 0
    t = np.where(down, (-world.cam_height - s[2])
                 / np.where(down, d[..., 2], -1.0), np.inf)
    t = np.where(t <= rmax, t, np.inf)
    # billboards: planes of constant camera depth, i.e. of constant
    # vehicle x (the camera looks along the vehicle's x axis)
    pts = pose_host.apply(world.poses_veh[frame], world.landmarks_at(frame))
    T_cv = world.T_cam_veh
    R_cv = pose_host.to_matrix(T_cv)[:3, :3]
    p_cam = pose_host.apply(T_cv, pts)
    s_cam = pose_host.apply(T_cv, s[None])[0]
    d_cam = d @ R_cv.T
    step_el = np.deg2rad(sensor["elevation_deg"][0]
                         - sensor["elevation_deg"][1]) / (B - 1)
    top_el = np.deg2rad(sensor["elevation_deg"][0])
    step_az = 2 * np.pi / C
    h = BILLBOARD_HALF_M
    near = (~world.is_ground
            & (np.abs(p_cam[:, 2] - s_cam[2]) > 0.5)
            & (np.linalg.norm(pts - s, axis=1) < rmax + 2 * h))
    for i in np.flatnonzero(near):
        # the rays through the billboard's bounding box of angles
        corners_c = p_cam[i] + np.array([[a, b, 0.0] for a in (-h, h)
                                         for b in (-h, h)])
        corners_v = pose_host.apply(pose_host.inverse(T_cv), corners_c) - s
        az = np.arctan2(corners_v[:, 1], corners_v[:, 0])
        az_c = np.arctan2(pts[i, 1] - s[1], pts[i, 0] - s[0])
        rel = (az - az_c + np.pi) % (2 * np.pi) - np.pi
        # elevation's extremes over the square: its top and bottom edges
        # at their nearest and farthest horizontal distance
        x0 = np.abs(corners_v[:, 0]).min()
        y_lo, y_hi = corners_v[:, 1].min(), corners_v[:, 1].max()
        hyp_near = np.hypot(x0, 0.0 if y_lo <= 0 <= y_hi
                            else min(abs(y_lo), abs(y_hi)))
        hyp_far = np.hypot(np.abs(corners_v[:, 0]).max(),
                           max(abs(y_lo), abs(y_hi)))
        z_lo, z_hi = corners_v[:, 2].min(), corners_v[:, 2].max()
        el_hi = np.arctan2(z_hi, hyp_near if z_hi >= 0 else hyp_far)
        el_lo = np.arctan2(z_lo, hyp_near if z_lo < 0 else hyp_far)
        c_lo = int(np.floor((az_c + rel.min()) / step_az))
        c_hi = int(np.ceil((az_c + rel.max()) / step_az))
        b_lo = max(int(np.floor((top_el - el_hi) / step_el)), 0)
        b_hi = min(int(np.ceil((top_el - el_lo) / step_el)), B - 1)
        if b_hi < b_lo:
            continue
        cols = np.arange(c_lo, c_hi + 1) % C
        rows = np.arange(b_lo, b_hi + 1)
        e = d_cam[rows][:, cols]                                # [b,c,3]
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (p_cam[i, 2] - s_cam[2]) / e[..., 2]
        x = s_cam[0] + tt * e[..., 0]
        y = s_cam[1] + tt * e[..., 1]
        hit = ((tt > 0) & (tt <= rmax) & (np.abs(x - p_cam[i, 0]) <= h)
               & (np.abs(y - p_cam[i, 1]) <= h))
        sub = t[np.ix_(rows, cols)]
        t[np.ix_(rows, cols)] = np.where(hit & (tt < sub), tt, sub)
    ok = np.isfinite(t)
    r = t[ok] + rng.normal(0.0, float(sensor["range_noise_m"]), int(ok.sum()))
    return (s + r[:, None] * d[ok]).astype(np.float32)


def _key(traffic: dict, camera: dict, sensor: dict) -> str:
    here = Path(__file__).resolve().parent
    src = b"".join((here / f).read_bytes()
                   for f in ("hdl64.py", "render.py", "synthetic.py",
                             "pose_host.py"))
    keep = {k: v for k, v in traffic.items() if k != "trace_frames"}
    blob = json.dumps([keep, camera, sensor], sort_keys=True).encode()
    return hashlib.sha256(blob + src).hexdigest()[:20]


def build(traffic: dict, camera: dict, sensor: dict):
    """(stamps [F], images [F,H,W] uint8, labels [F,H,W] uint8, points
    [sum N,3] float32, counts [F]) of one pass."""
    world = world_of(traffic, camera)
    rend = Renderer(world, texture_seed=int(traffic["texture_seed"]))
    F = world.poses_veh.shape[0]
    imgs, labs, clouds = [], [], []
    for i in range(F):
        img, lab = rend.frame(i)
        imgs.append((img * 255).astype(np.uint8))
        labs.append(lab)
        rng = np.random.default_rng([int(traffic["noise_seed"]), i])
        clouds.append(scan(world, i, sensor, rng))
    counts = np.array([len(c) for c in clouds], np.int64)
    return (world.stamps.astype(np.float64), np.stack(imgs), np.stack(labs),
            np.concatenate(clouds), counts)


NAMES = ("stamps", "images", "labels", "points", "counts")


def load(traffic: dict, camera: dict, sensor: dict, cache: Path = None):
    """The pass's arrays (as :func:`build`) and the world, from the cache,
    built into it first where missing. Returns (arrays, world, built)."""
    cache = CACHE if cache is None else Path(cache)
    d = cache / _key(traffic, camera, sensor)
    world = world_of(traffic, camera)
    built = False
    if not (d / "done").exists():
        arrays = build(traffic, camera, sensor)
        tmp = d.with_name(d.name + f".tmp{os.getpid()}")
        tmp.mkdir(parents=True, exist_ok=True)
        for name, a in zip(NAMES, arrays):
            np.save(tmp / f"{name}.npy", a)
        (tmp / "done").write_text("ok\n")
        if d.exists():
            import shutil
            shutil.rmtree(d)
        os.replace(tmp, d)
        built = True
    arrays = tuple(np.load(d / f"{name}.npy") for name in NAMES)
    return arrays, world, built


def permuted(points, counts, seed: int):
    """Each scan's returns as a list of [N,3] arrays, in an order drawn from
    the run's seed (a driver hands returns over in its own order)."""
    out, o = [], 0
    for i, n in enumerate(counts):
        rng = np.random.default_rng([seed, 0xF05E, i])
        out.append(points[o:o + n][rng.permutation(int(n))])
        o += n
    return out
