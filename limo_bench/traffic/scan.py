"""The one generator of the scan cells' traffic: a drive's speed profile,
world and dense lidar-camera tracks, from a cell's parameters and a seed.

Parameters (the cell file's ``traffic`` object):

- ``frames``, ``hz``: frames of one pass of the drive and their rate;
- ``speed_segments``: ``[[seconds, shape, a, b], ...]`` repeated until the
  pass is full. ``shape`` is ``"hold"`` (``a`` m/s throughout), ``"ramp"``
  (``a`` to ``b`` m/s, linear) or ``"half_sine"`` (0 up to ``a`` m/s and
  back, over the segment);
- ``yaw_rate``: rad per metre driven;
- ``landmarks_per_m``, ``ground_per_m``: structure and ground points per
  metre of the landmark corridor (the path plus the 40 m the world extends
  past its end);
- ``pixel_noise``, ``depth_noise`` (px, m), ``with_depth``, ``rows`` (the
  landmark rows of the track tensors, the configuration's capacity);
- ``world_seed``, ``noise_seed``: the draws of the landmarks and of the
  tracks' noise.

The drive is the file's, as a KITTI sequence is fixed: a world drawn anew
per run changed the work (11 to 48 trimmed solves in the same 60 frames,
on five worlds; PERF.md). The run's seed draws the order of the landmark
rows, the track ids a tracker hands out, so every seed gives the same
tracks, sizes and arrivals in another order.
"""

from __future__ import annotations

import numpy as np

from .synthetic import dense_tracks, make_world

CORRIDOR_EXTENSION_M = 40.0


def speed_profile(traffic: dict) -> np.ndarray:
    """[frames] m/s from the cell's speed segments."""
    hz, n = float(traffic["hz"]), int(traffic["frames"])
    parts = []
    total = 0
    while total < n:
        for seconds, shape, *args in traffic["speed_segments"]:
            m = max(int(round(seconds * hz)), 1)
            if shape == "hold":
                seg = np.full(m, float(args[0]))
            elif shape == "ramp":
                seg = np.linspace(float(args[0]), float(args[1]), m)
            elif shape == "half_sine":
                seg = float(args[0]) * np.sin(np.pi * (np.arange(m) + 0.5)
                                              / m)
            else:
                raise ValueError(f"unknown speed segment shape {shape!r}")
            parts.append(seg)
            total += m
    return np.concatenate(parts)[:n]


def world_and_tracks(traffic: dict, seed: int, **camera):
    """(stamps [F], uvd [F,R,3], valid [F,R], world) of one pass, the rows
    in the seed's order; ``camera`` (``focal``, ``pp``, ``image_size``,
    ``cam_height``) goes to the world."""
    sp = speed_profile(traffic)
    hz = float(traffic["hz"])
    path_m = float(sp.sum() / hz)
    corridor = path_m + CORRIDOR_EXTENSION_M
    world = make_world(
        num_frames=len(sp), hz=hz, speed=float(sp.max()), speed_profile=sp,
        yaw_rate=float(traffic["yaw_rate"]),
        n_landmarks=int(round(traffic["landmarks_per_m"] * corridor)),
        n_ground=int(round(traffic["ground_per_m"] * corridor)),
        seed=int(traffic["world_seed"]), **camera)
    stamps, uvd, valid = dense_tracks(
        world, int(traffic["rows"]), pixel_noise=traffic["pixel_noise"],
        depth_noise=traffic["depth_noise"],
        with_depth=bool(traffic["with_depth"]),
        seed=int(traffic["noise_seed"]))
    order = np.random.default_rng([seed, 0x5CA1]).permutation(uvd.shape[1])
    return stamps, uvd[:, order], valid[:, order], world
