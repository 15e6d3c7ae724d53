"""KITTI odometry dataset I/O.

Covers what the reference ecosystem reads (``apps/main_program/utility.h:11-60``
velodyne .bin quads + gt pose-line parser; calib/times from the standard
odometry layout; pose dump format ``poseToString`` 3×4 row-major,
general_helpers.hpp:24-29).

A copy of the reference package's ``limo_tpu/io/kitti.py`` with one
change: images and label images go through the port's own PNG codec
(:mod:`.png`, no imaging library). Velodyne scans go through the C++
loader (:mod:`.native_loader`), as the reference's do.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from . import native_loader
from .png import read_png


@dataclass
class KittiCalib:
    P: Dict[str, np.ndarray]        # P0..P3 3x4 projection matrices
    Tr_cam_velo: np.ndarray         # 4x4: velodyne → cam0

    @property
    def focal(self) -> float:
        return float(self.P["P0"][0, 0])

    @property
    def principal(self) -> np.ndarray:
        return self.P["P0"][:2, 2].copy()


def read_calib(path: str) -> KittiCalib:
    P: Dict[str, np.ndarray] = {}
    Tr = np.eye(4)
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.fromstring(vals, sep=" ")
            if key.startswith("P") and arr.size == 12:
                P[key] = arr.reshape(3, 4)
            elif key.startswith("Tr") and arr.size == 12:
                Tr = np.vstack([arr.reshape(3, 4), [0, 0, 0, 1]])
    return KittiCalib(P=P, Tr_cam_velo=Tr)


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """Ground-truth/dumped poses: one 3×4 row-major line per frame (cam0,
    pose_origin_cam convention — KITTI standard). Returns [N,4,4]."""
    rows = np.loadtxt(path).reshape(-1, 12)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows.reshape(-1, 3, 4)
    return out


def write_poses(path: str, mats: np.ndarray) -> None:
    """Write KITTI pose lines (``poseToString``: 3×4 row-major)."""
    rows = np.asarray(mats)[:, :3, :4].reshape(-1, 12)
    with open(path, "w") as f:
        for r in rows:
            f.write(" ".join(f"{v:.9e}" for v in r) + "\n")


def read_velodyne(path: str) -> np.ndarray:
    """Velodyne scan: float32 (x,y,z,intensity) quads → [N,4]
    (``utility.h:11-38``), through the C++ loader (numpy where ``g++`` is
    absent)."""
    return native_loader.read_velodyne(path)


@dataclass
class KittiSequence:
    """Lazy handle on one odometry sequence directory."""

    root: str                    # .../sequences/NN
    calib: KittiCalib
    times: np.ndarray
    poses_gt: Optional[np.ndarray] = None  # [N,4,4] if available

    @staticmethod
    def open(root: str, poses_file: Optional[str] = None) -> "KittiSequence":
        calib = read_calib(os.path.join(root, "calib.txt"))
        times = read_times(os.path.join(root, "times.txt"))
        poses = None
        if poses_file and os.path.exists(poses_file):
            poses = read_poses(poses_file)
        return KittiSequence(root=root, calib=calib, times=times, poses_gt=poses)

    def __len__(self) -> int:
        return self.times.shape[0]

    def image_path(self, i: int, cam: int = 0) -> str:
        return os.path.join(self.root, f"image_{cam}", f"{i:06d}.png")

    def load_image(self, i: int, cam: int = 0) -> np.ndarray:
        return read_png(self.image_path(i, cam)).astype(np.float32) / 255.0

    def velodyne_path(self, i: int) -> str:
        return os.path.join(self.root, "velodyne", f"{i:06d}.bin")

    def load_velodyne(self, i: int) -> np.ndarray:
        return read_velodyne(self.velodyne_path(i))

    def label_path(self, i: int, cam: int = 0) -> str:
        """Semantic label image (uint8 cityscapes ids). KITTI odometry does
        not ship these; the reference attaches externally-generated labels
        (launch/semantic_labels.launch) — a ``labels_N/`` dir alongside
        ``image_N/`` plays that role here."""
        return os.path.join(self.root, f"labels_{cam}", f"{i:06d}.png")

    @property
    def has_labels(self) -> bool:
        return os.path.isdir(os.path.join(self.root, "labels_0"))

    def load_labels(self, i: int, cam: int = 0) -> Optional[np.ndarray]:
        path = self.label_path(i, cam)
        if not os.path.exists(path):
            return None
        return read_png(path).astype(np.int32)


def pose7_to_kitti(poses7: np.ndarray) -> np.ndarray:
    """Window/archive pose7 (keyframe←origin) → KITTI 4×4 (origin←frame).

    The reference dumps T_cam_origin = pose⁻¹ per frame
    (mono_lidar.cpp:275-300)."""
    from ..geometry import pose_host
    p = np.asarray(poses7, np.float64)
    return pose_host.to_matrix(pose_host.inverse(p))
